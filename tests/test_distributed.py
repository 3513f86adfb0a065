"""Multi-process jax.distributed execution (SURVEY.md §2.3 multi-process
row): two REAL OS processes joined through
`parallel.mesh.distributed_init`'s num_processes>1 branch, a cross-process
psum, and a sharded-vs-unsharded solve over the global mesh.

The 8-virtual-device tests in test_parallel.py cover sharding semantics in
one process; this file covers the distributed runtime itself.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "distributed_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_psum_and_sharded_solve(tmp_path):
    num_processes = 2
    port = _free_port()
    env = dict(os.environ)
    env.update(
        {
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            "PYTHONPATH": os.path.dirname(os.path.dirname(_WORKER)),
        }
    )
    outs = [tmp_path / f"worker{i}.json" for i in range(num_processes)]
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), str(num_processes), str(port), str(outs[i])],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(num_processes)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{logs[i]}"
    for i, path in enumerate(outs):
        result = json.loads(path.read_text())
        assert result["ok"], result
        assert result["process_count"] == num_processes
        assert result["global_devices"] == 4  # 2 procs x 2 local devices
        assert result["local_devices"] == 2
        assert abs(result["psum_mean"] - result["psum_expected"]) < 1e-5
        assert result["solve_max_err"] < 1e-4
