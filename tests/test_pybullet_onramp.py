"""Real-pybullet on-ramp: keep the one-command
scene-10 run (`make eval-pybullet`) warm while pybullet itself is not
installable here.

Covers the pieces the fake-backend driver E2E (test_drivers.py) does not:
the driver's CLI surface as a real subprocess, and the envs package's
HAS_PYBULLET gate flipping when a module named `pybullet` is importable.
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DRIVER = os.path.join(_REPO, "examples", "gto_planning.py")


def _cpu_env():
    env = dict(os.environ)
    env.update(
        {
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": _REPO + os.pathsep + os.path.join(_REPO, "tests"),
        }
    )
    return env


def test_driver_help_runs():
    out = subprocess.run(
        [sys.executable, _DRIVER, "--help"],
        env=_cpu_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    for flag in ("--scene_id", "--scene_type", "--goal_capacity", "--resume"):
        assert flag in out.stdout


def test_driver_gates_cleanly_without_pybullet():
    """Without any module named pybullet, the driver must exit 1 with its
    install hint (the reference driver would ImportError instead)."""
    code = (
        "import sys; sys.argv=['gto_planning.py','-s','10'];"
        "import importlib.util;"
        f"spec=importlib.util.spec_from_file_location('d', {_DRIVER!r});"
        "m=importlib.util.module_from_spec(spec); spec.loader.exec_module(m);"
        "sys.exit(0 if m.HAS_PYBULLET else m.main())"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=_cpu_env(), capture_output=True, text=True, timeout=120,
    )
    if out.returncode == 0:
        return  # real pybullet present: the on-ramp is live, nothing to gate
    assert out.returncode == 1, out.stderr
    assert "needs pybullet" in out.stdout


def test_env_gate_flips_with_module_named_pybullet():
    """With a module importable under the REAL name `pybullet` (the
    emulator registered via install()), grasptrajopt_tpu.envs must expose
    the full simulation layer exactly as it would with the real engine."""
    code = (
        # importing fake_pybullet pulls in the envs package before install()
        # flips the gate — reload it afterwards, exactly as a process with
        # the real engine would see it importable on first touch
        "import importlib;"
        "from grasptrajopt_tpu.envs import fake_pybullet as fp;"
        "assert fp.install(force=True);"
        "import pybullet;"  # resolves under the real module name
        "import grasptrajopt_tpu.envs as E;"
        "E=importlib.reload(E);"
        "assert E.HAS_PYBULLET;"
        "from grasptrajopt_tpu.envs import SceneReplicaEnv, Panda, PyBulletSession;"
        "print('onramp-ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=_cpu_env(), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "onramp-ok" in out.stdout
