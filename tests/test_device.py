"""Device entry-point guards: the GPU check, the compile-cache rule, and an
import chain that needs neither PyYAML nor matplotlib."""

import json
import os
import subprocess
import sys

import pytest

import jax

from grasptrajopt_tpu.utils import device

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env_without_platform():
    """JAX_PLATFORMS unset and no card visible: JAX falls back to the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(PYTHONPATH=_REPO, CUDA_VISIBLE_DEVICES="")
    return env


class TestRequireGpu:
    def test_refuses_cpu_when_platform_unset(self, monkeypatch):
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
        with pytest.raises(SystemExit, match="no GPU"):
            device.require_gpu()
        with pytest.raises(SystemExit, match="JAX_PLATFORMS=cpu"):
            device.require_gpu(allow_requested_cpu=True)

    def test_requested_cpu_is_allowed_only_where_asked(self, monkeypatch):
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
        assert device.require_gpu(allow_requested_cpu=True) == "cpu"
        with pytest.raises(SystemExit):
            device.require_gpu()

    @pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
    def test_entry_points_exit_nonzero_without_gpu(self, script):
        out = subprocess.run(
            [sys.executable, os.path.join(_REPO, script)],
            env=_env_without_platform(), cwd=_REPO,
            capture_output=True, text=True, timeout=300,
        )
        assert out.returncode != 0
        assert "no GPU" in out.stderr
        assert '"ok"' not in out.stdout

    def test_chip_smoke_alone_exits_nonzero(self, tmp_path):
        with open(os.path.join(_REPO, "chip_smoke.py")) as f:
            (tmp_path / "chip_smoke.py").write_text(f.read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        out = subprocess.run(
            [sys.executable, "chip_smoke.py"], env=env, cwd=tmp_path,
            capture_output=True, text=True, timeout=300,
        )
        assert out.returncode != 0 and out.stdout.strip() == ""


class TestCompileCache:
    def test_cpu_runs_get_no_cache(self):
        assert jax.default_backend() == "cpu"
        assert device.enable_compile_cache() is None

    def test_env_dir_wins_else_repo_dir(self, monkeypatch, tmp_path):
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        try:
            assert device.enable_compile_cache() == os.path.join(_REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == os.path.join(_REPO, ".jax_cache")
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_cache_dir_is_gitignored(self):
        with open(os.path.join(_REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_planning_imports_without_yaml_or_matplotlib():
    code = (
        "import sys\n"
        "for m in ('yaml', 'matplotlib', 'matplotlib.pyplot'):\n"
        "    sys.modules[m] = None\n"
        "import grasptrajopt_tpu.planning, grasptrajopt_tpu.utils.templates\n"
        "from grasptrajopt_tpu.planning.pipeline import GraspPipeline\n"
        "from grasptrajopt_tpu.testing import make_synthetic_gripper\n"
        "import json; print(json.dumps(sorted(m for m in ('yaml', 'matplotlib') "
        "if sys.modules.get(m) is not None)))\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
