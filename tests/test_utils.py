"""Tests: profiling subsystem, manager templates, TOPP retiming."""

import numpy as np
import pytest

import jax.numpy as jnp

from grasptrajopt_tpu.planning.retiming import convert_plan_to_trajectory, toppra_retime
from grasptrajopt_tpu.utils.profiling import PhaseTimer, debug_guard, device_memory_stats
from grasptrajopt_tpu.utils.templates import Manager


class TestPhaseTimer:
    def test_phases_accumulate(self):
        timer = PhaseTimer(sync=False)
        import time

        with timer.phase("ik"):
            time.sleep(0.01)
        with timer.phase("ik"):
            time.sleep(0.01)
        with timer.phase("planning"):
            time.sleep(0.005)
        means = timer.means()
        assert means["ik_time"] >= 0.009
        assert means["planning_time"] >= 0.004
        assert timer.counts["ik"] == 2
        assert "ik" in timer.report()


class TestDebugGuard:
    def test_nan_guard_restores_config(self):
        import jax

        before = jax.config.jax_debug_nans
        with debug_guard(nans=True):
            assert jax.config.jax_debug_nans is True
        assert jax.config.jax_debug_nans == before


class TestManager:
    def test_lifecycle_and_timing(self, tmp_path):
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text("gain: 2.5\n")

        class FakeSolver:
            def solve(self):
                return {"x": np.ones(3)}

        class MyManager(Manager):
            def setup_solver(self):
                return FakeSolver()

            def is_ready(self):
                return True

            def reset(self):
                pass

            def get_target(self):
                return self.solution["x"]

        m = MyManager(config_filename=str(cfg), record_solver_perf=True)
        assert m.config["gain"] == 2.5
        assert m.is_first_solve()
        m.solve()
        assert not m.is_first_solve()
        assert m.get_solver_duration() is not None
        np.testing.assert_allclose(m.get_target(), np.ones(3))


class _FakeRobot:
    def __init__(self, ndof, vmax=1.0):
        self.velocity_optimized_joint_limits = np.full(ndof, vmax)
        self.velocity_actuated_joint_limits = np.full(ndof, vmax)


class TestRetiming:
    def test_limits_respected(self):
        # straight-line 2-joint plan over 20 waypoints
        T = 20
        plan = np.stack([np.linspace(0, 1.0, T), np.linspace(0, -0.5, T)])
        robot = _FakeRobot(2, vmax=0.8)
        qs, qds, qdds, ts = convert_plan_to_trajectory(robot, plan, accel_limit=0.5)
        assert qs.shape == (100, 2)
        assert ts[0] == 0.0 and ts[-1] > 0
        # endpoint positions preserved
        np.testing.assert_allclose(qs[0], plan[:, 0], atol=1e-3)
        np.testing.assert_allclose(qs[-1], plan[:, -1], atol=1e-3)
        # velocity limit respected; acceleration approximately (the
        # finite-difference re-sampling spikes briefly at phase switches)
        assert np.abs(qds).max() <= 0.8 * 1.05
        assert np.percentile(np.abs(qdds), 90) <= 0.5 * 1.2
        assert np.abs(qdds).max() <= 0.5 * 2.0

    def test_rest_to_rest(self):
        T = 15
        plan = np.stack([np.linspace(0, 0.5, T)])
        robot = _FakeRobot(1)
        qs, qds, qdds, ts = convert_plan_to_trajectory(robot, plan)
        np.testing.assert_allclose(qds[0], 0.0, atol=1e-2)
        np.testing.assert_allclose(qds[-1], 0.0, atol=1e-2)

    def test_faster_limits_shorter_duration(self):
        T = 15
        plan = np.stack([np.linspace(0, 1.0, T)])
        _, _, _, ts_slow = convert_plan_to_trajectory(_FakeRobot(1, vmax=0.5), plan)
        _, _, _, ts_fast = convert_plan_to_trajectory(_FakeRobot(1, vmax=2.0), plan)
        assert ts_fast[-1] < ts_slow[-1]


class TestAttribution:
    """utils/attribution.py: device busy share, op buckets, peak table."""

    def test_busy_share_merges_overlaps(self):
        from grasptrajopt_tpu.utils.attribution import busy_share

        # [0,10] and [5,20] overlap -> 20 busy; [30,40] after a 10 gap;
        # window 0..40 -> idle 10/40 (values in ns)
        out = busy_share([(0, 10e6), (5e6, 20e6), (30e6, 40e6)])
        assert out == {"window_ms": 40.0, "busy_ms": 30.0, "idle_share": 0.25}

    def test_bucketing(self):
        from grasptrajopt_tpu.utils.attribution import bucket_device_time

        events = {
            "loop_gather_fusion": {"us": 500.0, "count": 3, "hlo_op": "gather.4"},
            "gemm_fusion": {"us": 300.0, "count": 2, "hlo_op": "dot.5"},
            "min_d2": {"us": 100.0, "count": 1, "hlo_op": "custom-call.2"},
            "loop_exponential_fusion": {"us": 100.0, "count": 1, "hlo_op": "fusion.9"},
            None: [(0, 1)],
        }
        b = bucket_device_time(events)
        assert b["gather"] == 0.5 and b["matmul"] == 0.3
        assert b["pallas_kernel"] == 0.1 and b["other"] == 0.1
        assert b["total_device_ms"] == 1.0

    def test_profile_step_on_cpu_backend(self):
        """A trace with no GPU device events cannot attribute device time:
        profile_step raises instead of returning empty buckets."""
        import jax
        import jax.numpy as jnp

        from grasptrajopt_tpu.utils.attribution import profile_step

        f = jax.jit(lambda: (jnp.arange(512.0) ** 2).sum())
        with pytest.raises(RuntimeError, match="no device events"):
            profile_step(f, device_kind=jax.devices()[0].device_kind)

    def test_unknown_device_gets_no_peak_share(self):
        from grasptrajopt_tpu.utils.attribution import HBM_PEAK_BYTES_PER_S

        assert HBM_PEAK_BYTES_PER_S["NVIDIA H100 80GB HBM3"] == 3.35e12
        assert "cpu" not in HBM_PEAK_BYTES_PER_S
