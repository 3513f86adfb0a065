# Test/bench entry points.
#
# Tests and CPU evaluation runs pin JAX to the CPU. The device entry points
# (bench.py, chip_smoke.py) need an NVIDIA GPU and refuse a CPU fallback;
# run one of them at a time per card (a JAX process reserves most of the
# card's memory).

CPU_ENV := JAX_PLATFORMS=cpu

.PHONY: test test-fast smoke bench eval eval-shelf eval-pybullet

# full suite, slow tests included
test:
	$(CPU_ENV) python -m pytest tests/ -q

# iteration suite: planner/pipeline/batching integration tests over ~40 s
# are marked `slow`
test-fast:
	$(CPU_ENV) python -m pytest tests/ -q -x -m "not slow"

# GPU: every device path once against plain references
smoke:
	python chip_smoke.py

bench:
	python bench.py

# closed-loop evaluation on synthetic SceneReplica-style scenes (CPU)
eval:
	$(CPU_ENV) python examples/synthetic_eval.py -t tabletop

eval-shelf:
	$(CPU_ENV) python examples/synthetic_eval.py -t shelf

# real-engine on-ramp: the day pybullet becomes installable, this is the
# scene-10 closed-loop run against the real SceneReplica dataset (point
# GTO_DATA_DIR at it first). Until then the driver exits with its own
# "needs pybullet" message — the import path and the driver flow itself
# are kept green by tests/test_drivers.py (fake backend) and
# tests/test_pybullet_onramp.py (--help / module gate).
eval-pybullet:
	$(CPU_ENV) python examples/gto_planning.py -t tabletop -s 10
