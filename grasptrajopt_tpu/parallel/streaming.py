"""Steady-state throughput driving: keep K device batches in flight.

Every call pays host dispatch overhead. JAX's async dispatch hides it as
long as the host never blocks between submissions, so sustained
throughput is a *pipelining* property, not a kernel property. This module
makes that a first-class framework capability instead of a benchmark
trick:

  - `stream_map(fn, inputs, inflight=K)` — run a jitted solve over a
    sequence of input batches with a bounded number of outstanding device
    calls, yielding results in submission order.
  - `PlanStream` — submit/collect interface for serving-style
    microbatching: producers enqueue problem batches, the device stays
    saturated, results are collected in order.

No reference equivalent: the reference is a synchronous single-problem
loop (SURVEY.md §2.3 — scenes/objects iterated sequentially,
pybullet_gto_planning.py:151-164); its "pipeline" is the Python
interpreter. Here the pipeline depth bounds host memory (K live result
pytrees) while the device queue amortizes dispatch to zero.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

import jax

__all__ = ["stream_map", "PlanStream"]


def stream_map(
    fn: Callable,
    inputs: Iterable,
    inflight: int = 2,
) -> Iterator:
    """Map a (jitted) function over input batches, keeping up to `inflight`
    device calls outstanding; yields results in submission order.

    Each element of `inputs` is passed as `fn(*elem)` if it is a tuple,
    else `fn(elem)`. Results are `jax.block_until_ready`-materialized
    before being yielded, so consumers see finished arrays.

    inflight=1 degenerates to the synchronous loop; inflight=2 is enough to
    hide host dispatch behind device execution on one chip (double
    buffering); larger depths only help when submission itself is bursty.
    """
    if inflight < 1:
        raise ValueError(f"inflight must be >= 1, got {inflight}")
    pending: deque = deque()
    for elem in inputs:
        if len(pending) >= inflight:
            yield jax.block_until_ready(pending.popleft())
        pending.append(fn(*elem) if isinstance(elem, tuple) else fn(elem))
    while pending:
        yield jax.block_until_ready(pending.popleft())


class PlanStream:
    """Bounded-depth submit/collect pipeline around one jitted solve.

    Usage:
        stream = PlanStream(solve_batch, inflight=2)
        for batch in batches:
            for out in stream.submit(batch):   # 0+ completed results
                consume(out)
        for out in stream.drain():
            consume(out)

    `submit` enqueues one device call and returns any results whose
    completion the depth bound forced; `drain` flushes the rest. Results
    always come back in submission order.
    """

    def __init__(self, fn: Callable, inflight: int = 2):
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1, got {inflight}")
        self._fn = fn
        self._inflight = inflight
        self._pending: deque = deque()
        self.submitted = 0
        self.completed = 0

    def submit(self, *args):
        """Enqueue fn(*args); return a list of results (possibly empty)
        that had to be retired to respect the depth bound."""
        done = []
        if len(self._pending) >= self._inflight:
            done.append(jax.block_until_ready(self._pending.popleft()))
            self.completed += 1
        self._pending.append(self._fn(*args))
        self.submitted += 1
        return done

    def drain(self):
        """Retire every outstanding call, in order."""
        while self._pending:
            yield jax.block_until_ready(self._pending.popleft())
            self.completed += 1
