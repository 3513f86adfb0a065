"""Device-time attribution from jax.profiler traces.

`profile_step` runs a callable under the profiler, reads the device
planes of the resulting XSpace (`jax.profiler.ProfileData`), and reports:
the device busy share of the traced window, device time by op family, the
top ops, and — given the analytic bytes the obstacle-term row gathers
must move — their achieved bandwidth against the card's HBM peak.

Peaks are keyed by `device_kind`. A device missing from the table gets no
peak share: an assumed peak would be a made-up number.

The reference publishes wall-clock phase times only
(/root/reference/examples/pybullet_gto_planning.py:323); it has no device
profiler integration at all (SURVEY.md §5).
"""

from __future__ import annotations

import glob
import shutil
import tempfile
from collections import defaultdict
from typing import Callable, Optional

# HBM bandwidth, bytes/s, by jax device_kind. Source: NVIDIA H100 Tensor
# Core GPU data sheet (H100 SXM: 80 GB HBM3 at 3.35 TB/s).
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

_DEVICE_PLANE_PREFIX = "/device:GPU:"


def device_events(logdir: str) -> dict:
    """Per-op device time from a jax.profiler trace directory:
    {name: {"us", "count", "hlo_op"}} plus the busy intervals under the
    key None. Raises RuntimeError when the trace holds no device events
    (a trace with none cannot attribute anything)."""
    from jax.profiler import ProfileData

    tot = defaultdict(float)
    cnt = defaultdict(int)
    hlo = {}
    intervals = []
    for path in glob.glob(f"{logdir}/plugins/profile/*/*.xplane.pb"):
        for plane in ProfileData.from_file(path).planes:
            if not plane.name.startswith(_DEVICE_PLANE_PREFIX):
                continue
            for line in plane.lines:
                for ev in line.events:
                    dur = ev.duration_ns
                    if dur <= 0:
                        continue
                    stats = dict(ev.stats)
                    tot[ev.name] += dur / 1e3
                    cnt[ev.name] += 1
                    hlo.setdefault(ev.name, str(stats.get("hlo_op", "")))
                    intervals.append((ev.start_ns, ev.start_ns + dur))
    if not tot:
        raise RuntimeError(f"no device events in the trace under {logdir}")
    events = {n: {"us": tot[n], "count": cnt[n], "hlo_op": hlo[n]} for n in tot}
    events[None] = sorted(intervals)
    return events


def busy_share(intervals) -> dict:
    """Union of device-busy intervals over the window they span."""
    busy = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in intervals) - intervals[0][0]
    return {
        "window_ms": round(window / 1e6, 3),
        "busy_ms": round(busy / 1e6, 3),
        "idle_share": round(1.0 - busy / window, 4) if window > 0 else 0.0,
    }


_BUCKETS = (
    # (bucket, substrings matched against "name||hlo_op", lowercased)
    ("gather", ("gather",)),
    ("matmul", ("gemm", "cublas", "cutlass", "dot")),
    ("pallas_kernel", ("min_d2",)),
    ("cholesky_tri", ("cholesky", "potrf", "trsm", "triangular")),
    ("data_movement", ("copy", "transpose", "memcpy", "memset", "concatenate", "slice")),
    ("reduce", ("reduce",)),
)


def bucket_device_time(events: dict) -> dict:
    """Fold the per-op histogram into op-family buckets (fractions of total
    device time)."""
    buckets = defaultdict(float)
    total = 0.0
    for name, rec in events.items():
        if name is None:
            continue
        hay = (name + "||" + rec["hlo_op"]).lower()
        for bucket, keys in _BUCKETS:
            if any(k in hay for k in keys):
                buckets[bucket] += rec["us"]
                break
        else:
            buckets["other"] += rec["us"]
        total += rec["us"]
    out = {k: round(v / total, 4) for k, v in sorted(buckets.items(), key=lambda kv: -kv[1])}
    out["total_device_ms"] = round(total / 1e3, 3)
    return out


def profile_step(
    fn: Callable[[], object],
    device_kind: str,
    logdir: Optional[str] = None,
    gather_bytes: Optional[float] = None,
    keep_trace: bool = False,
) -> dict:
    """Run `fn` once under the profiler and return the attribution block:

    {"device": {window_ms, busy_ms, idle_share},
     "device_time_frac": {gather: .., matmul: .., data_movement: .., ...},
     "top_ops": [{name, hlo_op, ms, count}, ...],
     "gather": {bytes, device_ms, bytes_per_s[, frac_of_hbm_peak]}}

    gather_bytes: analytic bytes the workload's row gathers must move
    during `fn` (the caller computes it from shapes); frac_of_hbm_peak is
    present only for a device_kind in HBM_PEAK_BYTES_PER_S.
    """
    import jax

    logdir = logdir or tempfile.mkdtemp(prefix="gto_prof_")
    jax.profiler.start_trace(logdir)
    try:
        jax.block_until_ready(fn())
    finally:
        jax.profiler.stop_trace()
    try:
        events = device_events(logdir)
    finally:
        if not keep_trace:
            shutil.rmtree(logdir, ignore_errors=True)
    result = {
        "device": busy_share(events.pop(None)),
        "device_time_frac": bucket_device_time(events),
    }
    top = sorted(events.items(), key=lambda kv: -kv[1]["us"])[:8]
    result["top_ops"] = [
        {"name": name[:70], "hlo_op": rec["hlo_op"][:40],
         "ms": round(rec["us"] / 1e3, 3), "count": rec["count"]}
        for name, rec in top
    ]
    if gather_bytes:
        # XLA fuses the row gather into its consumers, and inside CUDA
        # graphs the events carry no HLO op; a bandwidth is reported only
        # when gather-named kernels hold a visible share of device time
        g_us = sum(
            rec["us"] for name, rec in events.items()
            if "gather" in (name + rec["hlo_op"]).lower()
        )
        total_us = sum(rec["us"] for rec in events.values())
        result["gather"] = {"bytes": int(gather_bytes), "device_ms": round(g_us / 1e3, 3)}
        if g_us < 0.01 * total_us:
            result["gather"]["bytes_per_s"] = "not identified in the trace"
        else:
            bps = gather_bytes / (g_us * 1e-6)
            result["gather"]["bytes_per_s"] = bps
            peak = HBM_PEAK_BYTES_PER_S.get(device_kind)
            if peak is not None:
                result["gather"]["frac_of_hbm_peak"] = round(bps / peak, 5)
    if keep_trace:
        result["trace_dir"] = logdir
    return result
