"""Histogram a jax.profiler trace by op: total GPU device time per event.

Usage: python tools/trace_report.py <trace_dir> [N]
Reads <dir>/plugins/profile/*/*.xplane.pb (e.g. from BENCH_PROFILE=<dir>
python bench.py) and prints the device busy share of the window and the
top-N device events by summed duration with their HLO op. A trace of the
real program is the reliable way to attribute cost; component
microbenchmarks mis-attribute.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from grasptrajopt_tpu.utils.attribution import busy_share, device_events  # noqa: E402


def main():
    root = sys.argv[1]
    topn = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    events = device_events(root)
    print(busy_share(events.pop(None)))
    grand = sum(rec["us"] for rec in events.values())
    print(f"{'total_ms':>10s} {'share':>6s} {'count':>7s}  name  [hlo_op]")
    for name, rec in sorted(events.items(), key=lambda kv: -kv[1]["us"])[:topn]:
        print(f"{rec['us'] / 1e3:10.3f} {rec['us'] / grand:6.1%} {rec['count']:7d}  "
              f"{name[:90]}  [{rec['hlo_op']}]")
    print(f"{grand / 1e3:10.3f} total device ms")


if __name__ == "__main__":
    main()
