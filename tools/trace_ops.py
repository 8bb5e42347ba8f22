#!/usr/bin/env python
"""Aggregate per-op device durations from a jax.profiler trace.

Reads the newest ``*.xplane.pb`` under ``<trace_dir>/plugins/profile/``
with ``jax.profiler.ProfileData`` and sums event durations per
(line, op) on every device plane (``/device:GPU:<i>`` on the GPU) —
enough to find which fusions or copies dominate a loop.

Usage:
    python tools/trace_ops.py <trace_dir> [top_n]

where <trace_dir> is the directory passed to jax.profiler.start_trace().
"""
import glob
import os
import sys
from collections import defaultdict


def latest_xplane(trace_dir: str) -> str:
    files = glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb"))
    if not files:
        raise SystemExit(f"no xplane.pb under {trace_dir}")
    return max(files, key=os.path.getmtime)


def device_op_times(trace_dir: str) -> dict:
    """{plane name: {(line name, op name): [total_ns, count]}} over the
    device planes of the newest trace in `trace_dir`."""
    from jax.profiler import ProfileData
    data = ProfileData.from_file(latest_xplane(trace_dir))
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        agg = defaultdict(lambda: [0.0, 0])
        for line in plane.lines:
            for ev in line.events:
                agg[(line.name, ev.name)][0] += ev.duration_ns
                agg[(line.name, ev.name)][1] += 1
        out[plane.name] = dict(agg)
    return out


def main(trace_dir: str, top_n: int = 30):
    for plane, agg in device_op_times(trace_dir).items():
        print(f"== {plane}")
        print(f"{'line':24s} {'op':56s} {'total_ms':>9s} {'count':>6s}")
        for (ln, name), (ns, cnt) in sorted(
                agg.items(), key=lambda kv: -kv[1][0])[:top_n]:
            print(f"{ln[:24]:24s} {name[:56]:56s} {ns / 1e6:9.3f} "
                  f"{cnt:6d}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 30)
