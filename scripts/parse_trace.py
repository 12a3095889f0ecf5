#!/usr/bin/env python
"""Summarize a jax.profiler (Perfetto JSON) trace captured with
LTEAX_TRACE=<dir>.

Usage: python scripts/parse_trace.py <trace_dir_or_json.gz> [--top N]
       [--match SUBSTR]

Finds the newest ``*.trace.json.gz`` under the directory, sums device-op
durations by op name (pid = the busiest device track by default), and
prints the top-N rows plus the total device time.  ``--match`` filters to
ops whose name contains the substring (case-insensitive).

This is the measure-first workflow's 5-minute step (PERF.md): trace, sum,
look — before designing any fix.
"""
import argparse
import collections
import glob
import gzip
import json
import os
import sys


def find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.trace.json.gz"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        sys.exit(f"no *.trace.json.gz under {path}")
    return hits[-1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--match", default=None)
    ap.add_argument("--pid", type=int, default=None,
                    help="device track pid (default: auto = busiest pid)")
    a = ap.parse_args()

    with gzip.open(find_trace(a.path), "rt") as f:
        tr = json.load(f)
    ev = tr["traceEvents"]

    # auto-pick the device pid: the busiest pid by summed slice duration
    # whose track isn't the python host thread
    by_pid = collections.defaultdict(float)
    pid_names = {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "X":
            by_pid[e["pid"]] += e.get("dur", 0)
    pid = a.pid
    if pid is None:
        dev = [(d, p) for p, d in by_pid.items()
               if "device" in pid_names.get(p, "").lower()
               or "gpu" in pid_names.get(p, "").lower()]
        pid = max(dev)[1] if dev else max((d, p) for p, d in by_pid.items())[1]

    durs = collections.defaultdict(float)
    cnt = collections.defaultdict(int)
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") == pid:
            n = e["name"]
            if a.match and a.match.lower() not in n.lower():
                continue
            durs[n] += e.get("dur", 0)
            cnt[n] += 1
    total = sum(durs.values())
    print(f"# pid {pid} ({pid_names.get(pid, '?')}), "
          f"total {total / 1e3:.2f} ms across {sum(cnt.values())} slices")
    for n, d in sorted(durs.items(), key=lambda kv: -kv[1])[:a.top]:
        print(f"{d / 1e3:9.3f} ms  x{cnt[n]:<5d} {n[:110]}")


if __name__ == "__main__":
    main()
