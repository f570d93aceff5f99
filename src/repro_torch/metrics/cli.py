"""``python -m repro_torch.metrics``: validate, check, diff, pretty-print
metrics snapshots.

    python -m repro_torch.metrics m.json                    # structural check
    python -m repro_torch.metrics m.json --check            # + invariants
    python -m repro_torch.metrics m.json --check --trace t.json   # + reconcile
    python -m repro_torch.metrics m.json --diff other.json  # what changed
    python -m repro_torch.metrics m.json --pretty           # human summary

Exit codes: 0 valid, 1 invariant/structure violation, 2 usage or
unreadable input -- the same contract as ``python -m repro_torch.trace``, so
CI treats both artifacts alike.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from .check import (check_snapshot, check_structure, diff_snapshots,
                    index_metrics)
from .registry import MetricsError


def _load(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: cannot load {path}: {e}", file=sys.stderr)
        raise SystemExit(2)


def _pretty(snap: Dict[str, Any]) -> List[str]:
    lines: List[str] = []
    idx = index_metrics(snap)
    for (name, labels), m in sorted(idx.items()):
        tag = "".join(f" {k}={v}" for k, v in labels)
        if m["type"] == "histogram":
            count = int(m["count"])
            mean = float(m["sum"]) / count if count else 0.0
            lines.append(
                f"  {name}{tag}: count={count} sum={float(m['sum']):.6g} "
                f"mean={mean:.6g} min={float(m.get('min', 0)):.6g} "
                f"max={float(m.get('max', 0)):.6g}"
            )
        else:
            lines.append(f"  {name}{tag}: {float(m['value']):g}")
    if "slo" in snap:
        s = snap["slo"]
        lines.append(
            f"  slo: verdict={s.get('verdict')} p95={s.get('p95_s', 0):.6g}s "
            f"target={s.get('target_p95_s', 0):g}s "
            f"latency_burn={s.get('latency_burn', 0):.3g} "
            f"error_burn={s.get('error_burn', 0):.3g}"
        )
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.metrics",
        description="Validate / check / diff repro metrics snapshots.",
    )
    ap.add_argument("snapshot", help="metrics snapshot JSON (--metrics out)")
    ap.add_argument("--check", action="store_true",
                    help="run the serving invariants, not just structure")
    ap.add_argument("--trace", metavar="TRACE.json",
                    help="reconcile serve counters against this Chrome "
                         "trace's cumulative counter totals")
    ap.add_argument("--diff", metavar="OTHER.json",
                    help="print per-series differences vs another snapshot")
    ap.add_argument("--pretty", action="store_true",
                    help="print a human-readable series summary")
    args = ap.parse_args(argv)

    snap = _load(args.snapshot)
    try:
        if args.check or args.trace:
            trace = _load(args.trace) if args.trace else None
            checked = check_snapshot(snap, trace)
        else:
            checked = check_structure(snap)
    except MetricsError as e:
        print(f"INVARIANT VIOLATION: {e}", file=sys.stderr)
        return 1

    n = len(snap.get("metrics", []))
    print(f"{args.snapshot}: {n} series ok "
          f"({', '.join(checked) if checked else 'no checks applicable'})")
    if args.pretty:
        for line in _pretty(snap):
            print(line)
    if args.diff:
        other = _load(args.diff)
        try:
            lines = diff_snapshots(snap, other)
        except MetricsError as e:
            print(f"INVARIANT VIOLATION: {e}", file=sys.stderr)
            return 1
        for line in lines:
            print(line)
        print(f"diff: {len(lines)} series changed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
