"""Aggregate the dry run's JSON records (``launch.dryrun``) into tables, as
the reference's ``repro/analysis/aggregate.py`` does.

  PYTHONPATH=src python -m repro_torch.analysis.aggregate [results/dryrun_torch]
"""
from __future__ import annotations

import json
import os
import sys
from typing import List, Set

ORDER_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
#: the mark of a term that a composed cell extrapolates (``modelled``)
MODELLED = "~"
_TERMS = {"t_compute": "compute", "t_memory": "memory",
          "t_collective": "collective"}


def load(results_dir: str) -> List[dict]:
    """Every ``*.json`` record in ``results_dir``, by file name."""
    recs = []
    for name in sorted(os.listdir(results_dir)):
        if name.endswith(".json"):
            with open(os.path.join(results_dir, name)) as f:
                recs.append(json.load(f))
    return recs


def fmt_s(x: float) -> str:
    """Seconds with a unit: ``us``, ``ms`` or ``s``, 3 digits."""
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.3g}us"
    if x < 1:
        return f"{x*1e3:.3g}ms"
    return f"{x:.3g}s"


def modelled(rec: dict) -> Set[str]:
    """The fields of a composed cell (``analysis.scancost``) that are
    extrapolated from its short runs, a model and not a count -- those
    whose check failed -- as the terms and memory fields they feed: of
    ``t_compute``, ``t_memory``, ``t_collective``,
    ``argument_size_in_bytes`` and ``temp_size_in_bytes``."""
    check = rec.get("scan_correction", {}).get("detail", {}).get("check", {})
    out = set()
    for field, held in check.items():
        if held:
            continue
        if field == "flops":
            out.add("t_compute")
        elif field == "bytes":
            out.add("t_memory")
        elif field.startswith("coll/"):
            out.add("t_collective")
        elif field.startswith("memory/"):
            out.add(field.split("/", 1)[1])
    return out


def roofline_table(recs: List[dict], mesh: str = "single") -> str:
    """A markdown table of ``mesh``'s cells, by arch and shape; a term
    that is a model (:func:`modelled`) carries :data:`MODELLED`, and a
    line under the table says so."""
    rows = [r for r in recs if r["mesh"] == mesh]
    rows.sort(key=lambda r: (r["arch"], ORDER_SHAPES.index(r["shape"])))
    out = [
        "| arch | shape | t_comp | t_mem | t_coll | bound | useful | "
        "frac | GiB/dev (arg+tmp) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    marked = False
    for r in rows:
        if r["status"] == "skipped":
            out.append(
                f"| {r['arch']} | {r['shape']} | -- | -- | -- | "
                f"*skipped* | -- | -- | {r['reason'].split(';')[0]} |"
            )
            continue
        if r["status"] != "ok":
            out.append(
                f"| {r['arch']} | {r['shape']} | ERROR | | | | | | "
                f"{r.get('error','')[:60]} |"
            )
            continue
        rf = r["roofline"]
        ma = r["memory_analysis"]
        guess = modelled(r)
        marked |= bool(guess)

        def mark(field, text):
            return MODELLED + text if field in guess else text

        bound = next(t for t, b in _TERMS.items() if b == rf["bottleneck"])
        out.append(
            "| {arch} | {shape} | {tc} | {tm} | {tx} | {b} | {u:.2f} | "
            "{f:.2f} | {a}+{t} |".format(
                arch=r["arch"], shape=r["shape"],
                tc=mark("t_compute", fmt_s(rf["t_compute"])),
                tm=mark("t_memory", fmt_s(rf["t_memory"])),
                tx=mark("t_collective", fmt_s(rf["t_collective"])),
                b=mark(bound, rf["bottleneck"]),
                u=rf["useful_flops_ratio"], f=rf["roofline_fraction"],
                a=mark("argument_size_in_bytes",
                       f"{ma['argument_size_in_bytes'] / 2 ** 30:.1f}"),
                t=mark("temp_size_in_bytes",
                       f"{ma['temp_size_in_bytes'] / 2 ** 30:.1f}"),
            )
        )
    if marked:
        out.append(f"\n{MODELLED}: extrapolated from the cell's short runs "
                   "(`analysis.scancost`), a model, not a count")
    return "\n".join(out)


def dryrun_summary(recs: List[dict]) -> str:
    """Counts of ok, skipped and error cells, and each mesh's seconds."""
    ok = sum(r["status"] == "ok" for r in recs)
    sk = sum(r["status"] == "skipped" for r in recs)
    er = sum(r["status"] == "error" for r in recs)
    lines = [f"cells: {ok} compiled ok, {sk} ruled skips, {er} errors"]
    for mesh in ("single", "multipod"):
        rows = [r for r in recs if r["mesh"] == mesh and r["status"] == "ok"]
        if rows:
            ct = sum(r.get("compile_s", 0) for r in rows)
            lines.append(
                f"  {mesh}: {len(rows)} cells, total compile {ct:.0f}s"
            )
    return "\n".join(lines)


def main() -> None:
    """Print the summary and both meshes' tables of a results dir."""
    d = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch"
    recs = load(d)
    print(dryrun_summary(recs))
    print("\n## single-pod (16x16 = 256 chips)\n")
    print(roofline_table(recs, "single"))
    print("\n## multi-pod (2x16x16 = 512 chips)\n")
    print(roofline_table(recs, "multipod"))


if __name__ == "__main__":
    main()
