"""Command-line entry point for the tool flow::

    python -m repro_torch.flow prog.cfd --target h100-sxm --dse

Reads a CFDlang source file, compiles it end-to-end (parse -> rewrite ->
schedule -> chain -> plan), and prints the generated-architecture report.
``--run`` additionally executes a smoke run of the planned system on
synthetic data through the chain pipeline driver.  ``--device`` names
where runs and measurements execute and which datasheet a missing
``--target`` detects: the CUDA card (``cuda``, the default) or the host
(``cpu``, whose kernel stages run their plain PyTorch versions).  With
``cuda`` a ``--run`` executes over every visible card, as the
reference's over ``jax.devices()``: a ``--devices`` / ``--cu-count``
plan runs as placed where there are enough cards, and on one group over
them otherwise.

``--tune-blocks`` times each kernel stage at its candidate blocks on
``--device`` (on the H100 datasheet, the CUDA kernel's legal tiles) and
runs it at the fastest; the report lists every candidate's time.
``--trace OUT.json`` runs the system traced, writes the Chrome trace and
prints the ``measured:`` attribution (on the card the stage spans carry
the device's own times); ``--profile [PATH]`` records that trace, the
tuner's winners or the DSE's measurements into the profile store (and
warm-starts ``--dse`` from it); ``--metrics OUT.json`` meters the run and
writes the snapshot.  An output path whose directory does not exist
exits 2 before anything runs.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from ..core.dsl import ParseError
from ..core.ir import IRError
from ..memory.channels import resolve_device
from . import build


def _parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.flow",
        description="CFDlang source -> planned, executable memory "
        "architecture (the paper's automated tool flow).",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=(
            "per-stage vectors:\n"
            "  --cu-count and --prefetch-depth accept one int for the\n"
            "  whole chain or a comma-separated per-stage vector, e.g.\n"
            "  '--cu-count 1,2,1' gives the middle stage two CUs and\n"
            "  '--prefetch-depth 2,1,1' runs stage 0 two host batches\n"
            "  ahead. Vector length must match the planned stage count\n"
            "  (after --fuse auto merges, one entry per ORIGINAL stage;\n"
            "  merged stages take the max of their members).\n"
            "\n"
            "the reference package's CLI tour (repro.flow takes the\n"
            "same flags): docs/CLI.md\n"
        ),
    )
    ap.add_argument("source", help="CFDlang program file ('-' for stdin)")
    ap.add_argument("--target", default=None,
                    help="memory datasheet (h100-sxm, alveo-u280, tpu-v5e, "
                    "cpu-host; default: detect on --device)")
    ap.add_argument("--policy", default="float32")
    ap.add_argument("--backend", default="xla",
                    help="stage backend: xla | staged | pallas "
                    "(pallas: the hand-written CUDA kernels; falls back to "
                    "xla when no kernel matches)")
    ap.add_argument("--backends", default=None,
                    help="comma-separated per-stage backends")
    ap.add_argument("--element-vars", default="",
                    help="comma-separated element vars (for sources "
                    "without 'elem' markers)")
    ap.add_argument("--max-stages", type=int, default=None,
                    help="collapse the schedule to at most this many "
                    "stages (paper's 1/2/3/7-module sweeps)")
    ap.add_argument("--fuse", choices=("auto", "off"), default=None,
                    help="'auto' makes the stage count a design axis: "
                    "adjacent stages merge whenever the planner prices "
                    "their HBM handoff above the fused roofline "
                    "(explicit cuts are never merged across)")
    ap.add_argument("--tune-blocks", action="store_true",
                    help="measure candidate block sizes per kernel stage "
                    "on --device and run each at the fastest")
    ap.add_argument("--batch-elements", type=int, default=None,
                    help="override E (default: planner auto-sizes + pads)")
    ap.add_argument("--prefetch-depth", default="1",
                    help="dispatch-ring depth per stage: one int "
                    "(chain-wide) or a comma-separated per-stage vector")
    ap.add_argument("--cu-count", default="1",
                    help="CUs per stage: one int (chain-wide) or a "
                    "comma-separated per-stage vector")
    ap.add_argument("--devices", default=None,
                    help="device topology the stage CU groups are "
                    "placed on: a size like '4', a heterogeneous spec "
                    "like 'cpu:2,tpu:4' (each group priced against its "
                    "own datasheet), or 0 to detect the local CUDA "
                    "device pool (default: just enough for the widest "
                    "stage)")
    ap.add_argument("--n-eq", type=int, default=None)
    ap.add_argument("--dse", action="store_true",
                    help="sweep chain design points, adopt the best "
                    "feasible plan, and print the ranking")
    ap.add_argument("--run", action="store_true",
                    help="execute a smoke run on synthetic data")
    ap.add_argument("--max-batches", type=int, default=2,
                    help="batches for --run (default 2)")
    ap.add_argument("--serial-stages", action="store_true",
                    help="force the back-to-back stage schedule for "
                    "--run (the paper's baseline; default: the plan's "
                    "pipeline mode)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where --run and --dse measurements execute, and "
                    "what a missing --target detects: the CUDA card "
                    "(default) or the host, whose kernel stages run their "
                    "plain PyTorch versions")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="trace the executed run and write Chrome-trace "
                    "JSON viewable in Perfetto (implies --run); also "
                    "prints the measured: pred-vs-measured attribution "
                    "(stage spans in the card's own times on --device "
                    "cuda)")
    ap.add_argument("--profile", default=None, nargs="?", const="",
                    metavar="PATH",
                    help="persistent profile store (default path, or "
                    "$REPRO_TORCH_PROFILE, when PATH is omitted): with "
                    "--trace, record the traced run into it; with "
                    "--dse, warm-start the ranking from it; with "
                    "--tune-blocks, record the winners; requires at "
                    "least one of the three")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="meter the executed run (repro_torch.metrics) "
                    "and write the snapshot JSON (implies --run; "
                    "validate with python -m repro_torch.metrics)")
    return ap.parse_args(argv)


def _parse_devices(raw):
    """``None`` -> None; ``"4"`` -> 4; ``"cpu:2,tpu:4"`` passes through
    as a heterogeneous topology spec for ``build.compile`` to parse."""
    if raw is None:
        return None
    raw = str(raw).strip()
    try:
        return int(raw)
    except ValueError:
        return raw


def _parse_per_stage(raw, flag: str):
    """``"2"`` -> 2; ``"2,1,1"`` -> [2, 1, 1]; junk -> ValueError naming
    the flag (both --cu-count and --prefetch-depth accept either)."""
    try:
        parts = [c.strip() for c in str(raw).split(",")]
        return (int(parts[0]) if len(parts) == 1
                else [int(c) for c in parts])
    except ValueError:
        raise ValueError(f"bad {flag} {raw!r}") from None


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI driver: compile/plan, then --dse/--run/--trace/--metrics as
    requested.  Exit 0 ok, 2 usage error; a failure while running
    propagates."""
    args = _parse_args(argv)
    try:
        if args.source == "-":
            source = sys.stdin.read()
            prog_name = "stdin"
        else:
            with open(args.source) as f:
                source = f.read()
            prog_name = args.source.rsplit("/", 1)[-1]
            if prog_name.endswith(".cfd"):
                prog_name = prog_name[:-4]
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    element_vars = tuple(
        v.strip() for v in args.element_vars.split(",") if v.strip()
    )
    backends = None
    if args.backends:
        backends = tuple(b.strip() for b in args.backends.split(","))
    try:
        cu_count = _parse_per_stage(args.cu_count, "--cu-count")
        prefetch_depth = _parse_per_stage(
            args.prefetch_depth, "--prefetch-depth"
        )
        devices = _parse_devices(args.devices)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if (args.profile is not None and not args.trace and not args.dse
            and not args.tune_blocks):
        # a silently inert flag is worse than an error: recording needs a
        # traced run, warm-starting needs a DSE sweep or a block tune
        print(
            "error: --profile does nothing without --trace (record the "
            "run), --dse (warm-start the ranking), or --tune-blocks "
            "(record the winners)",
            file=sys.stderr,
        )
        return 2
    for flag, path in (("--trace", args.trace), ("--metrics", args.metrics)):
        if path and not os.path.isdir(os.path.dirname(os.path.abspath(path))):
            print(f"error: {flag} {path}: no such directory",
                  file=sys.stderr)
            return 2
    profile = (args.profile or True) if args.profile is not None else None
    run = args.run or args.trace or args.metrics
    if args.device == "cuda" and (args.target is None or run
                                  or args.tune_blocks):
        try:
            resolve_device("cuda")
        except RuntimeError as e:
            print(f"error: {e} (--device cpu)", file=sys.stderr)
            return 2
    try:
        system = build.compile(
            source,
            name=prog_name,
            element_vars=element_vars,
            target=args.target,
            policy=args.policy,
            backend=args.backend,
            backends=backends,
            max_stages=args.max_stages,
            batch_elements=args.batch_elements,
            prefetch_depth=prefetch_depth,
            cu_count=cu_count,
            devices=devices,
            n_eq=args.n_eq,
            dse=args.dse,
            fuse=args.fuse,
            tune_blocks=args.tune_blocks,
            profile=(
                profile if (args.dse or args.tune_blocks) else None
            ),
            device=args.device,
        )
    except (ParseError, build.FlowError, IRError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    print(system.report())
    if args.dse and system.candidates is not None:
        from ..memory.dse import format_chain_ranking

        print()
        print("dse ranking (top 10):")
        print(format_chain_ranking(system.candidates, limit=10))
    if run:
        tracer = None
        if args.trace:
            from .. import trace as trace_mod

            tracer = trace_mod.Tracer()
        metrics = None
        if args.metrics:
            from .. import metrics as metrics_mod

            metrics = metrics_mod.MetricsRegistry()
        # the pool: every visible card (a --devices / --cu-count plan
        # runs as placed where they are enough), or one host slot
        res = system.run(
            max_batches=args.max_batches,
            pipeline_stages=False if args.serial_stages else None,
            device="cpu" if args.device == "cpu" else None,
            tracer=tracer,
            metrics=metrics,
        )
        print()
        print(
            f"ran {res.batches} batches x {res.plan.batch_elements} "
            f"elements in {res.wall_s:.3f}s "
            f"({'stage-pipelined' if res.pipelined_stages else 'serial'} "
            "schedule)"
        )
        for q, v in sorted(res.checksums.items()):
            print(f"  checksum {q} = {v:.6g}")
        if tracer is not None:
            trace_mod.write_chrome(
                tracer, args.trace, metadata={"source": prog_name}
            )
            print()
            print(
                f"trace written to {args.trace} "
                "(load in Perfetto / chrome://tracing)"
            )
            print()
            print(trace_mod.attribution_report(tracer, system.plan))
            if args.profile is not None:
                store = trace_mod.ProfileStore(
                    path=args.profile or None).for_device(args.device)
                got = store.record_trace(tracer, system.plan)
                print()
                print(
                    f"profile: recorded {got} samples -> {store.path}"
                )
        if metrics is not None:
            from ..metrics import write_snapshot

            snap = write_snapshot(metrics, args.metrics)
            print()
            print(
                f"metrics written to {args.metrics} "
                f"({len(snap['metrics'])} series)"
            )
    return 0
