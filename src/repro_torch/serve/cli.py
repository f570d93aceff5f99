"""Command-line entry point for the serving layer::

    python -m repro_torch.serve prog.cfd --requests 32 --smoke [--device cpu]

Compiles the program through the :class:`~repro_torch.serve.cache.PlanCache`
(twice, to demonstrate a cache hit), stands up a
:class:`~repro_torch.serve.engine.ServeEngine`, submits synthetic requests of
mixed element counts, drains, and reports cache/coalescing/latency
stats.  ``--smoke`` additionally re-serves every request one at a time
through a second engine and fails loudly unless the coalesced outputs
are bitwise-identical to the per-request serial runs -- the CI gate.
``--device`` is where the waves run: the CUDA cards (``cuda``, the
default; each wave is sharded over every visible card, as the
reference's over ``jax.devices()``; exit 2 without one) or the host
(``cpu``, whose kernel stages run their plain PyTorch versions).
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from ..core.dsl import ParseError
from ..core.ir import IRError
from ..flow import build
from ..flow.cli import _parse_per_stage
from ..memory.channels import resolve_device
from ..runtime.monitor import RequestLatency
from .cache import PlanCache
from .engine import ServeEngine


def _parse_args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Long-running request service over a compiled "
        "CFDlang system: plan cache + admission coalescing + "
        "stage-pipelined dispatch.",
    )
    ap.add_argument("source", help="CFDlang program file")
    ap.add_argument("--target", default=None)
    ap.add_argument("--policy", default="float32")
    ap.add_argument("--element-vars", default="")
    ap.add_argument("--max-stages", type=int, default=None)
    ap.add_argument("--batch-elements", type=int, default=None)
    ap.add_argument("--prefetch-depth", default="1",
                    help="dispatch-ring depth per stage: one int or a "
                    "comma-separated per-stage vector")
    ap.add_argument("--cu-count", default="1",
                    help="CUs per stage: one int or a per-stage vector")
    ap.add_argument("--n-eq", type=int, default=None)
    ap.add_argument("--requests", type=int, default=32,
                    help="synthetic requests to serve (default 32)")
    ap.add_argument("--window", type=int, default=None,
                    help="in-flight wave window (default: derived from "
                    "the plan's prefetch depths)")
    ap.add_argument("--max-wait-s", type=float, default=None,
                    help="flush an undersized wave after this long")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the waves run and what a missing --target "
                    "detects: the CUDA card (default) or the host")
    ap.add_argument("--smoke", action="store_true",
                    help="verify coalesced outputs are bitwise-identical "
                    "to per-request serial runs (exit 1 on mismatch)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome-trace JSON of the served run")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="meter the run (repro_torch.metrics registry) and "
                    "write the snapshot JSON, SLO verdict included "
                    "(validate with python -m repro_torch.metrics --check)")
    ap.add_argument("--slo-p95-s", type=float, default=5.0,
                    help="SLO: target p95 request latency in seconds "
                    "(default 5.0; used with --metrics)")
    ap.add_argument("--slo-error-rate", type=float, default=0.01,
                    help="SLO: request error-rate budget (default 0.01)")
    return ap.parse_args(argv)


def _synth_requests(engine: ServeEngine, n: int, seed: int):
    """Mixed-size synthetic requests: a spread of 1..~1.5E element
    counts so waves coalesce small requests AND split large ones."""
    rng = np.random.default_rng(seed + 17)
    E = engine.batch_elements
    hi = max(2, E + E // 2 + 1)
    reqs = []
    for _ in range(n):
        k = int(rng.integers(1, hi))
        reqs.append({
            q: rng.uniform(-1, 1, (k,) + shape).astype(np.float32)
            for q, shape in sorted(engine.in_specs.items())
        })
    return reqs


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse_args(argv)
    try:
        with open(args.source) as f:
            source = f.read()
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    prog_name = args.source.rsplit("/", 1)[-1]
    if prog_name.endswith(".cfd"):
        prog_name = prog_name[:-4]
    if args.requests < 1:
        print("error: --requests must be >= 1", file=sys.stderr)
        return 2

    element_vars = tuple(
        v.strip() for v in args.element_vars.split(",") if v.strip()
    )
    try:
        cu_count = _parse_per_stage(args.cu_count, "--cu-count")
        prefetch_depth = _parse_per_stage(
            args.prefetch_depth, "--prefetch-depth"
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.device == "cuda":
        try:
            resolve_device("cuda")
        except RuntimeError as e:
            print(f"error: {e} (--device cpu)", file=sys.stderr)
            return 2

    tracer = None
    if args.trace:
        from .. import trace as trace_mod

        tracer = trace_mod.Tracer()

    metrics = slo = None
    if args.metrics:
        from .. import metrics as metrics_mod

        metrics = metrics_mod.MetricsRegistry()
        slo = metrics_mod.SLOTracker(
            args.slo_p95_s, args.slo_error_rate, registry=metrics
        )

    cache = PlanCache(tracer=tracer, metrics=metrics)
    kwargs = dict(
        name=prog_name,
        element_vars=element_vars,
        target=args.target,
        policy=args.policy,
        max_stages=args.max_stages,
        batch_elements=args.batch_elements,
        prefetch_depth=prefetch_depth,
        cu_count=cu_count,
        n_eq=args.n_eq,
        device=args.device,
    )
    if args.n_eq is None and args.batch_elements is None:
        # the planner's auto-sized E fills the target's HBM channels --
        # right for batch jobs, absurd as one serving wave; size the
        # batch to the offered load instead
        kwargs["n_eq"] = max(64, 2 * args.requests)
    try:
        system = cache.get_or_compile(source, **kwargs)
        # a serving process sees the same program again and again; the
        # repeat compile must come from the cache (hit rate > 0)
        again = cache.get_or_compile(source, **kwargs)
    except (ParseError, build.FlowError, IRError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if again is not system:
        print("error: plan cache returned a different system for an "
              "identical compile call", file=sys.stderr)
        return 1
    print(system.plan.report())
    print()
    print(
        f"plan_cache: hits={cache.hits} misses={cache.misses} "
        f"hit_rate={cache.hit_rate:.2f}"
    )

    latency = RequestLatency()
    # the pool: every visible card, or one host slot
    pool_device = "cpu" if args.device == "cpu" else None
    engine = ServeEngine(
        system, window=args.window, max_wait_s=args.max_wait_s,
        tracer=tracer, latency=latency, seed=args.seed,
        metrics=metrics, slo=slo, device=pool_device,
    )
    request_inputs = _synth_requests(engine, args.requests, args.seed)
    served = [engine.submit(inp) for inp in request_inputs]
    engine.drain()
    failed = [r for r in served if r.error is not None]
    if failed:
        for r in failed:
            print(f"error: request r{r.rid} failed: {r.error!r}",
                  file=sys.stderr)
        return 1
    st = engine.stats
    lat = latency.summary()
    print(
        f"served {st['completed']} requests in {st['waves']} waves of "
        f"{engine.batch_elements} elements (wave pad {st['pad_elements']} "
        f"elem, plan pad {st['plan_pad_elements']} elem, "
        f"{st['ticks']} ticks)"
    )
    print(
        f"latency: mean {lat['mean_s'] * 1e3:.3f} ms   "
        f"p95 {lat['p95_s'] * 1e3:.3f} ms   "
        f"max {lat['max_s'] * 1e3:.3f} ms"
    )
    if slo is not None:
        v = slo.verdict()
        print(
            f"slo: verdict={v['verdict']} "
            f"p95 {v['p95_s'] * 1e3:.3f} ms "
            f"(target {v['target_p95_s'] * 1e3:.0f} ms)   "
            f"latency_burn {v['latency_burn']:.2f}   "
            f"error_burn {v['error_burn']:.2f}"
        )

    ok = True
    if args.smoke:
        serial = ServeEngine(system, seed=args.seed, device=pool_device)
        mismatches = 0
        for r, inp in zip(served, request_inputs):
            ref = serial.submit(inp)
            serial.drain()
            if ref.error is not None:
                print(f"error: serial r{r.rid} failed: {ref.error!r}",
                      file=sys.stderr)
                mismatches += 1
                continue
            for q in engine.out_names:
                if not np.array_equal(r.outputs[q], ref.outputs[q]):
                    print(
                        f"error: r{r.rid} output {q} differs from the "
                        "per-request serial run", file=sys.stderr,
                    )
                    mismatches += 1
        ok = mismatches == 0 and cache.hit_rate > 0
        verdict = "ok" if ok else f"FAILED ({mismatches} mismatches)"
        print(
            f"serve-smoke: {len(served)} coalesced requests vs serial "
            f"-> bitwise {verdict}"
        )

    if tracer is not None:
        from .. import trace as trace_mod

        trace_mod.write_chrome(
            tracer, args.trace, metadata={"source": prog_name}
        )
        print(f"trace written to {args.trace}")
    if metrics is not None:
        from ..metrics import write_snapshot

        snap = write_snapshot(
            metrics, args.metrics, extra={"slo": slo.verdict()}
        )
        print(
            f"metrics written to {args.metrics} "
            f"({len(snap['metrics'])} series)"
        )
    return 0 if ok else 1
