"""End-to-end CFD driver on the PyTorch + CUDA port (``repro_torch.flow``):
a CFDlang source file goes in, a planned memory architecture plus a
pipelined execution on the CUDA card comes out.  The default program is
the paper's full application (``examples/cfd_pipeline.cfd``:
interpolation -> gradient -> inverse Helmholtz); point --program at any
``.cfd`` file (``examples/inverse_helmholtz.cfd`` is the single-operator
path).  ``--device cpu`` runs on the host, kernel stages through their
plain PyTorch versions.  The plan uses one CU a stage: element sharding
across cards is not ported yet.

Run:  PYTHONPATH=src python examples/cfd_simulation_torch.py --n-eq 4096 --show-plan
"""
import argparse
import os
import sys

sys.path.insert(0, "src")

from repro_torch import flow  # noqa: E402
from repro_torch.cfd import reference  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--program",
                    default=os.path.join(_HERE, "cfd_pipeline.cfd"),
                    help="CFDlang source file to compile and run")
    ap.add_argument("--n-eq", type=int, default=4096)
    ap.add_argument("--batch-elements", type=int, default=0,
                    help="override E (0 = let the memory planner size it)")
    ap.add_argument("--prefetch-depth", type=int, default=1,
                    help="K batches staged ahead (0 = serial baseline); "
                    "K>0 also turns on cross-batch stage pipelining")
    ap.add_argument("--serial-stages", action="store_true",
                    help="force the back-to-back stage schedule "
                    "(bitwise-equal; isolates the pipelining win)")
    ap.add_argument("--policy", default="float32")
    ap.add_argument("--backend", default="pallas",
                    help="per-stage backend: xla | staged | pallas (the "
                    "CUDA kernels)")
    ap.add_argument("--max-stages", type=int, default=None)
    ap.add_argument("--fuse", choices=("auto", "off"), default=None,
                    help="'auto' merges stages whose handoff the cost "
                    "model prices above their combined roofline")
    ap.add_argument("--dse", action="store_true",
                    help="sweep chain design points, run the winner")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--show-plan", action="store_true",
                    help="print the full system report before running")
    args = ap.parse_args()

    with open(args.program) as f:
        source = f.read()
    system = flow.compile(
        source,
        name=os.path.basename(args.program).removesuffix(".cfd"),
        policy=args.policy,
        backend=args.backend,
        max_stages=args.max_stages,
        batch_elements=args.batch_elements or None,
        prefetch_depth=args.prefetch_depth,
        n_eq=args.n_eq,
        dse=args.dse,
        fuse=args.fuse,
        device=args.device,
    )
    if args.show_plan:
        print(system.report())
        print()
    plan = system.plan
    print(f"simulating {args.n_eq:,} elements through "
          f"{len(system.stage_names)} stages "
          f"({'->'.join(system.stage_names)}, {','.join(system.backends)}) "
          f"in {plan.batches_for(args.n_eq)} batches of "
          f"{plan.batch_elements} on {args.device}")
    res = system.run(
        n_eq=args.n_eq,
        pipeline_stages=False if args.serial_stages else None,
        device=args.device,
    )
    flops = res.elements * sum(
        s.program.total_flops() for s in system.chain.stages
    )
    print(f"wall: {res.wall_s:.3f}s  "
          f"({'stage-pipelined' if res.pipelined_stages else 'serial'} "
          "schedule)")
    for q, v in sorted(res.checksums.items()):
        print(f"  checksum {q} = {v:.4f}")
    print(f"GFLOPS (paper Eq. 2 accounting): "
          f"{flops / res.wall_s / 1e9 if res.wall_s else 0.0:.3f}")
    # context: the p=11 single-operator count the paper reports
    print(f"(paper flops/element at p=11: "
          f"{reference.paper_flops_per_element(11)})")


if __name__ == "__main__":
    main()
