"""Quickstart on the PyTorch + CUDA port: the paper's headline flow in
~40 lines.

CFDlang source -> pipeline (parse -> factorize -> schedule -> emit) ->
batched executable, validated against the Eq. (1) oracle.  Runs on the
CUDA card by default; ``--device cpu`` runs the plain PyTorch paths on
the host.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.cfd import reference  # noqa: E402
from repro_torch.core import api, dsl, rewrite, schedule  # noqa: E402
from repro_torch.flow import patterns  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
ap.add_argument("--backend", default="pallas",
                help="xla | staged | pallas (the CUDA kernel)")
args = ap.parse_args()

P = 11
SRC = dsl.INVERSE_HELMHOLTZ_SRC.format(p=P)

print("--- CFDlang source (paper Fig. 2) ---")
print(SRC)

# 1. parse + middle-end: the factorization rewrite takes the literal
#    O(p^6) contraction to the paper's (12p+1)p^3 GEMM chain.
prog = dsl.parse(SRC, element_vars=("u", "D", "v"))
opt = rewrite.optimize(prog)
print(f"literal flops/element:    {prog.total_flops():>12,}")
print(f"factorized flops/element: {opt.total_flops():>12,}"
      f"   (paper model: {(12 * P + 1) * P ** 3:,})")

# 2. operator scheduling: the dataflow groups of paper section 3.4.3
sch = schedule.schedule(opt, bytes_per_scalar=4)
print("\n--- dataflow schedule ---")
print(sch.summary())

# 3. compile + run a batch of elements on the device; 'pallas' dispatches
#    the program to the CUDA kernel its structure matches
impl = patterns.pallas_impl_for(opt) if args.backend == "pallas" else None
compiled = api.compile_cfdlang(SRC, element_vars=("u", "D", "v"),
                               backend=args.backend, pallas_impl=impl,
                               device=args.device)
rng = np.random.default_rng(0)
E = 64
S = rng.uniform(-1, 1, (P, P)).astype(np.float32)
D = rng.uniform(-1, 1, (E, P, P, P)).astype(np.float32)
u = rng.uniform(-1, 1, (E, P, P, P)).astype(np.float32)
v = compiled(S=S, D=D, u=u)["v"].cpu().numpy()

want = reference.inverse_helmholtz_batch(
    S.astype(np.float64), D.astype(np.float64), u.astype(np.float64)
)
print(f"\nbatched run ({args.backend} on {args.device}): v{v.shape}, "
      f"max |err| vs Eq.(1) oracle: {np.abs(v - want).max():.2e}")
