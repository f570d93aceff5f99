"""Digests of the flash-attention kernels' outputs at fixed inputs, to
compare two source trees bit for bit on one CUDA card.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/flash_digest.py [SRC_DIR]

``SRC_DIR`` (default: this tree's ``src``) holds the ``repro_torch`` to
load; its kernels build into that tree's ``build/``.  Prints one line
per case -- name, route, sha256 of the output's bytes -- so two trees'
outputs are bitwise equal exactly when their lines are:

    python tools/flash_digest.py checkout/parent/src > a.txt
    python tools/flash_digest.py > b.txt && diff a.txt b.txt
"""
from __future__ import annotations

import hashlib
import pathlib
import sys

#: (name, batch, query heads, KV heads, Tq, Tk, head dim, causal, dtype):
#: both routes, GQA, Tq < Tk, ragged tiles, non-causal
CASES = (
    ("wgmma causal", 2, 16, 8, 1024, 1024, 128, True, "bfloat16"),
    ("wgmma d64 Tq<Tk", 2, 6, 6, 192, 448, 64, True, "bfloat16"),
    ("wgmma non-causal ragged", 2, 6, 6, 300, 300, 64, False, "bfloat16"),
    ("fma f32 causal", 2, 4, 2, 256, 256, 16, True, "float32"),
    ("fma f32 d128 Tq<Tk", 1, 8, 2, 96, 160, 128, True, "float32"),
    ("fma bf16 d32", 2, 4, 1, 200, 200, 32, True, "bfloat16"),
)


def main() -> int:
    """Print each case's digest; returns the exit code."""
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, sys.argv[1] if len(sys.argv) > 1 else str(root / "src"))
    import torch

    from repro_torch.kernels.attention import attention, ref

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for name, B, Hq, Hkv, Tq, Tk, d, causal, dtype in CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(n, T, d, generator=gen, device=dev).to(dt)
                   for n, T in ((B * Hq, Tq), (B * Hkv, Tk), (B * Hkv, Tk)))
        out = attention.flash_attention(q, k, v, n_q_heads=Hq,
                                        n_kv_heads=Hkv, causal=causal)
        bits = out.contiguous().view(torch.int16 if dt == torch.bfloat16
                                     else torch.int32)
        digest = hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()
        print(f"{name} [{ref.route(dt, d)}] {digest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
