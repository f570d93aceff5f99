"""Digests of the flash-attention kernels' outputs at fixed inputs, to
compare two source trees bit for bit on one CUDA card.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/flash_digest.py [SRC_DIR]

``SRC_DIR`` (default: this tree's ``src``) holds the ``repro_torch`` to
load; its kernels build into that tree's ``build/``.  Prints one line
per case -- name, route, sha256 of the output's bytes (the forward's
``o``; the backward's ``dq``, ``dk`` and ``dv`` from the forward kernel's
``o`` and ``lse``) -- so two trees' outputs are bitwise equal exactly
when their lines are.  A backward line names the route its kernel
launched on (a tree without ``launches_by_route`` on the backward has
only the CUDA-core kernel, ``fma``):

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
#: the backward's cases, in the same fields: both routes, GQA, Tq < Tk,
#: ragged tiles, non-causal
BWD_CASES = (
    ("bwd wgmma d128 GQA", 2, 16, 8, 512, 512, 128, True, "bfloat16"),
    ("bwd wgmma d64 Tq<Tk ragged", 2, 6, 6, 200, 456, 64, True, "bfloat16"),
    ("bwd wgmma d64 non-causal", 2, 3, 3, 160, 224, 64, False, "bfloat16"),
    ("bwd fma f32 causal", 2, 4, 2, 256, 256, 16, True, "float32"),
    ("bwd fma f32 d128 Tq<Tk", 1, 8, 2, 96, 160, 128, True, "float32"),
    ("bwd fma f32 d64 non-causal", 2, 2, 2, 136, 136, 64, False, "float32"),
    ("bwd fma bf16 d32", 2, 4, 1, 200, 200, 32, True, "bfloat16"),
)


def _digest(*tensors) -> str:
    """sha256 of the tensors' bytes, one after another."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        bits = t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                                   else torch.int32)
        h.update(bits.cpu().numpy().tobytes())
    return h.hexdigest()


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
        print(f"{name} [{ref.route(dt, d)}] {_digest(out)}")
    bwd = attention.flash_attention_bwd
    for name, B, Hq, Hkv, Tq, Tk, d, causal, dtype in BWD_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev).manual_seed(1)
        q, k, v, do = (torch.randn(n, T, d, generator=gen, device=dev).to(dt)
                       for n, T in ((B * Hq, Tq), (B * Hkv, Tk),
                                    (B * Hkv, Tk), (B * Hq, Tq)))
        kw = dict(n_q_heads=Hq, n_kv_heads=Hkv, causal=causal)
        o, lse = attention._forward_kernel(q, k, v, scale=d ** -0.5,
                                           block_q=512, block_k=512,
                                           with_lse=True, **kw)
        before = dict(getattr(bwd, "launches_by_route", {}))
        grads = bwd(q, k, v, o, lse, do, **kw)
        after = getattr(bwd, "launches_by_route", {})
        launched = [r for r in after if after[r] != before.get(r)] or ["fma"]
        print(f"{name} [{launched[0]}] {_digest(*grads)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
