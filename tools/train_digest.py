"""Digests of the training path's results at fixed inputs, to compare two
source trees bit for bit on one CUDA card.

Usage (from the repository root, on a machine with a CUDA card)::

    python tools/train_digest.py [SRC_DIR] [--moe | --recurrent]

``SRC_DIR`` (default: this tree's ``src``) holds the ``repro_torch`` to
load; its kernels build into that tree's ``build/``.  Prints one line per
result -- name, then the float32 bits of a loss or gradient norm, or the
sha256 of a state's bytes -- so two trees' results are bitwise equal
exactly when their lines are:

* internlm2-1.8b at its published widths (bfloat16 params, remat
  ``block``, the flash kernels), ``STEPS`` AdamW steps of a 4 x 4,096
  batch from the seeded token stream (``chip_smoke.py`` phase T's
  step): each step's loss and gradient norm, and the state after them;
* the smoke internlm2 (float32): 3 steps, a checkpoint, 2 more; the
  checkpoint restored and the same 2 steps again (phase T's resume):
  the losses and the resumed state.

With ``--moe``, the MoE path's forwards instead: olmoe-1b-7b at its
published widths (bfloat16, seed 0, attention ``xla``: the MoE blocks
are what is compared, not the kernels), a scoring forward of a 4 x 512
batch at the capacity of its tokens (``chip_smoke.py`` phase E's rule),
a prefill of 4 x 128 tokens and 8 greedy decode steps, and
``moe_apply`` of one block on seeded input at the default capacity
with its kept (token, expert) assignments.  Only forwards: a backward's
scatter-add sums by atomics on the card, in no fixed order.

With ``--recurrent``, the step loops' results instead (``models.ssm``):
xlstm-125m at its published widths (bfloat16, seed 0) scoring a 4 x
1,024 batch through the exact scan and through ``MLSTM_CHUNK = 64``, a
prefill of 4 x 128 tokens and 8 greedy decode steps, and the loss and
every gradient of a 2 x 256 batch through the exact scan; and the smoke
jamba (float32): its forward, and ``mamba_apply`` of its first Mamba
layer with the gradients of x and of every param.  (The chunked scan's
gradient scatters its running max's by atomics on the card.)

Lines starting ``#`` are times, not digests: the published-width run's
``TIMED`` further steps, each in seconds (wall clock from a synchronized
card to the loss on the host, as phase T times them) with the peak
memory, and the loss alone (``runtime.losses.cross_entropy``, forward
and backward) on phase T's (4, 4,096, V) float32 logits, in ms (CUDA
events, the median of ``LOSS_REPS``).  Compare the digests without them:

    python tools/train_digest.py checkout/parent/src > a.txt
    python tools/train_digest.py > b.txt
    diff <(grep -v '^#' a.txt) <(grep -v '^#' b.txt)
"""
from __future__ import annotations

import hashlib
import pathlib
import sys
import tempfile
import time

#: the published-width run's steps, batch and length
STEPS, BATCH, LEN = 3, 4, 4096
#: the steps timed after them, and the loss's timed repetitions
TIMED, LOSS_REPS = 6, 10
#: ``--moe``: the scoring batch, the prompt and the decode steps
MOE_SCORE, MOE_PROMPT, MOE_STEPS = (4, 512), (4, 128), 8
#: ``--recurrent``: the scoring batch, the chunk, the prompt and decode
#: steps, and the batch whose gradients are digested
REC_SCORE, REC_CHUNK, REC_PROMPT, REC_STEPS = (4, 1024), 64, (4, 128), 8
REC_GRAD = (2, 256)


def _bits(x) -> str:
    """A 0-d float32 tensor's bits, as hex."""
    import struct

    return struct.pack("<f", float(x)).hex()


def _digest(state) -> str:
    """sha256 of every leaf of ``state``'s bytes, in tree order."""
    import torch

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(state):
        t = t.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _loss_ms(vocab: int) -> float:
    """The median ms of the loss's forward and backward on seeded
    (BATCH, LEN, vocab) float32 logits."""
    import torch

    from repro_torch.runtime.losses import cross_entropy

    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn(BATCH, LEN, vocab, device="cuda", generator=gen)
    logits.requires_grad_(True)
    labels = torch.randint(0, vocab, (BATCH, LEN), device="cuda",
                           generator=gen)
    ms = []
    for i in range(LOSS_REPS + 2):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(cross_entropy(logits, labels), logits)
        stop.record()
        torch.cuda.synchronize()
        if i >= 2:                        # two warm-up calls
            ms.append(start.elapsed_time(stop))
    return sorted(ms)[len(ms) // 2]


def _moe(dev) -> None:
    """Print the ``--moe`` digests."""
    import torch

    from repro_torch import configs
    from repro_torch.models import build_model, moe

    cfg = configs.get("olmoe-1b-7b")
    model = build_model(cfg, attn_impl="xla")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, MOE_SCORE, device=dev, generator=gen)
    with torch.no_grad():
        t = time.perf_counter()
        logits = model.forward(params, {"tokens": tokens},
                               moe_capacity=tokens.numel())
        torch.cuda.synchronize()
        print(f"olmoe-1b-7b forward {MOE_SCORE} {_digest([logits])}")
        print(f"# forward {time.perf_counter() - t:.4f} s")
        B, P = MOE_PROMPT
        cache = model.init_cache(B, P + MOE_STEPS)
        out, cache = model.prefill(params, {"tokens": tokens[:B, :P]}, cache,
                                   moe_capacity=B * P)
        outs = [out]
        for i in range(MOE_STEPS):
            out, cache = model.decode_step(params, out.argmax(-1), cache,
                                           P + i)
            outs.append(out)
        print(f"olmoe-1b-7b prefill {MOE_PROMPT} and {MOE_STEPS} decode "
              f"steps {_digest(outs + [cache['k'], cache['v']])}")
        blk = {k: v[0] for k, v in params["blocks"]["moe"].items()
               if not isinstance(v, dict)}
        blk["router"] = {k: v[0] for k, v in
                         params["blocks"]["moe"]["router"].items()}
        x = torch.randn(*MOE_SCORE, cfg.d_model, device=dev, generator=gen,
                        dtype=torch.bfloat16)
        y = moe.moe_apply(blk, x, cfg)
        *_, keep, _, _, _ = moe._route(blk, x.reshape(1, -1, cfg.d_model),
                                       cfg, None)
        print(f"olmoe-1b-7b moe_apply {tuple(x.shape)} {_digest([y])} kept "
              f"{int(keep.sum())}")


def _recurrent(dev) -> None:
    """Print the ``--recurrent`` digests."""
    import torch

    from repro_torch import configs
    from repro_torch.models import build_model, ssm
    from repro_torch.runtime.losses import cross_entropy
    from repro_torch.tree import tree_leaves

    cfg = configs.get("xlstm-125m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, REC_SCORE, device=dev, generator=gen)
    with torch.no_grad():
        for chunk in (None, REC_CHUNK):
            ssm.MLSTM_CHUNK = chunk
            t = time.perf_counter()
            logits = model.forward(params, {"tokens": tokens})
            torch.cuda.synchronize()
            print(f"xlstm-125m forward {REC_SCORE} chunk {chunk} "
                  f"{_digest([logits])}")
            print(f"# forward chunk {chunk} {time.perf_counter() - t:.4f} s")
        ssm.MLSTM_CHUNK = None
        B, P = REC_PROMPT
        cache = model.init_cache(B, P + REC_STEPS)
        out, cache = model.prefill(params, {"tokens": tokens[:B, :P]}, cache)
        outs = [out]
        for i in range(REC_STEPS):
            out, cache = model.decode_step(params, out.argmax(-1), cache,
                                           P + i)
            outs.append(out)
        print(f"xlstm-125m prefill {REC_PROMPT} and {REC_STEPS} decode steps "
              f"{_digest(outs + [cache])}")
    B, T = REC_GRAD
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    batch = tokens[:B, :T + 1]
    loss = cross_entropy(model.forward(params, {"tokens": batch[:, :-1]}),
                         batch[:, 1:])
    grads = torch.autograd.grad(loss, leaves)
    print(f"xlstm-125m loss {REC_GRAD} {_bits(loss.detach())} gradients "
          f"{_digest(list(grads))}")
    del params, grads, leaves

    cfg = configs.get_smoke("jamba-1.5-large-398b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=dev, generator=gen)
    with torch.no_grad():
        print(f"jamba smoke forward (2, 64) "
              f"{_digest([model.forward(params, {'tokens': tokens})])}")
    p = _first_layer(params["periods"]["sub0"]["mamba"])
    x = torch.randn(2, 64, cfg.d_model, device=dev, generator=gen)
    leaves = [x] + tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_(True)
    y, _ = ssm.mamba_apply(p, x, cfg)
    grads = torch.autograd.grad(y.square().sum(), leaves)
    print(f"jamba smoke mamba_apply (2, 64) {_digest([y])} gradients "
          f"{_digest(list(grads))}")


def _first_layer(tree):
    """The first period's layer of a stacked (period, ...) params tree,
    a copy."""
    if isinstance(tree, dict):
        return {k: _first_layer(v) for k, v in tree.items()}
    return tree[0].detach().clone()


def main() -> int:
    """Print each result's digest; returns the exit code."""
    root = pathlib.Path(__file__).resolve().parents[1]
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    sys.path.insert(0, args[0] if args else str(root / "src"))
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.train import init_train_state, make_train_step

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if "--moe" in sys.argv[1:]:
        _moe(dev)
        return 0
    if "--recurrent" in sys.argv[1:]:
        _recurrent(dev)
        return 0

    cfg = configs.get("internlm2-1.8b")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(model, AdamWConfig(lr=3e-4, warmup_steps=10,
                                              total_steps=STEPS))
    data = TokenStream(vocab=cfg.vocab, batch=BATCH, seq_len=LEN, seed=0)
    for i in range(STEPS):
        state, m = step(state, next(data))
        print(f"internlm2-1.8b step {i} loss {_bits(m['loss'])} grad_norm "
              f"{_bits(m['grad_norm'])}")
    print(f"internlm2-1.8b state after {STEPS} steps {_digest(state)}")
    times = []
    for _ in range(TIMED):
        batch = next(data)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch)
        m["loss"].item()
        times.append(time.perf_counter() - t)
    print(f"# internlm2-1.8b seconds a step {' '.join(f'{x:.4f}' for x in times)}"
          f" peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, step, model
    torch.cuda.empty_cache()
    print(f"# cross_entropy forward and backward {_loss_ms(cfg.vocab):.3f} ms")

    cfg = configs.get_smoke("internlm2-1.8b")
    model = build_model(cfg)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=10))

    def run(state, start, n):
        data = TokenStream(vocab=cfg.vocab, batch=2, seq_len=128, seed=0,
                           start_step=start)
        losses = []
        for _ in range(n):
            state, m = step(state, next(data))
            losses.append(_bits(m["loss"]))
        return state, losses

    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        state, first = run(state, 0, 3)
        mgr.save(state, step=3, blocking=False)
        mgr.wait()
        state, tail = run(state, 3, 2)
        resumed, again = run(mgr.restore(state), 3, 2)
    print(f"smoke losses {' '.join(first + tail)} resumed "
          f"{' '.join(again)}")
    print(f"smoke resumed state {_digest(resumed)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
