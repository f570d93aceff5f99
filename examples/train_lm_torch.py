"""End-to-end LM training driver of the PyTorch port: train a small
model for a few hundred steps with the full runtime stack (prefetch
pipeline, AdamW, checkpointing, straggler monitor) -- the port of
``examples/train_lm.py``.

The default profile is a reduced-width qwen3-family model (--profile
smoke); --profile 100m selects a ~100M-parameter config.  It runs on
the CUDA card unless given --device cpu.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import PrefetchPipeline, TokenStream  # noqa: E402
from repro_torch.memory.channels import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.runtime.train import (LoopConfig, TrainLoop,  # noqa: E402
                                       init_train_state, make_train_step)


def profile_100m() -> ModelConfig:
    """~100M params, qwen3-family (qk_norm + GQA)."""
    return ModelConfig(
        arch_id="qwen3-100m", family="dense", n_layers=12, d_model=640,
        n_heads=10, n_kv_heads=2, d_ff=1792, vocab=50304, head_dim=64,
        qk_norm=True, act="swiglu", norm="rmsnorm",
        param_dtype="float32", compute_dtype="float32",
    )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--profile", choices=["smoke", "100m"], default="smoke")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = (profile_100m() if args.profile == "100m"
           else configs.get_smoke("qwen3-14b"))
    model = build_model(cfg, attn_impl="xla", device=device)
    state = init_train_state(model, torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.arch_id}  params={n_params / 1e6:.1f}M  device={device}")

    opt = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(model, opt)
    ckpt = CheckpointManager(args.ckpt_dir)

    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start_step = int(state["step"])
        print(f"resumed from checkpoint step {start_step}")

    stream = TokenStream(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq_len,
        cfg=cfg, start_step=start_step,
    )
    data = PrefetchPipeline(stream, device=device)  # the double-buffered host path

    def on_straggler(step_idx, dt):
        print(f"  [monitor] step {step_idx} straggled ({dt:.2f}s)")

    loop = TrainLoop(
        step, state, data,
        cfg=LoopConfig(total_steps=args.steps, checkpoint_every=50,
                       log_every=10),
        checkpointer=ckpt,
        on_straggler=on_straggler,
    )
    final = loop.run()
    data.close()
    for h in loop.history[:: max(1, len(loop.history) // 10)]:
        print(f"step {h['step']:>5}  loss {h['loss']:.4f}  {h['dt']*1e3:.0f}ms")
    if loop.history:
        print(f"final step {int(final['step'])}, "
              f"loss {loop.history[-1]['loss']:.4f} "
              f"(from {loop.history[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
