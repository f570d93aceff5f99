"""Training launcher: pick an architecture and a mesh, build the train
step, and run the fault-tolerant loop -- the port of the reference's
``repro/launch/train.py``.  It runs on the CUDA card unless given
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --smoke --steps 20 --device cpu

Under ``torch.distributed.run`` (``RANK`` and ``WORLD_SIZE`` set) every
process joins the process group (``nccl`` on the card, each rank on
``cuda:LOCAL_RANK``; ``gloo`` with ``--device cpu``), the state and
each batch are sharded over a (data, model) mesh of ``world_size //
--model-axis`` by ``--model-axis`` ranks, and rank 0 prints:

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --smoke --steps 3 \\
      --batch 4 --seq-len 16 --model-axis 2 --device cpu

Every rank draws the same global batch from the token stream's seed and
keeps its share.  One process with ``--model-axis 1`` runs unsharded.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch
import torch.distributed as dist

from .. import configs
from ..checkpoint import CheckpointManager
from ..data import PrefetchPipeline, TokenStream
from ..distributed import sharding
from ..memory.channels import resolve_device
from ..models import build_model
from ..optim import AdamWConfig
from ..runtime.train import (LoopConfig, TrainLoop, init_train_state,
                             make_train_step)
from . import mesh as mesh_mod


def main(argv=None) -> int:
    """Parse ``argv``, train, print the loss span; returns the exit code."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="internlm2-1.8b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--attn-impl", default="auto",
                    choices=["auto", "xla", "xla_flash", "pallas"])
    ap.add_argument("--mlstm-chunk", type=int, default=None,
                    help="chunkwise-parallel mLSTM width (xlstm archs)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..models import ssm as ssm_mod
    ssm_mod.MLSTM_CHUNK = args.mlstm_chunk

    device = args.device
    if mesh_mod.launched() and device is None:
        device = f"cuda:{os.environ.get('LOCAL_RANK', '0')}"
    device = resolve_device(device)
    mesh = None
    if mesh_mod.launched() or args.model_axis != 1:
        mesh = mesh_mod.make_local_mesh(args.model_axis, device)
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = build_model(cfg, attn_impl=args.attn_impl, device=device)
    say(f"device: {device}")
    if mesh is not None:
        say(f"mesh: {mesh_mod.axis_sizes(mesh)}")

    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(model, gen)
    if mesh is not None:
        state = sharding.distribute_state(state, mesh)
    opt = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=args.steps)
    step = make_train_step(model, opt, grad_accum=args.grad_accum)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        start = int(state["step"])
        say(f"resumed at step {start}")
    stream = TokenStream(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq_len,
        cfg=cfg, start_step=start,
    )
    data = PrefetchPipeline(stream, device=device)
    batches = data if mesh is None else (
        sharding.distribute_batch(b, mesh) for b in data)
    loop = TrainLoop(
        step, state, batches,
        cfg=LoopConfig(total_steps=args.steps, checkpoint_every=25),
        checkpointer=ckpt,
    )
    try:
        loop.run()
    finally:
        data.close()
        ckpt.wait()
    if loop.history:
        say(f"steps {loop.history[0]['step']}..{loop.history[-1]['step']}: "
            f"loss {loop.history[0]['loss']:.4f} -> "
            f"{loop.history[-1]['loss']:.4f}")
    if mesh is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
