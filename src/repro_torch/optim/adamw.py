"""AdamW on nested dicts (and lists) of tensors, with the reference's
arithmetic (``repro/optim/adamw.py``).

Moments are kept in float32 whatever the param dtype; the global
gradient norm clips every gradient; weight decay applies to leaves of
two or more dims only (the stacked norm scales, ``(n_layers, d)``, count
as such leaves, as in the reference); the bias-corrected step is taken
in float32 and the param rounded back to its dtype.  The update runs
under ``torch.no_grad()`` one leaf at a time, so the transient memory is
a few float32 copies of the largest leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW and schedule settings (the reference's defaults)."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), float32:
    linear warm-up over ``warmup_steps``, then a cosine from ``lr`` down
    to ``min_lr_frac * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0, cfg.total_steps
                                           - cfg.warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any) -> dict:
    """Zero float32 moments like ``params`` and an int32 step of 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt(sum of every leaf's squares), in float32.  Of DTensor leaves,
    the norm of the whole tree: each leaf's sum is a sum over its shards
    (a replicated DTensor)."""
    total = None
    for leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def adamw_update(
    cfg: AdamWConfig,
    grads: Any,
    opt_state: Any,
    params: Any,
) -> Tuple[Any, Any, dict]:
    """One AdamW step: ``(new_params, new_opt_state, metrics)`` with
    metrics ``grad_norm`` (before clipping) and ``lr``.

    The params and moments passed in are updated in place and returned
    (the counterpart of the reference launcher's ``donate_argnums=(0,)``:
    the old state is not kept), so a caller that needs the old values
    must copy them first.  DTensor leaves (:mod:`repro_torch.distributed`)
    keep their placements; the scalars meet them as replicated."""
    with torch.no_grad(), implicit_replication():
        step = opt_state["step"] + 1
        gnorm = global_norm(grads)
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        lr = cosine_schedule(cfg, step).to(gnorm.device)
        stepf = step.to(torch.float32)
        b1t = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                         device=step.device), stepf)
        b2t = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                         device=step.device), stepf)

        def upd(p, g, mu, nu):
            g32 = g.to(torch.float32) * clip
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
            del g32
            delta = (mu / b1t).div_(torch.sqrt(nu / b2t).add_(cfg.eps))
            p32 = p.to(torch.float32)
            if p.dim() >= 2:
                delta.add_(cfg.weight_decay * p32)
            p.copy_(p32.sub_(lr * delta))
            return p

        new_params = tree_map(upd, params, grads, opt_state["mu"],
                              opt_state["nu"])
    new_state = {"mu": opt_state["mu"], "nu": opt_state["nu"], "step": step}
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
