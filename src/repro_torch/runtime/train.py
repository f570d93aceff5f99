"""Train-step builders and the fault-tolerant training loop, as the
reference's ``repro/runtime/train.py``.

``make_train_step``: one step -- the loss and its gradient by autograd
(through the flash kernels' forward and backward on the card), then the
AdamW update of :mod:`repro_torch.optim`.  With ``grad_accum > 1`` the
batch is split into microbatches along its leading axis and their
float32 gradients are summed in a Python loop (the reference's
``lax.scan``), then averaged.

A state placed by :func:`repro_torch.distributed.sharding.distribute_state`
(params and moments DTensors) and a batch from ``distribute_batch`` give
the sharded step, with the same code: DTensor propagates each op's
sharding (with the rules of :mod:`repro_torch.distributed.rules` for the
ops that need them), the plain tensors the model makes meet DTensors as
replicated (``implicit_replication``, over the forward, the backward and
the update), and a gradient left as partial sums over ranks is reduced
to its param's placements right after the backward.  Its metrics come
back as plain tensors.

``TrainLoop``: checkpoint/restart, straggler monitoring, preemption-signal
handling, and resumable data, with the reference's rules.  A step
updates the state in place, so a retry after a fault in the forward or
backward starts from the same state; a fault inside the optimizer update
may leave it partly updated.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..models.api import Model
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..tree import tree_leaves, tree_map, tree_unflatten
from . import losses
from .monitor import StepMonitor


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def make_loss_fn(model: Model, *, moe_capacity: Optional[int] = None):
    """loss_fn(params, batch): the cross entropy on ``batch["labels"]``,
    else the next-token loss on ``batch["tokens"]`` (float32 scalar)."""
    def loss_fn(params, batch):
        logits = model.forward(params, batch, moe_capacity=moe_capacity)
        if "labels" in batch:
            labels = torch.as_tensor(batch["labels"], device=logits.device)
            return losses.cross_entropy(logits, labels)
        tokens = torch.as_tensor(batch["tokens"], device=logits.device)
        return losses.next_token_loss(logits, tokens)

    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, grads)`` of ``loss_fn(params, batch)``: gradients in each
    param's dtype, zeros for a param the loss does not reach (as
    ``jax.grad`` gives).  Of DTensor params, DTensor gradients in their
    params' placements."""
    leaves = tree_leaves(params)
    with torch.enable_grad(), implicit_replication():
        live = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
             for p, g in zip(live, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _placed_like(g, p):
    """A DTensor gradient in its param's placements: a partial sum over
    ranks is reduced here, once.  Left partial, the update's ``g * g``
    would be formed as the full ``g`` times each rank's part, summed:
    a square that can round below zero."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    *,
    moe_capacity: Optional[int] = None,
    grad_accum: int = 1,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).  The state's
    params and moments are updated in place (see ``adamw_update``);
    metrics hold ``loss``, ``grad_norm`` and ``lr`` as 0-d tensors."""
    loss_fn = make_loss_fn(model, moe_capacity=moe_capacity)

    def to_device(batch):
        return {k: torch.as_tensor(v, device=model.device)
                for k, v in batch.items()}

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        batch = to_device(batch)
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            mbatches = [
                {k: v.reshape((grad_accum, -1) + tuple(v.shape[1:]))[i]
                 for k, v in batch.items()}
                for i in range(grad_accum)
            ]
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            with implicit_replication():
                for mb in mbatches:
                    l, g = value_and_grad(loss_fn, params, mb)
                    loss = loss + l
                    grads = tree_map(torch.add, grads, g)
                loss = loss / grad_accum
                grads = tree_map(lambda g: g / grad_accum, grads)

        new_params, new_opt, metrics = adamw_update(
            opt_cfg, grads, state["opt_state"], params
        )
        del grads
        new_state = {
            "params": new_params,
            "opt_state": new_opt,
            "step": state["step"] + 1,
        }
        metrics = {k: v.full_tensor() if isinstance(v, DTensor) else v
                   for k, v in dict(metrics, loss=loss).items()}
        return new_state, metrics

    return train_step


def init_train_state(model: Model, generator: torch.Generator) -> Dict[str, Any]:
    """Params from ``model.init(generator)``, fresh AdamW moments and an
    int32 step of 0, on the model's device."""
    params = model.init(generator)
    return {
        "params": params,
        "opt_state": adamw_init(params),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoopConfig:
    """Steps, checkpoint cadence, straggler factor and retries."""

    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0   # flag steps slower than f x EWMA
    max_retries: int = 2            # per-step retry on transient failure


class PreemptionGuard:
    """SIGTERM -> finish the current step, checkpoint, exit cleanly."""

    def __init__(self) -> None:
        self.requested = False
        try:
            self._prev = signal.signal(signal.SIGTERM, self._handler)
        except ValueError:  # non-main thread (tests)
            self._prev = None

    def _handler(self, signum, frame):  # pragma: no cover - signal path
        self.requested = True


class TrainLoop:
    """Steps ``train_step`` over ``data_iter`` from the state's step,
    retrying, checkpointing and stopping on SIGTERM (``run``)."""

    def __init__(
        self,
        train_step: Callable,
        state: Dict[str, Any],
        data_iter,
        *,
        cfg: LoopConfig = LoopConfig(),
        checkpointer=None,
        on_straggler: Optional[Callable[[int, float], None]] = None,
    ) -> None:
        self.train_step = train_step
        self.state = state
        self.data_iter = data_iter
        self.cfg = cfg
        self.checkpointer = checkpointer
        self.monitor = StepMonitor(straggler_factor=cfg.straggler_factor)
        self.on_straggler = on_straggler
        self.guard = PreemptionGuard()
        self.history: list = []

    def run(self) -> Dict[str, Any]:
        """Run to ``cfg.total_steps`` (or a preemption); the last state."""
        start = int(self.state["step"])
        for step in range(start, self.cfg.total_steps):
            batch = next(self.data_iter)
            t0 = time.perf_counter()
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    self.state, metrics = self.train_step(self.state, batch)
                    loss = float(metrics["loss"])  # blocks; surfaces faults
                    break
                except Exception:
                    if attempt == self.cfg.max_retries:
                        # persist progress before propagating
                        if self.checkpointer is not None:
                            self.checkpointer.save(self.state, step=step)
                        raise
            dt = time.perf_counter() - t0
            flagged = self.monitor.record(dt)
            if flagged and self.on_straggler is not None:
                self.on_straggler(step, dt)
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if (
                self.checkpointer is not None
                and (step + 1) % self.cfg.checkpoint_every == 0
            ):
                self.checkpointer.save(self.state, step=step + 1)
            if self.guard.requested:
                if self.checkpointer is not None:
                    self.checkpointer.save(self.state, step=step + 1)
                break
        return self.state
