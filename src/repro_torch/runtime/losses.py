"""Losses, in plain PyTorch, as the reference's ``runtime/losses.py``.

Cross entropy picks the label's logit by a masked sum (``iota == label``)
where the logits are a DTensor, as the reference does: with the logits
split on the vocab over ``model`` (the vocab-parallel head), the max and
the exp-sum reduce as partial sums, the pick is a masked partial sum,
and no rank forms a tensor of the whole vocab (vocab-parallel CE).
Logits that arrive as a partial sum are reduced to that layout first
(``distributed.rules.reduced_logits``).  On a
plain tensor it picks by a gather, which gives the same bits (one logit
plus zeros) without the masked sum's passes over the (B, T, V) logits.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor


def _vocab_ids(lf: DTensor) -> DTensor:
    """``arange(V)`` along ``lf``'s last dim, each rank's own slice, split
    as ``lf`` splits its last dim: the mask it makes is split like the
    logits (a replicated arange would make every rank a whole-vocab
    mask)."""
    from torch.distributed.tensor import Replicate, Shard

    V = lf.shape[-1]
    mesh, last = lf.device_mesh, lf.ndim - 1
    ids = DTensor.from_local(
        torch.arange(V, device=lf.to_local().device), mesh,
        [Replicate()] * mesh.ndim, run_check=False)
    # a split of a replicated tensor is a local slice: no communication
    return ids.redistribute(mesh, [
        Shard(0) if p.is_shard(last) else Replicate() for p in lf.placements])


def masked_pick(lf: torch.Tensor, labels: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """``lf[..., labels]`` by the reference's masked sum over ``ids``, the
    vocab ids along ``lf``'s last dim: exact, one logit plus zeros (0
    where a label is out of range)."""
    return torch.where(ids == labels[..., None], lf, 0.0).sum(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """logits: (B, T, V); labels: (B, T) integers.  Mean negative
    log-likelihood in float32 over the labels that are not ``ignore_id``.
    The pick is exact: a DTensor's by :func:`masked_pick`, a tensor's by a
    gather."""
    lf = logits.float()
    if isinstance(lf, DTensor):
        from ..distributed import rules

        lf = rules.reduced_logits(lf)
    m = lf.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    if isinstance(lf, DTensor):
        picked = masked_pick(lf, labels, _vocab_ids(lf))
    else:
        safe = torch.where(labels == ignore_id, 0, labels).long()
        picked = lf.gather(-1, safe[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return -((picked - lse) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Shifted LM loss when only tokens are provided."""
    return cross_entropy(logits[:, :-1], tokens[:, 1:])
