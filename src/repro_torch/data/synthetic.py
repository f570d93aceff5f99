"""Deterministic, resumable synthetic data sources (numpy only).

Every batch is a pure function of (seed, step): restart-after-failure
resumes bit-identically from the checkpointed step counter -- the data-
side half of the fault-tolerance story.  The batches are bit for bit the
reference's (``repro/data/synthetic.py``): the same numpy generators,
draws and casts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..models.config import ModelConfig


@dataclasses.dataclass
class TokenStream:
    """Zipf-ish synthetic LM tokens with shifted labels."""

    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    start_step: int = 0
    cfg: Optional[ModelConfig] = None  # enc-dec archs get frames too

    def __post_init__(self) -> None:
        self.step = self.start_step

    def state(self) -> Dict[str, int]:
        """The resume state: the next step and the seed."""
        return {"step": self.step, "seed": self.seed}

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch of ``step``: a pure function of (seed, step)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )
        # zipf-like marginal, clipped into vocab
        raw = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        tokens = (raw % self.vocab).astype(np.int32)
        out = {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
        }
        if self.cfg is not None and self.cfg.is_encdec:
            out["frames"] = rng.normal(
                size=(self.batch, self.cfg.n_audio_frames, self.cfg.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b


def cfd_element_stream(
    p: int, batch_elements: int, *, seed: int = 0, start_batch: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """[-1, 1]-normalized CFD element batches (paper's data contract)."""
    b = start_batch
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, b]))
        yield {
            "D": rng.uniform(-1, 1, (batch_elements, p, p, p)).astype(np.float32),
            "u": rng.uniform(-1, 1, (batch_elements, p, p, p)).astype(np.float32),
        }
        b += 1
