"""Deterministic, checkpointable synthetic data pipeline.

Work units are *index ranges* over an infinite deterministic token stream:
batch ``i`` is a pure function of ``(seed, i)``.  That determinism is what
makes the V-BOINC analogy work end-to-end — a failed volunteer's work unit
can be re-issued to any other worker and produce a bit-identical result
(quorum validation in core/scheduler.py relies on this), and the pipeline's
checkpoint is a single cursor integer carried in every snapshot.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic structure: a noisy order-k Markov stream so the LM has
    # something learnable (loss decreases measurably within ~100 steps)
    markov_order: int = 1
    noise: float = 0.05


class TokenStream:
    """Infinite deterministic stream; ``batch(i)`` is random-access."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # fixed transition structure derived from the seed
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._mix = rng.integers(1, v, size=(cfg.markov_order,), dtype=np.int64)
        self._bias = int(rng.integers(0, v))

    def batch(self, index: int) -> dict:
        """Batch ``index`` -> {tokens (B,T+1) int32} (inputs + shifted labels)."""
        cfg = self.cfg
        v = cfg.vocab_size
        b, t = cfg.global_batch, cfg.seq_len
        rng = np.random.default_rng((cfg.seed, index))
        seqs = np.empty((b, t + 1), np.int64)
        seqs[:, :cfg.markov_order] = rng.integers(
            0, v, size=(b, cfg.markov_order))
        # vectorized Markov rollout with noise
        noise_mask = rng.random((b, t + 1)) < cfg.noise
        noise_tok = rng.integers(0, v, size=(b, t + 1))
        for j in range(cfg.markov_order, t + 1):
            nxt = (seqs[:, j - cfg.markov_order:j] @ self._mix
                   + self._bias) % v
            seqs[:, j] = np.where(noise_mask[:, j], noise_tok[:, j], nxt)
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}


@dataclass
class Cursor:
    """The pipeline's entire checkpointable state."""
    next_index: int = 0

    def advance(self) -> int:
        i = self.next_index
        self.next_index += 1
        return i

    def to_state(self) -> dict:
        return {"next_index": self.next_index}

    @classmethod
    def from_state(cls, state: dict) -> "Cursor":
        return cls(next_index=int(state["next_index"]))
