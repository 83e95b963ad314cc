"""Data pipelines: synthetic LM token streams and the PIC particle feed.

The port's own copy of ``repro.data.pipeline``, which is pure NumPy: the
same draws from the same seeds, so ``batch_at(step)`` and the particle
feed are the reference's bit for bit.

Deterministic and seekable: ``batch_at(step)`` is a pure function of
(seed, step), so a restarted job resumes mid-epoch with no coordination,
the property checkpointing relies on (``train.checkpoint``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    # markov-chain synthetic text: makes loss decrease measurably
    order: int = 1
    branch: int = 16


class TokenPipeline:
    """Synthetic seekable LM stream with learnable structure.

    Tokens follow a sparse random Markov chain over the vocab, so a real
    model trained on it shows a clearly decreasing loss (used by the
    end-to-end example and the training integration test).
    """

    def __init__(self, cfg: ModelConfig, data: DataConfig):
        self.cfg = cfg
        self.data = data
        rng = np.random.default_rng(data.seed)
        V = cfg.vocab_size
        # each token has `branch` likely successors
        self.succ = rng.integers(0, V, size=(V, data.branch))

    def batch_at(self, step: int) -> dict:
        d = self.data
        rng = np.random.default_rng((d.seed, step))
        B, S = d.global_batch, d.seq_len
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.cfg.vocab_size, B)
        for t in range(S):
            choice = rng.integers(0, d.branch, B)
            noise = rng.random(B) < 0.05
            nxt = self.succ[toks[:, t], choice]
            nxt = np.where(noise, rng.integers(0, self.cfg.vocab_size, B),
                           nxt)
            toks[:, t + 1] = nxt
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.family == "vlm":
            batch["prefix_embeds"] = rng.standard_normal(
                (B, self.cfg.vision_len, self.cfg.d_model)).astype(np.float32)
        if self.cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (B, self.cfg.encoder_len, self.cfg.d_model)).astype(
                    np.float32)
        return batch


class ParticleFeed:
    """PIC particle positions drifting over steps (the paper's workload).

    ``load_matrix(step)`` bins particles into the (n1, n2) grid — the exact
    input of the partitioners; the PIC example rebalances with it.
    """

    def __init__(self, n1: int, n2: int, n_particles: int = 200_000,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.n1, self.n2 = n1, n2
        self.pos = rng.random((n_particles, 2))
        self.vel = rng.standard_normal((n_particles, 2)) * 1e-3
        # swirl center pulls particles into a crescent over time
        self.center = np.array([0.45, 0.5])

    def step(self) -> None:
        d = self.pos - self.center
        r = np.linalg.norm(d, axis=1, keepdims=True) + 1e-3
        swirl = np.stack([-d[:, 1], d[:, 0]], axis=1) / r
        self.vel = 0.98 * self.vel + 2e-4 * swirl - 5e-5 * d / r
        self.pos = (self.pos + self.vel) % 1.0

    def load_matrix(self) -> np.ndarray:
        a = np.zeros((self.n1, self.n2), dtype=np.int64)
        i = np.clip((self.pos[:, 0] * self.n1).astype(int), 0, self.n1 - 1)
        j = np.clip((self.pos[:, 1] * self.n2).astype(int), 0, self.n2 - 1)
        np.add.at(a, (i, j), 1)
        return a + 1  # keep Delta finite like PIC-MAG
