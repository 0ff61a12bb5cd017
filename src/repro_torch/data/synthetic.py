"""Deterministic synthetic token pipeline (counterpart of
``repro.data.synthetic``).

Host-sharded: each data-parallel host derives its stream from
(seed, host_id, step), so a restart replays exactly and no two hosts see
the same tokens. The draws are numpy's, as in the reference, so both
packages produce the same integers; ``batch_at`` puts them on the
stream's device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..core.operators import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    selector: str = "uniform"      # uniform | dpp
    pool_factor: int = 4           # dpp: candidates per selected sequence


class TokenStream:
    """Stateless per-step batch generator (markov-ish synthetic text)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0,
                 num_hosts: int = 1, *, device="cuda"):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self.device = resolve_device(device)

    def tokens_at(self, step: int) -> np.ndarray:
        """The (local_batch, seq_len + 1) int32 token rows of ``step``."""
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, self.host_id, step]))
        # zipf-ish marginal over vocab with local repetition structure
        base = rng.zipf(1.3, size=(self.local_batch, c.seq_len + 1))
        tokens = (base % (c.vocab - 2)) + 1
        # inject repeated spans (gives the model something learnable)
        span_hi = max(min(32, c.seq_len // 4), 2)
        for b in range(self.local_batch):
            span = int(rng.integers(1, span_hi))
            src = int(rng.integers(0, max(c.seq_len - 2 * span, 1)))
            dst = int(rng.integers(0, max(c.seq_len - span, 1)))
            tokens[b, dst:dst + span] = tokens[b, src:src + span]
        return tokens.astype(np.int32)

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for ``step`` (resume == replay)."""
        return to_batch(self.tokens_at(step), self.device)

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def to_batch(tokens: np.ndarray, device) -> dict:
    """``{"tokens", "labels"}`` (B, T) int32 on ``device`` from
    (B, T + 1) token rows."""
    t = torch.as_tensor(tokens, dtype=torch.int32).to(device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def sequence_embeddings(tokens: np.ndarray, dim: int = 64,
                        seed: int = 0) -> np.ndarray:
    """Cheap fixed random-projection bag-of-tokens embedding used by the
    DPP selector (B, dim), L2-normalised."""
    rng = np.random.default_rng(seed)
    vocab_hash = rng.standard_normal((4096, dim)).astype(np.float32)
    idx = np.asarray(tokens) % 4096
    emb = vocab_hash[idx].mean(axis=1)
    norm = np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-8
    return emb / norm
