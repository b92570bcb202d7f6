"""Deterministic synthetic token pipeline — stateless, shardable, resumable.

The port's copy of ``repro.data.pipeline`` (numpy only): the same
batches, byte for byte.  The pipeline is a pure function
``step -> batch``; there is NO loader state to checkpoint or lose.  Any
worker (or replacement worker after a failure) recomputes its shard of any
step independently, which also makes elastic re-scaling trivial: the
(step, dp_rank, dp_size) triple fully determines the data.

The synthetic stream is a mixture of Zipf-distributed unigrams with
shifting n-gram structure so losses are non-trivial and reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _fold(seed: int, *xs: int) -> np.random.Generator:
    s = np.uint64(seed)
    for x in xs:
        s = np.uint64((int(s) * 6364136223846793005 + int(x) + 1) % 2**64)
    return np.random.default_rng(int(s))


def batch_for_step(cfg: DataConfig, step: int,
                   dp_rank: int = 0, dp_size: int = 1
                   ) -> Dict[str, np.ndarray]:
    """The (dp_rank)-th shard of global step `step`."""
    assert cfg.global_batch % dp_size == 0
    per = cfg.global_batch // dp_size
    rng = _fold(cfg.seed, step, dp_rank)
    # Zipf unigrams clipped to vocab, plus a step-dependent periodic motif
    # so the stream has learnable structure.
    z = rng.zipf(cfg.zipf_a, size=(per, cfg.seq_len + 1))
    toks = (z % (cfg.vocab - 2)) + 1
    motif = (np.arange(cfg.seq_len + 1)[None, :] * (1 + step % 7)
             + dp_rank) % 97
    mask = rng.random((per, cfg.seq_len + 1)) < 0.15
    toks = np.where(mask, (motif % (cfg.vocab - 2)) + 1, toks)
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def global_batch_for_step(cfg: DataConfig, step: int
                          ) -> Dict[str, np.ndarray]:
    return batch_for_step(cfg, step, 0, 1)


class DataIterator:
    """Step-indexed iterator with O(1) resume (just set .step)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 dp_rank: int = 0, dp_size: int = 1):
        self.cfg = cfg
        self.step = start_step
        self.dp_rank = dp_rank
        self.dp_size = dp_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = batch_for_step(self.cfg, self.step, self.dp_rank, self.dp_size)
        self.step += 1
        return b

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])
