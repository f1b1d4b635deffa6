"""Deterministic sharded synthetic token pipeline.

Each host materialises only its shard (host_id / num_hosts) of the global
batch.  Every *row* is seeded by (seed, step, global_row) — restart-safe and
elastic: after a re-mesh to fewer hosts, step N still yields the same
global token set, just re-partitioned (the fault-tolerance test relies on
this).

Tokens follow a noisy affine bigram process, so a small model has real
signal to learn.  numpy only: the reference's ``repro/data/pipeline.py``,
copied, so that a port run and a reference run read the same tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 17
    noise: float = 0.1          # fraction of uniform-random tokens
    mult: int = 31              # bigram transition: t+1 = (mult*t + add) % V
    add: int = 7


def _row_draws(cfg: DataConfig, step: int, row: int):
    g = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, row]))
    init = g.integers(0, cfg.vocab_size)
    noise = g.random(cfg.seq_len + 1) < cfg.noise
    rand = g.integers(0, cfg.vocab_size, cfg.seq_len + 1)
    return init, noise, rand


def global_example(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    """One (seq_len+1,) example, identified by (step, global row)."""
    init, noise, rand = _row_draws(cfg, step, row)
    toks = np.empty(cfg.seq_len + 1, np.int64)
    toks[0] = init
    for i in range(1, cfg.seq_len + 1):
        toks[i] = rand[i] if noise[i] else \
            (cfg.mult * toks[i - 1] + cfg.add) % cfg.vocab_size
    return toks


class ShardedBatches:
    """Iterator of {"tokens": (local_batch, seq_len+1) int32}."""

    def __init__(self, cfg: DataConfig, num_hosts: int = 1, host_id: int = 0,
                 start_step: int = 0):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.cfg = cfg
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.step = start_step

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        local = cfg.global_batch // self.num_hosts
        rows = range(self.host_id * local, (self.host_id + 1) * local)
        draws = [_row_draws(cfg, step, r) for r in rows]
        toks = np.empty((local, cfg.seq_len + 1), np.int64)
        toks[:, 0] = [d[0] for d in draws]
        noise = np.stack([d[1] for d in draws])
        rand = np.stack([d[2] for d in draws])
        for i in range(1, cfg.seq_len + 1):  # vectorised across rows
            chain = (cfg.mult * toks[:, i - 1] + cfg.add) % cfg.vocab_size
            toks[:, i] = np.where(noise[:, i], rand[:, i], chain)
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b
