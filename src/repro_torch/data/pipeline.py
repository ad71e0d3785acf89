"""Deterministic, shardable synthetic data pipelines.

Every batch is a pure function of (seed, step, shard), so an elastic restart
replays the exact stream from the restored step with any number of data
shards — the property the ft/elastic runner relies on.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, shard]))


@dataclasses.dataclass
class LMSyntheticDataset:
    """Markov-chain token stream (so loss actually decreases when training)."""

    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    order: int = 1

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        rng = _rng(self.seed, step, shard)
        b = self.batch // n_shards
        # structured stream: tokens[t+1] = (a*tokens[t] + noise) % vocab
        a = 31
        toks = np.empty((b, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        noise = rng.integers(0, 7, (b, self.seq_len))
        for t in range(self.seq_len):
            toks[:, t + 1] = (a * toks[:, t] + noise[:, t]) % self.vocab
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class RecsysSyntheticDataset:
    """Click model: label = sigmoid(w . features) with fixed hidden w."""

    n_dense: int
    n_sparse: int
    vocab: int
    batch: int
    seed: int = 0

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        rng = _rng(self.seed, step, shard)
        b = self.batch // n_shards
        dense = rng.normal(size=(b, self.n_dense)).astype(np.float32)
        sparse = rng.integers(0, self.vocab, (b, self.n_sparse)).astype(np.int32)
        w = np.sin(np.arange(self.n_dense) + 1).astype(np.float32)
        logit = dense @ w + 0.01 * sparse.sum(1)
        p = 1.0 / (1.0 + np.exp(-(logit - logit.mean())))
        labels = (rng.random(b) < p).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "labels": labels}


class ShardedLoader:
    """Iterates a dataset as (step -> batch) for one shard of the mesh."""

    def __init__(self, dataset, shard: int = 0, n_shards: int = 1, start_step: int = 0):
        self.ds = dataset
        self.shard = shard
        self.n_shards = n_shards
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self):
        b = self.ds.batch_at(self.step, self.shard, self.n_shards)
        self.step += 1
        return b


# ---- SNN benchmark data ---------------------------------------------------- #
def make_uniform(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Uniform [0,1]^d — the paper's synthetic benchmark (§6.1)."""
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def make_blobs(n_per: int, centers, std: float = 0.3, seed: int = 0):
    """Gaussian blobs + labels (DBSCAN evaluation data)."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for i, c in enumerate(centers):
        c = np.asarray(c, np.float32)
        xs.append(rng.normal(c, std, size=(n_per, c.size)).astype(np.float32))
        ys.append(np.full(n_per, i))
    return np.concatenate(xs), np.concatenate(ys)
