"""Deterministic synthetic data pipeline (restart-safe by construction): a
numpy copy of the JAX package's ``data/pipeline.py``.

Each corpus is a Markov-ish token source with its own Zipf exponent and a
corpus-specific bigram shift, so models *can* learn (loss decreases) and the
mixture identity of a sequence is statistically visible. Batches are pure
functions of (seed, step): resuming at step k reproduces the exact stream,
and the same (seed, step) gives the JAX package's arrays.
"""
from __future__ import annotations

import numpy as np

from .mixture import MixtureSampler


class SyntheticCorpus:
    """Zipf unigrams + deterministic bigram drift, per corpus id."""

    def __init__(self, vocab: int, corpus_id: int, zipf: float | None = None):
        self.vocab = vocab
        self.corpus_id = corpus_id
        self.zipf = zipf if zipf is not None else 1.1 + 0.25 * (corpus_id % 4)

    def sample(self, rng: np.random.Generator, n: int, seq: int) -> np.ndarray:
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks ** (-self.zipf)
        p /= p.sum()
        base = rng.choice(self.vocab, size=(n, seq), p=p)
        # bigram structure: token_t depends weakly on token_{t-1}
        shift = (self.corpus_id * 97 + 13) % self.vocab
        drift = (np.cumsum(base, axis=1) + shift) % self.vocab
        mix = rng.random((n, seq)) < 0.3
        return np.where(mix, drift, base).astype(np.int32)


def make_batch(cfg, step: int, global_batch: int, seq_len: int,
               mixture: MixtureSampler | None = None,
               seed: int = 0) -> dict[str, np.ndarray]:
    """Pure function of (cfg, step, seed): the restart-safety contract.
    ``labels`` (B, S) int32 numpy arrays, with ``tokens`` (B, S) int32, or
    ``embeds`` (B, S, D) float32 under the embed frontend; ``frames`` (B,
    S, D) float32 for an encoder. All drawn from one generator in the JAX
    package's order, so the arrays are equal to its."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    batch: dict[str, np.ndarray] = {}
    if mixture is not None:
        corpus_ids = mixture.sample(step, global_batch)
    else:
        corpus_ids = np.zeros(global_batch, np.int64)
    toks = np.zeros((global_batch, seq_len), np.int32)
    for cid in np.unique(corpus_ids):
        rows = np.where(corpus_ids == cid)[0]
        toks[rows] = SyntheticCorpus(cfg.vocab, int(cid)).sample(rng, len(rows), seq_len)
    if cfg.frontend == "embed":
        emb = rng.normal(0, 1, (global_batch, seq_len, cfg.d_model))
        batch["embeds"] = emb.astype(np.float32)
    else:
        batch["tokens"] = toks
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(
            0, 1, (global_batch, seq_len, cfg.d_model)).astype(np.float32)
    batch["labels"] = toks
    return batch
