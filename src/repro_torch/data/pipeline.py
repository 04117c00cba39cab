"""Deterministic, shardable, resumable synthetic data pipeline (a copy of
the JAX package's ``repro.data.pipeline``: numpy only, the same arrays for
the same seed).

Every batch is a pure function of ``(seed, step, shard)`` — no filesystem,
no RNG state to lose: resuming from a checkpoint's ``step`` reproduces the
exact token stream, and each data-parallel shard draws only its slice
(host-local arrays; the launcher assembles global arrays per mesh).

The generator emits document-structured token streams (Zipfian unigrams per
pseudo-document, BOS-delimited) so losses move like language data rather
than uniform noise.  An exact-dedup filter (same hash-partition machinery
as the SNP engine's visited set) is included to mirror a production
dedup stage and is reused by tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..configs.base import ArchConfig

__all__ = ["DataConfig", "make_batch", "data_iterator", "dedup_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    doc_len_mean: int = 512
    bos_token: int = 1


def _rng_for(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def _zipf_tokens(rng, n, vocab):
    # Zipf-ish unigram draw, cheap and bounded
    u = rng.random(n)
    ranks = np.minimum((1.0 / np.maximum(u, 1e-9)) ** 0.7, vocab - 2)
    toks = ranks.astype(np.int64)
    perm_seed = rng.integers(0, 2 ** 31)
    # per-document token permutation so documents differ in content
    return (toks * 2654435761 + perm_seed) % (vocab - 2) + 2


def make_batch(
    arch: ArchConfig, data_cfg: DataConfig, *, step: int, shard: int,
    batch: int, seq_len: int,
) -> Dict[str, np.ndarray]:
    """One shard-local batch: tokens/labels/positions (+frontend stubs)."""
    rng = _rng_for(data_cfg, step, shard)
    V = arch.vocab_size
    ncb = max(1, arch.codebooks)
    total = batch * ncb * seq_len + batch
    toks = _zipf_tokens(rng, total, V)
    # BOS-delimit pseudo-documents
    doc_mask = rng.random(total) < 1.0 / max(data_cfg.doc_len_mean, 2)
    toks = np.where(doc_mask, data_cfg.bos_token, toks)
    if arch.codebooks:
        tokens = toks[:batch * ncb * seq_len].reshape(batch, ncb, seq_len)
        labels = np.roll(tokens, -1, axis=-1)
    else:
        tokens = toks[:batch * seq_len].reshape(batch, seq_len)
        labels = np.roll(tokens, -1, axis=-1)
    labels = labels.copy()
    labels[..., -1] = -1   # no target for the final position
    positions = np.broadcast_to(np.arange(seq_len), (batch, seq_len)).copy()
    out = {
        "tokens": tokens.astype(np.int32),
        "labels": labels.astype(np.int32),
        "positions": positions.astype(np.int32),
    }
    if arch.mrope_sections:
        out["positions"] = np.broadcast_to(
            out["positions"][None], (3, batch, seq_len)).copy()
    if arch.frontend != "none" and not arch.codebooks:
        out["frontend_embeds"] = rng.standard_normal(
            (batch, seq_len, arch.d_model)).astype(np.float32)
        out["embed_mask"] = (
            np.arange(seq_len)[None, :] < seq_len // 8
        ).repeat(batch, 0)
    return out


def data_iterator(
    arch: ArchConfig, data_cfg: DataConfig, *, shard: int, batch: int,
    seq_len: int, start_step: int = 0,
) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """Resumable: pass the checkpointed step as ``start_step`` and the
    stream continues bit-identically."""
    step = start_step
    while True:
        yield step, make_batch(arch, data_cfg, step=step, shard=shard,
                               batch=batch, seq_len=seq_len)
        step += 1


def dedup_batch(tokens: np.ndarray) -> np.ndarray:
    """Exact duplicate-sequence mask (True = keep): the data-pipeline twin
    of the SNP visited-set dedup."""
    seen = set()
    keep = np.ones(tokens.shape[0], bool)
    for i, row in enumerate(tokens.reshape(tokens.shape[0], -1)):
        h = hash(row.tobytes())
        if h in seen:
            keep[i] = False
        seen.add(h)
    return keep
