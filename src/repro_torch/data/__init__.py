"""Deterministic shardable resumable data pipeline (numpy only)."""

from .pipeline import DataConfig, data_iterator, dedup_batch, make_batch

__all__ = ["DataConfig", "make_batch", "data_iterator", "dedup_batch"]
