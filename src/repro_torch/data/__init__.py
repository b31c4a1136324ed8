"""Deterministic synthetic data pipeline (stateless, shard-local, prefetch)."""
from .pipeline import DataConfig, PrefetchIterator, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "PrefetchIterator", "SyntheticLM", "make_pipeline"]
