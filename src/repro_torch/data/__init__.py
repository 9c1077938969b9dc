"""Deterministic synthetic data pipeline."""
from .pipeline import DataConfig, SyntheticTokens, prefetch  # noqa: F401
