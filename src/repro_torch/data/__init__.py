"""Synthetic training data: a copy of ``repro/data`` (numpy only)."""

from .pipeline import DataConfig, Prefetcher, SyntheticDataset, loss_floor

__all__ = ["DataConfig", "Prefetcher", "SyntheticDataset", "loss_floor"]
