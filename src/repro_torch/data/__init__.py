"""Deterministic synthetic data (port of ``repro/data``)."""
from repro_torch.data.pipeline import DataIterator, SyntheticCorpus

__all__ = ["DataIterator", "SyntheticCorpus"]
