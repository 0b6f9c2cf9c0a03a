"""Synthetic corpora for the port (numpy only)."""
from repro_torch.data.corpus import DATASET_PRESETS, CorpusConfig, SyntheticCorpus

__all__ = ["CorpusConfig", "SyntheticCorpus", "DATASET_PRESETS"]
