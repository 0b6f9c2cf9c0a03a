"""Synthetic corpora, the hash tokenizer and dedup-fed ingestion for the
port (numpy; ingestion runs the port's dedup pipeline)."""
from repro_torch.data.corpus import DATASET_PRESETS, CorpusConfig, SyntheticCorpus
from repro_torch.data.ingest import DedupIngest, PackedBatches
from repro_torch.data.tokenizer import HashWordTokenizer

__all__ = ["CorpusConfig", "SyntheticCorpus", "DATASET_PRESETS",
           "HashWordTokenizer", "DedupIngest", "PackedBatches"]
