"""Baselines from the paper's evaluation (§3, §6), port of
`repro/baselines`.

Every baseline is a registered `repro_torch.index` backend run through the
one generic `DedupPipeline`; the constructors below are the reference's
thin wrappers with its keyword signatures and defaults, plus `device`
(None means cuda and raises without a card; "cpu" is the plain path):

  BruteForcePipeline   — "brute": exact online admission (Table 1 ground
                         truth)
  DPKPipeline          — "dpk": MinHash-LSH banding + Jaccard verification
  FlatLSHPipeline      — "flat_lsh": Milvus MINHASH_LSH analogue (bucketed
                         flat retrieval with a topK candidate budget)
  PrefixFilterPipeline — "prefix_filter": frequency-ordered prefix-filter
                         set-similarity join (INDEX_FIRST order)
  RawHNSWPipeline      — "hnsw_raw": FAISS (Jaccard) / FAISS (Hamming)
"""
from repro_torch.baselines.base import SignatureStage
from repro_torch.baselines.brute import BruteForcePipeline
from repro_torch.baselines.dpk import DPKPipeline
from repro_torch.baselines.flat import FlatLSHPipeline
from repro_torch.baselines.hnsw_raw import RawHNSWPipeline
from repro_torch.baselines.prefix_filter import PrefixFilterPipeline

__all__ = ["SignatureStage", "BruteForcePipeline", "DPKPipeline",
           "FlatLSHPipeline", "PrefixFilterPipeline", "RawHNSWPipeline"]
