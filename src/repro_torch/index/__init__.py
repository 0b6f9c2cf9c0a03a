"""repro_torch.index — the dedup-backend API of the port: one protocol, one
registry, one generic online pipeline (counterpart of `repro.index`)."""
from repro_torch.index.pipeline import (DedupPipeline,  # noqa: F401
                                        QueryResult, greedy_leader,
                                        greedy_leader_split)
from repro_torch.index.protocol import (BATCH_FIRST,  # noqa: F401
                                        INDEX_FIRST, DedupBackend, SigBatch,
                                        SigSpec, StepResult)
from repro_torch.index.registry import (accepted_opts,  # noqa: F401
                                        available, make, make_pipeline,
                                        register, validate_opts)

__all__ = ["DedupBackend", "SigBatch", "SigSpec", "StepResult", "BATCH_FIRST",
           "INDEX_FIRST",
           "DedupPipeline", "QueryResult", "greedy_leader", "greedy_leader_split",
           "register", "make", "make_pipeline", "available", "accepted_opts",
           "validate_opts"]
