"""Distribution layer (port of `repro/dist/`): activation sharding anchors
+ parameter sharding plans over `torch.distributed` device meshes.

  act         — mesh-scoped DTensor redistributions dropped into model
                code at the canonical activation shapes (B,S,d), (B,d),
                logits. Identities when no mesh (or a one-rank mesh) is
                set.
  sharding    — ShardingPlan (logical-axis rules -> PartitionSpecs with
                divisibility filtering, and their DTensor placements),
                batch/cache input specs, dp_axes.
"""
from repro_torch.dist import act  # noqa: F401
from repro_torch.dist.sharding import (ShardingPlan, batch_pspecs,  # noqa: F401
                                       cache_pspecs, dp_axes, make_plan)

__all__ = ["act", "ShardingPlan", "make_plan", "batch_pspecs",
           "cache_pspecs", "dp_axes"]
