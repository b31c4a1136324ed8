"""Distribution: logical-axis sharding, the mesh registry, the collectives
the model differentiates through, and gradient compression."""
from .sharding import (FSDP_ARCHS, batch_axes, constrain, current_mesh,
                       current_rules, gather_shard, local_shard, rules_for,
                       shardings_for, spec_for, use_mesh_rules,
                       zero1_shardings)
from .compression import compressed_psum_pod

__all__ = ["FSDP_ARCHS", "batch_axes", "constrain", "current_mesh",
           "current_rules", "gather_shard", "local_shard", "rules_for",
           "shardings_for", "spec_for", "use_mesh_rules", "zero1_shardings",
           "compressed_psum_pod"]
