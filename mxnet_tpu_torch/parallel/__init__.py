"""Training on a device (:class:`ShardedTrainer` on a one-device mesh and
its functional optimizers) and the mesh and partition rules that
tensor-parallel serving shards its parameters and K/V-cache with."""

from . import mesh, partition
from .mesh import Mesh, NamedSharding, PartitionSpec, make_mesh
from .partition import (gpt_partition_rules, match_partition_rules,
                        named_shardings, parse_rules, rules_digest,
                        spec_tuple)
from .trainer import ShardedTrainer, adam_opt, adamw_opt, sgd_opt

__all__ = ["ShardedTrainer", "sgd_opt", "adam_opt", "adamw_opt", "mesh",
           "partition", "Mesh", "NamedSharding", "PartitionSpec",
           "make_mesh", "match_partition_rules", "gpt_partition_rules",
           "parse_rules", "rules_digest", "spec_tuple", "named_shardings"]
