"""Logical -> physical sharding rules, as `repro.sharding`.  The placement
of the training state on a mesh is `sharding.placement` (not imported here:
the models import the rules, and the placement reads the models)."""

from .rules import (MULTI_POD_RULES, SINGLE_POD_RULES, ShardingRules,
                    logical, spec_tree_from_layout)

__all__ = ["ShardingRules", "SINGLE_POD_RULES", "MULTI_POD_RULES", "logical",
           "spec_tree_from_layout"]
