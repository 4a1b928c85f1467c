"""Logical -> physical sharding rules, as `repro.sharding`."""

from .rules import (MULTI_POD_RULES, SINGLE_POD_RULES, ShardingRules,
                    logical, spec_tree_from_layout)

__all__ = ["ShardingRules", "SINGLE_POD_RULES", "MULTI_POD_RULES", "logical",
           "spec_tree_from_layout"]
