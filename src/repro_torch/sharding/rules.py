"""Logical -> physical sharding rules, as `repro.sharding.rules`.

Model code names every parameter axis with a *logical* name ("batch",
"seq", "model_d", "ff", "heads", "kv_heads", "vocab", "experts", ...).  A
`ShardingRules` table maps those to mesh axes, so the same layout table
describes the single-pod (data, model) mesh, the multi-pod (pod, data,
model) mesh or a test mesh by swapping the table.  Specs are
`core.mesh.PartitionSpec` trees, equal as tuples to JAX's.

Conventions (MaxText-style megatron sharding):
  * batch          -> ("pod", "data")   pure DP; never crosses TP groups
  * heads/ff/vocab/experts -> "model"   tensor/expert parallelism
  * seq            -> "data" only for the long-context decode cells (batch=1)
  * everything else replicated

The sharded train step reads these specs (`sharding.placement`): each
weight is stored sharded as its spec says, AdamW's moments also over the
batch axes (ZeRO-1), and the batch is split over the batch axes.  Every
family (the transformer family, dense, MoE and MLA, Griffin and xLSTM)
computes on those blocks, tensor- and expert-parallel over "model"
(`sharding.tensor_parallel`).
"""

from __future__ import annotations

import dataclasses

from ..core.mesh import PartitionSpec as P


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis name to mesh axis (str, tuple, or None)."""
    rules: dict

    def axis(self, name: str | None):
        if name is None:
            return None
        return self.rules.get(name, None)

    def spec(self, *logical_axes: str | None) -> P:
        return P(*(self.axis(a) for a in logical_axes))


SINGLE_POD_RULES = ShardingRules(rules={
    "batch": "data",
    "seq_sharded": "data",      # long-context: sequence over the data axis
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "model_d": None,            # d_model replicated (no sequence parallel here)
    "seq": None,
})

MULTI_POD_RULES = ShardingRules(rules={
    "batch": ("pod", "data"),
    "seq_sharded": "data",      # sequence sharding stays inside a pod
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "model_d": None,
    "seq": None,
})


def logical(rules: ShardingRules, *axes: str | None) -> P:
    return rules.spec(*axes)


def spec_tree_from_layout(rules: ShardingRules, layout: dict) -> dict:
    """A PartitionSpec tree mirroring a param layout table
    ({name: (shape, logical_axes, init_kind)}, possibly nested)."""
    out = {}
    for name, val in layout.items():
        if isinstance(val, dict):
            out[name] = spec_tree_from_layout(rules, val)
        else:
            _, axes, _ = val
            out[name] = rules.spec(*axes)
    return out


__all__ = ["ShardingRules", "SINGLE_POD_RULES", "MULTI_POD_RULES", "logical",
           "spec_tree_from_layout"]
