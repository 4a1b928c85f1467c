"""Elastic rescaling: move a state between mesh shapes, as in
`repro.checkpointing.elastic`.

A checkpoint written on one mesh restores onto any other (the manager stores
whole host arrays); `reshard` cuts each rank's block of every leaf for the
new mesh.  `plan_rescale` checks that the new mesh still divides every
sharded dimension: the guard a scheduler calls before it commits a shrink or
a grow.  Specs are `core.mesh.PartitionSpec`s (or plain tuples): per
dimension an axis name, None or a tuple of axis names.
"""

from __future__ import annotations

import numpy as np

from ..core.mesh import ShapeMesh


def abstract_target_mesh(axis_sizes, axis_names) -> ShapeMesh:
    """Describe a rescale *target* without owning its processes:
    `plan_rescale` reads only ``mesh.shape``."""
    return ShapeMesh(axis_sizes, axis_names)


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple))


def _block(x, mesh, spec):
    """This rank's block of `x` under `spec`: along each sharded dimension
    the slice its coordinates (row-major over the dimension's axes) pick."""
    for i, ax in enumerate(tuple(spec) if spec is not None else ()):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        sizes = [mesh.shape[a] for a in axes]
        index = int(np.ravel_multi_index([mesh.coord[a] for a in axes],
                                         sizes))
        n = x.shape[i] // int(np.prod(sizes))
        x = x[(slice(None),) * i + (slice(index * n, (index + 1) * n),)]
    return x


def reshard(tree, mesh, spec_tree):
    """Each rank's local block of every leaf of `tree` under (mesh, spec).

    Every rank holds the whole leaf (a restored checkpoint), so the blocks
    are cut locally by this rank's mesh coordinates, with no collective.
    """
    if mesh.coord is None:
        raise ValueError(f"this rank is not in {mesh}")
    if _is_leaf(tree):
        return _block(tree, mesh, spec_tree)
    if isinstance(tree, dict):
        return {k: reshard(tree[k], mesh, spec_tree[k]) for k in tree}
    return type(tree)(reshard(x, mesh, s) for x, s in zip(tree, spec_tree))


def plan_rescale(shape_tree, spec_tree, mesh) -> list[str]:
    """Return a list of violations (empty = the rescale is legal)."""
    problems: list[str] = []

    def visit(path, shape, spec):
        dims = tuple(spec) if spec is not None else ()
        for i, ax in enumerate(dims):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            total = int(np.prod([mesh.shape[a] for a in axes]))
            if i >= len(shape) or shape[i] % total:
                problems.append(
                    f"{path}: dim {i} of {shape} not divisible by {ax}={total}")

    def walk(path, shapes, specs):
        if isinstance(shapes, dict):
            for k in shapes:
                walk(f"{path}/{k}", shapes[k], specs[k])
        elif isinstance(shapes, (list, tuple)):
            for i, (sh, sp) in enumerate(zip(shapes, specs)):
                walk(f"{path}[{i}]", sh, sp)
        else:
            visit(path, tuple(shapes.shape) if hasattr(shapes, "shape")
                  else shapes, specs)

    walk("", shapes=shape_tree, specs=spec_tree)
    return problems


__all__ = ["reshard", "plan_rescale", "abstract_target_mesh"]
