"""Per-leaf comm planning, PyTorch port of ``src/repro/core/leafwise.py``.

Parameter trees are nested dicts. Leaves are visited in sorted-key order,
the order ``jax.tree.flatten`` uses for dicts, so leaf ``i`` of the port
is leaf ``i`` of the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import compressor as C
from repro_torch.core import onebit_allreduce as AR
from repro_torch.core.comm import Hierarchy, norm_hierarchy


def _visit(node, prefix, paths, leaves):
    if isinstance(node, dict):
        for k in sorted(node):
            _visit(node[k], prefix + (k,), paths, leaves)
    else:
        paths.append(prefix)
        leaves.append(node)


def flatten_tree(tree) -> Tuple[List[Tuple[str, ...]], List[Any]]:
    """Nested dict -> (key paths, leaves) in sorted-key order. (A module
    function, not a recursive closure: a closure that calls itself is a
    reference cycle, which would hold the leaves, a step's gradients
    among them, until the cyclic garbage collector runs.)"""
    paths, leaves = [], []
    _visit(tree, (), paths, leaves)
    return paths, leaves


def unflatten_tree(paths, leaves) -> Dict:
    out: Dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def clone_tree(tree) -> Dict:
    """A nested dict of tensors with storage of its own (the optimizer
    updates params in place)."""
    paths, leaves = flatten_tree(tree)
    return unflatten_tree(paths, [x.clone() for x in leaves])


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Static per-leaf communication plan for one parameter tree."""

    n: int
    hierarchy: Optional[Hierarchy]   # normalized (None: flat or n == 1)
    paths: List[Tuple[str, ...]]
    shapes: List[Tuple[int, ...]]
    specs: List[Any]
    dp_mask: List[bool]
    layouts: List[C.LeafLayout]

    def flat(self, tree) -> List[Any]:
        paths, leaves = flatten_tree(tree)
        if paths != self.paths:
            raise ValueError(f"tree leaves {paths} do not match the plan's "
                             f"{self.paths}")
        return leaves


def make_plan(param_shapes, specs, dp_mask, n_workers: int,
              hierarchy: Optional[Hierarchy] = None) -> LeafPlan:
    """``param_shapes``: nested dict of shape tuples; ``specs`` and
    ``dp_mask`` the same structure (None: replicated / all DP). The
    hierarchy is normalized here and nowhere else on the optimizer side:
    every consumer reads ``plan.hierarchy``."""
    hierarchy = norm_hierarchy(hierarchy, n_workers)
    paths, shapes = flatten_tree(param_shapes)
    specs_f = ([None] * len(paths) if specs is None
               else flatten_tree(specs)[1])
    dp_f = ([True] * len(paths) if dp_mask is None
            else flatten_tree(dp_mask)[1])
    layouts = [C.make_layout(s, sp, n_workers,
                             n_inner=hierarchy.inner if hierarchy else 1)
               for s, sp in zip(shapes, specs_f)]
    return LeafPlan(n=n_workers, hierarchy=hierarchy, paths=paths,
                    shapes=[tuple(s) for s in shapes], specs=specs_f,
                    dp_mask=list(dp_f), layouts=layouts)


def make_ar_cfg(plan: LeafPlan, *, scale_mode, codec,
                comm_dtype) -> AR.OneBitConfig:
    """Algorithm-2 exchange config bound to a plan's topology."""
    return AR.OneBitConfig(scale_mode=scale_mode, codec=codec,
                           hierarchy=plan.hierarchy, comm_dtype=comm_dtype)
