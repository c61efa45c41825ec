"""Arithmetic over parameter trees, in the reference's leaf order.

The port keeps parameters as ``{state_dict name: tensor}`` dicts
(``enc.0.w``) or, for the LMs, as the reference's nested tree of dicts
and lists. :func:`flatten` names every leaf of either by its dot-joined
path, :func:`unflatten_as` puts named leaves back into a tree's
structure (empty nodes included), and :func:`leaf_order` sorts names in
the order JAX flattens the nested tree they name (dict keys sorted,
list items in index order), so a sum over leaves is taken in the
reference's order (``repro/common/tree.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch


def _path_key(name: str):
    # siblings are all list indices or all dict keys, so ints and strs
    # are never compared with each other
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def leaf_order(names) -> List[str]:
    """``names`` in the order JAX flattens the nested tree they name."""
    return sorted(names, key=_path_key)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every leaf of a tree of dicts, lists and tuples under its
    dot-joined path; a flat ``{name: tensor}`` dict keeps its names."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_as(template, flat: Dict[str, Any], prefix: str = ""):
    """The leaves of ``flat`` (names of :func:`flatten`) in the structure
    of ``template``."""
    if isinstance(template, dict):
        return {k: unflatten_as(v, flat, f"{prefix}.{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unflatten_as(v, flat, f"{prefix}.{i}" if prefix else str(i))
                for i, v in enumerate(template)]
    return flat[prefix]


def tree_global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in the reference's order (``repro/common/tree.py:29-34``)."""
    flat = flatten(tree)
    names = leaf_order(flat)
    if not names:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(flat[k].to(torch.float32)))
             for k in names)
    return torch.sqrt(sq)


def tree_cast(tree, dtype: torch.dtype):
    """Every floating leaf cast to ``dtype``, the rest as it is
    (``repro/common/tree.py::tree_cast``); differentiable."""
    return unflatten_as(tree, {k: t.to(dtype) if t.is_floating_point()
                               else t for k, t in flatten(tree).items()})
