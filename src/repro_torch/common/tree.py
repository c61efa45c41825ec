"""Arithmetic over parameter dicts, in the reference's leaf order.

The port keeps parameters as ``{state_dict name: tensor}`` dicts
(``enc.0.w``). The reference's helpers (``repro/common/tree.py``) walk a
nested pytree, whose leaves JAX flattens with dict keys sorted and list
items in index order; :func:`leaf_order` gives the same order for the
dot-joined names, so a sum over leaves is taken in the same order.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _path_key(name: str):
    # siblings are all list indices or all dict keys, so ints and strs
    # are never compared with each other
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def leaf_order(names) -> List[str]:
    """``names`` in the order JAX flattens the nested tree they name."""
    return sorted(names, key=_path_key)


def tree_global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in the reference's order (``repro/common/tree.py:29-34``)."""
    names = leaf_order(tree)
    if not names:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(torch.sum(torch.square(tree[k].to(torch.float32)))
             for k in names)
    return torch.sqrt(sq)
