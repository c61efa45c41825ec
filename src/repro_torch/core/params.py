"""Parameters carried across from the JAX package.

The reference keeps Perona's parameters as a pytree of nested dicts and
lists (``repro.core.model.perona_init``); its checkpoints
(``repro/checkpointing/manager.py``) store one ``step_<n>.npz`` with
every leaf under its slash-joined path (``enc/0/w``, ``tag/2/b``,
``cls/w``). The port reads either form and hands back the same tree of
float32 tensors; :func:`flat_params` gives the ``state_dict`` names of
``core.model.PeronaModel`` (the same paths, joined with dots).
The port never reproduces ``jax.random`` initialisation.

:func:`load_golden` reads ``assets/perona_paper_golden.npz``: the
configuration, trained parameters, preprocessor statistics and scoring
outputs of the JAX package's §IV-C model (written by
``tests/test_torch_golden.py --write``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.model import PeronaConfig
from repro_torch.core.preprocess import Preprocessor

GOLDEN_PATH = (Path(__file__).resolve().parents[1] / "assets"
               / "perona_paper_golden.npz")


def params_from_numpy(tree) -> Any:
    """A parameter pytree of numpy arrays (nested dicts and lists, as
    ``jax.tree_util.tree_map(np.asarray, params)`` gives it) -> the same
    tree of float32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


def flat_params(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tree as ``{"enc.0.w": tensor, ...}``: ``PeronaModel``'s
    ``state_dict`` names."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: torch.as_tensor(tree)}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flat_params(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """Slash-joined leaf paths -> nested dicts, with all-digit levels
    turned back into lists (the reference's MLP and hop lists)."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def load_npz(path, prefix: str = "") -> Any:
    """Parameters from a reference checkpoint (``step_<n>.npz``); with
    ``prefix``, only the leaves under it (the golden file keeps them
    under ``params/``)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}
    if not flat:
        raise KeyError(f"no parameters under {prefix!r} in {path}")
    return params_from_numpy(unflatten(flat))


@dataclasses.dataclass
class Golden:
    config: PeronaConfig
    params: Any  # tree of float32 tensors
    preproc: Preprocessor  # the fitted statistics
    score: Dict[str, np.ndarray]  # the JAX engine's ScoreResult fields


def load_golden(path=GOLDEN_PATH) -> Golden:
    with np.load(path, allow_pickle=False) as z:
        fields = json.loads(str(z["config"]))
        fields["loss_weights"] = tuple(fields["loss_weights"])
        stats = {k[len("preproc/"):]: z[k] for k in z.files
                 if k.startswith("preproc/")}
        score = {k[len("score/"):]: z[k] for k in z.files
                 if k.startswith("score/")}
    pre = Preprocessor(
        feature_names=[str(s) for s in stats["feature_names"]],
        benchmark_types=[str(s) for s in stats["benchmark_types"]],
        maximize=stats["maximize"], lo=stats["lo"], hi=stats["hi"],
        fill_mean=stats["fill_mean"],
        raw_feature_count=int(stats["raw_feature_count"]),
        edge_lo=stats["edge_lo"], edge_hi=stats["edge_hi"],
        edge_names=[str(s) for s in stats["edge_names"]])
    return Golden(config=PeronaConfig(**fields),
                  params=load_npz(path, prefix="params/"),
                  preproc=pre, score=score)
