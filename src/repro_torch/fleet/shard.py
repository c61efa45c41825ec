"""Fleet scoring of a stacked request batch as one flat graph.

A fleet re-fingerprinting round is a stack of *independent* per-node
scoring requests (paper §III-C scores each execution only against the
predecessors of its own (node x benchmark type) chain, so request
graphs never cross). The reference (``repro/fleet/shard.py``) runs
``shard_map(vmap(make_score_fn))`` over a 1-D device mesh. The port
scores a stacked ``(R, bucket, ...)`` batch on a card as ONE graph of
``R x bucket`` nodes through the engine's scoring function
(``serving.engine.make_score_fn``): each stacked array is viewed as
``(R * bucket, ...)``, request ``r``'s predecessor indices ``nbr >= 0``
move by ``r * bucket`` (``-1``, no predecessor, stays), the scoring
function runs once, and its outputs are viewed back as
``(R, bucket, ...)``.

That is exact in arithmetic: nothing in ``core/model.py`` reduces
across nodes (``_transformer_conv`` and ``_tag_conv`` read only a
node's own ``nbr`` rows, and the edge-softmax kernel takes every node
on its own), so a node's outputs depend on its own request alone. One
dispatch of ``R x bucket`` nodes keeps the card's kernels wide where
``R`` dispatches of one request each would be launch-bound.

With several devices the request axis is split into equal contiguous
shards, one call per device, launched before any is read back and
gathered in request order; the outputs do not depend on the split.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.mesh import shard_size
from repro_torch.core.model import PeronaModel
from repro_torch.core.preprocess import Preprocessor
from repro_torch.obs.dispatch import DispatchSite, instance_site
from repro_torch.serving.engine import (ARG_NAMES, device_params,
                                        make_score_fn)


class ShardedScorer:
    """Stacked requests scored as one flat graph per device."""

    def __init__(self, model: PeronaModel, preproc: Preprocessor,
                 devices: Optional[Sequence] = None):
        devices = ["cuda"] if devices is None else list(devices)
        if not devices:
            raise ValueError("ShardedScorer needs at least one device")
        # the largest power-of-two prefix: pow2-padded request axes
        # then split evenly (the reference's pow2_devices)
        devices = devices[:1 << (len(devices).bit_length() - 1)]
        self.devices: List[torch.device] = [resolve_device(d)
                                            for d in devices]
        self.n_devices = len(self.devices)
        self.model = model.eval()
        self._fns = {dev: make_score_fn(self.model, preproc, dev)
                     for dev in set(self.devices)}
        # per-instance dispatch accounting on the obs registry
        self.site = DispatchSite(instance_site("fleet.scorer"))

    @property
    def trace_count(self) -> int:
        """Distinct (R, bucket) shapes scored so far (the reference's
        jit tracings)."""
        return self.site.count

    def pad_requests(self, n_requests: int) -> int:
        """Power-of-two request-axis size, divisible by the device
        count."""
        return shard_size(n_requests, self.n_devices)

    def to_device(self, stack: Dict[str, np.ndarray], lo: int, hi: int,
                  device: torch.device) -> List[torch.Tensor]:
        """Requests ``lo:hi`` of ``stack`` as flat ``(R * bucket, ...)``
        tensors on ``device``, in ARG_NAMES order, with each request's
        predecessor indices offset to its rows of the flat graph."""
        args = []
        for k in ARG_NAMES:
            a = stack[k][lo:hi]
            flat = a.reshape((-1,) + a.shape[2:])
            args.append(torch.from_numpy(flat).to(device))
        r, bucket = hi - lo, stack[ARG_NAMES[0]].shape[1]
        i = ARG_NAMES.index("nbr")
        nbr = args[i]
        offset = (torch.arange(r, dtype=nbr.dtype, device=device)
                  * bucket).repeat_interleave(bucket)[:, None]
        args[i] = torch.where(nbr >= 0, nbr + offset, nbr)
        return args

    def forward(self, params, args: Sequence[torch.Tensor],
                device: torch.device) -> Dict[str, torch.Tensor]:
        """One call of the scoring function on the flat graph (queued on
        ``device``; nothing is read back)."""
        return self._fns[device](device_params(self.model, params, device),
                                 *args)

    @staticmethod
    def to_host(out: Dict[str, torch.Tensor], r: int
                ) -> Dict[str, np.ndarray]:
        """Flat outputs back on the host as ``(r, bucket, ...)``."""
        return {k: v.cpu().numpy().reshape((r, -1) + v.shape[1:])
                for k, v in out.items()}

    def score_stack(self, params, stack: Dict[str, np.ndarray]
                    ) -> Dict[str, np.ndarray]:
        """Score a stacked request batch: every array in ``stack`` has
        leading axis R (a multiple of the device count; see
        :meth:`pad_requests`) then the per-request padded row bucket.
        ``params``: the reference's nested tree or ``state_dict`` names.
        Returns numpy outputs with the same leading axes."""
        r, bucket = stack[ARG_NAMES[0]].shape[:2]
        if r % self.n_devices:
            raise ValueError(
                f"request axis {r} not divisible by the "
                f"{self.n_devices} devices; pad with pad_requests() first")
        per = r // self.n_devices
        with torch.inference_mode(), self.site.dispatch(
                (r, bucket), "fleet.score_stack",
                args={"requests": r, "bucket": bucket}):
            outs = [self.forward(params,
                                 self.to_device(stack, i * per,
                                                (i + 1) * per, dev), dev)
                    for i, dev in enumerate(self.devices)]
            host = [self.to_host(out, per) for out in outs]
        return {k: np.concatenate([h[k] for h in host]) for k in host[0]}
