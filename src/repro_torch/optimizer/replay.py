"""Batched BO search lanes, every lane advanced a round at a time.

The port of ``repro/optimizer/replay.py``. Replays many CherryPick/
Arrow-style configuration searches (paper §IV-D) in parallel: every
*lane* is one (workload, seed, tuner variant, fleet condition) scenario
over the same candidate grid; one round advances every still-active
lane by one BO step (masked GP fit on the lane's evaluated set, EI +
optional Perona weighting, stopping rules, argmax selection). Where the
reference scans a ``vmap``-ed step, the port runs the
``max_runs - n_init`` rounds as a Python loop of batched float64 tensor
ops over the lane axis, with no read back to the host between rounds:
:class:`PendingReplay` holds the device tensors and its ``result()``
makes the one fetch. Lanes and observation slots are pow2-padded
(``common.mesh.shard_size``), so replays of similar matrices share a
signature (``REPLAY_TRACES`` counts distinct signatures, the
reference's tracings).

Pass ``devices=`` to split the lane axis into equal contiguous parts,
one a device (the pow2 prefix of the list, as ``fleet/shard.py::
ShardedScorer`` splits requests): each round is enqueued on every
device before the next, and the parts are gathered in lane order at the
fetch. ``device=`` places all lanes on one device. Lanes never
interact, so a split is bit for bit the one-device replay.

Host tables reach the card as non-blocking copies from pinned memory,
so nothing from the first copy to the fetch waits for the device.

All math runs in float64, and selection is on float32-rounded EI with
first-index argmax (``tuning/cherrypick.py``), so lanes reproduce the
sequential numpy traces: same evaluated configs, same best-valid-cost
curves (see tests/test_torch_optimizer.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.mesh import pad_lanes, pow2_devices, shard_size
from repro_torch.common.rng import lognormal_noise_grid
from repro_torch.obs.dispatch import DispatchSite
from repro_torch.optimizer.acquire import (expected_improvement,
                                           perona_weight_factors)
from repro_torch.optimizer.gp import gp_fit, gp_predict

#: Distinct replay signatures run (the reference's tracings), with the
#: dispatch calls and their wall time (``obs.dispatch``).
REPLAY_TRACES = DispatchSite("optimizer.replay")


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Search hyperparameters, matching the sequential defaults
    (``CherryPick.__init__`` / ``GP`` / ``PeronaAcquisitionWeighter``)."""

    max_runs: int = 9
    n_init: int = 3
    ei_threshold: float = 0.1
    noise: float = 1e-3
    xi: float = 0.01
    strength: float = 0.3
    per_dollar: bool = True


@dataclasses.dataclass
class LaneTables:
    """Per-lane constant tables (numpy, lane-stacked; L lanes over a
    shared candidate grid of C configurations, feature dim D)."""

    x_train: np.ndarray  # (L, C, D) GP features of *evaluated* configs
    x_cand: np.ndarray  # (L, C, D) GP features of candidates (Arrow's
    #                      imputation quirk makes these differ, see
    #                      scenarios.lane_tables)
    y: np.ndarray  # (L, C) constraint-penalized objective
    runtime: np.ndarray  # (L, C) runtimes (constraint checks)
    cost: np.ndarray  # (L, C) raw execution cost (trace reporting)
    limit: np.ndarray  # (L,) runtime constraint
    price: np.ndarray  # (L, C) $/h of the candidate's machine type
    norm_scores: np.ndarray  # (L, C, 4) normalized fingerprint scores
    util_low: np.ndarray  # (L, C, 4) per-run utilization metrics
    use_weighter: np.ndarray  # (L,) Perona-weighted lane flag
    init_idx: np.ndarray  # (L, n_init) seeded init draws

    def __len__(self) -> int:
        return len(self.y)


@dataclasses.dataclass
class BatchReplayResult:
    chosen: np.ndarray  # (L, max_runs) evaluated config indices, -1 pad
    count: np.ndarray  # (L,) evaluations performed per lane
    dispatches: int  # dispatches of this replay (always 1)


@dataclasses.dataclass
class SeededLaneSpec:
    """Seeded replay inputs: O(W*C + K*C + L) instead of the O(L*C*D)
    materialized :class:`LaneTables`.

    The shared grid tables (deterministic, workload/config/condition
    indexed) go to every device; the per-lane arrays are just ids + the
    runtime limit + seeded init draws. The replay re-derives every
    stochastic table cell on the device from ``noise_key``
    (counter-based ``fold_in(key, workload_id, config_uid)`` draws, see
    ``common.rng``): on the dataset's device, bit for bit the host
    grid — lane tables are never materialized on the host.

    ``runtime``/``cost`` are the host copies of the (W, C) grids used
    only to materialize traces after the fetch; they are not shipped
    to the device."""

    # shared grid tables (copied to every device)
    base_runtime: np.ndarray  # (W, C) noise-free runtime component
    low_num: np.ndarray  # (W, C, 4) utilization-metric numerators
    low_caps: np.ndarray  # (4,) utilization metric caps
    x_base: np.ndarray  # (C, B) base feature block
    price: np.ndarray  # (C,) USD/h per candidate
    count: np.ndarray  # (C,) node counts
    config_uid: np.ndarray  # (C,) fold-in uids (noise counters)
    norm_scores: np.ndarray  # (K, C, 4) per-condition weighter scores
    fp_low: np.ndarray  # (K, C, 4) per-condition fingerprint features
    noise_key: np.ndarray  # (2,) uint32 contention stream key
    noise_scale: float  # lognormal noise scale
    # per-lane (split over devices)
    workload_id: np.ndarray  # (L,) int32
    condition_id: np.ndarray  # (L,) int32 row into norm_scores/fp_low
    variant_id: np.ndarray  # (L,) int32 index into scenarios.VARIANTS
    limit: np.ndarray  # (L,) runtime constraint
    init_idx: np.ndarray  # (L, n_init) seeded init draws
    # host-only trace tables
    runtime: np.ndarray  # (W, C)
    cost: np.ndarray  # (W, C)

    def __len__(self) -> int:
        return len(self.workload_id)


def selection_scores(sel, count, tables, *, cfg: ReplayConfig,
                     slots: int):
    """Every lane's float32-rounded selection scores for its next pick
    (``-inf`` on evaluated configurations) and its best observed
    objective: the GP fit on the evaluated set, EI and the optional
    Perona weighting. ``sel`` (L, max_runs), ``count`` (L,);
    ``tables`` as :data:`TABLE_NAMES`."""
    xt, xc, y_tab, r_tab, ulow, ns, price, limit, use_w = tables
    n_lanes, n_cand = y_tab.shape
    dev = y_tab.device
    idx = torch.clamp(sel, min=0)
    runs = torch.arange(cfg.max_runs, device=dev)
    omask = runs[None, :] < count[:, None]
    # pad the observation axis to the pow2 slot count
    idx_p = torch.zeros((n_lanes, slots), dtype=idx.dtype, device=dev)
    idx_p[:, :cfg.max_runs] = idx
    mask_p = torch.arange(slots, device=dev)[None, :] < count[:, None]

    lane = torch.arange(n_lanes, device=dev)[:, None]
    x_obs = xt[lane, idx_p]
    y_obs = y_tab[lane, idx_p]
    state = gp_fit(x_obs, y_obs, mask_p, noise=cfg.noise,
                   median_rows=cfg.max_runs)
    mu, sigma = gp_predict(state, xc)
    best = torch.where(mask_p, y_obs,
                       torch.full_like(y_obs, np.inf)).min(-1).values
    ei = expected_improvement(mu, sigma, best[:, None], xi=cfg.xi)

    low_obs = ulow[lane, idx_p]
    util = (torch.where(mask_p[..., None], low_obs,
                        torch.zeros_like(low_obs)).sum(1)
            / count[:, None].to(low_obs.dtype))
    any_valid = (mask_p & (r_tab[lane, idx_p] <= limit[:, None])).any(-1)
    factor = perona_weight_factors(util, ns, price, any_valid,
                                   strength=cfg.strength,
                                   per_dollar=cfg.per_dollar)
    ei = torch.where(use_w[:, None], ei * factor, ei)

    seen = torch.zeros((n_lanes, n_cand), dtype=torch.int32, device=dev)
    seen = seen.scatter_add(1, idx, omask.to(torch.int32)) > 0
    ei = torch.where(seen, torch.full_like(ei, -np.inf), ei)
    # float32-rounded selection grid, shared with the sequential
    # reference (see CherryPick.search): deterministic tie-breaks on
    # ulp-close candidates regardless of backend rounding
    return ei.to(torch.float32).to(torch.float64), best


def _round(sel, count, active, tables, *, cfg: ReplayConfig, slots: int):
    """One BO round of every lane (the reference's vmapped
    ``_lane_step``): score, stop or pick the first maximum."""
    ei, best = selection_scores(sel, count, tables, cfg=cfg, slots=slots)
    mx = ei.max(-1).values
    stop_flat = mx <= 0.0
    stop_converged = ((mx / torch.clamp(best, min=1e-9) < cfg.ei_threshold)
                      & (count >= cfg.n_init + 2))
    advance = active & ~stop_flat & ~stop_converged
    pick = torch.argmax(ei, dim=-1).to(sel.dtype)  # first maximum
    at = count[:, None].to(torch.int64)
    old = sel.gather(1, at)[:, 0]
    sel = sel.scatter(1, at, torch.where(advance, pick, old)[:, None])
    count = count + advance.to(count.dtype)
    return sel, count, advance


#: Table order of a replay's rounds (:class:`LaneTables` fields).
TABLE_NAMES = ("x_train", "x_cand", "y", "runtime", "util_low",
               "norm_scores", "price", "limit", "use_weighter")


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to the card as a non-blocking copy
    from pinned memory, so the host does not wait for the device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _lane_devices(devices, device) -> List[torch.device]:
    """The devices the lane axis is split over: the pow2 prefix of
    ``devices``, else ``[device]`` (default: the card)."""
    if devices is not None and device is not None:
        raise ValueError("pass either devices= (a lane split) or "
                         "device= (placement), not both")
    if devices is None:
        return [resolve_device("cuda" if device is None else device)]
    devices = pow2_devices(devices)
    if not devices:
        raise ValueError("devices= needs at least one device")
    return [resolve_device(d) for d in devices]


def _init_carry(init_idx, lanes, cfg, device):
    sel0 = np.full((lanes, cfg.max_runs), -1, np.int64)
    sel0[:, :cfg.n_init] = init_idx
    return (_to_device(sel0, device),
            torch.full((lanes,), cfg.n_init, dtype=torch.int64,
                       device=device),
            torch.ones(lanes, dtype=torch.bool, device=device))


@dataclasses.dataclass
class PendingReplay:
    """An enqueued but not fetched replay: ``parts`` hold each device's
    ``(sel, count)`` tensors; :meth:`result` copies them to the host
    (the one point at which the host waits for the device)."""

    n_lanes: int
    dispatches: int
    parts: list

    def result(self) -> BatchReplayResult:
        sel = np.concatenate([s.cpu().numpy() for s, _ in self.parts])
        count = np.concatenate([c.cpu().numpy() for _, c in self.parts])
        return BatchReplayResult(
            chosen=sel[: self.n_lanes].astype(np.int32),
            count=count[: self.n_lanes].astype(np.int32),
            dispatches=self.dispatches)


def _run_rounds(parts, cfg: ReplayConfig, slots: int) -> list:
    """Every round on every part, each round enqueued on all devices
    before the next; no value is read back."""
    carries = [carry for carry, _ in parts]
    for _ in range(cfg.max_runs - cfg.n_init):
        for i, (_, tables) in enumerate(parts):
            carries[i] = _round(*carries[i], tables, cfg=cfg, slots=slots)
    return [(sel, count) for sel, count, _ in carries]


def _empty(cfg: ReplayConfig) -> PendingReplay:
    return PendingReplay(n_lanes=0, dispatches=0, parts=[
        (torch.zeros((0, cfg.max_runs), dtype=torch.int64),
         torch.zeros(0, dtype=torch.int64))])


def replay_async(tables: LaneTables,
                 cfg: Optional[ReplayConfig] = None, *,
                 devices: Optional[Sequence] = None,
                 device=None,
                 lanes_floor: int = 1) -> PendingReplay:
    """Enqueue every lane's full search and return without waiting for
    the device.

    ``devices``: split the lane axis over these devices (pow2 prefix).
    ``device``: place all lanes on that device (default: the card) —
    ``scenarios.replay_pipelined`` round-robins lane blocks over the
    devices this way. ``lanes_floor``: minimum padded lane-bucket size
    (a power of two) — fixed-size lane blocks let differing matrix
    sizes share one signature.
    """
    cfg = ReplayConfig() if cfg is None else cfg
    devs = _lane_devices(devices, device)
    n_lanes = len(tables)
    if n_lanes == 0:
        return _empty(cfg)
    lanes = shard_size(n_lanes, len(devs), floor=lanes_floor)
    slots = shard_size(cfg.max_runs)
    n_cand, dim = tables.x_train.shape[1:]
    per = lanes // len(devs)

    # pad the lane axis by repeating lane 0 (masked out)
    host = tuple(pad_lanes(np.asarray(getattr(tables, name),
                                      bool if name == "use_weighter"
                                      else np.float64), lanes)
                 for name in TABLE_NAMES)
    init = pad_lanes(tables.init_idx, lanes)
    sig = ("tables", cfg, lanes, slots, n_cand, dim, tuple(devs))
    with REPLAY_TRACES.dispatch(sig, "replay.dispatch",
                                args={"lanes": n_lanes, "padded": lanes}):
        parts = []
        for d, dev in enumerate(devs):
            rows = slice(d * per, (d + 1) * per)
            parts.append((_init_carry(init[rows], per, cfg, dev),
                          tuple(_to_device(a[rows], dev) for a in host)))
        out = _run_rounds(parts, cfg, slots)
    return PendingReplay(n_lanes=n_lanes, dispatches=1, parts=out)


def replay(tables: LaneTables,
           cfg: Optional[ReplayConfig] = None, *,
           devices: Optional[Sequence] = None, device=None,
           lanes_floor: int = 1) -> BatchReplayResult:
    """Run every lane's full search (split over ``devices`` when given)
    and fetch the result."""
    return replay_async(tables, cfg, devices=devices, device=device,
                        lanes_floor=lanes_floor).result()


def expand_seeded(grid, lane_args, noise_scale: float):
    """The lane tables of a seeded replay, on the device of its inputs:
    the contention noise re-drawn from counter-based keys over the
    whole (W, C) grid (``common.rng.lognormal_noise_grid``, the call the
    dataset makes, so the same bits on the same device), then every
    derived table in the op order of ``tuning.scout._build_grid`` /
    ``scenarios.lane_tables``. ``grid`` and ``lane_args`` as
    :func:`seeded_inputs` returns them; returns the tables in
    :data:`TABLE_NAMES` order."""
    (base, low_num, low_caps, x_base, price, count, uid, ns, fp,
     noise_key) = grid
    wid, cid, vid, limit = lane_args
    noise = lognormal_noise_grid(noise_key, base.shape[0], uid,
                                 noise_scale, base.device)
    # one multiply for runtime, left-to-right cost chain, capped
    # utilization ratios; the hour as a device tensor, since CUDA
    # divides by a host scalar as a multiply by its reciprocal
    rt = base[wid] * noise[wid]
    hour = torch.full((), 3600.0, dtype=rt.dtype, device=rt.device)
    cost = rt / hour * price * count
    y = torch.where(rt <= limit[:, None], cost, cost * 5.0)
    rtm = torch.clamp(rt, min=1e-6)
    denom = torch.stack([rtm, torch.ones_like(rtm), rtm, rtm], dim=-1)
    lows = torch.minimum(low_caps, low_num[wid] / denom)
    zeros = torch.zeros_like(lows)
    # variant feature blocks (scenarios.VARIANTS order): arrow trains
    # on observed lows (candidates imputed to zero), arrow+perona uses
    # the fingerprint lows on both sides
    v = vid[:, None, None]
    low_train = torch.where(v == 2, lows,
                            torch.where(v == 3, fp[cid], zeros))
    low_cand = torch.where(v == 3, fp[cid], zeros)
    xb = x_base.expand(len(wid), -1, -1)
    xt = torch.cat([xb, low_train], dim=-1)
    xc = torch.cat([xb, low_cand], dim=-1)
    return (xt, xc, y, rt, lows, ns[cid], price.expand_as(rt), limit,
            (vid % 2) == 1)


def seeded_inputs(spec: SeededLaneSpec, device, *,
                  lanes: Optional[int] = None,
                  n_conds: Optional[int] = None, rows=slice(None)):
    """``spec``'s shared grid tables and the per-lane arrays of
    ``rows`` (after padding the lane axis to ``lanes`` by repeating
    lane 0 and the condition axis to ``n_conds`` with zeros) as tensors
    on ``device``, in :func:`expand_seeded`'s order."""
    device = torch.device(device)
    lanes = len(spec) if lanes is None else lanes
    ns, fp = spec.norm_scores, spec.fp_low
    extra = (len(ns) if n_conds is None else n_conds) - len(ns)
    if extra > 0:
        ns = np.concatenate([ns, np.zeros((extra,) + ns.shape[1:])], 0)
        fp = np.concatenate([fp, np.zeros((extra,) + fp.shape[1:])], 0)
    grid = (spec.base_runtime, spec.low_num, spec.low_caps, spec.x_base,
            spec.price, spec.count, spec.config_uid.astype(np.int64), ns,
            fp, np.asarray(spec.noise_key, np.uint32).astype(np.int64))
    lane = (spec.workload_id.astype(np.int64),
            spec.condition_id.astype(np.int64),
            spec.variant_id.astype(np.int64), spec.limit)
    return (tuple(_to_device(np.asarray(a, np.float64)
                             if a.dtype.kind == "f" else a, device)
                  for a in grid),
            tuple(_to_device(pad_lanes(np.asarray(a, np.float64)
                                       if a.dtype.kind == "f" else a,
                                       lanes)[rows], device)
                  for a in lane))


def replay_seeded_async(spec: SeededLaneSpec,
                        cfg: Optional[ReplayConfig] = None, *,
                        devices: Optional[Sequence] = None,
                        device=None,
                        lanes_floor: int = 1) -> PendingReplay:
    """Enqueue a seeded replay: lane tables are generated on the device
    from ``spec``'s grid + per-lane ids (:func:`expand_seeded`), so the
    host ships O(W*C + K*C + L) arrays instead of the O(L*C*D)
    :class:`LaneTables`. Options mirror :func:`replay_async`.

    The condition axis is pow2-padded so matrices with different
    condition counts share one signature."""
    cfg = ReplayConfig() if cfg is None else cfg
    devs = _lane_devices(devices, device)
    n_lanes = len(spec)
    if n_lanes == 0:
        return _empty(cfg)
    lanes = shard_size(n_lanes, len(devs), floor=lanes_floor)
    slots = shard_size(cfg.max_runs)
    n_cand, base_dim = spec.x_base.shape
    n_workloads = spec.base_runtime.shape[0]
    n_conds = shard_size(len(spec.norm_scores))
    per = lanes // len(devs)
    init = pad_lanes(spec.init_idx, lanes)
    sig = ("seeded", cfg, lanes, slots, n_cand, base_dim, n_workloads,
           n_conds, tuple(devs))
    with REPLAY_TRACES.dispatch(sig, "replay.dispatch_seeded",
                                args={"lanes": n_lanes, "padded": lanes}):
        parts = []
        for d, dev in enumerate(devs):
            rows = slice(d * per, (d + 1) * per)
            grid, lane_args = seeded_inputs(spec, dev, lanes=lanes,
                                            n_conds=n_conds, rows=rows)
            parts.append((_init_carry(init[rows], per, cfg, dev),
                          expand_seeded(grid, lane_args,
                                        float(spec.noise_scale))))
        out = _run_rounds(parts, cfg, slots)
    return PendingReplay(n_lanes=n_lanes, dispatches=1, parts=out)


def replay_seeded(spec: SeededLaneSpec,
                  cfg: Optional[ReplayConfig] = None, *,
                  devices: Optional[Sequence] = None, device=None,
                  lanes_floor: int = 1) -> BatchReplayResult:
    """Run a seeded replay (tables generated on the device) and fetch."""
    return replay_seeded_async(spec, cfg, devices=devices, device=device,
                               lanes_floor=lanes_floor).result()


def traces_from_result(tables: LaneTables, result: BatchReplayResult,
                       configs) -> List["SearchTrace"]:
    """Materialize per-lane :class:`tuning.cherrypick.SearchTrace`
    objects (identical field-for-field to the sequential traces when
    the lane reproduced the sequential decisions), vectorized across
    lanes (one gather + running-min per field)."""
    n = len(tables)
    if n == 0:
        return []
    picks_all = result.chosen[:n]
    idx = np.maximum(picks_all, 0)
    costs_all = np.take_along_axis(tables.cost, idx, axis=1)
    runtimes_all = np.take_along_axis(tables.runtime, idx, axis=1)
    return _materialize_traces(picks_all, result.count[:n], costs_all,
                               runtimes_all, tables.limit[:n], configs)


def traces_from_spec(spec: SeededLaneSpec, result: BatchReplayResult,
                     configs) -> List["SearchTrace"]:
    """Materialize seeded-replay traces: per-lane costs/runtimes are
    gathered from the spec's host-side (W, C) grid tables via the
    lane's workload row — no per-lane tables needed."""
    n = len(spec)
    if n == 0:
        return []
    picks_all = result.chosen[:n]
    idx = np.maximum(picks_all, 0)
    wid = spec.workload_id[:n, None]
    costs_all = spec.cost[wid, idx]
    runtimes_all = spec.runtime[wid, idx]
    return _materialize_traces(picks_all, result.count[:n], costs_all,
                               runtimes_all, spec.limit[:n], configs)


def _materialize_traces(picks_all, counts, costs_all, runtimes_all,
                        limits, configs) -> List["SearchTrace"]:
    from repro_torch.tuning.cherrypick import SearchTrace

    valid = runtimes_all <= limits[:, None]
    # running min over valid runs only; lanes with no valid run yet
    # stay at +inf (the sequential bookkeeping)
    best_all = np.minimum.accumulate(
        np.where(valid, costs_all, np.inf), axis=1)

    out = []
    for lane in range(len(counts)):
        k = int(counts[lane])
        out.append(SearchTrace(
            evaluated=[configs[int(i)] for i in picks_all[lane, :k]],
            costs=costs_all[lane, :k].tolist(),
            runtimes=runtimes_all[lane, :k].tolist(),
            best_valid_cost=best_all[lane, :k].tolist(),
            search_cost=float(np.sum(costs_all[lane, :k]))))
    return out
