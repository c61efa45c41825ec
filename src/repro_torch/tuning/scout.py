"""Scout-like dataset simulator (paper §IV-D evaluation substrate).

The real scout dataset (github.com/oxhead/scout) holds 18 big-data
workloads x 69 AWS configurations (scaleout x VM type: m4/c4/r4 in
large/xlarge/2xlarge), one run each = 1242 executions. It is not
available offline, so we simulate it: every workload has latent resource
demands (cpu/mem/disk/network intensity + parallel fraction) and every
configuration has capabilities from the machine profiles; runtime
follows an Amdahl-style model with contention noise. Costs use
us-east-2 on-demand prices.

Every stochastic quantity is a *counter-based* draw (``common.rng``):
workload demand vectors are a pure function of ``fold_in(seed,
workload_id, param_id)`` and the contention noise of a (workload,
configuration) cell of ``fold_in(seed, workload_id, config_uid)``.
There is no sequential stream state, so results are independent of
call order and of which consumer (sequential tuner, batched lane
tables, the fused device replay program) asks first. The full grid is
materialized vectorized at construction; off-grid configurations fall
back to the same per-cell fold-in draw.

The port keeps the reference's numpy tables. Its counter-based draws
(the parameter grid, the noise grid and the off-grid noise) come from
``repro_torch.common.rng`` on the dataset's ``device``, with host copies
kept: one dataset draws every grid on one device, the device its
seeded replay runs on, so the seeded expansion there reproduces the
host tables bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.common.device import resolve_device
from repro_torch.common.rng import (STREAM_CONTENTION, STREAM_WORKLOAD_PARAMS,
                                    bounded_uniform_grid,
                                    lognormal_noise_grid, stream_key)
from repro_torch.fingerprint.machines import MACHINE_PROFILES

# USD/hour, AWS on-demand us-east-2 (Ohio)
PRICES = {
    "m4.large": 0.10, "m4.xlarge": 0.20, "m4.2xlarge": 0.40,
    "c4.large": 0.10, "c4.xlarge": 0.199, "c4.2xlarge": 0.398,
    "r4.large": 0.133, "r4.xlarge": 0.266, "r4.2xlarge": 0.532,
}
VM_TYPES = tuple(PRICES)
SCALEOUTS_BY_SIZE = {"large": (8, 10, 12), "xlarge": (4, 6, 8),
                     "2xlarge": (2, 3, 4)}

#: contention-noise scale: runtime = base * exp(scale * N(0, 1))
CONTENTION_SCALE = 0.06

#: clipping caps of the four low-level utilization metrics
#: (cpu, memory, disk, network) — shared with the device expansion
LOW_CAPS = (1.0, 1.5, 1.0, 1.0)

#: workload latent-demand parameters: (name, low, high) uniform bounds
PARAM_BOUNDS = (
    ("cpu_work", 2e6, 3e7),
    ("mem_need_gb", 2.0, 28.0),
    ("disk_work", 1e5, 4e6),
    ("net_work", 1e2, 4e3),
    ("parallel_frac", 0.75, 0.98),
)

_CORES = {"large": 2, "xlarge": 4, "2xlarge": 8}
_MEM_GB = {"large": 8, "xlarge": 16, "2xlarge": 32}


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    vm_type: str
    count: int

    @property
    def key(self) -> Tuple[str, int]:
        return (self.vm_type, self.count)


def config_uid(config: CloudConfig) -> int:
    """A stable integer uid for a configuration — the fold-in counter
    of its contention-noise draws. ``vm_type_index * 256 + count``
    stays collision-free for any realistic scaleout and is unchanged
    by extending the scaleout grid (new configs get new uids, existing
    draws keep theirs)."""
    return VM_TYPES.index(config.vm_type) * 256 + config.count


def _mem_gb(vm_type: str) -> int:
    size = vm_type.split(".")[1]
    mem = _MEM_GB[size]
    if "c4" in vm_type:
        mem //= 2
    if "r4" in vm_type:
        mem *= 2  # memory-optimized
    return mem


def all_configs() -> List[CloudConfig]:
    configs = []
    for vm in VM_TYPES:
        size = vm.split(".")[1]
        for c in SCALEOUTS_BY_SIZE[size]:
            configs.append(CloudConfig(vm, c))
    # 9 VM types x 3 scaleouts = 27; scout uses denser scaleout grids for
    # small sizes — extend to 69 configs (23 per family)
    extra = {"large": (4, 6, 14, 16, 18, 20), "xlarge": (2, 10, 12, 14),
             "2xlarge": (5, 6, 8, 10)}
    seen = {c.key for c in configs}
    for vm in VM_TYPES:
        size = vm.split(".")[1]
        for c in extra[size]:
            cc = CloudConfig(vm, c)
            if cc.key not in seen:
                configs.append(cc)
                seen.add(cc.key)
    configs.sort(key=lambda c: (c.vm_type, c.count))
    return configs


WORKLOAD_NAMES = [
    "spark-pagerank", "spark-kmeans", "spark-sql-join", "spark-sort",
    "spark-wordcount", "spark-lr", "spark-als", "spark-bayes",
    "spark-terasort", "hadoop-grep", "hadoop-wordcount", "hadoop-sort",
    "spark-svm", "spark-pca", "spark-fpgrowth", "spark-graphx-cc",
    "spark-streaming-agg", "spark-decision-tree",
]


@dataclasses.dataclass(frozen=True)
class ScoutGrid:
    """The fully materialized (workload x config) tables of one
    dataset, plus the deterministic inputs the device replay program
    needs to re-derive the stochastic parts in-program.

    ``runtime == base_runtime * noise`` where ``noise`` is drawn from
    the counter-based contention stream — the replay program receives
    ``base_runtime`` + ``noise_key`` and reproduces ``runtime`` (and
    everything downstream of it) bit-identically on device."""

    base_runtime: np.ndarray  # (W, C) noise-free runtime component
    runtime: np.ndarray  # (W, C) runtimes (seconds)
    cost: np.ndarray  # (W, C) execution cost (USD)
    low_num: np.ndarray  # (W, C, 4) utilization-metric numerators
    lows: np.ndarray  # (W, C, 4) low-level utilization metrics
    x_base: np.ndarray  # (C, 6) config feature vectors
    price: np.ndarray  # (C,) USD/h of the config's machine type
    count: np.ndarray  # (C,) node counts
    config_uid: np.ndarray  # (C,) fold-in uids of the grid configs
    noise_key: np.ndarray  # (2,) uint32 contention stream key


@dataclasses.dataclass
class ScoutDataset:
    seed: int = 0
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.configs = all_configs()
        params_key = stream_key(self.seed, STREAM_WORKLOAD_PARAMS)
        noise_key = stream_key(self.seed, STREAM_CONTENTION)
        lo = np.asarray([b[1] for b in PARAM_BOUNDS])
        hi = np.asarray([b[2] for b in PARAM_BOUNDS])
        params = bounded_uniform_grid(params_key, len(WORKLOAD_NAMES),
                                      lo, hi, self.device).cpu().numpy()
        self.workloads = {
            name: {PARAM_BOUNDS[p][0]: float(params[w, p])
                   for p in range(len(PARAM_BOUNDS))}
            for w, name in enumerate(WORKLOAD_NAMES)}
        self._wid = {name: w for w, name in enumerate(WORKLOAD_NAMES)}
        self._col = {c.key: j for j, c in enumerate(self.configs)}
        self.grid = self._build_grid(params, noise_key)
        self._offgrid_cache: Dict = {}

    # ---------------------------------------------------------- grid
    def _build_grid(self, params: np.ndarray,
                    noise_key: np.ndarray) -> ScoutGrid:
        configs = self.configs
        uids = np.asarray([config_uid(c) for c in configs], np.int32)
        cpu = np.asarray([MACHINE_PROFILES[c.vm_type].cpu
                          for c in configs])
        iops = np.asarray([MACHINE_PROFILES[c.vm_type].disk_iops
                           for c in configs])
        gbps = np.asarray([MACHINE_PROFILES[c.vm_type].net_gbps
                           for c in configs])
        cores = np.asarray([_CORES[c.vm_type.split(".")[1]]
                            for c in configs], np.float64)
        mem_gb = np.asarray([_mem_gb(c.vm_type) for c in configs],
                            np.float64)
        count = np.asarray([c.count for c in configs], np.float64)
        price = np.asarray([PRICES[c.vm_type] for c in configs])

        # (W, 1) params against (C,) config columns -> (W, C) tables,
        # elementwise-identical to the scalar model below
        cpu_work, mem_need, disk_work, net_work, pf = (
            params[:, p:p + 1] for p in range(5))
        n_cores = cores * count
        cpu_t = cpu_work / cpu * ((1 - pf) + pf / n_cores)
        disk_t = disk_work / iops * 100.0 / count
        net_t = net_work * (count - 1) / np.maximum(gbps * 100.0, 1.0)
        threshold = mem_gb * 0.85
        mem_penalty = np.where(
            mem_need > threshold,
            1.0 + 2.2 * (mem_need / threshold - 1.0), 1.0)
        base = (cpu_t + disk_t + net_t) * mem_penalty

        noise = lognormal_noise_grid(noise_key, len(WORKLOAD_NAMES),
                                     uids, CONTENTION_SCALE,
                                     self.device).cpu().numpy()
        runtime = base * noise
        cost = runtime / 3600.0 * price * count

        low_num = np.stack([
            cpu_work / cpu / n_cores,
            np.broadcast_to(mem_need / mem_gb, base.shape),
            np.broadcast_to(disk_work / iops, base.shape),
            np.broadcast_to(net_t, base.shape),
        ], axis=-1)
        lows = _lows_from(low_num, runtime)
        x_base = np.stack([self.config_features(c) for c in configs])
        return ScoutGrid(base_runtime=base, runtime=runtime, cost=cost,
                         low_num=low_num, lows=lows, x_base=x_base,
                         price=price, count=count, config_uid=uids,
                         noise_key=noise_key)

    def _offgrid(self, workload: str, config: CloudConfig):
        """Scalar model for configurations outside the 69-config grid —
        the same pure fold-in draw, memoized only as a shortcut."""
        key = (workload, config.key)
        hit = self._offgrid_cache.get(key)
        if hit is not None:
            return hit
        w = self.workloads[workload]
        prof = MACHINE_PROFILES[config.vm_type]
        cores = _CORES[config.vm_type.split(".")[1]]
        mem_gb = _mem_gb(config.vm_type)
        n_cores = cores * config.count
        pf = w["parallel_frac"]
        cpu_t = w["cpu_work"] / prof.cpu * ((1 - pf) + pf / n_cores)
        disk_t = w["disk_work"] / prof.disk_iops * 100.0 / config.count
        net_t = (w["net_work"] * (config.count - 1)
                 / max(prof.net_gbps * 100.0, 1.0))
        mem_penalty = 1.0
        if w["mem_need_gb"] > mem_gb * 0.85:  # spilling
            mem_penalty = 1.0 + 2.2 * (
                w["mem_need_gb"] / (mem_gb * 0.85) - 1.0)
        base = (cpu_t + disk_t + net_t) * mem_penalty
        noise = lognormal_noise_grid(
            self.grid.noise_key, len(WORKLOAD_NAMES),
            np.asarray([config_uid(config)], np.int32),
            CONTENTION_SCALE, self.device)[self._wid[workload], 0].item()
        runtime = float(base * noise)
        low_num = np.asarray([
            w["cpu_work"] / prof.cpu / n_cores,
            w["mem_need_gb"] / mem_gb,
            w["disk_work"] / prof.disk_iops,
            net_t,
        ])
        lows = _lows_from(low_num[None, :], np.asarray([runtime]))[0]
        out = (runtime, lows)
        self._offgrid_cache[key] = out
        return out

    # ------------------------------------------------------------- runtime
    def runtime_s(self, workload: str, config: CloudConfig) -> float:
        col = self._col.get(config.key)
        if col is not None:
            return float(self.grid.runtime[self._wid[workload], col])
        return self._offgrid(workload, config)[0]

    def cost_usd(self, workload: str, config: CloudConfig) -> float:
        rt = self.runtime_s(workload, config)
        return rt / 3600.0 * PRICES[config.vm_type] * config.count

    def low_level_metrics(self, workload: str, config: CloudConfig
                          ) -> np.ndarray:
        """Arrow's augmentation: utilization-style metrics of the run."""
        col = self._col.get(config.key)
        if col is not None:
            return self.grid.lows[self._wid[workload], col].copy()
        return self._offgrid(workload, config)[1].copy()

    def workload_arrays(self, workload: str):
        """Canonical-order materialization of one workload's tables:
        (runtimes, costs, low-level metrics) over ``self.configs``.
        Every value is a pure counter-based draw, so any consumer — in
        any call order, on host or inside the device replay program —
        sees bit-identical tables."""
        w = self._wid[workload]
        return (self.grid.runtime[w].copy(), self.grid.cost[w].copy(),
                self.grid.lows[w].copy())

    # --------------------------------------------------------------- views
    def workload_id(self, workload: str) -> int:
        return self._wid[workload]

    def config_features(self, config: CloudConfig) -> np.ndarray:
        prof = MACHINE_PROFILES[config.vm_type]
        return np.asarray([
            config.count,
            math.log(prof.cpu), math.log(prof.memory),
            math.log(prof.disk_iops), math.log(prof.net_gbps * 1000),
            PRICES[config.vm_type],
        ])

    def utilization_factors(self, config: CloudConfig) -> np.ndarray:
        """Per-aspect utilization headroom factor of a configuration —
        one term of Perona's acquisition weighting (paper §IV-D)."""
        prof = MACHINE_PROFILES[config.vm_type]
        caps = np.asarray([prof.cpu, prof.memory, prof.disk_iops,
                           prof.net_gbps * 1000])
        ref = np.asarray([5000.0, 50000.0, 8000.0, 10000.0])
        return np.clip(caps / ref, 0.05, 1.0)


def _lows_from(low_num: np.ndarray, runtime: np.ndarray) -> np.ndarray:
    """(..., 4) low-level metrics from their numerators + runtimes, in
    the exact op order the device expansion uses (``torch.minimum(caps,
    num / denom)``), so host and device lows are bit-identical."""
    rtm = np.maximum(runtime, 1e-6)
    denom = np.stack([rtm, np.ones_like(rtm), rtm, rtm], axis=-1)
    return np.minimum(np.asarray(LOW_CAPS), low_num / denom)
