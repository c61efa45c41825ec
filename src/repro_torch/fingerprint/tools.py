"""Simulators for the six benchmark tools (fixed configuration templates).

Each simulator maps a MachineProfile (+ stress factors + rng) to the
metric dict one tool run would yield after Perona's regex parsing of the
results log. Metric names, unit mixtures (ms/us/s, KiB, MiB, bps/MBps)
and constant config echoes mirror the real tools so the preprocessing
pipeline has real work to do: ~150 unique raw metrics across the suite,
of which only a fraction carries signal (the rest are constants or pure
noise and must be discarded by the selection step).

The simulators are *batched*: ``severity`` is a ``(R,)`` array and every
metric comes back as a ``(R,)`` value array — one RNG draw per metric
column instead of one per run, which is what makes fleet-scale columnar
acquisition cheap. R=1 recovers single-run semantics.

``rng`` may be a ``np.random.Generator``, an int seed, or a fold-in
path tuple (``common.rng.as_generator``): passing e.g. ``(seed, round,
"fio", "e2-medium")`` gives draws that are a pure function of that
path, independent of any other group's draw order.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.common.rng import as_generator
from repro_torch.fingerprint.machines import (MachineProfile,
                                              STRESS_FACTORS,
                                              stress_multiplier)

Metric = Tuple[np.ndarray, str]


def _noisy(rng, base, rel) -> np.ndarray:
    """base * lognormal noise; base must already be (R,)-shaped."""
    base = np.asarray(base, np.float64)
    return base * np.exp(rng.normal(0.0, rel, base.shape))


def _eff(profile: MachineProfile, severity: np.ndarray, aspect: str
         ) -> Dict[str, np.ndarray]:
    """severity (R,) in [0, 1]: 0 = nominal, 1 = full ChaosMesh stress."""
    r = severity.shape
    eff = {
        "cpu": np.full(r, profile.cpu),
        "memory": np.full(r, profile.memory),
        "disk_iops": np.full(r, profile.disk_iops),
        "disk_lat_us": np.full(r, profile.disk_lat_us),
        "net_gbps": np.full(r, profile.net_gbps),
        "net_lat_us": np.full(r, profile.net_lat_us),
    }
    for key, f in STRESS_FACTORS[aspect].items():
        eff[key] = eff[key] * stress_multiplier(f, severity)
    return eff


def _full(severity: np.ndarray, value: float) -> np.ndarray:
    return np.full(severity.shape, value, np.float64)


def sysbench_cpu(profile, rng, severity) -> Dict[str, Metric]:
    rng = as_generator(rng)
    e = _eff(profile, severity, "cpu")
    n = profile.noise
    c = lambda v: _full(severity, v)
    eps = _noisy(rng, e["cpu"], n)
    total_time = 10.0
    events = eps * total_time
    lat_avg = 1000.0 / eps  # ms per event per thread
    return {
        "cpu.events_per_second": (eps, "events/s"),
        "cpu.total_time": (_noisy(rng, c(total_time), 0.001), "s"),
        "cpu.total_events": (events, "events"),
        "cpu.latency_min": (_noisy(rng, lat_avg * 0.82, n), "ms"),
        "cpu.latency_avg": (_noisy(rng, lat_avg, n * 0.6), "ms"),
        "cpu.latency_max": (_noisy(rng, lat_avg * 3.1, n * 2.2), "ms"),
        "cpu.latency_p95": (_noisy(rng, lat_avg * 1.35, n), "ms"),
        "cpu.latency_sum": (_noisy(rng, lat_avg * events, n * 0.5), "ms"),
        "cpu.threads": (c(1.0), "count"),
        "cpu.prime_limit": (c(10000.0), "count"),
        "cpu.time_limit": (c(10.0), "s"),
        "cpu.events_per_thread": (events, "events"),
        "cpu.fairness_avg": (events, "events"),
        "cpu.fairness_stddev": (_noisy(rng, events * 0.001, 1.0), "events"),
        "cpu.user_pct": (_noisy(rng, c(96.0), 0.01), "%"),
        "cpu.sys_pct": (_noisy(rng, c(2.4), 0.3), "%"),
        "cpu.ctx_switches": (_noisy(rng, c(2200), 0.25), "count"),
        "cpu.migrations": (_noisy(rng, c(14), 0.5), "count"),
        "cpu.cache_miss_ratio": (_noisy(rng, c(0.021), 0.3), "ratio"),
        "cpu.ipc": (_noisy(rng, 1.15 + e["cpu"] / 9000.0, 0.05), "ratio"),
    }


def sysbench_memory(profile, rng, severity) -> Dict[str, Metric]:
    rng = as_generator(rng)
    e = _eff(profile, severity, "memory")
    n = profile.noise
    c = lambda v: _full(severity, v)
    thr = _noisy(rng, e["memory"], n)
    block_kib = 1.0
    ops = thr * 1024.0  # 1 KiB ops per second
    lat_avg = 1e6 / ops
    return {
        "mem.ops_per_second": (ops, "ops/s"),
        "mem.throughput": (thr, "MiB/s"),
        "mem.throughput_gb": (thr / 1024.0, "GiB/s"),
        "mem.transferred": (thr * 10.0, "MiB"),
        "mem.total_time": (_noisy(rng, c(10.0), 0.001), "s"),
        "mem.latency_min": (_noisy(rng, lat_avg * 0.7, n), "us"),
        "mem.latency_avg": (_noisy(rng, lat_avg, n * 0.6), "us"),
        "mem.latency_max": (_noisy(rng, lat_avg * 5.5, n * 2.5), "us"),
        "mem.latency_p95": (_noisy(rng, lat_avg * 1.3, n), "us"),
        "mem.latency_stddev": (_noisy(rng, lat_avg * 0.4, n * 2), "us"),
        "mem.block_size": (c(block_kib), "KiB"),
        "mem.total_size": (c(10240.0), "MiB"),
        "mem.ops_total": (ops * 10.0, "ops"),
        "mem.write_ratio": (c(1.0), "ratio"),
        "mem.numa_nodes": (c(1.0), "count"),
        "mem.page_faults": (_noisy(rng, c(180), 0.4), "count"),
        "mem.tlb_miss_ratio": (_noisy(rng, c(0.004), 0.4), "ratio"),
        "mem.scan_stride": (c(64.0), "bytes"),
    }


def fio(profile, rng, severity) -> Dict[str, Metric]:
    rng = as_generator(rng)
    e = _eff(profile, severity, "disk")
    n = profile.noise
    c = lambda v: _full(severity, v)
    out: Dict[str, Metric] = {}
    for rw, frac in (("read", 1.0), ("write", 0.82)):
        iops = _noisy(rng, e["disk_iops"] * frac, n * 1.3)
        bw_kib = iops * 4.0  # 4 KiB blocks
        lat = _noisy(rng, e["disk_lat_us"] / frac, n * 1.3)
        out.update({
            f"fio.{rw}.iops": (iops, "iops"),
            f"fio.{rw}.bw": (bw_kib, "KiB/s"),
            f"fio.{rw}.bw_mb": (bw_kib / 1024.0, "MiB/s"),
            f"fio.{rw}.lat_min": (_noisy(rng, lat * 0.45, n), "us"),
            f"fio.{rw}.lat_avg": (lat, "us"),
            f"fio.{rw}.lat_max": (_noisy(rng, lat * 40, n * 3), "us"),
            f"fio.{rw}.lat_stddev": (_noisy(rng, lat * 0.8, n * 2), "us"),
            f"fio.{rw}.clat_p50": (_noisy(rng, lat * 0.9, n), "us"),
            f"fio.{rw}.clat_p90": (_noisy(rng, lat * 1.6, n), "us"),
            f"fio.{rw}.clat_p95": (_noisy(rng, lat * 2.0, n), "us"),
            f"fio.{rw}.clat_p99": (_noisy(rng, lat * 4.2, n * 1.5), "us"),
            f"fio.{rw}.clat_p999": (_noisy(rng, lat * 11.0, n * 2), "us"),
            f"fio.{rw}.slat_avg": (_noisy(rng, c(2.4), 0.3), "us"),
            f"fio.{rw}.io_kbytes": (bw_kib * 30.0, "KiB"),
            f"fio.{rw}.runtime": (_noisy(rng, c(30000.0), 0.001), "ms"),
            f"fio.{rw}.total_ios": (iops * 30.0, "count"),
            f"fio.{rw}.drop_ios": (c(0.0), "count"),
            f"fio.{rw}.short_ios": (c(0.0), "count"),
        })
    out.update({
        "fio.jobs": (c(1.0), "count"),
        "fio.bs": (c(4.0), "KiB"),
        "fio.iodepth": (c(32.0), "count"),
        "fio.disk_util": (_noisy(rng, c(97.0), 0.01), "%"),
        "fio.cpu_usr": (_noisy(rng, c(3.2), 0.3), "%"),
        "fio.cpu_sys": (_noisy(rng, c(11.0), 0.3), "%"),
        "fio.ctx": (_noisy(rng, c(61000), 0.2), "count"),
        "fio.majf": (c(0.0), "count"),
        "fio.minf": (_noisy(rng, c(120), 0.5), "count"),
    })
    return out


def ioping(profile, rng, severity) -> Dict[str, Metric]:
    rng = as_generator(rng)
    e = _eff(profile, severity, "disk")
    n = profile.noise
    c = lambda v: _full(severity, v)
    lat = _noisy(rng, e["disk_lat_us"] * 0.8, n * 1.2)
    iops = 1e6 / lat
    return {
        "ioping.requests": (c(100.0), "count"),
        "ioping.total_time": (lat * 100.0 / 1000.0, "ms"),
        "ioping.lat_min": (_noisy(rng, lat * 0.55, n), "us"),
        "ioping.lat_avg": (lat, "us"),
        "ioping.lat_max": (_noisy(rng, lat * 7.0, n * 2.5), "us"),
        "ioping.lat_mdev": (_noisy(rng, lat * 0.6, n * 2), "us"),
        "ioping.iops": (iops, "iops"),
        "ioping.throughput": (iops * 4.0, "KiB/s"),
        "ioping.request_size": (c(4.0), "KiB"),
        "ioping.working_set": (c(256.0), "MiB"),
    }


def qperf(profile, rng, severity) -> Dict[str, Metric]:
    rng = as_generator(rng)
    e = _eff(profile, severity, "network")
    n = profile.noise
    c = lambda v: _full(severity, v)
    bw = _noisy(rng, e["net_gbps"] * 119.2, n)  # MB/s
    lat = _noisy(rng, e["net_lat_us"], n * 1.2)
    return {
        "qperf.tcp_bw": (bw, "MB/s"),
        "qperf.tcp_lat": (lat, "us"),
        "qperf.udp_send_bw": (_noisy(rng, bw * 0.93, n), "MB/s"),
        "qperf.udp_recv_bw": (_noisy(rng, bw * 0.88, n), "MB/s"),
        "qperf.udp_lat": (_noisy(rng, lat * 0.9, n), "us"),
        "qperf.msg_rate": (_noisy(rng, 1e3 / lat * 490, n), "K/s"),
        "qperf.msg_size": (c(64.0), "KiB"),
        "qperf.duration": (c(10.0), "s"),
        "qperf.cpu_util_loc": (_noisy(rng, c(30.0), 0.2), "%"),
        "qperf.cpu_util_rem": (_noisy(rng, c(28.0), 0.2), "%"),
    }


def iperf3(profile, rng, severity) -> Dict[str, Metric]:
    rng = as_generator(rng)
    e = _eff(profile, severity, "network")
    n = profile.noise
    c = lambda v: _full(severity, v)
    bps = _noisy(rng, e["net_gbps"] * 1e9 * 0.94, n)
    rtt = _noisy(rng, e["net_lat_us"] * 2.1, n)
    return {
        "iperf3.sent_bps": (bps, "bps"),
        "iperf3.recv_bps": (_noisy(rng, bps * 0.985, n * 0.3), "bps"),
        "iperf3.sent_bytes": (bps / 8 * 10, "bytes"),
        "iperf3.recv_bytes": (bps / 8 * 9.85, "bytes"),
        "iperf3.retransmits": (
            rng.poisson(3 + 37 * severity).astype(np.float64), "count"),
        "iperf3.jitter": (_noisy(rng, 0.04 + 20.0 / (bps / 1e9 + 1) / 1000,
                                 0.4), "ms"),
        "iperf3.lost_packets": (
            rng.poisson(1 + 24 * severity).astype(np.float64), "count"),
        "iperf3.lost_percent": (_noisy(rng, 0.01 + 0.89 * severity,
                                       0.6), "%"),
        "iperf3.cpu_host": (_noisy(rng, c(24.0), 0.25), "%"),
        "iperf3.cpu_remote": (_noisy(rng, c(21.0), 0.25), "%"),
        "iperf3.duration": (c(10.0), "s"),
        "iperf3.streams": (c(1.0), "count"),
        "iperf3.tcp_mss": (c(1448.0), "bytes"),
        "iperf3.snd_cwnd": (_noisy(rng, bps / 8 * rtt / 1e6 / 1024, 0.3),
                            "KiB"),
        "iperf3.rtt": (rtt / 1000.0, "ms"),
        "iperf3.rtt_var": (_noisy(rng, rtt * 0.2 / 1000.0, 0.5), "ms"),
    }


TOOLS = {
    "sysbench-cpu": sysbench_cpu,
    "sysbench-memory": sysbench_memory,
    "fio": fio,
    "ioping": ioping,
    "qperf": qperf,
    "iperf3": iperf3,
}


def node_metrics(profile, rng, severity, aspect) -> Dict[str, np.ndarray]:
    """Prometheus-style low-level metrics sampled during a run (the GNN
    edge attributes and Arrow's augmentation features). Batched like the
    tool simulators: (R,) severity in, (R,) gauge columns out."""
    rng = as_generator(rng)
    base = {
        "node.cpu_util": 0.35, "node.mem_util": 0.42,
        "node.disk_io_util": 0.18, "node.net_util": 0.12,
        "node.load1": 0.8, "node.psi_cpu": 0.03, "node.psi_io": 0.02,
        "node.ctx_rate": 3200.0,
    }
    bump = {
        "cpu": {"node.cpu_util": 0.92, "node.load1": 3.4,
                "node.psi_cpu": 0.55},
        "memory": {"node.mem_util": 0.93, "node.psi_cpu": 0.2},
        "disk": {"node.disk_io_util": 0.95, "node.psi_io": 0.6},
        "network": {"node.net_util": 0.9},
    }
    out = {}
    for k, v in base.items():
        col = np.full(severity.shape, v, np.float64)
        target = bump[aspect].get(k)
        if target is not None:
            col = col + severity * (target - col)
        out[k] = col * np.exp(rng.normal(0, 0.15, severity.shape))
    return out


# Constant config echoes parsed from tool logs (versions, template knobs).
# They carry no signal and exist to exercise Perona's selection step —
# the real suite yields ~153 raw metrics of which only ~1/3 survive.
EXTRA_CONSTANTS: Dict[str, Dict[str, Tuple[float, str]]] = {
    "sysbench-cpu": {
        "cpu.version": (1.020, "count"), "cpu.luajit": (2.1, "count"),
        "cpu.max_prime_digits": (5.0, "count"),
        "cpu.rate_limit": (0.0, "1/s"), "cpu.warmup": (2.0, "s"),
        "cpu.histogram_buckets": (1024.0, "count"),
    },
    "sysbench-memory": {
        "mem.version": (1.020, "count"), "mem.access_mode": (1.0, "count"),
        "mem.hugepages": (0.0, "count"), "mem.warmup": (2.0, "s"),
        "mem.rate_limit": (0.0, "1/s"),
        "mem.histogram_buckets": (1024.0, "count"),
    },
    "fio": {
        "fio.version": (3.28, "count"), "fio.direct": (1.0, "count"),
        "fio.ramp_time": (5.0, "s"), "fio.size": (1024.0, "MiB"),
        "fio.ioengine_id": (3.0, "count"), "fio.verify": (0.0, "count"),
        "fio.runtime_limit": (30.0, "s"), "fio.thinktime": (0.0, "us"),
        "fio.rwmixread": (55.0, "%"), "fio.fsync": (0.0, "count"),
    },
    "ioping": {
        "ioping.version": (1.2, "count"), "ioping.interval": (0.2, "s"),
        "ioping.direct": (1.0, "count"), "ioping.cached": (0.0, "count"),
        "ioping.warmup_requests": (10.0, "count"),
        "ioping.deadline": (60.0, "s"),
    },
    "qperf": {
        "qperf.version": (0.44, "count"), "qperf.port": (19765.0, "count"),
        "qperf.timeout": (120.0, "s"), "qperf.loc_cpus": (2.0, "count"),
        "qperf.rem_cpus": (2.0, "count"),
    },
    "iperf3": {
        "iperf3.version": (3.9, "count"), "iperf3.port": (5201.0, "count"),
        "iperf3.blksize": (131072.0, "bytes"),
        "iperf3.omit": (2.0, "s"), "iperf3.interval": (1.0, "s"),
        "iperf3.reverse": (0.0, "count"), "iperf3.parallel": (1.0, "count"),
    },
}
