"""Benchmark-execution graphs (paper §III-C), dense fixed-degree layout.

Graphs are composed per (benchmark type x compute instance): the
chronologically sorted executions of one type on one machine form a
chain, and each node receives forward edges from its P=3 immediate
predecessors. Edge attributes concatenate the source run's low-level
machine metrics with encodings of the time interval between the pair.

Because the in-degree is fixed, the whole dataset is one dense batch:
  x (N, F'), nbr (N, P) int32 (-1 = missing), edge (N, P, A),
  types/labels/norm ground truth per node — no scatter/gather graphs
(the JAX package's TPU layout, kept so both packages agree).

Construction is columnar: chain membership, predecessor indices and
edge attributes are derived with one lexsort + shifted-array ops over
the :class:`BenchmarkFrame` (record lists are converted on entry).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.preprocess import Preprocessor
from repro_torch.fingerprint.frame import (BenchmarkFrame, FrameOrRecords,
                                           as_frame)

P_PREDECESSORS = 3


@dataclasses.dataclass
class PeronaBatch:
    x: np.ndarray  # (N, F') preprocessed features
    type_id: np.ndarray  # (N,) int32 benchmark type
    anomaly: np.ndarray  # (N,) int32 0/1 ground truth (stress marker)
    nbr: np.ndarray  # (N, P) int32 predecessor indices, -1 missing
    nbr_mask: np.ndarray  # (N, P) bool
    edge: np.ndarray  # (N, P, A) edge attributes in (0,1)
    norm_gt: np.ndarray  # (N,) ranking ground truth (p-norm of x')
    machine: List[str]  # (N,) node names
    chain: np.ndarray  # (N,) int32 chain id (type x machine)

    def __len__(self) -> int:
        return len(self.x)

    def subset(self, idx: np.ndarray) -> "PeronaBatch":
        """Subset *with remapped edges* (edges to excluded nodes are
        dropped)."""
        idx = np.asarray(idx)
        remap = -np.ones(len(self.x), np.int64)
        remap[idx] = np.arange(len(idx))
        nbr = np.where(self.nbr >= 0, remap[self.nbr], -1)[idx]
        return PeronaBatch(
            x=self.x[idx], type_id=self.type_id[idx],
            anomaly=self.anomaly[idx], nbr=nbr.astype(np.int32),
            nbr_mask=nbr >= 0, edge=self.edge[idx],
            norm_gt=self.norm_gt[idx],
            machine=[self.machine[i] for i in idx],
            chain=self.chain[idx])


def time_encodings(dt: np.ndarray, t_src: np.ndarray) -> np.ndarray:
    """(..., 4) time-interval/hour-of-day encodings, vectorized."""
    dt = np.asarray(dt, np.float64)
    t_src = np.asarray(t_src, np.float64)
    hod = (t_src / 3600.0) % 24.0
    ang = 2 * np.pi * hod / 24
    return np.stack([
        np.log1p(dt) / 12.0,
        np.minimum(dt / 3600.0, 1.0),
        0.5 + 0.5 * np.sin(ang),
        0.5 + 0.5 * np.cos(ang),
    ], axis=-1)


@dataclasses.dataclass
class GraphStructure:
    """Statistics-free graph topology of a frame: predecessor indices
    within each (benchmark type x machine) chain + raw time terms.
    Feature/edge *values* are attached separately (numpy in
    ``build_graphs``, inside the scoring call of
    ``serving.FingerprintEngine``).
    """

    nbr: np.ndarray  # (N, P) int32, -1 = missing
    nbr_mask: np.ndarray  # (N, P) bool
    chain: np.ndarray  # (N,) int32 dense chain ids
    dt: np.ndarray  # (N, P) float64 time gap to predecessor (0 if none)
    t_src: np.ndarray  # (N, P) float64 predecessor timestamp (0 if none)


def chain_structure(key: np.ndarray, t: np.ndarray,
                    p: int = P_PREDECESSORS) -> GraphStructure:
    """Core topology derivation from a per-row chain key + timestamps:
    each row's P predecessors are the immediately preceding rows of the
    same chain in stable (t, row) order. ``graph_structure`` wraps this
    for frames; the fleet service calls it directly on store-gathered
    arrays (no intermediate frame)."""
    n = len(key)
    key = np.asarray(key, np.int64)
    t = np.asarray(t, np.float64)
    chain = np.unique(key, return_inverse=True)[1].astype(np.int32)

    # stable (chain, t, row) order; the record path sorts chains by key
    # and chain members chronologically with stable ties
    order = np.lexsort((np.arange(n), t, key))
    key_sorted = key[order]
    boundary = np.ones(n, bool)
    boundary[1:] = key_sorted[1:] != key_sorted[:-1]
    chain_start = np.maximum.accumulate(
        np.where(boundary, np.arange(n), 0))

    nbr = -np.ones((n, p), np.int32)
    dt = np.zeros((n, p), np.float64)
    t_src = np.zeros((n, p), np.float64)
    pos = np.arange(n)
    for q in range(p):
        src = pos - 1 - q
        valid = src >= chain_start
        j = np.where(valid, order[np.maximum(src, 0)], -1)
        rows = order[valid]
        nbr[rows, q] = j[valid]
        jj = j[valid]
        dt[rows, q] = np.maximum(t[rows] - t[jj], 0.0)
        t_src[rows, q] = t[jj]
    return GraphStructure(nbr=nbr, nbr_mask=nbr >= 0, chain=chain,
                          dt=dt, t_src=t_src)


def graph_structure(frame: BenchmarkFrame,
                    p: int = P_PREDECESSORS) -> GraphStructure:
    # chain key ordered like the record path: sorted (type name, machine
    # name) tuples -> ranks of the sorted vocabularies
    bt_rank = np.argsort(np.argsort(frame.benchmark_types))
    m_rank = np.argsort(np.argsort(frame.machines))
    key = (bt_rank[frame.type_code].astype(np.int64)
           * max(len(frame.machines), 1) + m_rank[frame.machine_code])
    return chain_structure(key, frame.t, p)


def build_graphs(data: FrameOrRecords,
                 preproc: Preprocessor) -> PeronaBatch:
    frame = as_frame(data)
    x = preproc.transform(frame)
    edge_feats = preproc.transform_edges(frame)
    n = len(frame)
    a = edge_feats.shape[1] + 4
    type_id = preproc.type_ids(frame)
    anomaly = frame.stressed.astype(np.int32)
    norm_gt = preproc.groundtruth_norm(x)

    gs = graph_structure(frame)
    edge = np.zeros((n, P_PREDECESSORS, a), np.float32)
    src = np.maximum(gs.nbr, 0)
    vals = np.concatenate(
        [edge_feats[src], time_encodings(gs.dt, gs.t_src)], axis=-1)
    edge[:] = np.where(gs.nbr_mask[..., None], vals, 0.0)
    return PeronaBatch(
        x=x.astype(np.float32), type_id=type_id, anomaly=anomaly,
        nbr=gs.nbr, nbr_mask=gs.nbr_mask, edge=edge,
        norm_gt=norm_gt.astype(np.float32),
        machine=frame.machine_names(), chain=gs.chain)


def chronological_split(data: FrameOrRecords, fractions=(0.6, 0.2, 0.2)):
    """Per-(machine x type) chronological split (every node appears in
    every split — the paper's node-name stratification — while graph
    edges stay causal). Frames in, frames out; record lists in, record
    lists out."""
    frame = as_frame(data)
    is_frame = isinstance(data, BenchmarkFrame)
    n = len(frame)
    key = (frame.type_code.astype(np.int64)
           * max(len(frame.machines), 1) + frame.machine_code)
    order = np.lexsort((np.arange(n), frame.t, key))
    key_sorted = key[order]
    boundary = np.ones(n, bool)
    boundary[1:] = key_sorted[1:] != key_sorted[:-1]
    start = np.maximum.accumulate(np.where(boundary, np.arange(n), 0))
    # chain length / position via next-boundary distance
    idx_of_start = np.where(boundary)[0]
    lengths = np.diff(np.append(idx_of_start, n))
    length_per_row = np.repeat(lengths, lengths)
    pos = np.arange(n) - start
    a = (length_per_row * fractions[0]).astype(np.int64)
    b = (length_per_row * (fractions[0] + fractions[1])).astype(np.int64)
    split_sorted = np.where(pos < a, 0, np.where(pos < b, 1, 2))
    split = np.empty(n, np.int64)
    split[order] = split_sorted

    out = []
    for s in range(3):
        idx = np.sort(np.nonzero(split == s)[0])
        sub = frame.select(idx)
        out.append(sub if is_frame else sub.to_records())
    return tuple(out)
