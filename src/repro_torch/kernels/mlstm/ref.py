"""Plain PyTorch version of the stabilized chunkwise mLSTM.

Mirrors ``repro/kernels/mlstm/ref.py`` in the kernel's layout: q/k/v
``(BH, S, hd)``, gates ``(BH, S)`` float32, state ``(C (BH, hd, hd),
n (BH, hd), m (BH,))`` float32. It differs in one point, the schedule:
chunks of ``L = min(chunk, S)`` rows with a short last chunk when
``S % L != 0`` (the reference takes one chunk of S rows there, and its
Pallas kernel refuses such S). The CUDA kernel takes the same schedule.
The chunking changes the carried stabilizer m, and with it the scale of
C and n, but not h or ``C * exp(m)``.

The CPU tests use it, ``chip_smoke.py`` holds the CUDA kernels against
it on the card, and the kernel wrapper (``ops``) takes it for tensors
that lie on the CPU. :func:`mlstm_chunkwise_bwd` is the plain version of
the backward kernel, in explicit formulas on the same schedule, and
:func:`gh_dots` the identity by which the backward's tensor-core route
gets ``<g_i, h_i>`` without h. Under float64 inputs (the CPU tests'
float64 evaluations) all compute in float64.
"""

from __future__ import annotations

import torch

M_INIT = -1e30  # the fresh state's stabilizer: finite, so no -inf - -inf


def init_state(bh: int, hd: int, device="cpu", dtype=torch.float32):
    return (torch.zeros(bh, hd, hd, dtype=dtype, device=device),
            torch.zeros(bh, hd, dtype=dtype, device=device),
            torch.full((bh,), M_INIT, dtype=dtype, device=device))


def _parts(q, k, v, li, lf, C, n, m):
    """The forward of one chunk of Lc rows, every intermediate kept: q/k/v
    (BH, Lc, hd) float32, gates (BH, Lc), the state entering the chunk.
    :func:`_chunk` returns h and the state after it; the backward reads
    the rest."""
    Lc = q.shape[1]
    p = {}
    # cumulative log-forget, summed in float64 and rounded to float32: a
    # float32 cumsum's rounding depends on its order (sequential here, a
    # tree in XLA, a scan on the card) and exp amplifies it; this gives
    # the kernel's bits on any device
    b = torch.cumsum(lf.double(), dim=1).to(lf.dtype)  # (BH, Lc)
    total_f = b[:, -1]  # b at the last real row
    # intra-chunk decay D[i, j] = b_i - b_j + li_j for j <= i
    dmat = b[:, :, None] - b[:, None, :] + li[:, None, :]
    causal = torch.ones(Lc, Lc, dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~causal, float("-inf"))
    inter_log = b + m[:, None]  # decay of the carried state for row i
    m_new = torch.maximum(inter_log, dmat.amax(dim=2))  # finite: D[i, i]
    p["dmat_s"] = dmat_s = torch.exp(dmat - m_new[:, :, None])  # 0 above
    p["inter_s"] = inter_s = torch.exp(inter_log - m_new)
    scores = q @ k.transpose(1, 2)
    p["weighted"] = weighted = scores * dmat_s
    num = weighted @ v + (q @ C) * inter_s[:, :, None]
    p["den"] = den = weighted.sum(2) + (q @ n[:, :, None])[:, :, 0] * inter_s
    p["floor"] = floor = torch.exp(-m_new)
    p["norm"] = norm = torch.maximum(den.abs(), floor)
    p["h"] = num / norm[:, :, None]

    m_next = torch.maximum(total_f + m, (b + li).amax(dim=1))
    p["kdecay"] = kdecay = torch.exp(total_f[:, None] - b + li
                                     - m_next[:, None])
    p["decay"] = decay = torch.exp(total_f + m - m_next)
    kd = k * kdecay[:, :, None]
    C = decay[:, None, None] * C + kd.transpose(1, 2) @ v
    n = decay[:, None] * n + kd.sum(1)
    return p, (C, n, m_next)


def _chunk(q, k, v, li, lf, C, n, m):
    """One chunk of Lc rows: q/k/v (BH, Lc, hd) float32, gates (BH, Lc).
    Returns (h float32, (C, n, m) after the chunk)."""
    p, state = _parts(q, k, v, li, lf, C, n, m)
    return p["h"], state


def mlstm_chunkwise(q, k, v, log_i, log_f, chunk: int = 64, state=None):
    """q/k/v (BH, S, hd); log_i/log_f (BH, S). Returns (h (BH, S, hd) in
    q's type, (C, n, m) float32)."""
    BH, S, hd = q.shape
    L = min(chunk, S)
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    C, n, m = (init_state(BH, hd, q.device, f) if state is None
               else tuple(t.to(f) for t in state))
    li, lf = log_i.to(f), log_f.to(f)
    hs = []  # one cat at the end: under autograd a slice write per chunk
    # would clone the whole gradient of h in its backward
    for s0 in range(0, S, L):
        rows = slice(s0, min(s0 + L, S))
        hc, (C, n, m) = _chunk(q[:, rows].to(f), k[:, rows].to(f),
                               v[:, rows].to(f), li[:, rows], lf[:, rows],
                               C, n, m)
        hs.append(hc.to(q.dtype))
    return torch.cat(hs, dim=1), (C, n, m)


def _gh_identity(p, u, qc, vc, C):
    """<g_i, h_i> for the rows of one chunk (``p`` its :func:`_parts`,
    u_i = g_i / N_i, C entering it) from two products the backward forms
    anyway, G = u v^T and y = C u:
        <g_i, h_i> = sum_{j <= i} W_ij G_ij + inter_s_i <q_i, y_i>,
    since h_i = (sum_j W_ij v_j + inter_s_i q_i C) / N_i (W is 0 above
    the diagonal)."""
    G = u @ vc.transpose(1, 2)
    y = u @ C.transpose(1, 2)
    return (p["weighted"] * G).sum(2) + p["inter_s"] * (qc * y).sum(2)


def gh_dots(q, k, v, log_i, log_f, g_h, chunk: int = 64):
    """<g_i, h_i> of every row (BH, S) for the cotangent ``g_h`` of h, by
    the identity of :func:`_gh_identity` (no h), on
    :func:`mlstm_chunkwise`'s schedule from a fresh state."""
    BH, S, hd = q.shape
    L = min(chunk, S)
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    C, n, m = init_state(BH, hd, q.device, f)
    li, lf = log_i.to(f), log_f.to(f)
    out = []
    for s0 in range(0, S, L):
        rows = slice(s0, min(s0 + L, S))
        qc, kc, vc = (t[:, rows].to(f) for t in (q, k, v))
        p, state = _parts(qc, kc, vc, li[:, rows], lf[:, rows], C, n, m)
        u = g_h[:, rows].to(f) / p["norm"][:, :, None]
        out.append(_gh_identity(p, u, qc, vc, C))
        C, n, m = state
    return torch.cat(out, dim=1)


def mlstm_chunkwise_bwd(q, k, v, log_i, log_f, g_h, chunk: int = 64,
                        gh: str = "h"):
    """The gradient of :func:`mlstm_chunkwise` (fresh state) for the
    cotangent ``g_h`` (BH, S, hd) of h alone, the function of the backward
    kernel of ``csrc/mlstm.cu``, in explicit formulas on the same
    schedule. Returns (dq, dk, dv) in q's type and (dlog_i, dlog_f)
    float32 (float64 under float64 inputs). ``gh`` says how s_i gets
    <g_i, h_i>: from the recomputed h (``"h"``, the CUDA-core route's
    way) or by :func:`_gh_identity` (``"identity"``, the tensor-core
    route's).

    h_i = num_i / N_i does not depend on the stabilizers (m_new_i, the
    carried m): with den_i = exp(-m_new_i) Dn_i, h_i is the unstabilised
    numerator over max(|Dn_i|, 1). So every stabilizer is a constant
    here; the reference's autodiff differentiates through its maxima, and
    those terms sum to zero. A forward walk keeps each chunk's
    intermediates and entering state; the walk back from the last chunk
    carries the cotangent (dC, dn) of the state after the chunk, in the
    scale of that state (C is stabilised by the m it carries, so dC needs
    no stabilizer of its own: dC entering = decay dC + its rows' terms,
    decay <= 1). Per chunk, with u_i = g_i / N_i and s_i = -sign(den_i)
    <g_i, h_i> / N_i where |den_i| is the larger term of N_i (else 0):
    dW_ij = <u_i, v_j> + s_i gives dv (W^T u), dS = dW * exp(D - m_new)
    (dq = dS k, dk = dS^T q) and the log-weight cotangent dW * W on
    D_ij = b_i - b_j + log_i_j; the carried state gives dq_i its
    inter_s_i (C u_i + s_i n) and b_i its inter_s_i <q_i, C u_i + s_i n>;
    the update C' = decay C + sum_j kd_j k_j v_j^T, n' = decay n +
    sum_j kd_j k_j gives dk_j kd_j (dC' v_j + dn'), dv_j kd_j dC'^T k_j,
    and the logs of kd_j and decay their cotangents. dlog_f is the
    reverse cumulative sum of b's cotangents inside the chunk, in float64
    rounded to float32 as the forward sums b.
    """
    BH, S, hd = q.shape
    L = min(chunk, S)
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    C, n, m = init_state(BH, hd, q.device, f)
    li, lf = log_i.to(f), log_f.to(f)
    walk = []
    for s0 in range(0, S, L):
        rows = slice(s0, min(s0 + L, S))
        x = [t[:, rows].to(f) for t in (q, k, v)]
        p, state = _parts(*x, li[:, rows], lf[:, rows], C, n, m)
        walk.append((rows, x, C, n, p))
        C, n, m = state
    dC, dn = torch.zeros_like(C), torch.zeros_like(n)
    out = {name: [] for name in ("dq", "dk", "dv", "dli", "dlf")}
    for rows, (qc, kc, vc), C, n, p in reversed(walk):
        g = g_h[:, rows].to(f)
        u = g / p["norm"][:, :, None]
        if gh == "h":
            gh_i = (g * p["h"]).sum(2)
        elif gh == "identity":
            gh_i = _gh_identity(p, u, qc, vc, C)
        else:
            raise ValueError(f"gh is 'h' or 'identity', got {gh!r}")
        s = torch.where(p["den"].abs() > p["floor"],
                        -torch.sign(p["den"]) * gh_i / p["norm"],
                        torch.zeros_like(p["den"]))
        inter_s, kdecay = p["inter_s"], p["kdecay"]
        # within the chunk (dW is 0 above the diagonal through dmat_s, W)
        dW = u @ vc.transpose(1, 2) + s[:, :, None]
        dS = dW * p["dmat_s"]
        dD = dW * p["weighted"]
        dq = dS @ kc
        dk = dS.transpose(1, 2) @ qc
        dv = p["weighted"].transpose(1, 2) @ u
        # through the state entering the chunk
        y = u @ C.transpose(1, 2) + s[:, :, None] * n[:, None, :]
        dq = dq + inter_s[:, :, None] * y
        d_inter = (qc * y).sum(2)
        # through the state after it
        z = vc @ dC.transpose(1, 2) + dn[:, None, :]
        dk = dk + kdecay[:, :, None] * z
        dv = dv + kdecay[:, :, None] * (kc @ dC)
        d_kd = (kc * z).sum(2)
        d_decay = (dC * C).sum((1, 2)) + (dn * n).sum(1)
        # the log cotangents of D, inter_s, kd and decay, onto b and log_i
        col_d = dD.sum(1)
        kd_log = d_kd * kdecay
        db = dD.sum(2) - col_d + d_inter * inter_s - kd_log
        db[:, -1] += kd_log.sum(1) + d_decay * p["decay"]
        acc = torch.float64
        dlf = torch.flip(torch.cumsum(torch.flip(db.to(acc), (1,)), 1), (1,))
        out["dlf"].append(dlf.to(f))
        out["dli"].append(col_d + kd_log)
        for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
            out[name].append(t.to(q.dtype))
        # the cotangent of the state entering the chunk
        w = inter_s[:, :, None] * qc
        dC = p["decay"][:, None, None] * dC + w.transpose(1, 2) @ u
        dn = p["decay"][:, None] * dn + (w * s[:, :, None]).sum(1)
    return tuple(torch.cat(out[name][::-1], dim=1)
                 for name in ("dq", "dk", "dv", "dli", "dlf"))
