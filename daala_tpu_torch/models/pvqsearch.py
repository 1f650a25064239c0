"""Device PVQ band search on torch tensors: the per-band gain/theta/
codeword RDO batched over every band of a frame, one call per band
length.

The counterpart of daala_tpu/models/pvqsearch.py.  The reference's
per-band search (od_pvq_encode -> pvq_theta, src/pvq_encoder.c:333-636)
is embarrassingly parallel across the bands of a frame: with the
reference's own fast rate model (the `speed > 0` branch of od_pvq_rate,
src/pvq_encoder.c:247-262) the search depends only on the input
coefficients, the MC-prediction coefficients, the frame quantizer and
the QM tables, none of the sequentially adapted entropy state.  So the
whole search runs on the device against the analysis coefficients that
stay there; only a compact decision table comes back, and the native
entropy pass replays it (frame_enc.inc ec_pvq_theta_forced).

Decision parity: the integer stages (gains, companding, Householder, k)
follow the reference's fixed-point semantics exactly, in int64 (torch's
shifts by 64 or more, or by a negative amount, give what XLA's do: 0
for a left shift, the sign for an arithmetic right shift).  The float
RDO (distortions, pulse search, rate model) runs in float32 with the
same operation order and promotion as the JAX function, so a small
fraction of near-tie decisions may differ between devices and from the
host's f64 search; the host searches any band the device marks invalid
(pulse budget overflow) itself, as in JAX.

Differences from the JAX module, none of which changes a result:

- the 12 theta and 2 noref candidates run as ONE pulse search over a
  stacked (C*m, n) batch, and the sequential `better` selection over
  them is evaluated in closed form (`_select`), so the number of
  launches per call depends on neither the row count nor the candidate
  count (only the pulse loop's trip count, which the data sets);
- no row chunking and no padding ladder: one call per band length and
  frame type, whatever the row count;
- the band gather masks out-of-range offsets explicitly where JAX used
  `mode="fill"`.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from daala_tpu_torch.models.analysis import wrap32 as _wrap32
from daala_tpu_torch.ops import partition as part
from daala_tpu_torch.ops import pvq as P
from daala_tpu_torch.utils import devstats

_GAIN_WEIGHT = 1.4
_CGSCALE = float(P.OD_CGAIN_SCALE)
# 1 / OD_CGAIN_SCALE^2, rounded to float32 as the JAX module's constant.
_INV_CS2 = float(np.float32(1.0 / (_CGSCALE * _CGSCALE)))

# ---------------------------------------------------------------------------
# Vectorized fixed-point helpers (int32 semantics of ops/pvq.py) on int64
# tensors.  Arguments are int64 tensors or Python ints.
# ---------------------------------------------------------------------------


def _l(x):
    """int64 view of a tensor argument (Python ints pass through)."""
    return x.long() if torch.is_tensor(x) else x


@functools.lru_cache(maxsize=None)
def _pow2(device):
    return torch.tensor([1 << i for i in range(32)], dtype=torch.int64,
                        device=device)


def _ilog(x):
    """OD_ILOG for non-negative x (bit length); 0 -> 0.  The input is
    truncated to uint32 first, as JAX's astype(uint32) does; the bit
    length is an integer search of the powers of two (no float log2)."""
    x = _l(x) & 0xFFFFFFFF
    return torch.searchsorted(_pow2(x.device), x, right=True)


def _ilog_c(x):
    """OD_ILOG via CLZ: negative 32-bit inputs yield 32."""
    x = _l(x)
    return torch.where(x < 0, 32, _ilog(x.clamp_min(0)))


def _shl32(a, s):
    """32-bit wrapping left shift."""
    v = (_l(a) << s) & 0xFFFFFFFF
    return torch.where(v >= (1 << 31), v - (1 << 32), v)


def _wrap16(v):
    return ((v + 32768) & 65535) - 32768


def _shr_round(x, s):
    return (_l(x) + ((1 << s) >> 1)) >> s


def _vshr(x, s):
    """Variable shift; negative s = wrapping left shift."""
    if not torch.is_tensor(s):
        return _l(x) >> s if s > 0 else _shl32(x, -s)
    return torch.where(s > 0, _l(x) >> s.clamp_min(0),
                       _shl32(x, (-s).clamp_min(0)))


def _vshr_round(x, s):
    if not torch.is_tensor(s):
        return _shr_round(x, s) if s > 0 else _shl32(x, -s)
    sp = s.clamp_min(0)
    return torch.where(s > 0, (_l(x) + ((1 << sp) >> 1)) >> sp,
                       _shl32(x, (-s).clamp_min(0)))


def _mult16_16_q15(a, b):
    return (_l(a) * _l(b)) >> 15


def _mult16_16_q16(a, b):
    return (_l(a) * _l(b)) >> 16


def _mult16_32_qbeta(a, b):
    return (_l(a) * _l(b)) >> P.OD_BETA_SHIFT


def _od_rcp(x):
    i = _ilog_c(x) - 1
    n = _wrap16(_vshr_round(x, i - P.OD_RCP_INSHIFT)
                - (1 << P.OD_RCP_INSHIFT))
    r = _wrap16(30840 + _mult16_16_q15(-15420, n))
    r = _wrap16(r - _mult16_16_q15(r, _mult16_16_q15(r, n) + r - 32768))
    r = _wrap16(r - (1 + _mult16_16_q15(r, _mult16_16_q15(r, n) + r
                                        - 32768)))
    return _wrap16(_vshr_round(r, i - P.OD_RCP_OUTSHIFT))


def _rsqrt_norm(t):
    n = _l(t) - 32768
    r = 23565 + _mult16_16_q15(n, -13481 + _mult16_16_q15(n, 6711))
    r2 = r * r
    y = (((r2 >> 15) * n + r2) >> 12) - 131077
    ry = r * y
    return r + ((((ry >> 16) * (3 * y) >> 3) - ry) >> 18)


def _sqrt_norm(x):
    return _shr_round(x * _rsqrt_norm(x), P.OD_SQRT_OUTSHIFT) \
        .clamp_max(32767)


def _od_sqrt(x):
    """(sqrt_norm, shift); x == 0 -> (0, 0)."""
    k = (_ilog(x) - 1) >> 1
    s = 2 * k - (P.OD_SQRT_INSHIFT - 2)
    t = _vshr(x, s)
    shift = P.OD_SQRT_OUTSHIFT - ((s + P.OD_SQRT_INSHIFT) >> 1)
    zero = _l(x) == 0
    return (torch.where(zero, 0, _sqrt_norm(t)),
            torch.where(zero, 0, shift))


_EXP2_C = (32768, 22709, 7913, 1704, 443)


def _od_exp2(x):
    integer = _l(x) >> P.OD_EXP2_INSHIFT
    xf = _l(x) - _shl32(integer, P.OD_EXP2_INSHIFT)
    frac = _mult16_16_q15(
        xf, _EXP2_C[1] + _mult16_16_q15(
            xf, _EXP2_C[2] + _mult16_16_q15(
                xf, _EXP2_C[3] + _mult16_16_q15(xf, _EXP2_C[4]))))
    out = _vshr_round(_EXP2_C[0] + frac, -integer) + 1
    out = torch.where(integer > 14, 0x7F000000, out)
    return torch.where(integer < -15, 0, out)


def _od_log2(x):
    return _l(x) + _mult16_16_q15(
        x, 14482 + _mult16_16_q15(
            x, -23234 + _mult16_16_q15(
                x, 13643 + _mult16_16_q15(
                    x, -6403 + _mult16_16_q15(x, 1515)))))


def _od_pow(x, beta):
    """x**beta (beta a host int, Q12); x a tensor."""
    log2_x = _ilog(x) - 1
    xshift = log2_x - P.OD_LOG2_INSHIFT
    t = _vshr(x, xshift) - (1 << P.OD_LOG2_INSHIFT)
    logr = _od_log2(t) + (log2_x - P.OD_COMPAND_SHIFT) \
        * P.OD_LOG2_OUTSCALE
    logr = _mult16_32_qbeta(beta, logr)
    return torch.where(_l(x) == 0, 0, _od_exp2(logr))


_RCP_B15 = P.beta_rcp(P.BETA_1_5)


def _gain_compand(g, q0, beta15):
    """Per-row companding: beta15 (bool) selects the activity-masking
    beta 1.5 (Q12) vs beta 1 (the only two betas the encoder uses)."""
    q0l = _l(q0)
    b1 = torch.div(P.OD_CGAIN_SCALE * _l(g) + (q0l >> 1), q0l,
                   rounding_mode="floor")
    expr = _od_pow(g, _RCP_B15)
    expr = expr << (P.OD_CGAIN_SHIFT + P.OD_COMPAND_SHIFT
                    - P.OD_EXP2_OUTSHIFT)
    b15 = torch.div(expr + (q0l >> 1), q0l, rounding_mode="floor")
    return torch.where(beta15, b15, b1)


def _compute_gain(x16, q0, beta15, bshift):
    acc = (_l(x16) * _l(x16)).sum(-1)
    irt, sqrt_shift = _od_sqrt(acc)
    g = _vshr_round(irt, sqrt_shift - bshift)
    return _gain_compand(g, q0, beta15), g


def _gain_expand(cg0, q0, beta):
    if beta == P.BETA_1:
        return _shr_round(_l(cg0) * _l(q0), P.OD_CGAIN_SHIFT)
    if beta == P.BETA_1_5:
        irt, sqrt_outshift = _od_sqrt(_l(cg0) * _l(q0))
        sqrt_inshift = (P.OD_CGAIN_SHIFT + P.OD_COMPAND_SHIFT) >> 1
        tmp = _l(cg0) * _l(q0) * irt
        return _vshr_round(tmp, P.OD_CGAIN_SHIFT + sqrt_outshift
                           + sqrt_inshift)
    cg = _shr_round(_l(cg0) * _l(q0), P.OD_CGAIN_SHIFT)
    expr = _od_pow(cg, beta)
    return _shr_round(expr, P.OD_EXP2_OUTSHIFT - P.OD_COMPAND_SHIFT)


def _cos_pi_2(x):
    x2 = _mult16_16_q15(x, x)
    return ((1073758164 - _l(x) * _l(x) + x2
             * (-7654 + _mult16_16_q16(x2, 16573
                                       + _mult16_16_q16(-2529, x2))))
            >> 15).clamp_max(32767)


def _pvq_cos(x):
    x = _l(x) & 0x0001FFFF
    x = torch.where(x > (1 << 16), (1 << 17) - x, x)
    poly = torch.where(x < (1 << 15), _cos_pi_2(x), -_cos_pi_2(65536 - x))
    exact = torch.where((x & 0x0000FFFF) != 0, 0,
                        torch.where((x & 0x0001FFFF) != 0, -32767, 32767))
    return torch.where((x & 0x00007FFF) != 0, poly, exact)


def _pvq_sin(x):
    return _pvq_cos(32768 - _l(x))


def _compute_max_theta(qcg, beta15):
    qconst_pi_2 = int(0.5 + (np.pi / 2) * (1 << P.OD_CGAIN_SHIFT))
    rcp = torch.where(beta15, _RCP_B15, P.BETA_1)
    ts = _shr_round(_l(qcg) * _mult16_32_qbeta(rcp, qconst_pi_2),
                    P.OD_CGAIN_SHIFT * 2)
    return _wrap32(torch.where(
        _l(qcg) < int(0.5 + 1.4 * (1 << P.OD_CGAIN_SHIFT)), 1, ts))


def _compute_theta(t, max_theta):
    t = torch.minimum(_l(t), _l(max_theta) - 1)
    return torch.where(_l(max_theta) != 0,
                       torch.div(P.OD_MAX_THETA_SCALE * t
                                 + (_l(max_theta) >> 1),
                                 _l(max_theta).clamp_min(1),
                                 rounding_mode="floor"),
                       0)


def _compute_k(qcg, itheta, noref, n, beta15):
    """n, noref: host values; qcg/itheta tensors (itheta unused when
    noref); beta15 (bool) selects the beta-1.5 rows."""
    if noref:
        rt = P._SQRT_TABLE[1][P._ilog(n + 1)]
        rcp = torch.where(beta15, _RCP_B15, P.BETA_1)
        k = _shr_round(
            (_l(qcg) - int(0.5 + 0.2 * (1 << P.OD_CGAIN_SHIFT)))
            * _mult16_32_qbeta(rcp, rt),
            P.OD_CGAIN_SHIFT + P.OD_SQRT_TBL_SHIFT).clamp_min(1)
        k = torch.where(_l(qcg) == 0, 0, k)
        if n == 15:
            # The reference's n==15, beta > 1.25 special case: only the
            # beta-1.5 rows qualify (beta 1 does not).
            k = torch.where(beta15 & (_l(qcg) == P.OD_CGAIN_SCALE), 1, k)
        return _wrap32(k)
    rt = P._SQRT_TABLE[0][P._ilog(n + 1)]
    k = _vshr_round(
        (_shl32(itheta, P.OD_ITHETA_SHIFT)
         - int(0.5 + 0.2 * (1 << P.OD_ITHETA_SHIFT))) * rt,
        P.OD_SQRT_TBL_SHIFT + P.OD_ITHETA_SHIFT).clamp_min(1)
    return _wrap32(torch.where(_l(itheta) == 0, 0, k))


def _apply_householder(x, r):
    """Vectorized over rows: x, r (m, n) int64."""
    l2r = (r * r).sum(-1, keepdim=True)
    proj = (r * x).sum(-1, keepdim=True)
    l2r_shift = (_ilog(l2r) - 1) - 14
    l2r_norm = _wrap16(_vshr_round(l2r, l2r_shift))
    rcp = _od_rcp(l2r_norm)
    proj_shift = (_ilog(proj.abs()) - 1) - 14
    proj_norm = _wrap16(_vshr_round(proj, proj_shift))
    proj_1 = _wrap16(_mult16_16_q15(proj_norm, rcp))
    outshift = (P.OD_RCP_OUTSHIFT - proj_shift - 1 + l2r_shift) \
        .clamp_max(30)
    tmp = r * proj_1
    sp = outshift.clamp_min(0)
    pos = (tmp + ((1 << sp) >> 1)) >> sp
    neg = _shl32(tmp, (-outshift).clamp_min(0))
    tmp = torch.where(outshift >= 0, pos, neg)
    return _wrap16(x - tmp)


def _fconst(v, like):
    """A 0-dim float32 tensor on `like`'s device.  Dividing by it is a
    true division on every device (a CUDA division by a host scalar
    multiplies by the scalar's reciprocal instead)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Pulse search (reference: pvq_search_rdo_double, src/pvq_encoder.c:93-227)
# ---------------------------------------------------------------------------

_RSQRT16 = (1.000000, 0.707107, 0.577350, 0.500000, 0.447214, 0.408248,
            0.377964, 0.353553, 0.333333, 0.316228, 0.301511, 0.288675,
            0.277350, 0.267261, 0.258199, 0.250000)


@functools.lru_cache(maxsize=None)
def _rsqrt16(device):
    return torch.tensor(_RSQRT16, dtype=torch.float32, device=device)


def _pulse_search(xc, k, g2, lam, n, iters, lane_ok=None):
    """Vectorized greedy RDO pulse allocation.

    xc: (m, n) f32 signed coefficients; lane_ok: (m, n) bool, lanes
    outside the coded sub-vector (the theta path searches n-1 dims) are
    excluded from every argmax and contribute zero; k: (m,) int target
    pulses; g2: (m,) distortion scale; lam: host float.  Returns (y
    signed (m, n) int32, cos_dist (m,), ok (m,): False when `iters`
    steps were not enough).  Fresh search per call.

    The trip count is read once per call (one host sync): the largest
    number of pulses any row still needs after the floor-projection
    init, capped at `iters`.  Rows that finish early are masked, as in
    the JAX while_loop."""
    dev = xc.device
    if lane_ok is None:
        lane_ok = torch.ones(xc.shape, dtype=torch.bool, device=dev)
    xc = torch.where(lane_ok, xc, 0.0)
    x = xc.abs()
    xx = (x * x).sum(-1)
    norm_1 = 1.0 / torch.sqrt(1e-30 + xx)
    lamr = lam / (1e-30 + g2)
    kf = k.float()
    # Floor-projection init for k > 2 (host: k > 2 branch).
    l1 = x.sum(-1, keepdim=True)
    yp = torch.floor(kf[:, None] * x / l1.clamp_min(1e-30))
    yp = yp.clamp_min(0.0)
    yp = torch.where((k > 2)[:, None], yp, 0.0)
    xy = (x * yp).sum(-1)
    yy = (yp * yp).sum(-1)
    i = yp.sum(-1)
    rdo_pulses = 1 + torch.div(k, 4, rounding_mode="floor")
    delta_rate = torch.full_like(kf, 3.0 / n)
    accel_rate = torch.zeros_like(kf)
    if n == 15:
        accel_rate = torch.where(k == 1, -8.0 / n, accel_rate)
        delta_rate = torch.where(k == 1, 4.5 / n - (-8.0 / n), delta_rate)
    elif n == 8:
        accel_rate = torch.where(k == 1, 5.7 / n, accel_rate)
        delta_rate = torch.where(k == 1, 9.3 / n - 5.7 / n, delta_rate)
    jidx = torch.arange(n, dtype=torch.float32, device=dev)
    rate_pen = (lamr[:, None] * jidx[None, :]
                * (delta_rate[:, None] + jidx[None, :] * accel_rate[:, None]))
    rsq = _rsqrt16(dev)
    rows = torch.arange(xc.shape[0], device=dev)
    need = int(torch.ceil((kf - i).max()).item()) if xc.shape[0] else 0
    for _ in range(min(iters, max(need, 0))):
        active = i < kf
        phase2 = i >= (kf - rdo_pulses.float())
        txy = xy[:, None] + x
        tyy = yy[:, None] + 2.0 * yp + 1.0
        score1 = (txy * txy) / tyy
        small = tyy <= 16.0
        tidx = tyy.clamp(1.0, 16.0).long() - 1
        tyy_r = torch.where(small, rsq[tidx],
                            1.0 / torch.sqrt(tyy.clamp_min(1.0)))
        score2 = 2.0 * txy * norm_1[:, None] * tyy_r - rate_pen
        score = torch.where(phase2[:, None], score2, score1)
        score = torch.where(lane_ok, score, -math.inf)
        pos = score.argmax(-1)
        xadd = x.gather(1, pos[:, None])[:, 0]
        yold = yp.gather(1, pos[:, None])[:, 0]
        one = torch.where(active, 1.0, 0.0)
        yp = yp.index_put((rows, pos), one, accumulate=True)
        xy = xy + torch.where(active, xadd, 0.0)
        yy = yy + torch.where(active, 2.0 * yold + 1.0, 0.0)
        i = i + one
    ok = i >= kf
    cos_dist = xy / (1e-100 + torch.sqrt(xx * yy))
    cos_dist = torch.where(k == 0, 0.0, cos_dist)
    y = torch.where(xc < 0, -yp, yp).to(torch.int32)
    y = torch.where((k == 0)[:, None], 0, y)
    return y, cos_dist, ok


def _fast_rate(y, k, n_eff, n):
    """The reference's speed>0 rate model (od_pvq_rate,
    src/pvq_encoder.c:253-262), without the theta terms the caller
    adds."""
    ya = y.abs().float()
    j = torch.arange(n, dtype=torch.float32, device=y.device)[None, :]
    total = torch.where(j < n_eff, j * ya, 0.0).sum(-1)
    kf = k.float().clamp_min(1.0)
    f = total / (kf * n)
    rate = (1.0 + 0.4 * f) * n * torch.log2(
        1.0 + torch.log(n * 2.0 * (f + 0.025)).clamp_min(0.0)
        * kf / _fconst(n, kf)) + 3.0
    return torch.where(k == 0, 0.0, rate)


@functools.lru_cache(maxsize=None)
def _split_tree(n):
    """DFS-preorder binary split tree of a band of length n (the
    recursion of od_encode_band_pvq_splits,
    src/laplace_encoder.c:56-80): list of (base, size, level,
    parent_index)."""
    nodes = []

    def build(base, size, level, parent):
        idx = len(nodes)
        nodes.append((base, size, level, parent))
        if size <= 1:
            return
        mid = size >> 1
        build(base, mid, level + 1, idx)
        build(base + mid, size - mid, level + 1, idx)

    build(0, n, 0, -1)
    return tuple(nodes)


@functools.lru_cache(maxsize=None)
def _tree_tables(n_tree):
    """Static evaluation tables for the split tree of a band of length
    n_tree (numpy, cached): node spans, k1 CDF row ids, size contexts,
    and the proper-ancestor incidence matrix.  With these the whole
    tree evaluates as a fixed set of static-index gathers plus one
    (m, NN) x (NN, NN) matmul."""
    nodes = _split_tree(n_tree)
    nn = len(nodes)
    base = np.array([b for b, s, l, p in nodes], np.int32)
    size = np.array([s for b, s, l, p in nodes], np.int32)
    level = np.array([l for b, s, l, p in nodes], np.int32)
    parent = np.array([p for b, s, l, p in nodes], np.int32)
    anc = np.zeros((nn, nn), np.float32)
    for i in range(nn):
        p = parent[i]
        while p >= 0:
            anc[p, i] = 1.0
            p = parent[p]
    # k1 rows only exist for 1 < size <= 16 (is_k1 masks the rest; ids
    # outside that range would index past the CDF table).
    k1_id = np.array([P.k1_ctx(int(s), bool(l == 0))
                      if 1 < s <= 16 else 0
                      for s, l in zip(size, level)], np.int32)
    sz_ctx = np.array([P.size_ctx(int(s)) if s > 1 else 0
                       for s in size], np.int32)
    return dict(nn=nn, base=base, size=size, anc=anc, k1_id=k1_id,
                sz_ctx=sz_ctx, mid=(size >> 1))


@functools.lru_cache(maxsize=None)
def _tree_tensors(n_tree, w1, device):
    """_tree_tables(n_tree) as tensors on `device` (int64; the ancestor
    matrix float64), with the flat k1 CDF index of each node's total
    for a table of width w1."""
    tt = _tree_tables(n_tree)
    out = {k: torch.from_numpy(np.asarray(v, np.int64)).to(device)
           for k, v in tt.items() if k not in ("nn", "anc")}
    out["anc"] = torch.from_numpy(tt["anc"].astype(np.float64)).to(device)
    out["tot1"] = torch.from_numpy(
        (tt["k1_id"] * w1 + np.minimum(tt["size"] - 1, w1 - 1))
        .astype(np.int64)).to(device)
    return out


def _codeword_rate(y, k, n_tree, n, k1_cdf, split_cdf):
    """Exact PVQ codeword rate (bits) from frame-start CDF tables:
    replays the recursive split coder of encode_band_pvq_splits
    (reference: src/laplace_encoder.c:56-80) over a static DFS tree,
    vectorized over (rows, nodes).  n_tree is the coded vector length
    (n for noref, n-1 for the theta path).  Within-band CDF adaptation
    is the only approximation.

    blocked(node) ("an ancestor terminated coding") is the OR over
    proper ancestors a of [(k(a)==1 & size(a)<=16) | k(a)==0]: one
    matmul of the 0/1 termination flags against the static ancestor
    matrix.  It runs in float64, which no reduced-precision matmul
    setting touches; every product is 0 or 1 and every sum at most the
    tree depth, so it is exact."""
    del k  # k == 0 rows fall out of the node masks
    m = y.shape[0]
    dev = y.device
    w1 = k1_cdf.shape[1]
    tg = _tree_tensors(n_tree, w1, dev)
    ya = y.abs().long()
    lane = torch.arange(n, device=dev)[None, :]
    ya = torch.where(lane < n_tree, ya, 0)
    zcol = torch.zeros((m, 1), dtype=torch.int64, device=dev)
    csum = torch.cat([zcol, ya.cumsum(-1)], -1)
    # Weighted prefix sums give each k==1 span's pulse position in O(1).
    wsum = torch.cat([zcol, (ya * lane).cumsum(-1)], -1)
    base, size = tg["base"], tg["size"]
    k_node = csum[:, base + size] - csum[:, base]          # (m, NN)
    term = ((k_node == 1) & (size <= 16)[None, :]) | (k_node == 0)
    blocked = (term.double() @ tg["anc"]) > 0.5
    inner = (size > 1)[None, :]
    active = (~blocked) & (k_node > 0) & inner
    is_k1 = active & (k_node == 1) & (size <= 16)[None, :]
    # k == 1 leaf: position coded from pvq_k1_cdf[k1_ctx].
    pos = (wsum[:, base + size] - wsum[:, base]) - base[None, :]
    pos = torch.minimum(pos.clamp_min(0), (size - 1)[None, :])
    flat1 = k1_cdf.reshape(-1)
    last1 = flat1.shape[0] - 1
    rowoff = (tg["k1_id"] * w1)[None, :]
    tot1 = flat1[tg["tot1"]][None, :].float()
    # JAX clamps gather indices into range; these only reach past the
    # table on nodes that is_k1 masks out.
    hi1 = flat1[(rowoff + pos).clamp_max(last1)].float()
    lo1 = torch.where(pos > 0,
                      flat1[(rowoff + (pos - 1).clamp_min(0))
                            .clamp_max(last1)], 0).float()
    cost_k1 = (torch.log2(tot1.clamp_min(1.0))
               - torch.log2((hi1 - lo1).clamp_min(1.0)))
    # Split node: count_right from pvq_split_cdf[fctx] + raw bits.
    is_split = active & ~is_k1
    count_right = csum[:, base + size] - csum[:, base + tg["mid"]]
    shift = (_ilog(k_node) - 3).clamp_min(0)
    msbs = count_right >> shift
    t_red = k_node >> shift
    fctx = (7 * tg["sz_ctx"][None, :] + t_red - 1) \
        .clamp(0, split_cdf.shape[0] - 1)
    w2 = split_cdf.shape[1]
    flat2 = split_cdf.reshape(-1)
    roff2 = fctx * w2
    tot2 = flat2[roff2 + t_red.clamp_max(w2 - 1)].float()
    hi2 = flat2[roff2 + msbs.clamp_max(w2 - 1)].float()
    lo2 = torch.where(msbs > 0,
                      flat2[roff2 + (msbs - 1).clamp(0, w2 - 1)],
                      0).float()
    cost_sp = (torch.log2(tot2.clamp_min(1.0))
               - torch.log2((hi2 - lo2).clamp_min(1.0))
               + shift.float())
    return (torch.where(is_k1, cost_k1, 0.0).sum(-1)
            + torch.where(is_split, cost_sp, 0.0).sum(-1))


def _select(best_cost, cost, ok, isnr):
    """The sequential `better` selection of the JAX scan, in closed form.

    The scan starts from the initial candidate (index -1, cost
    best_cost) and lets candidate c (in order) replace the best when it
    is ok and its cost is below the best's (theta: `<`) or not above it
    (noref: `<=`); a NaN never compares true.  So the best cost ends at
    the minimum, the first candidate to reach it (the initial one
    first) becomes the best there, and after it only noref candidates
    of equal cost replace it: the winner is the last such noref
    candidate, else the first to reach the minimum.  A NaN initial cost
    is never replaced.  cost/ok/isnr: (C, m); returns the winner per
    row, -1 for the initial candidate."""
    C = cost.shape[0]
    cidx = torch.arange(C, device=cost.device)[:, None]
    valid = ok & ~torch.isnan(cost)
    mn = torch.minimum(best_cost,
                       torch.where(valid, cost, math.inf).amin(0))
    at_min = valid & (cost == mn)
    first = torch.where(at_min, cidx, C).amin(0)
    first = torch.where(best_cost == mn, -1, first)
    last_nr = torch.where(at_min & isnr & (cidx > first), cidx, -1).amax(0)
    win = torch.where(last_nr >= 0, last_nr, first)
    return torch.where(torch.isnan(best_cost), -1, win)


def _take(a, win):
    """a (C, m, ...) at the winners (m,) (clamped; -1 rows are the
    caller's to mask)."""
    w = win.clamp_min(0)
    idx = w.view((1, -1) + (1,) * (a.dim() - 2)).expand((1,) + a.shape[1:])
    return a.gather(0, idx)[0]


# ---------------------------------------------------------------------------
# The per-band-length band search.
# ---------------------------------------------------------------------------


def band_search(dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15,
                lam, n, iters, k1_cdf=None, split_cdf=None,
                is_keyframe=False):
    """Batched pvq_theta for inter bands and keyframe-luma bands, on the
    device of its tensors (JAX's band_search, with its arguments as
    torch tensors on one device and n, iters, lam, is_keyframe host
    values).

      dflat, mdflat: 1-D int32 concatenations of the frame's input /
          MC-prediction coefficient planes (the analysis outputs, still
          on the device; keyframes: pass dflat twice).
      base: (m,) flat offset of each row's block origin inside dflat.
      tabsel: (m,) row -> gather-table id; tab: (T, n) flat offsets of
          the band's coefficients relative to the block origin, in
          coding order; qmtab: (T, n) the tables' QM slices.
      q0: (m,) band quantizers; beta15: (m,) bool, the row uses the
          activity-masking beta 1.5 (else beta 1).
      k1_cdf, split_cdf: the frame-start codeword CDF tables (int); None
          selects the fast rate model.

    is_keyframe gates the keyframe differences of pvq_theta: the skip
    distortion is the plain gain energy, no theta=0 reference-gain
    candidate, and no theta machinery (R == 0 makes it dead).

    Returns ints (m, 6) int32 = [noref, qg, itheta, max_theta, k,
    valid], y (m, n) int16 and skip_diff (m,) f32, as JAX's."""
    with torch.profiler.record_function("band_search"):
        return _band_search(dflat, mdflat, base, tabsel, tab, qmtab, q0,
                            beta15, lam, n, iters, k1_cdf, split_cdf,
                            is_keyframe)


def _band_search(dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15, lam,
                 n, iters, k1_cdf, split_cdf, is_keyframe):
    dev = dflat.device
    idx = base.long()[:, None] + tab.long()[tabsel.long()]
    inb = (idx >= 0) & (idx < dflat.shape[0])
    idx = idx.clamp(0, max(dflat.shape[0] - 1, 0))
    Xl = torch.where(inb, dflat[idx], 0).long()
    qml = qmtab.long()[tabsel.long()]
    q0 = q0.long()
    beta15 = beta15.bool()
    m = Xl.shape[0]
    rows = torch.arange(m, device=dev)
    inv_cs2 = _INV_CS2
    # vector_log_mag (src/pvq.c:470-484)
    tx = Xl >> 8
    xs_tot = (tx * tx).sum(-1)
    xshift = (8 + 1 + torch.div(_ilog(n + xs_tot), 2, rounding_mode="floor")
              - 15).clamp_min(0)
    x16 = _vshr_round(Xl * qml, P.OD_QM_SHIFT + xshift[:, None])
    cg, g = _compute_gain(x16, q0, beta15, xshift)
    cgf = cg.float()
    x16_f = x16.float()
    if not is_keyframe:
        Rl = torch.where(inb, mdflat[idx], 0).long()
        tr = Rl >> 8
        rs_tot = (tr * tr).sum(-1)
        rshift = (8 + 1 + torch.div(_ilog(n + rs_tot), 2,
                                    rounding_mode="floor") - 14).clamp_min(0)
        r16 = _vshr_round(Rl * qml, P.OD_QM_SHIFT + rshift[:, None])
        corr_i = (x16 * r16).sum(-1)
        cgr, gr = _compute_gain(r16, q0, beta15, rshift)
        icgr = _shr_round(cgr, P.OD_CGAIN_SHIFT)
        gain_offset = cgr - _shl32(icgr, P.OD_CGAIN_SHIFT)
        cgrf = cgr.float()
        corr = corr_i.float() / (
            1e-100 + g.float() * gr.float()
            / _shl32(torch.ones_like(g), xshift + rshift).float())
        corr = corr.clamp(-1.0, 1.0)
        # skip_dist (inter branch of pvq_theta).
        skip_dist = (_GAIN_WEIGHT * (cgf - cgrf) ** 2
                     + cgrf * cgf * (2.0 - 2.0 * corr)) * inv_cs2
    else:
        # Keyframe skip codes zeros: the plain gain energy.
        skip_dist = _GAIN_WEIGHT * cgf * cgf * inv_cs2
    # Initial candidate: qg=0 noref zero-vector.
    best_dist = _GAIN_WEIGHT * cgf * cgf * inv_cs2
    zeros_m = torch.zeros(m, dtype=torch.int64, device=dev)
    noref0 = 1
    itheta0 = -1
    if not is_keyframe:
        # Initial candidate 2 (inter): reference-gain, theta=0 (qg=0
        # coded).  For icgr != 0 the host keeps the zero-vector
        # distortion from candidate 1 (pvq_theta only overwrites it in
        # the icgr == 0 branch).
        scgr = gain_offset.float().clamp_min(0.0)
        best_dist = torch.where(
            icgr == 0,
            (_GAIN_WEIGHT * (cgf - scgr) ** 2
             + scgr * cgf * (2.0 - 2.0 * corr)) * inv_cs2,
            best_dist)
        noref0 = 0
        itheta0 = 0
    dist0 = best_dist
    best_cost = best_dist

    gb_nr = cg >> P.OD_CGAIN_SHIFT
    # Candidate parameters on a leading candidate axis: 3 gains x 4
    # thetas (inter), then 2 noref gains.
    cand = []   # (i, j, ok, k, ts, g2, sinp, qth, isnr), each (c, m)
    if not is_keyframe:
        theta_on = Rl.ne(0).any(-1) & (corr > 0.0)
        # Householder reflection of r16.
        mpos = r16.abs().argmax(-1)
        rm = r16.gather(1, mpos[:, None])[:, 0]
        s = torch.where(rm > 0, 1, -1)
        bump = _shr_round(gr * s, rshift)
        r16_refl = r16.index_put((rows, mpos), _wrap16(rm + bump))
        xr_full = _apply_householder(x16, r16_refl)
        # Delete index mpos: xr[j] = xr_full[j + (j >= mpos)], j < n-1.
        jj = torch.arange(n, device=dev)[None, :]
        gidx = jj + (jj >= mpos[:, None]).long()
        xr = xr_full.gather(1, gidx.clamp_max(n - 1))
        theta_f = torch.acos(corr)
        theta_q = torch.floor(0.5 + P.OD_MAX_THETA_SCALE * 2.0 / np.pi
                              * theta_f).long()
        gain_bound = (cg - gain_offset) >> P.OD_CGAIN_SHIFT
        i_base = (gain_bound - 1).clamp_min(1)
        theta_scale_1 = 1.0 / ((1 << 15) * 2.0 / np.pi)
        # xr lane n-1 is padding for the (n-1)-dim sub-search; excluded
        # from the pulse search via its lane mask.
        xr_f = xr.float()
        xr_f[:, n - 1] = 0.0
        noref_on = (corr < 0.5) | (cg < _shl32(torch.full_like(cg, 2),
                                               P.OD_CGAIN_SHIFT))
        # 3 gains (axis 0) x 4 thetas (axis 1), flattened gain-major.
        i3 = _wrap32(i_base[None, :] + torch.arange(3, device=dev)[:, None])
        gain_ok = i3 <= gain_bound + 1
        qcg3 = _shl32(i3, P.OD_CGAIN_SHIFT) + gain_offset
        ts3 = _compute_max_theta(qcg3, beta15)
        tq_s = theta_q.float() * theta_scale_1 * 2.0 / _fconst(np.pi, cgf)
        tpos = tq_s * ts3.float()
        t_lower = (torch.floor(0.5 + tpos).long() - 2).clamp_min(0)
        t_upper = torch.minimum(ts3 - 1, torch.ceil(tpos).long())
        four = torch.arange(4, device=dev)[None, :, None]
        j = (t_lower[:, None, :] + four).reshape(12, m)
        rep = lambda a: a[:, None, :].expand(3, 4, m).reshape(12, m)
        i_t, qcg_t, ts_t = rep(i3), rep(qcg3), rep(ts3)
        ok_t = (theta_on & rep(gain_ok) & (j <= rep(t_upper)) & (j >= 0))
        qth_t = _wrap32(_compute_theta(j, ts_t))
        k_t = _compute_k(qcg_t, j, False, n, beta15)
        qcgf_t = qcg_t.float()
        dist_th = 2.0 - 2.0 * _pvq_cos(theta_q - qth_t).float() \
            / P.OD_TRIG_SCALE
        dist_pre = (_GAIN_WEIGHT * (qcgf_t - cgf) ** 2
                    + qcgf_t * cgf * dist_th) * inv_cs2
        ok_t = ok_t & ~((dist_pre > dist0 + lam) & (k_t != 0))
        sin_prod = (_pvq_sin(theta_q).float() / P.OD_TRIG_SCALE) \
            * (_pvq_sin(qth_t).float() / P.OD_TRIG_SCALE)
        cand.append((i_t, j, ok_t, k_t, ts_t,
                     qcgf_t * cgf * sin_prod * inv_cs2, sin_prod, qth_t,
                     torch.zeros_like(ok_t)))
    else:
        # Keyframe luma always searches the noref branch (pvq_theta:
        # `(is_keyframe && pli == 0) || corr < 0.5 || ...`).
        noref_on = torch.ones(m, dtype=torch.bool, device=dev)
        xr_f = x16_f      # unused (every candidate is noref)
        theta_q = zeros_m
        icgr = zeros_m
        gain_offset = zeros_m
    i_n = _wrap32(gb_nr.clamp_min(1)[None, :]
                  + torch.arange(2, device=dev)[:, None])
    gain_ok = i_n <= gb_nr + 1
    qcg_n = _shl32(i_n, P.OD_CGAIN_SHIFT)
    k_n = _compute_k(qcg_n, None, True, n, beta15)
    qcgf_n = qcg_n.float()
    dist_pre = _GAIN_WEIGHT * (qcgf_n - cgf) ** 2 * inv_cs2
    ok_n = noref_on & gain_ok & ~((dist_pre > dist0) & (k_n != 0))
    zf = torch.zeros_like(qcgf_n)
    cand.append((i_n, torch.full_like(i_n, -1), ok_n, k_n,
                 torch.zeros_like(i_n), qcgf_n * cgf * inv_cs2, zf,
                 torch.zeros_like(i_n), torch.ones_like(ok_n)))
    c_i, c_j, c_ok, c_k, c_ts, c_g2, c_sinp, c_qth, c_isnr = (
        torch.cat(parts) for parts in zip(*cand))
    C = c_i.shape[0]
    trate = 0.9 * torch.log2(c_ts.float().clamp_min(1.0)) \
        - 0.5 * (c_i == icgr[None, :]).float()
    dth = (2.0 - 2.0 * _pvq_cos(theta_q[None, :] - c_qth).float()
           / P.OD_TRIG_SCALE)
    qcgf = torch.where(c_isnr, _shl32(c_i, P.OD_CGAIN_SHIFT),
                       _shl32(c_i, P.OD_CGAIN_SHIFT)
                       + gain_offset[None, :]).float()

    # One pulse search over every candidate's rows, stacked (C*m, n).
    xvec = torch.where(c_isnr[:, :, None], x16_f[None], xr_f[None])
    lane_ok = c_isnr[:, :, None] | (torch.arange(n, device=dev)
                                    < n - 1)[None, None, :]
    lane_ok = lane_ok.expand(C, m, n)
    kk = torch.where(c_ok, c_k, 0)
    y_c, cos_dist, ok_p = _pulse_search(
        xvec.reshape(C * m, n), kk.reshape(-1), c_g2.reshape(-1), lam, n,
        iters, lane_ok=lane_ok.reshape(C * m, n))
    y_c = y_c.view(C, m, n)
    cos_dist = cos_dist.view(C, m)
    valid = ~(c_ok & ~ok_p.view(C, m)).any(0)
    dist_theta = dth + c_sinp * (2.0 - 2.0 * cos_dist)
    dist_t = (_GAIN_WEIGHT * (qcgf - cgf) ** 2
              + qcgf * cgf * dist_theta) * inv_cs2
    dist_n = (_GAIN_WEIGHT * (qcgf - cgf) ** 2
              + qcgf * cgf * (2.0 - 2.0 * cos_dist)) * inv_cs2
    dist = torch.where(c_isnr, dist_n, dist_t)
    # The noref candidates are the last 2 (rate over n lanes); the theta
    # candidates before them code n-1 lanes.
    nt = C - 2
    if k1_cdf is not None:
        rate_parts = []
        if nt:
            rate_parts.append(_codeword_rate(
                y_c[:nt].reshape(nt * m, n), None, n - 1, n, k1_cdf,
                split_cdf).view(nt, m))
        rate_parts.append(_codeword_rate(
            y_c[nt:].reshape(2 * m, n), None, n, n, k1_cdf,
            split_cdf).view(2, m))
        rate = torch.cat(rate_parts)
    else:
        n_eff = torch.where(c_isnr, n, n - 1).reshape(-1, 1)
        rate = _fast_rate(y_c.reshape(C * m, n), c_k.reshape(-1), n_eff,
                          n).view(C, m)
    rate = rate + torch.where(c_isnr, 0.0, trate)
    cost = dist + lam * rate
    win = _select(best_cost, cost, c_ok, c_isnr)
    sel = win >= 0
    best_dist = torch.where(sel, _take(dist, win), best_dist)
    noref = torch.where(sel, _take(c_isnr, win).long(), noref0)
    best_qg = torch.where(sel, _take(c_i, win), 0)
    best_itheta = torch.where(sel, _take(c_j, win), itheta0)
    best_ts = torch.where(sel, _take(c_ts, win), 0)
    best_k = torch.where(sel, _take(c_k, win), 0)
    best_y = torch.where(sel[:, None], _take(y_c, win), 0)
    skip_diff = skip_dist - best_dist
    # int16 pulse transport: |y[i]| <= k, so one bound check keeps the
    # packing exact (the host searches the impossible overflow itself).
    valid = valid & (best_k <= 32767)
    ints = torch.stack([noref, best_qg, best_itheta, best_ts, best_k,
                        valid.long()], -1).to(torch.int32)
    return ints, best_y.to(torch.int16), skip_diff


# ---------------------------------------------------------------------------
# Frame-level entry point: bucket the bands of a frame by length, search on
# the device, emit a decision table for the host entropy pass.
# ---------------------------------------------------------------------------


class DevicePVQTable:
    """Dense per-frame device PVQ decision table (a copy of
    daala_tpu.models.pvqsearch.DevicePVQTable, which lives in a module
    that imports jax).

    groups: one entry per (plane, block size) with vector block
    coordinates and per-band result arrays; native_arrays() flattens
    them to the (idx, meta, yoff, ypool, sd) arrays frame_enc.inc's
    ec_pvq_theta_forced replay reads, with numpy scatters.  (JAX's
    get(), the per-band view of its Python coefficient path, is not
    copied: the port has only the native pass.)
    """

    def __init__(self):
        self.groups = []

    def native_arrays(self, st, info):
        """Flatten to the native replay arrays (idx int32 per-plane 4x4
        grid concat -> slot | -1, meta (nslots, 16, 6) int32,
        yoff (nslots,) int64, ypool int32, sd (nslots, 16) f64), slot
        order = sorted (pli, by4, bx4)."""
        base = [0] * (info.nplanes + 1)
        n4h_p = [0] * info.nplanes
        for pli in range(info.nplanes):
            xd, yd = info.plane_dec[pli]
            n4h_p[pli] = (st.frame_width >> xd) >> 2
            base[pli + 1] = base[pli] + \
                ((st.frame_height >> yd) >> 2) * n4h_p[pli]
        if not self.groups:
            return (np.full(max(1, base[info.nplanes]), -1, np.int32),
                    np.zeros((1, 16, 6), np.int32),
                    np.zeros(1, np.int64), np.zeros(1, np.int32),
                    np.zeros((1, 16), np.float64))
        flat = np.concatenate([
            base[g["pli"]] + g["by4"].astype(np.int64) * n4h_p[g["pli"]]
            + g["bx4"] for g in self.groups])
        slen_all = np.concatenate([
            np.full(len(g["by4"]), part.scan_length(4 << g["bs"]),
                    np.int64) for g in self.groups])
        order = np.argsort(flat, kind="stable")
        nslots = len(flat)
        slot_of = np.empty(nslots, np.int64)
        slot_of[order] = np.arange(nslots)
        idx = np.full(base[info.nplanes], -1, np.int32)
        idx[flat] = slot_of.astype(np.int32)
        slen_sorted = slen_all[order]
        yoff = np.zeros(nslots, np.int64)
        yoff[1:] = np.cumsum(slen_sorted)[:-1]
        ypool = np.zeros(max(1, int(slen_sorted.sum())), np.int32)
        meta = np.zeros((nslots, 16, 6), np.int32)
        sd = np.zeros((nslots, 16), np.float64)
        row0 = 0
        for g in self.groups:
            m_grp = len(g["by4"])
            slots = slot_of[row0:row0 + m_grp]
            row0 += m_grp
            offs = part.band_offsets(4 << g["bs"])
            yo = yoff[slots]
            for band, r in g["bands"].items():
                meta[slots, band, 0] = r["noref"]
                meta[slots, band, 1] = r["qg"]
                meta[slots, band, 2] = r["itheta"]
                meta[slots, band, 3] = r["ts"]
                meta[slots, band, 4] = r["k"]
                meta[slots, band, 5] = r["valid"]
                sd[slots, band] = r["skip_diff"]
                o0 = int(offs[band])
                nn = r["y"].shape[1]
                ypool[yo[:, None]
                      + (o0 + np.arange(nn, dtype=np.int64))[None, :]] \
                    = r["y"]
        return idx, meta, yoff, ypool, sd


def search_frame(st, info, quantizer, d_planes, md_planes, lam,
                 is_keyframe=False, use_masking=True):
    """Device PVQ search for a whole frame's bands, on the device of
    the planes.

    st: codec state (bsize map, qm tables, pvq_qm_q4, the frame-start
    codeword CDFs); d_planes / md_planes: per-plane whole-frame
    frequency-domain input / reference coefficients, as tensors on one
    device (the deferred analysis outputs; md_planes None on
    keyframes).  For inter frames every plane searches
    against its MC prediction; for keyframes only luma is searched,
    against a zero reference (chroma/CfL keyframe bands reference the
    coded luma and stay on the host, reference
    src/pvq_encoder.c:858-875).

    One band_search call per band length: the rows carry only compact
    descriptors (block base offset, gather-table id, quantizer, beta);
    the coefficients never leave the device.

    Returns a zero-argument `finish()`: every call has been queued and
    finish() fetches the results as a DevicePVQTable.  Both parts run in
    the devstats span "search_frame"."""
    with devstats.span("search_frame"):
        finish = _dispatch(st, info, quantizer, d_planes, md_planes, lam,
                        is_keyframe, use_masking)

    def timed_finish():
        with devstats.span("search_frame"):
            return finish()
    return timed_finish


def _dispatch(st, info, quantizer, d_planes, md_planes, lam, is_keyframe,
           use_masking):
    cw = st.adapt.pvq.pvq_codeword_ctx
    table = DevicePVQTable()
    buckets = {}   # n -> dict(base=[], tsel=[], q0=[], b15=[], segs=[])
    tabs = {}      # nn -> {(stride, bs, band, off_qm): tab_id}
    tab_rows = {}  # nn -> [(off_row int32[nn], qm_row int32[nn])]
    nplanes = 1 if is_keyframe else len(d_planes)
    bs8 = np.asarray(st.bsize)
    dev = d_planes[0].device

    def _flatten(planes):
        return torch.cat([p.reshape(-1).to(torch.int32)
                          for p in planes[:nplanes]])

    plane_base = [0] * (nplanes + 1)
    for pli in range(nplanes):
        plane_base[pli + 1] = plane_base[pli] + \
            int(np.prod(tuple(d_planes[pli].shape)))
    dflat = _flatten(d_planes)
    mdflat = dflat if is_keyframe else _flatten(md_planes)
    for pli in range(nplanes):
        xdec, ydec = info.plane_dec[pli]
        stride = int(d_planes[pli].shape[1])
        n4v = (st.frame_height >> ydec) >> 2
        n4h = (st.frame_width >> xdec) >> 2
        # Plane leaf size: the luma block-size recursion clamped at the
        # plane decimation (decode_recursive's `bs = max(obs, xdec) -
        # xdec`), vectorized over the plane 4x4 grid.
        by4g, bx4g = np.mgrid[0:n4v, 0:n4h]
        bs_map = np.maximum(
            bs8[(by4g << ydec) >> 1, (bx4g << xdec) >> 1], xdec) - xdec
        lead = (((by4g & ((1 << bs_map) - 1)) == 0)
                & ((bx4g & ((1 << bs_map) - 1)) == 0))
        for bs in range(int(bs_map.max()) + 1):
            sel = lead & (bs_map == bs)
            if not sel.any():
                continue
            by4s, bx4s = np.nonzero(sel)
            by4s = by4s.astype(np.int32)
            bx4s = bx4s.astype(np.int32)
            n = 4 << bs
            offs = part.band_offsets(n)
            nb_bands = len(offs) - 1
            slen = part.scan_length(n)
            off_qm = P.qm_offset(bs, xdec)
            qm_slice = np.asarray(st.qm[off_qm:off_qm + slen], np.int32)
            beta15 = bool(use_masking and pli == 0 and bs > 0)
            m_grp = len(by4s)
            # Flat offset of each block's raster origin inside dflat.
            blk_base = (plane_base[pli]
                        + ((by4s.astype(np.int64) >> bs) * n) * stride
                        + (bx4s.astype(np.int64) >> bs) * n) \
                .astype(np.int32)
            grp = dict(pli=pli, bs=bs, by4=by4s, bx4=bx4s, bands={})
            table.groups.append(grp)
            co = part.coding_order_indices(n)
            for band in range(nb_bands):
                o0, o1 = int(offs[band]), int(offs[band + 1])
                nn = o1 - o0
                q_band = max(1, max(1, quantizer)
                             * int(st.pvq_qm_q4[pli][P.qm_get_index(
                                 bs, band + 1)]) >> 4)
                bk = buckets.setdefault(
                    nn, dict(base=[], tsel=[], q0=[], b15=[],
                             segs=[], m=0))
                tkey = (stride, bs, band, off_qm)
                tmap = tabs.setdefault(nn, {})
                tid = tmap.get(tkey)
                if tid is None:
                    tid = len(tmap)
                    tmap[tkey] = tid
                    cb = co[o0:o1]
                    off_row = ((cb // n) * stride + cb % n) \
                        .astype(np.int32)
                    tab_rows.setdefault(nn, []).append(
                        (off_row, qm_slice[o0:o1]))
                bk["base"].append(blk_base)
                bk["tsel"].append(np.full(m_grp, tid, np.int32))
                bk["q0"].append(np.full(m_grp, q_band, np.int32))
                bk["b15"].append(np.full(m_grp, beta15, np.bool_))
                bk["segs"].append((grp, band, bk["m"], m_grp))
                bk["m"] += m_grp
    # Queue every band_search call first, then fetch all results.
    pending = []  # (segs, device results tuple)
    k1_cdf = devstats.upload(np.asarray(cw.pvq_k1_cdf, np.int32), dev)
    split_cdf = devstats.upload(np.asarray(cw.pvq_split_cdf, np.int32), dev)
    for nn in sorted(buckets):
        bk = buckets[nn]
        rows = tab_rows[nn]
        args = [devstats.upload(a, dev) for a in (
            np.concatenate(bk["base"]), np.concatenate(bk["tsel"]),
            np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
            np.concatenate(bk["q0"]), np.concatenate(bk["b15"]))]
        devstats.dispatch()
        pending.append((bk["segs"], band_search(
            dflat, mdflat, *args, float(lam), nn, int(nn + 64),
            k1_cdf=k1_cdf, split_cdf=split_cdf,
            is_keyframe=bool(is_keyframe))))

    def finish():
        devstats.prefetch(*[r for _, res in pending for r in res])
        for segs, res in pending:
            ints = devstats.fetch(res[0])
            y = devstats.fetch(res[1], None).astype(np.int32)
            skip_diff = devstats.fetch(res[2], None).astype(np.float64)
            devstats.count("pvq_rows", len(ints))
            devstats.count("pvq_invalid_rows", int((ints[:, 5] == 0).sum()))
            for grp, band, start, m_grp in segs:
                sl = slice(start, start + m_grp)
                grp["bands"][band] = dict(
                    noref=ints[sl, 0], qg=ints[sl, 1],
                    itheta=ints[sl, 2], ts=ints[sl, 3], k=ints[sl, 4],
                    y=y[sl], skip_diff=skip_diff[sl],
                    valid=ints[sl, 5])
        return table
    return finish
