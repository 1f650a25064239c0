"""The PVQ pulse search in plain PyTorch: a frozen copy of the plain
version in the port's ops/cuda/pulse_kernels.py (the code its
pulse_search kernel equals bit for bit), without the kernel.

Replaces _pulse_search (daala_tpu/models/pvqsearch.py:318), which JAX
runs in XLA, not Pallas: for each (m, n) row of signed coefficients,
the masked magnitudes and their sums, the floor-projection init, the
rate penalties, the greedy loop that adds one pulse at a time at the
lane of the highest score (the first on a tie), and the signed pulses
and the cosine distance after it.  One launch a call on the card.

The float32 row sums (x.x, x.y, y.y, |x|_1 and the init's pulse count)
are taken in the order XLA:CPU takes JAX's (`ordered_sum`,
`ordered_dot`); they set the distortion of every candidate and, past
2^24, differ in the last bit between orders.  The step's arithmetic is
csrc/pulse_step.cuh, every float operation in the plain version's
association, so the kernel equals the plain version bit for bit;
tests/test_torch_pulse_plan.py compiles the header for the host.

The plain version runs the batch's largest trip count with the rows
that have their pulses frozen, and reads that count back to the host
once a call; the kernel runs each row's own count, so nothing comes
back to the host.

`pulse_search` launches the kernel for tensors on a CUDA device and
runs the plain version only for tensors on the CPU; there is no
fallback.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


CHUNK = 32  # XLA:CPU sums rows longer than this in chunks of this many

_RSQRT16 = (1.000000, 0.707107, 0.577350, 0.500000, 0.447214, 0.408248,
            0.377964, 0.353553, 0.333333, 0.316228, 0.301511, 0.288675,
            0.277350, 0.267261, 0.258199, 0.250000)


@functools.lru_cache(maxsize=None)
def _rsqrt16(device):
    return torch.tensor(_RSQRT16, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _rsqrt_seed(device):
    """The 12-bit estimate of x86's rsqrtps as int32 float bit patterns:
    entry p * 1024 + i covers [2^p (1 + i/1024), 2^p (1 + (i+1)/1024))
    and holds round(2^13 / sqrt(its midpoint)) / 2^13 (every entry in
    [0.5, 1), exponent 126)."""
    mid = (1.0 + (np.arange(1024) + 0.5) / 1024.0)
    mid = np.concatenate([mid, 2.0 * mid])
    est = (np.rint(8192.0 / np.sqrt(mid)) / 8192.0).astype(np.float32)
    return torch.from_numpy(est.view(np.int32)).to(device)


def _fma32(a, b, c):
    """The fused multiply-add a * b + c of float32 tensors (b and c may be
    floats that are float32 values), rounded once to float32, as the
    hardware FMAs that XLA:CPU contracts into and the card's fmaf.  The
    product is exact in float64, and the float64 sum rounded to float32
    is the one rounding of the exact value except where that sum lands
    on a float32 midpoint (or in float32's subnormal range) while it was
    inexact: there the sum is rounded to odd (its exact error, by
    TwoSum, steps a sum whose last bit is even one ulp toward the
    error) before the float32 rounding, which is then correct because
    53 >= 2 x 24 + 2."""
    a = a.double()
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    p = a * b
    s = p + c
    mid = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    near = mid | ((s.abs() < 2.0 ** -125) & (s != 0))
    if bool(near.any()):
        bv = s - p
        err = (p - (s - bv)) + (c - bv)
        even = (s.view(torch.int64) & 1) == 0
        step = near & even & (err != 0)
        s = torch.where(step, torch.nextafter(s, err * math.inf), s)
    return s.float()


def _rsqrt(x):
    """1 / sqrt(x) of a float32 tensor of positive normal values or
    zeros, as XLA:CPU computes JAX's `1.0 / jnp.sqrt(x)`: XLA rewrites
    it into rsqrt, which it evaluates as the 12-bit rsqrtps estimate
    (`_rsqrt_seed`, scaled by the exponent) refined by two Newton steps,
    u = fma(x y, y, -1), y = fma(-y / 2, u, y); zero gives inf.  About
    one value in eight differs from the correctly rounded one."""
    b = x.view(torch.int32)
    e = (b >> 23) - 127
    par = e & 1
    seed = _rsqrt_seed(x.device)[(par << 10) | ((b >> 13) & 1023)]
    y = (seed - (((e - par) >> 1) << 23)).view(torch.float32)
    for _ in range(2):
        u = _fma32(x * y, y, -1.0)
        y = _fma32(y * -0.5, u, y)
    return torch.where(x == 0, math.inf, y)


def ordered_sum(v):
    """The float32 sums of the rows of v (m, n) in XLA:CPU's order: for
    n <= 32 one chain from lane 0 up; longer rows in chunks of 32 lanes
    (XLA's reduce-window), each chunk a chain, then the chunk sums in
    order.  Checked against JAX at n = 8, 15, 32, 64, 128 and 256; other
    lengths over 32 are summed as if padded with zeros to a multiple of
    32.  At most 32 steps over (m, n / 32) tensors."""
    m, n = v.shape
    if n <= CHUNK:
        acc = v.new_zeros(m)
        for j in range(n):
            acc = acc + v[:, j]
        return acc
    nc = -(-n // CHUNK)
    v = torch.nn.functional.pad(v, (0, nc * CHUNK - n)).view(m, nc, CHUNK)
    acc = v.new_zeros(m, nc)
    for j in range(CHUNK):
        acc = acc + v[:, :, j]
    total = v.new_zeros(m)
    for c in range(nc):
        total = total + acc[:, c]
    return total


def ordered_dot(a, b):
    """The float32 dot products of the rows of a and b (m, n) in XLA:CPU's
    order: for n <= 32 one chain of fused multiply-adds from lane 0 up
    (LLVM contracts the product into the sum); longer rows round each
    product to float32 and sum them as `ordered_sum`."""
    m, n = a.shape
    if n > CHUNK:
        return ordered_sum(a * b)
    acc = a.new_zeros(m)
    for j in range(n):
        acc = _fma32(a[:, j], b[:, j], acc)
    return acc


def rate_constants(n):
    """(delta, accel, delta for k = 1, accel for k = 1): the float32 rate
    model constants of a row of n lanes (the reference's n = 8 and 15
    special cases for k = 1)."""
    delta, accel = np.float32(3.0 / n), np.float32(0.0)
    if n == 15:
        return delta, accel, np.float32(4.5 / n - (-8.0 / n)), \
            np.float32(-8.0 / n)
    if n == 8:
        return delta, accel, np.float32(9.3 / n - 5.7 / n), \
            np.float32(5.7 / n)
    return delta, accel, delta, accel


def pulse_loop_plain(x, yp, xy, yy, i, kf, rdo_pulses, norm_1, rate_pen,
                     lane_ok, iters):
    """The greedy loop of the plain version.  The trip count is read once
    per call (one host sync): the largest number of pulses any row still
    needs, capped at `iters`.  Rows that finish early are masked, as in
    the JAX while_loop."""
    dev = x.device
    rsq = _rsqrt16(dev)
    rows = torch.arange(x.shape[0], device=dev)
    need = int(torch.ceil((kf - i).max()).item()) if x.shape[0] else 0
    for _ in range(min(iters, max(need, 0))):
        active = i < kf
        phase2 = i >= (kf - rdo_pulses.float())
        txy = xy[:, None] + x
        tyy = yy[:, None] + 2.0 * yp + 1.0
        score = (txy * txy) / tyy
        # The rate penalised score, on the rows that take it and still
        # take pulses (a row's other scores change nothing).
        r2 = torch.nonzero(phase2 & active)[:, 0]
        if r2.numel():
            txy2, tyy2 = txy[r2], tyy[r2]
            tidx = tyy2.clamp(1.0, 16.0).long() - 1
            tyy_r = torch.where(tyy2 <= 16.0, rsq[tidx],
                                _rsqrt(tyy2.clamp_min(1.0)))
            score[r2] = _fma32(2.0 * txy2 * norm_1[r2, None], tyy_r,
                               -rate_pen[r2])
        score = torch.where(lane_ok, score, -math.inf)
        pos = score.argmax(-1)
        xadd = x.gather(1, pos[:, None])[:, 0]
        yold = yp.gather(1, pos[:, None])[:, 0]
        one = torch.where(active, 1.0, 0.0)
        yp = yp.index_put((rows, pos), one, accumulate=True)
        xy = xy + torch.where(active, xadd, 0.0)
        yy = yy + torch.where(active, 2.0 * yold + 1.0, 0.0)
        i = i + one
    return yp, xy, yy, i


def pulse_search_plain(xc, k, g2, lam, lane_ok, iters, src=None):
    """The plain PyTorch version: what the kernel computes.  Returns (y
    signed (m, n) int32, cos_dist (m,) float32, ok (m,) bool)."""
    if src is not None:
        xc, lane_ok = xc[src.long()], lane_ok[src.long()]
    n = xc.shape[1]
    xc = torch.where(lane_ok, xc, 0.0)
    x = xc.abs()
    xx = ordered_dot(x, x)
    norm_1 = _rsqrt(1e-30 + xx)
    lamr = torch.full((), lam, dtype=torch.float32,
                      device=g2.device) / (1e-30 + g2)
    kf = k.float()
    # Floor-projection init for k > 2 (host: k > 2 branch).
    l1 = ordered_sum(x)[:, None]
    yp = torch.floor(kf[:, None] * x / l1.clamp_min(1e-30))
    yp = yp.clamp_min(0.0)
    yp = torch.where((k > 2)[:, None], yp, 0.0)
    xy = ordered_dot(x, yp)
    yy = ordered_dot(yp, yp)
    i = ordered_sum(yp)
    rdo_pulses = 1 + torch.div(k, 4, rounding_mode="floor")
    delta, accel, delta1, accel1 = rate_constants(n)
    delta_rate = torch.where(k == 1, float(delta1), float(delta)).float()
    accel_rate = torch.where(k == 1, float(accel1), float(accel)).float()
    jidx = torch.arange(n, dtype=torch.float32, device=xc.device)
    # XLA:CPU contracts delta + j accel into one fused multiply-add.
    rate_pen = (lamr[:, None] * jidx[None, :]) * _fma32(
        jidx[None, :], accel_rate[:, None], delta_rate[:, None])
    yp, xy, yy, i = pulse_loop_plain(x, yp, xy, yy, i, kf, rdo_pulses,
                                     norm_1, rate_pen, lane_ok, iters)
    ok = i >= kf
    cos_dist = xy * _rsqrt(xx * yy)
    cos_dist = torch.where(k == 0, 0.0, cos_dist)
    y = torch.where(xc < 0, -yp, yp).to(torch.int32)
    y = torch.where((k == 0)[:, None], 0, y)
    return y, cos_dist, ok


