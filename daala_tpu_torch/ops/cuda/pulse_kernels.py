"""The greedy loop of the PVQ pulse search: the CUDA kernel
(csrc/pulse_search.cu) and its plain PyTorch version.

Replaces the loop of _pulse_search (daala_tpu/models/pvqsearch.py:318),
which JAX runs as an XLA while_loop, not a Pallas kernel.  The caller
(models/pvqsearch.py _pulse_search) computes everything before the loop
in torch: the floor-projection init and the row sums xx, l1, xy, yy, i,
norm_1 and the rate penalties.  Those float32 sums are the search's only
reductions whose order matters, so with them outside, the kernel equals
the plain loop bit for bit on the same inputs.

Each row adds pulses one at a time, min(iters, ceil(kf - i)) of them,
at the lane of the highest score (the first on a tie): the correlation
score until the last rdo_pulses pulses, then the rate-penalised one.
The plain version runs the batch's largest trip count with the rows
that have their pulses frozen, and reads that count back to the host
once a call; the kernel runs each row's own count (one warp a row), so
nothing comes back to the host.  The step's arithmetic is
csrc/pulse_step.cuh, which tests/test_torch_pulse_plan.py also compiles
for the host.

`pulse_loop` launches the kernel for tensors on a CUDA device and runs
the plain version only for tensors on the CPU; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from daala_tpu_torch.ops.cuda import _build
from daala_tpu_torch.utils import devstats

NAME = "pulse_search"  # the source, csrc/pulse_search.cu
KERNEL = "pulse_loop"  # the launch count's name
KERNELS = ("pulse_search_kernel",)  # the source's __global__ functions
MAX_N = 512  # the widest row the kernel takes (32 lanes x 16 registers)
_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

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
    """The fused multiply-add a * b + c of float32 tensors (c may be a
    float): the product is exact in float64, so the result is rounded
    once to float32 wherever the float64 sum is exact, and otherwise
    differs from one rounding only where that sum lands on a float32
    midpoint (about one case in 2^29)."""
    return (a.double() * b.double() + c).float()


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


def pulse_loop_plain(x, yp, xy, yy, i, kf, rdo_pulses, norm_1, rate_pen,
                     lane_ok, iters):
    """The plain PyTorch version: what the kernel computes.  The trip
    count is read once per call (one host sync): the largest number of
    pulses any row still needs, capped at `iters`.  Rows that finish
    early are masked, as in the JAX while_loop."""
    dev = x.device
    rsq = _rsqrt16(dev)
    rows = torch.arange(x.shape[0], device=dev)
    need = int(torch.ceil((kf - i).max()).item()) if x.shape[0] else 0
    for _ in range(min(iters, max(need, 0))):
        active = i < kf
        phase2 = i >= (kf - rdo_pulses.float())
        txy = xy[:, None] + x
        tyy = yy[:, None] + 2.0 * yp + 1.0
        score1 = (txy * txy) / tyy
        small = tyy <= 16.0
        tidx = tyy.clamp(1.0, 16.0).long() - 1
        tyy_r = torch.where(small, rsq[tidx], _rsqrt(tyy.clamp_min(1.0)))
        score2 = _fma32(2.0 * txy * norm_1[:, None], tyy_r, -rate_pen)
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
    return yp, xy, yy, i


def _check(x, yp, xy, yy, i, kf, rdo_pulses, norm_1, rate_pen, lane_ok,
           iters):
    if x.dim() != 2:
        raise ValueError("pulse_loop takes (m, n) rows, got %s"
                         % (tuple(x.shape),))
    m, n = x.shape
    for name, t, shape, dtype in (
            ("x", x, (m, n), torch.float32),
            ("yp", yp, (m, n), torch.float32),
            ("rate_pen", rate_pen, (m, n), torch.float32),
            ("lane_ok", lane_ok, (m, n), torch.bool),
            ("xy", xy, (m,), torch.float32),
            ("yy", yy, (m,), torch.float32),
            ("i", i, (m,), torch.float32),
            ("kf", kf, (m,), torch.float32),
            ("rdo_pulses", rdo_pulses, (m,), None),
            ("norm_1", norm_1, (m,), torch.float32)):
        if tuple(t.shape) != shape or (dtype is not None
                                       and t.dtype != dtype):
            raise ValueError("pulse_loop: %s is %s %s, wants %s %s"
                             % (name, t.dtype, tuple(t.shape), dtype, shape))
        if t.device != x.device:
            raise ValueError("pulse_loop: %s is on %s, x on %s"
                             % (name, t.device, x.device))
    if iters < 0:
        raise ValueError("pulse_loop: iters %d < 0" % iters)


def build():
    """Build (first use) and load csrc/pulse_search.cu; returns the
    library."""
    return _build.load(NAME, {NAME: _ARGTYPES})


def pulse_loop_cuda(x, yp, xy, yy, i, kf, rdo_pulses, norm_1, rate_pen,
                    lane_ok, iters):
    """Launch csrc/pulse_search.cu on CUDA tensors; returns new tensors
    (yp, xy, yy, i)."""
    _check(x, yp, xy, yy, i, kf, rdo_pulses, norm_1, rate_pen, lane_ok,
           iters)
    if x.device.type != "cuda":
        raise ValueError("pulse_loop_cuda takes CUDA tensors")
    m, n = x.shape
    if n > MAX_N:
        raise ValueError("pulse_loop_cuda takes rows of at most %d lanes, "
                         "got %d" % (MAX_N, n))
    ins = [t.contiguous() for t in (x, yp, rate_pen, lane_ok, xy, yy, i,
                                    kf, rdo_pulses.to(torch.float32),
                                    norm_1)]
    outs = [torch.empty_like(yp)] + [torch.empty_like(xy) for _ in range(3)]
    if m == 0:
        return tuple(outs)
    lib = build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pulse_search(
            *[t.data_ptr() for t in ins], _rsqrt16(x.device).data_ptr(),
            _rsqrt_seed(x.device).data_ptr(),
            *[t.data_ptr() for t in outs], m, n, int(iters), stream)
    devstats.launch(KERNEL)
    _build.check(err, KERNEL)
    return tuple(outs)


def pulse_loop(x, yp, xy, yy, i, kf, rdo_pulses, norm_1, rate_pen, lane_ok,
               iters):
    """The greedy pulse loop of the PVQ search over (m, n) rows.

    x: |coefficients| with masked lanes zero; yp: the init's pulses;
    xy, yy, i: the rows' x.yp, yp.yp and pulse count; kf: the target
    pulses (float); rdo_pulses: the last pulses scored with the rate
    penalty rate_pen (m, n); norm_1: 1 / |x|; lane_ok: the lanes that
    may take a pulse; iters: the cap on steps.  Returns (yp, xy, yy,
    i) after the loop.  The kernel on CUDA tensors, the plain version on
    CPU tensors."""
    args = (x, yp, xy, yy, i, kf, rdo_pulses, norm_1, rate_pen, lane_ok,
            iters)
    if x.device.type == "cuda":
        return pulse_loop_cuda(*args)
    if x.device.type == "cpu":
        _check(*args)
        return pulse_loop_plain(*args)
    raise ValueError("pulse_loop: unsupported device %s" % x.device)
