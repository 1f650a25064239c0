"""The per-leaf OBMC kernels (csrc/obmc_leaf.cu) and their plain
PyTorch versions.

Replace the two Pallas kernels of daala_tpu/ops/pallas/obmc_kernels.py:

  obmc_blend       <- obmc_blend_pallas (:191): every leaf's blended
                      (ny, nx) prediction from its 4 corner windows (6-tap
                      subpel filters, the int16 wrap of 8-bit data, the
                      merged (oc, s) blend; daala_tpu/models/obmc.py
                      predict_leaves :132 is the XLA version).
  obmc_leaf_cells  <- obmc_leaf_cells_pallas (:208): the 8-bit blend,
                      then |pred - cur| over the visible area summed per
                      8x8 cell (daala_tpu/models/mesweep.py
                      _leaf_cells_xla :197 is the XLA version).

Both take the leaves packed by `leaf_args` into one (L, 16) int32 array
(the layout of daala_tpu.models.obmc.pallas_leaf_args, with the subpel
phases in column 15 in place of the (L, 4, 16) tap array), and read the
reference planes as the port keeps them resident: (4, Hp, Wp) uint8, or
uint16 for 12-bit references.  `leaf_args` raises when a window leaves
its plane: nothing clamps, on either side.

On the card the kernels are bound by integer operations (about 55 per
pixel at n = 64, with dp4a and dp2a); their launch plans are in
csrc/obmc_plan.cuh and the design in the note of csrc/obmc_leaf.cu.
The CUDA wrappers take planes whose base and rows are 16-byte aligned
(the kernels copy the windows with cp.async) and that hold fewer than
2^32 bytes, which every frame of the codec gives.

`obmc_blend` and `obmc_leaf_cells` launch the kernel for tensors on a
CUDA device and run the plain version only for tensors on the CPU;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from daala_tpu_torch.codec.mc import SUBPEL_FILTER_SET, _setup_s_split
from daala_tpu_torch.ops.cuda import _build
from daala_tpu_torch.utils import devstats

SOURCE = "obmc_leaf"
BLEND, CELLS = "obmc_blend", "obmc_leaf_cells"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    BLEND: [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P],
    CELLS: [_P, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P],
    "obmc_plan_info": [_I, _I, _I, _I, _P],
}
_PLAN_KEYS = ("threads", "leaves_per_block", "copy_bytes", "smem_bytes",
              "blocks_per_sm", "rows_per_thread")
# Leaves per step of the plain version: bounds its (L, 4, ny+5, nx+5)
# intermediates to a few tens of MB.
_PLAIN_CHUNK_PIXELS = 1 << 20


def leaf_args(pos, srcs, mvs, ocs, ss, pad, log_x, log_y, plane_shape):
    """Pack one size class of leaves for the kernels: (L, 16) int32 with
    [0:4] srcs, [4:8] window rows sy, [8:12] window columns sx, [12]
    oc * 4 + s, [13] py, [14] px, [15] the subpel phases (bits 6k..6k+2:
    mvx & 7 of corner k, bits 6k+3..6k+5: mvy & 7).

    pos (L, 2) [y, x] plane pixels, srcs (L, 4) slots, mvs (L, 4, 2)
    [mvx, mvy] plane 1/8-pel, ocs/ss (L,), as models/obmc.py
    build_leaf_lists gives them.  Raises unless every corner window
    [sy, sy + ny + 5) x [sx, sx + nx + 5) lies inside a plane of
    plane_shape (Hp, Wp)."""
    pos = np.asarray(pos, np.int64)
    srcs = np.asarray(srcs, np.int64)
    mvs = np.asarray(mvs, np.int64)
    ocs = np.asarray(ocs, np.int64)
    ss = np.asarray(ss, np.int64)
    mvx, mvy = mvs[:, :, 0], mvs[:, :, 1]
    sy = pad + pos[:, 0:1] + (mvy >> 3) - 2
    sx = pad + pos[:, 1:2] + (mvx >> 3) - 2
    hp, wp = plane_shape
    bad = ((sy < 0) | (sy + (1 << log_y) + 5 > hp) | (sx < 0)
           | (sx + (1 << log_x) + 5 > wp) | (srcs < 0) | (srcs > 3)).any(1)
    bad |= (ocs < 0) | (ocs > 3) | (ss < 0) | (ss > 3)
    if bad.any():
        i = int(np.argmax(bad))
        raise ValueError(
            "OBMC leaf %d: window rows %s, columns %s (n %dx%d), srcs %s, "
            "oc %d, s %d lie outside a %dx%d plane or the tables"
            % (i, sy[i].tolist(), sx[i].tolist(), 1 << log_y, 1 << log_x,
               srcs[i].tolist(), ocs[i], ss[i], hp, wp))
    scal = np.zeros((pos.shape[0], 16), np.int32)
    scal[:, 0:4] = srcs
    scal[:, 4:8] = sy
    scal[:, 8:12] = sx
    scal[:, 12] = ocs * 4 + ss
    scal[:, 13:15] = pos
    phases = (mvx & 7) | (mvy & 7) << 3
    scal[:, 15] = (phases << (6 * np.arange(4))).sum(1)
    return scal


@functools.lru_cache(maxsize=None)
def weight_table(log_x, log_y):
    """(4 oc, 4 s, 4 corner, ny, nx) int32 merged blend weight planes
    (mc.py _setup_s_split); the s=3 entry reproduces blend_full.  A copy
    of daala_tpu.models.obmc._weight_table, which lives in a module that
    imports jax."""
    nx, ny = 1 << log_x, 1 << log_y
    i = np.arange(nx)[None, :]
    j = np.arange(ny)[:, None]
    tab = np.zeros((4, 4, 4, ny, nx), np.int32)
    for oc in range(4):
        for s in range(4):
            s0, dsdi, dsdj, dd = _setup_s_split(oc, s, log_x, log_y)
            for k in range(4):
                tab[oc, s, k] = (s0[k] + i * dsdi[k] + j * dsdj[k]
                                 + i * j * dd[k])
    return tab


def _wrap16(v):
    """Two's-complement int16 wrap of int32 values (the od_mc buffer
    width)."""
    return ((v + 32768) & 0xFFFF) - 32768


def bits(t):
    """t, or for a uint16 tensor its int16 view: torch has no indexing
    kernels for uint16, and 12-bit values read and scatter the same
    through the view."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


def _blend_chunk(planes4, scal, log_x, log_y, hi):
    nx, ny = 1 << log_x, 1 << log_y
    dev = planes4.device
    sub = torch.as_tensor(SUBPEL_FILTER_SET, device=dev)
    srcs = scal[:, 0:4].long()
    sy, sx = scal[:, 4:8], scal[:, 8:12]
    shift = 6 * torch.arange(4, device=dev, dtype=torch.int32)
    fx = sub[((scal[:, 15:16] >> shift) & 7).long()]          # (L, 4, 6)
    fy = sub[((scal[:, 15:16] >> (shift + 3)) & 7).long()]
    rows = sy[:, :, None] + torch.arange(ny + 5, device=dev)
    cols = sx[:, :, None] + torch.arange(nx + 5, device=dev)
    win = planes4[srcs[:, :, None, None], rows[:, :, :, None],
                  cols[:, :, None, :]].int()             # (L, 4, ny+5, nx+5)
    buff = sum(win[:, :, :, m:m + nx] * fx[:, :, m, None, None]
               for m in range(6))
    buff = buff - (128 << 11) if hi else _wrap16(buff - (128 << 7))
    acc = sum(buff[:, :, m:m + ny, :] * fy[:, :, m, None, None]
              for m in range(6))
    if hi:
        preds = (((acc + (1 << 13)) >> 14) + (128 << 4)).clamp(0, 4095)
    else:
        preds = ((acc + (1 << 13) + (128 << 14)) >> 14).clamp(0, 255)
    # Blend: out = (p0 << (lb2+1) + sum_k (pk - p0) * sw_k + rnd) >> ...
    lb2p1 = log_x + log_y + 1
    wtab = torch.as_tensor(weight_table(log_x, log_y), device=dev)
    sw = wtab.view(16, 4, ny, nx)[scal[:, 12].long()]        # (L, 4, ny, nx)
    p0 = preds[:, 0]
    accb = (p0 << lb2p1) + (1 << (lb2p1 - 1))
    for k in range(1, 4):
        accb = accb + (preds[:, k] - p0) * sw[:, k]
    return accb >> lb2p1


def obmc_blend_plain(planes4, scal, log_x, log_y):
    """The plain PyTorch version of obmc_blend: (L, ny, nx) in the
    planes' type, stored modulo 2^8 or 2^16 as daala_tpu's astype does
    (the blend of non-square leaves can leave the range)."""
    hi = planes4.dtype == torch.uint16
    step = max(1, _PLAIN_CHUNK_PIXELS
               // (4 * ((1 << log_y) + 5) * ((1 << log_x) + 5)))
    out = torch.cat([_blend_chunk(bits(planes4), scal[a:a + step], log_x,
                                  log_y, hi)
                     for a in range(0, scal.shape[0], step)])
    if hi:
        return out.to(torch.int16).view(torch.uint16)
    return out.to(torch.uint8)


def obmc_leaf_cells_plain(planes4, cur, scal, log_n):
    """The plain PyTorch version of obmc_leaf_cells: obmc_blend_plain,
    then the visible-clipped per-8x8-cell SADs against cur (vh, vw)."""
    n, nc = 1 << log_n, 1 << log_n >> 3
    vh, vw = cur.shape
    blocks = obmc_blend_plain(planes4, scal, log_n, log_n).int()
    ar = torch.arange(n, device=cur.device)
    rows = scal[:, 13:14] + ar
    cols = scal[:, 14:15] + ar
    c = cur[rows.clamp(max=vh - 1)[:, :, None],
            cols.clamp(max=vw - 1)[:, None, :]].int()
    vis = (rows < vh)[:, :, None] & (cols < vw)[:, None, :]
    d = torch.where(vis, (blocks - c).abs(), 0)
    return d.view(-1, nc, 8, nc, 8).sum((2, 4), dtype=torch.int32)


def _check(planes4, scal, hi_ok=True):
    if planes4.dim() != 3 or planes4.shape[0] != 4 or planes4.dtype not in (
            (torch.uint8, torch.uint16) if hi_ok else (torch.uint8,)):
        raise ValueError("OBMC kernels take (4, Hp, Wp) uint8%s planes, got "
                         "%s %s" % (" or uint16" if hi_ok else "",
                                    planes4.dtype, tuple(planes4.shape)))
    if scal.dim() != 2 or scal.shape[1] != 16 or scal.dtype != torch.int32:
        raise ValueError("OBMC kernels take (L, 16) int32 leaf arguments "
                         "(leaf_args), got %s %s"
                         % (scal.dtype, tuple(scal.shape)))
    if scal.device != planes4.device:
        raise ValueError("planes on %s, leaf arguments on %s"
                         % (planes4.device, scal.device))
    if not (planes4.is_contiguous() and scal.is_contiguous()):
        raise ValueError("OBMC kernels take contiguous tensors")


def _check_layout(planes4):
    """The kernels copy the windows with cp.async from rows that start
    on 16-byte boundaries, and address the planes with 32-bit offsets:
    raise unless the planes' base and row pitch (Wp * itemsize) are
    multiples of 16 bytes and the planes hold fewer than 2^32 bytes.
    Every frame the codec makes qualifies (frame widths are multiples
    of 64, pads 64 or 32)."""
    pitch = planes4.shape[2] * planes4.element_size()
    if pitch % 16 or planes4.data_ptr() % 16:
        raise ValueError("OBMC kernels take planes whose base and rows are "
                         "16-byte aligned, got a %d-byte row pitch at "
                         "address %#x" % (pitch, planes4.data_ptr()))
    if planes4.numel() * planes4.element_size() >= 1 << 32:
        raise ValueError("OBMC kernels take planes of fewer than 2^32 "
                         "bytes, got %s" % (tuple(planes4.shape),))


def _check_sizes(log_x, log_y, lo):
    if not (lo <= log_x <= 6 and lo <= log_y <= 6):
        raise ValueError("OBMC leaf sizes must be %d..64, got %dx%d"
                         % (1 << lo, 1 << log_y, 1 << log_x))


def build():
    """Build (first use) and load csrc/obmc_leaf.cu; returns the
    library."""
    return _build.load(SOURCE, _ENTRIES)


def plan_info(log_x, log_y, hi=False, cells=False):
    """The launch plan of one kernel instantiation on the current CUDA
    device (csrc/obmc_plan.cuh, with the occupancy calculator's blocks
    per SM), as a dict."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    _build.check(build().obmc_plan_info(log_x, log_y, int(hi), int(cells),
                                        ctypes.addressof(out)),
                 "obmc_plan_info")
    return dict(zip(_PLAN_KEYS, out))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def obmc_blend_cuda(planes4, scal, log_x, log_y):
    """Launch obmc_blend on CUDA tensors: (L, ny, nx) in the planes'
    type."""
    _check(planes4, scal)
    _check_sizes(log_x, log_y, 2)
    if planes4.device.type != "cuda":
        raise ValueError("obmc_blend_cuda takes CUDA tensors")
    _check_layout(planes4)
    L = scal.shape[0]
    out = torch.empty((L, 1 << log_y, 1 << log_x), dtype=planes4.dtype,
                      device=planes4.device)
    if L == 0:
        return out
    lib = build()
    _, hp, wp = planes4.shape
    with torch.cuda.device(planes4.device):
        err = lib.obmc_blend(planes4.data_ptr(),
                             int(planes4.dtype == torch.uint16), hp, wp,
                             scal.data_ptr(), L, log_x, log_y,
                             out.data_ptr(), _stream(planes4))
    devstats.launch(BLEND)
    _build.check(err, BLEND)
    return out


def obmc_leaf_cells_cuda(planes4, cur, scal, log_n):
    """Launch obmc_leaf_cells on CUDA tensors: (L, n/8, n/8) int32."""
    _check(planes4, scal, hi_ok=False)
    _check_sizes(log_n, log_n, 3)
    if planes4.device.type != "cuda":
        raise ValueError("obmc_leaf_cells_cuda takes CUDA tensors")
    _check_layout(planes4)
    if (cur.dim() != 2 or cur.dtype != torch.uint8
            or cur.device != planes4.device or not cur.is_contiguous()):
        raise ValueError("obmc_leaf_cells takes the visible current luma "
                         "as a contiguous (vh, vw) uint8 tensor beside the "
                         "planes, got %s %s on %s"
                         % (cur.dtype, tuple(cur.shape), cur.device))
    L, nc = scal.shape[0], 1 << log_n >> 3
    out = torch.empty((L, nc, nc), dtype=torch.int32, device=planes4.device)
    if L == 0:
        return out
    lib = build()
    _, hp, wp = planes4.shape
    vh, vw = cur.shape
    with torch.cuda.device(planes4.device):
        err = lib.obmc_leaf_cells(planes4.data_ptr(), hp, wp, cur.data_ptr(),
                                  vh, vw, scal.data_ptr(), L, log_n,
                                  out.data_ptr(), _stream(planes4))
    devstats.launch(CELLS)
    _build.check(err, CELLS)
    return out


def obmc_blend(planes4, scal, log_x, log_y):
    """Blended predictions (L, ny, nx) of the leaves packed in scal, in
    the planes' type.  The kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if planes4.device.type == "cuda":
        return obmc_blend_cuda(planes4, scal, log_x, log_y)
    if planes4.device.type == "cpu":
        _check(planes4, scal)
        _check_sizes(log_x, log_y, 2)
        return obmc_blend_plain(planes4, scal, log_x, log_y)
    raise ValueError("obmc_blend: unsupported device %s" % planes4.device)


def obmc_leaf_cells(planes4, cur, scal, log_n):
    """Per-8x8-cell SADs (L, n/8, n/8) int32 of the leaves packed in scal
    against the visible current luma cur.  The kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if planes4.device.type == "cuda":
        return obmc_leaf_cells_cuda(planes4, cur, scal, log_n)
    if planes4.device.type == "cpu":
        _check(planes4, scal, hi_ok=False)
        _check_sizes(log_n, log_n, 3)
        return obmc_leaf_cells_plain(planes4, cur, scal, log_n)
    raise ValueError("obmc_leaf_cells: unsupported device %s"
                     % planes4.device)
