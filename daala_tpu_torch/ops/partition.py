"""PVQ band layout and raster<->coding-order permutations.

TPU-first redesign of the reference's staged scan conversion (reference:
src/partition.c:100-244): instead of per-block loops over zigzag tables, we
precompute one flat permutation per block size at import time and apply it as
a single gather over the last axis of a batched coefficient tensor.  XLA
fuses the gather with surrounding elementwise work.

Band structure (reference: src/partition.c:76-85): the first entry of
BAND_OFFSETS* is the number of bands, followed by band boundaries into the
coding-order vector.  Position 0 of the coding-order vector is DC (coded
separately from PVQ).

The port's copy of daala_tpu/ops/partition.py;
tests/test_torch_copies.py holds it to the original.  Its
`coding_to_raster` takes numpy arrays only: the original's jax.numpy
branch is left out.
"""

from __future__ import annotations

import numpy as np

from daala_tpu_torch.ops import _tables as T

OD_NBSIZES = 5
OD_LOG_BSIZE0 = 2
BLOCK_SIZES = (4, 8, 16, 32, 64)

_ZIGZAGS = {4: T.ZIGZAG4, 8: T.ZIGZAG8, 16: T.ZIGZAG16, 32: T.ZIGZAG32,
            64: T.ZIGZAG64}
_BAND_OFFSETS_RAW = {4: T.BAND_OFFSETS4, 8: T.BAND_OFFSETS8,
                     16: T.BAND_OFFSETS16, 32: T.BAND_OFFSETS32,
                     64: T.BAND_OFFSETS64}


def band_offsets(n: int) -> np.ndarray:
    """Band boundaries (including the leading DC slot) for an n-point block.

    Returns the offsets array [1, 16, 24, ...] of length nbands+1; band b
    covers coding-order positions [offsets[b], offsets[b+1]).
    """
    raw = _BAND_OFFSETS_RAW[n]
    nbands = int(raw[0])
    return np.asarray(raw[1:nbands + 2], np.int32)


def num_bands(n: int) -> int:
    return int(_BAND_OFFSETS_RAW[n][0])


# Number of zigzag entries each layout stage actually uses: the scan stops
# at the last band boundary, so high-frequency positions of 32x32/64x64
# blocks are never scanned (reference: src/partition.c:36-72,105:
# len = layout->band_offsets[layout->nb_bands]; LAYOUT32 uses 256 of 768
# entries, LAYOUT64 uses 0 of 3072).
_LAYOUT_LEN = {4: 15, 8: 48, 16: 192, 32: 256, 64: 0}


def scan_length(n: int) -> int:
    """Number of coding-order slots for an n x n block (incl. DC).

    Equals the last band boundary: 4->16, 8->64, 16->256, 32->512, 64->512.
    The tail of large blocks is not scanned/coded (it stays at the
    prediction in the decoder; the 64x64 layout stage contributes no
    entries of its own, reference: src/partition.c:36-40)."""
    return int(band_offsets(n)[-1])


def _build_coding_order(n: int) -> np.ndarray:
    """Flat raster indices in coding order for an n x n block.

    Mirrors od_raster_to_coding_order (reference: src/partition.c:144-163):
    DC first, then the 4x4 zigzag (15 entries), then for each larger stage
    size s (8..n) the first _LAYOUT_LEN[s] zigzag entries covering the
    s x s block minus its top-left (s/2 x s/2) sub-block, at offset
    (s/2)^2.
    """
    idx = np.zeros(scan_length(n), np.int64)
    idx[0] = 0
    zz4 = _ZIGZAGS[4]
    idx[1:16] = zz4[:, 1] * n + zz4[:, 0]
    s = 8
    while s <= n:
        off = (s // 2) * (s // 2)
        zz = _ZIGZAGS[s][:_LAYOUT_LEN[s]]
        idx[off:off + len(zz)] = zz[:, 1] * n + zz[:, 0]
        s *= 2
    return idx


_CODING_ORDER = {n: _build_coding_order(n) for n in BLOCK_SIZES}


def coding_order_indices(n: int) -> np.ndarray:
    """Permutation p (length scan_length(n)) with
    coding_vec[i] = raster_flat[p[i]]."""
    return _CODING_ORDER[n]


def raster_to_coding(blocks):
    """Batched scan conversion: (..., n, n) -> (..., scan_length(n))."""
    n = blocks.shape[-1]
    flat = blocks.reshape(blocks.shape[:-2] + (n * n,))
    return flat[..., _CODING_ORDER[n]]


def coding_to_raster(vecs, n: int, base=None):
    """Inverse batched scan conversion: (..., scan_length(n)) -> (..., n, n).

    Unscanned positions take the value from `base` (same block shape) when
    given, else 0 — mirroring the decoder, where uncoded high frequencies
    keep the predictor's coefficients."""
    perm = _CODING_ORDER[n]
    shape = vecs.shape[:-1] + (n * n,)
    if base is None:
        out = np.zeros(shape, vecs.dtype)
    else:
        out = base.reshape(shape).copy()
    out[..., perm] = vecs
    return out.reshape(vecs.shape[:-1] + (n, n))
