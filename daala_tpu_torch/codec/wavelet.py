"""Haar wavelet coefficient coder (lossless mode, and the optional lossy
wavelet mode).

Mirrors od_wavelet_quantize / od_wavelet_unquantize and the tree-sum
coders (reference: src/encode.c:960-1080, src/decode.c:330-482).  The
whole 64x64 (or 32x32 chroma) superblock is one Haar block; magnitudes are
coded as recursive tree sums, then signs, then scaled by the per-direction
per-level Haar QM.

The port's copy of daala_tpu/codec/wavelet.py;
tests/test_torch_copies.py holds it to the original.
"""

from __future__ import annotations

import numpy as np

from daala_tpu_torch.codec.state import OD_HAAR_QM
from daala_tpu_torch.entropy.adapt import decode_cdf_adapt, encode_cdf_adapt


def _ilog(x):
    return int(x).bit_length()


# -- tree/coeff split symbols (reference: src/encode.c:930-983,
#    src/decode.c:330-366) ---------------------------------------------------

def _enc_coeff_split(enc, adapt, a, total, ctx):
    if total == 0:
        return
    shift = max(0, _ilog(total) - 4)
    if shift:
        enc.encode_bits(a & ((1 << shift) - 1), shift)
        a >>= shift
        total >>= shift
    encode_cdf_adapt(enc, a, adapt.haar_coeff_cdf[15 * ctx + total - 1],
                     total + 1, adapt.haar_coeff_increment)


def _dec_coeff_split(dec, adapt, total, ctx):
    if total == 0:
        return 0
    a = 0
    shift = max(0, _ilog(total) - 4)
    if shift:
        a = dec.decode_bits(shift)
    a += decode_cdf_adapt(dec, adapt.haar_coeff_cdf[15 * ctx
                                                    + (total >> shift) - 1],
                          (total >> shift) + 1,
                          adapt.haar_coeff_increment) << shift
    if a > total:
        a = total
        dec.error = 1
    return a


def _enc_tree_split(enc, adapt, a, total, ctx):
    if total == 0:
        return
    shift = max(0, _ilog(total) - 4)
    if shift:
        enc.encode_bits(a & ((1 << shift) - 1), shift)
        a >>= shift
        total >>= shift
    encode_cdf_adapt(enc, a,
                     adapt.haar_split_cdf[15 * (2 * ctx + min(shift, 1))
                                          + total - 1],
                     total + 1, adapt.haar_split_increment)


def _dec_tree_split(dec, adapt, total, ctx):
    if total == 0:
        return 0
    a = 0
    shift = max(0, _ilog(total) - 4)
    if shift:
        a = dec.decode_bits(shift)
    a += decode_cdf_adapt(dec,
                          adapt.haar_split_cdf[15 * (2 * ctx
                                                     + min(shift, 1))
                                               + (total >> shift) - 1],
                          (total >> shift) + 1,
                          adapt.haar_split_increment) << shift
    if a > total:
        a = total
        dec.error = 1
    return a


# -- sum trees (reference: src/encode.c:903-959/985-1002,
#    src/decode.c:368-413) ---------------------------------------------------

def _compute_max_tree(tree_sum, x, y, c, ln):
    n = 1 << ln
    maxval = 0
    if 2 * x < n and 2 * y < n:
        maxval += _compute_max_tree(tree_sum, 2 * x, 2 * y, c, ln)
        maxval += _compute_max_tree(tree_sum, 2 * x + 1, 2 * y, c, ln)
        maxval += _compute_max_tree(tree_sum, 2 * x, 2 * y + 1, c, ln)
        maxval += _compute_max_tree(tree_sum, 2 * x + 1, 2 * y + 1, c, ln)
    maxval += abs(int(c[y, x]))
    tree_sum[y][x] = maxval
    return maxval


def _enc_sum_tree(enc, adapt, c, ln, tree_sum, x, y, direction):
    n = 1 << ln
    if tree_sum[y][x] == 0:
        return
    coeff_mag = abs(int(c[y, x]))
    _enc_coeff_split(enc, adapt, coeff_mag, tree_sum[y][x],
                     direction + 3 * (_ilog(max(x, y)) - 1))
    children_sum = (tree_sum[2 * y][2 * x] + tree_sum[2 * y][2 * x + 1]
                    + tree_sum[2 * y + 1][2 * x]
                    + tree_sum[2 * y + 1][2 * x + 1])
    if children_sum:
        if direction == 0:
            _enc_tree_split(enc, adapt,
                            tree_sum[2 * y][2 * x]
                            + tree_sum[2 * y][2 * x + 1], children_sum, 0)
            _enc_tree_split(enc, adapt, tree_sum[2 * y][2 * x],
                            tree_sum[2 * y][2 * x]
                            + tree_sum[2 * y][2 * x + 1], 2)
            _enc_tree_split(enc, adapt, tree_sum[2 * y + 1][2 * x],
                            tree_sum[2 * y + 1][2 * x]
                            + tree_sum[2 * y + 1][2 * x + 1], 2)
        else:
            _enc_tree_split(enc, adapt,
                            tree_sum[2 * y][2 * x]
                            + tree_sum[2 * y + 1][2 * x], children_sum, 1)
            _enc_tree_split(enc, adapt, tree_sum[2 * y][2 * x],
                            tree_sum[2 * y][2 * x]
                            + tree_sum[2 * y + 1][2 * x], 2)
            _enc_tree_split(enc, adapt, tree_sum[2 * y][2 * x + 1],
                            tree_sum[2 * y][2 * x + 1]
                            + tree_sum[2 * y + 1][2 * x + 1], 2)
    if 4 * x < n and 4 * y < n:
        _enc_sum_tree(enc, adapt, c, ln, tree_sum, 2 * x, 2 * y, direction)
        _enc_sum_tree(enc, adapt, c, ln, tree_sum, 2 * x + 1, 2 * y,
                      direction)
        _enc_sum_tree(enc, adapt, c, ln, tree_sum, 2 * x, 2 * y + 1,
                      direction)
        _enc_sum_tree(enc, adapt, c, ln, tree_sum, 2 * x + 1, 2 * y + 1,
                      direction)


def _dec_sum_tree(dec, adapt, c, ln, tree_sum, x, y, direction):
    n = 1 << ln
    if tree_sum == 0:
        return
    coeff_mag = _dec_coeff_split(dec, adapt, tree_sum,
                                 direction + 3 * (_ilog(max(x, y)) - 1))
    c[y, x] = coeff_mag
    children_sum = tree_sum - coeff_mag
    children = [[0, 0], [0, 0]]
    if children_sum:
        if direction == 0:
            sum1 = _dec_tree_split(dec, adapt, children_sum, 0)
            children[0][0] = _dec_tree_split(dec, adapt, sum1, 2)
            children[0][1] = sum1 - children[0][0]
            children[1][0] = _dec_tree_split(dec, adapt,
                                             children_sum - sum1, 2)
            children[1][1] = children_sum - sum1 - children[1][0]
        else:
            sum1 = _dec_tree_split(dec, adapt, children_sum, 1)
            children[0][0] = _dec_tree_split(dec, adapt, sum1, 2)
            children[1][0] = sum1 - children[0][0]
            children[0][1] = _dec_tree_split(dec, adapt,
                                             children_sum - sum1, 2)
            children[1][1] = children_sum - sum1 - children[0][1]
    if 4 * x < n and 4 * y < n:
        _dec_sum_tree(dec, adapt, c, ln, children[0][0], 2 * x, 2 * y,
                      direction)
        _dec_sum_tree(dec, adapt, c, ln, children[0][1], 2 * x + 1, 2 * y,
                      direction)
        _dec_sum_tree(dec, adapt, c, ln, children[1][0], 2 * x, 2 * y + 1,
                      direction)
        _dec_sum_tree(dec, adapt, c, ln, children[1][1], 2 * x + 1,
                      2 * y + 1, direction)
    else:
        c[2 * y, 2 * x] = children[0][0]
        c[2 * y, 2 * x + 1] = children[0][1]
        c[2 * y + 1, 2 * x] = children[1][0]
        c[2 * y + 1, 2 * x + 1] = children[1][1]


# -- top level ---------------------------------------------------------------

def wavelet_quantize(enc, adapt, ln, dblock, predt, quant, pli):
    """od_wavelet_quantize: quantize+code the (n, n) Haar block (except
    DC); writes the reconstruction into a returned array (reference:
    src/encode.c:1003-1080)."""
    n = 1 << ln
    out = np.zeros((n, n), np.int64)
    for direction in range(3):
        for level in range(ln):
            by = ((direction + 1) >> 1) << level
            bx = ((direction + 1) & 1) << level
            q = 1 if quant == 0 else \
                quant * OD_HAAR_QM[1 if direction == 2 else 0][level] >> 4
            m = 1 << level
            for i in range(m):
                for j in range(m):
                    from daala_tpu_torch.codec.pvq_codec import div_r0
                    out[by + i, bx + j] = div_r0(
                        int(dblock[by + i, bx + j])
                        - int(predt[by + i, bx + j]), q)
    tree_sum = [[0] * n for _ in range(n)]
    _compute_max_tree(tree_sum, 1, 0, out, ln)
    _compute_max_tree(tree_sum, 0, 1, out, ln)
    _compute_max_tree(tree_sum, 1, 1, out, ln)
    tree_sum[0][0] = tree_sum[0][1] + tree_sum[1][0] + tree_sum[1][1]
    bits = _ilog(tree_sum[0][0])
    encode_cdf_adapt(enc, min(bits, 15), adapt.haar_bits_cdf[pli], 16,
                     adapt.haar_bits_increment)
    if bits >= 15:
        # Unary (reference: od_ec_enc_unary, src/encode.c:925-928).
        x = bits - 15
        if x:
            enc.encode_bits(0, x)
        enc.encode_bits(1, 1)
    if bits > 1:
        enc.encode_bits(tree_sum[0][0] & ((1 << (bits - 1)) - 1), bits - 1)
    _enc_tree_split(enc, adapt, tree_sum[1][1], tree_sum[0][0], 3)
    _enc_tree_split(enc, adapt, tree_sum[0][1],
                    tree_sum[0][0] - tree_sum[1][1], 4)
    _enc_sum_tree(enc, adapt, out, ln, tree_sum, 1, 0, 0)
    _enc_sum_tree(enc, adapt, out, ln, tree_sum, 0, 1, 1)
    _enc_sum_tree(enc, adapt, out, ln, tree_sum, 1, 1, 2)
    for i in range(n):
        for j in range(n):
            if i + j and out[i, j]:
                enc.encode_bits(1 if out[i, j] < 0 else 0, 1)
    for direction in range(3):
        for level in range(ln):
            by = ((direction + 1) >> 1) << level
            bx = ((direction + 1) & 1) << level
            q = 1 if quant == 0 else \
                quant * OD_HAAR_QM[1 if direction == 2 else 0][level] >> 4
            m = 1 << level
            out[by:by + m, bx:bx + m] = (
                q * out[by:by + m, bx:bx + m]
                + predt[by:by + m, bx:bx + m])
    return out


def wavelet_unquantize(dec, adapt, ln, predt, quant, pli):
    """od_wavelet_unquantize (reference: src/decode.c:415-482).  Returns
    the reconstructed (n, n) Haar coefficients (DC slot left at 0; the
    caller fills it)."""
    n = 1 << ln
    pred = np.zeros((n, n), np.int64)
    bits = decode_cdf_adapt(dec, adapt.haar_bits_cdf[pli], 16,
                            adapt.haar_bits_increment)
    if bits == 15:
        # Unary continuation.  The reference's loop consumes raw bits
        # until a 1 arrives regardless of the value (src/decode.c:
        # 322-327); stopping early shifts the raw-bit window and every
        # later sign/suffix read with it (raw bits come from the stream
        # tail), so consume identically.  The only cap is a hang guard
        # far beyond any real packet (the reference would spin forever
        # on an all-zero tail).
        zeros = 0
        while dec.decode_bits(1) == 0:
            zeros += 1
            if zeros > (1 << 16):
                dec.error = 1
                break
        bits += zeros
    if bits > 24:
        dec.error = 1
        return pred
    elif bits > 1:
        tree00 = (1 << (bits - 1)) | dec.decode_bits(bits - 1)
    else:
        tree00 = bits
    tree11 = _dec_tree_split(dec, adapt, tree00, 3)
    tree01 = _dec_tree_split(dec, adapt, tree00 - tree11, 4)
    tree10 = tree00 - tree11 - tree01
    _dec_sum_tree(dec, adapt, pred, ln, tree01, 1, 0, 0)
    _dec_sum_tree(dec, adapt, pred, ln, tree10, 0, 1, 1)
    _dec_sum_tree(dec, adapt, pred, ln, tree11, 1, 1, 2)
    for i in range(n):
        for j in range(n):
            if i + j == 0:
                continue
            if pred[i, j]:
                if dec.decode_bits(1):
                    pred[i, j] = -pred[i, j]
    for direction in range(3):
        for level in range(ln):
            by = ((direction + 1) >> 1) << level
            bx = ((direction + 1) & 1) << level
            q = 1 if quant == 0 else \
                quant * OD_HAAR_QM[1 if direction == 2 else 0][level] >> 4
            m = 1 << level
            pred[by:by + m, bx:bx + m] = (
                q * pred[by:by + m, bx:bx + m]
                + predt[by:by + m, bx:bx + m])
    return pred
