"""Quality metrics: PSNR, PSNR-HVS-M, SSIM, MS-SSIM.

Equivalents of the reference's offline metric tools
(reference: tools/dump_psnr.c, tools/dump_psnrhvs.c, tools/dump_ssim.c,
tools/dump_msssim.c).
"""

from __future__ import annotations

import numpy as np


def psnr(a, b, maxval=255.0):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    if mse == 0:
        return float("inf")
    return 10 * np.log10(maxval * maxval / mse)


# CSF weights for PSNR-HVS (reference: tools/dump_psnrhvs.c:80-120).
_CSF_Y = np.array([
    [1.6193873005, 2.2901594831, 2.08509755623, 1.48366094411,
     0.999227625638, 0.622557230743, 0.404589405388, 0.271306656997],
    [2.2901594831, 1.94321815382, 2.04793073064, 1.68731108984,
     1.2305666963, 0.767913815959, 0.505312529424, 0.338240959913],
    [2.08509755623, 2.04793073064, 1.34329019223, 1.09205635862,
     0.875087929243, 0.60512836623, 0.448943958666, 0.30881878844],
    [1.48366094411, 1.68731108984, 1.09205635862, 0.772819797575,
     0.605636379554, 0.448943958666, 0.352474791098, 0.247682437031],
    [0.999227625638, 1.2305666963, 0.875087929243, 0.605636379554,
     0.448943958666, 0.352474791098, 0.283797458834, 0.210228316969],
    [0.622557230743, 0.767913815959, 0.60512836623, 0.448943958666,
     0.352474791098, 0.283797458834, 0.235186582729, 0.180712592073],
    [0.404589405388, 0.505312529424, 0.448943958666, 0.352474791098,
     0.283797458834, 0.235186582729, 0.200261666352, 0.160314207231],
    [0.271306656997, 0.338240959913, 0.30881878844, 0.247682437031,
     0.210228316969, 0.180712592073, 0.160314207231, 0.137109189847]])


def _dct8_f(block):
    """Float 8x8 type-II DCT (for the metric only)."""
    n = 8
    k = np.arange(n)
    c = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1)
                                  * k[:, None] / (2 * n))
    c[0] /= np.sqrt(2)
    return c @ block @ c.T


def psnr_hvs(a, b, step=7):
    """PSNR-HVS-M-style metric on one plane (reference:
    tools/dump_psnrhvs.c)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    h, w = a.shape
    total = 0.0
    count = 0
    for y in range(0, h - 7, step):
        for x in range(0, w - 7, step):
            da = _dct8_f(a[y:y + 8, x:x + 8])
            db = _dct8_f(b[y:y + 8, x:x + 8])
            d = (da - db) * _CSF_Y
            total += np.sum(d * d)
            count += 64
    if total == 0:
        return float("inf")
    return 10 * np.log10(255 * 255 / (total / count))


def _fspecial_gauss(size, sigma):
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2_valid(img, kernel):
    kh, kw = kernel.shape
    h, w = img.shape
    out = np.zeros((h - kh + 1, w - kw + 1))
    for i in range(kh):
        for j in range(kw):
            out += kernel[i, j] * img[i:i + h - kh + 1, j:j + w - kw + 1]
    return out


def ssim(a, b, k1=0.01, k2=0.03, maxval=255.0):
    """Single-scale SSIM with an 11x11 gaussian window (reference:
    tools/dump_ssim.c)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    win = _fspecial_gauss(11, 1.5)
    c1 = (k1 * maxval) ** 2
    c2 = (k2 * maxval) ** 2
    mu_a = _filter2_valid(a, win)
    mu_b = _filter2_valid(b, win)
    sa = _filter2_valid(a * a, win) - mu_a ** 2
    sb = _filter2_valid(b * b, win) - mu_b ** 2
    sab = _filter2_valid(a * b, win) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * sab + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2)
    return float(np.mean(num / den))


def ms_ssim(a, b, levels=5):
    """Multi-scale SSIM (reference: tools/dump_msssim.c)."""
    weights = [0.0448, 0.2856, 0.3001, 0.2363, 0.1333][:levels]
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    vals = []
    for lvl in range(levels):
        win = _fspecial_gauss(11, 1.5)
        c2 = (0.03 * 255) ** 2
        mu_a = _filter2_valid(a, win)
        mu_b = _filter2_valid(b, win)
        sa = _filter2_valid(a * a, win) - mu_a ** 2
        sb = _filter2_valid(b * b, win) - mu_b ** 2
        sab = _filter2_valid(a * b, win) - mu_a * mu_b
        cs = np.mean((2 * sab + c2) / (sa + sb + c2))
        if lvl == levels - 1:
            c1 = (0.01 * 255) ** 2
            l = np.mean((2 * mu_a * mu_b + c1)
                        / (mu_a ** 2 + mu_b ** 2 + c1))
            vals.append(l * cs)
        else:
            vals.append(cs)
        if lvl < levels - 1:
            a = (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2]
                 + a[1::2, 1::2])[:a.shape[0] // 2, :a.shape[1] // 2] / 4
            b = (b[0::2, 0::2] + b[1::2, 0::2] + b[0::2, 1::2]
                 + b[1::2, 1::2])[:b.shape[0] // 2, :b.shape[1] // 2] / 4
    out = 1.0
    for v, wgt in zip(vals, weights):
        out *= max(v, 0) ** wgt
    return float(out)


def bd_rate(rate1, dist1, rate2, dist2):
    """Bjontegaard delta-rate between two RD curves (reference:
    tools/bjontegaard.c, tools/bd_rate.sh): average bitrate difference in
    percent over the overlapping quality interval."""
    r1 = np.log(np.asarray(rate1, np.float64))
    r2 = np.log(np.asarray(rate2, np.float64))
    d1 = np.asarray(dist1, np.float64)
    d2 = np.asarray(dist2, np.float64)
    p1 = np.polyfit(d1, r1, 3)
    p2 = np.polyfit(d2, r2, 3)
    lo = max(d1.min(), d2.min())
    hi = min(d1.max(), d2.max())
    if hi <= lo:
        raise ValueError("no overlap between RD curves")
    q1 = np.polyint(p1)
    q2 = np.polyint(p2)
    int1 = np.polyval(q1, hi) - np.polyval(q1, lo)
    int2 = np.polyval(q2, hi) - np.polyval(q2, lo)
    avg_diff = (int2 - int1) / (hi - lo)
    return (np.exp(avg_diff) - 1) * 100


# ---------------------------------------------------------------------------
# CIEDE2000 color metric (reference: tools/dump_ciede2000.py behavior:
# studio-range normalize, box-upsampled 4:2:0 chroma, BT.709 matrix,
# Lab conversion, deltaE-2000 with kL=0.65/kC=1/kH=4, score
# 45 - 20*log10(mean dE)).  Implemented from the CIE standard formulas
# (Sharma, Wu & Dalal 2005) in pure numpy.

_BT709_YUV2RGB = np.array([
    [1.0, 0.0, 1.28033],
    [1.0, -0.21482, -0.38059],
    [1.0, 2.12798, 0.0],
])


def _yuv420_to_rgb(planes):
    """Studio-range 8-bit (Y, Cb, Cr) 4:2:0 planes -> float RGB (H, W, 3)."""
    y = (planes[0].astype(np.float64) - 16.0) / 219.0
    out = [y]
    for c in planes[1:3]:
        cf = (c.astype(np.float64) - 128.0) / 224.0
        if cf.shape != y.shape:
            cf = np.repeat(np.repeat(cf, 2, axis=0), 2, axis=1)
            cf = cf[:y.shape[0], :y.shape[1]]
        out.append(cf)
    ycc = np.stack(out, axis=-1)
    return ycc @ _BT709_YUV2RGB.T


def _rgb_to_lab(rgb):
    """sRGB in [0,1] -> CIE Lab (D65 white point)."""
    rgb = np.clip(rgb, 0.0, 1.0)
    lin = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                   rgb / 12.92)
    m = np.array([[0.412453, 0.357580, 0.180423],
                  [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    xyz = lin @ m.T
    xyz = xyz / np.array([0.95047, 1.0, 1.08883])
    eps = (6.0 / 29.0) ** 3
    f = np.where(xyz > eps, np.cbrt(xyz),
                 xyz / (3 * (6.0 / 29.0) ** 2) + 4.0 / 29.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return np.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                     200.0 * (fy - fz)], axis=-1)


def delta_e_2000(lab1, lab2, kl=0.65, kc=1.0, kh=4.0):
    """Pixelwise CIEDE2000 color difference between two Lab images."""
    l1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    l2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]
    c1 = np.hypot(a1, b1)
    c2 = np.hypot(a2, b2)
    cbar = 0.5 * (c1 + c2)
    c7 = cbar ** 7
    g = 0.5 * (1.0 - np.sqrt(c7 / (c7 + 25.0 ** 7)))
    a1p = (1.0 + g) * a1
    a2p = (1.0 + g) * a2
    c1p = np.hypot(a1p, b1)
    c2p = np.hypot(a2p, b2)
    h1p = np.degrees(np.arctan2(b1, a1p)) % 360.0
    h2p = np.degrees(np.arctan2(b2, a2p)) % 360.0
    dlp = l2 - l1
    dcp = c2p - c1p
    zero = (c1p * c2p) == 0
    dh = h2p - h1p
    dh = np.where(dh > 180.0, dh - 360.0, dh)
    dh = np.where(dh < -180.0, dh + 360.0, dh)
    dh = np.where(zero, 0.0, dh)
    dhp = 2.0 * np.sqrt(c1p * c2p) * np.sin(np.radians(dh) / 2.0)
    lbar = 0.5 * (l1 + l2)
    cbarp = 0.5 * (c1p + c2p)
    hsum = h1p + h2p
    habs = np.abs(h1p - h2p)
    hbar = np.where(habs <= 180.0, 0.5 * hsum,
                    np.where(hsum < 360.0, 0.5 * (hsum + 360.0),
                             0.5 * (hsum - 360.0)))
    hbar = np.where(zero, hsum, hbar)
    t = (1.0 - 0.17 * np.cos(np.radians(hbar - 30.0))
         + 0.24 * np.cos(np.radians(2.0 * hbar))
         + 0.32 * np.cos(np.radians(3.0 * hbar + 6.0))
         - 0.20 * np.cos(np.radians(4.0 * hbar - 63.0)))
    dtheta = 30.0 * np.exp(-(((hbar - 275.0) / 25.0) ** 2))
    c7p = cbarp ** 7
    rc = 2.0 * np.sqrt(c7p / (c7p + 25.0 ** 7))
    l50 = (lbar - 50.0) ** 2
    sl = 1.0 + 0.015 * l50 / np.sqrt(20.0 + l50)
    sc = 1.0 + 0.045 * cbarp
    sh = 1.0 + 0.015 * cbarp * t
    rt = -np.sin(np.radians(2.0 * dtheta)) * rc
    x = dlp / (kl * sl)
    y = dcp / (kc * sc)
    z = dhp / (kh * sh)
    return np.sqrt(x * x + y * y + z * z + rt * y * z)


def ciede2000(planes_a, planes_b):
    """Frame-level CIEDE2000 score: 45 - 20*log10(mean pixel dE), the
    convention of the reference's dump_ciede2000.py (kL=0.65, kH=4)."""
    lab_a = _rgb_to_lab(_yuv420_to_rgb(planes_a))
    lab_b = _rgb_to_lab(_yuv420_to_rgb(planes_b))
    de = delta_e_2000(lab_a, lab_b)
    mean = float(de.mean())
    if mean <= 0:
        return 100.0
    return float(45.0 - 20.0 * np.log10(mean))


# ---- Fast SSIM (reference: tools/dump_fastssim.c) -------------------------

#: Effective 8x8 "integer approximation to a Gaussian" window of the
#: structure term, extracted from the incremental column scheme of
#: fs_calc_structure (reference: tools/dump_fastssim.c:318-421); the
#: taps sum to 104, matching the tool's normalization comment.  Indexed
#: [dr + 4][dc + 4] relative to the output pixel.
_FS_KERNEL = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0],
    [0, 1, 2, 4, 4, 2, 1, 0, 0],
    [0, 0, 1, 2, 2, 1, 0, 0, 0],
    [0, 0, 0, 1, 1, 0, 0, 0, 0],
    [0, 0, 0, 1, 1, 0, 0, 0, 0],
    [0, 0, 1, 2, 2, 1, 0, 0, 0],
    [0, 1, 2, 4, 4, 2, 1, 0, 0],
    [1, 2, 4, 8, 8, 4, 2, 1, 0],
    [1, 2, 4, 8, 8, 4, 2, 1, 0]], np.float64)

#: Per-level weights (Wang's MS-SSIM weights, finest scale dropped and
#: renormalized; reference: tools/dump_fastssim.c:425-428).
_FS_WEIGHTS = (0.2989654541015625, 0.3141326904296875,
               0.2473602294921875, 0.1395416259765625)


def _fs_window(field, kernel):
    """Zero-padded correlation of `field` with the structure kernel."""
    h, w = field.shape
    pad = np.zeros((h + 8, w + 8), np.float64)
    pad[4:4 + h, 4:4 + w] = field
    out = np.zeros((h, w), np.float64)
    for dr in range(9):
        for dc in range(9):
            k = kernel[dr, dc]
            if k:
                out += k * pad[dr:dr + h, dc:dc + w]
    return out


def _fs_repbox8(im):
    """8x8 box sum with edge replication, window [-4, +3] in both axes
    (reference: tools/dump_fastssim.c:192-257 fs_apply_luminance)."""
    h, w = im.shape
    pr = im[np.clip(np.arange(-4, h + 4), 0, h - 1), :]
    cs = np.cumsum(pr, axis=0)
    colsum = cs[7:7 + h] - np.vstack([np.zeros((1, w)), cs[:h - 1]])
    pc = colsum[:, np.clip(np.arange(-4, w + 4), 0, w - 1)]
    cs2 = np.cumsum(pc, axis=1)
    return cs2[:, 7:7 + w] - np.hstack([np.zeros((h, 1)), cs2[:, :w - 1]])


def _fs_structure(im1, im2, level, samplemax):
    h, w = im1.shape
    gx = np.zeros((h, w), np.float64)
    gy = np.zeros((h, w), np.float64)
    g1 = np.abs(im1[1:, 1:] - im1[:-1, :-1])
    g2 = np.abs(im1[1:, :-1] - im1[:-1, 1:])
    gx[:-1, :-1] = 4 * np.maximum(g1, g2) + np.minimum(g1, g2)
    g1 = np.abs(im2[1:, 1:] - im2[:-1, :-1])
    g2 = np.abs(im2[1:, :-1] - im2[:-1, 1:])
    gy[:-1, :-1] = 4 * np.maximum(g1, g2) + np.minimum(g1, g2)
    c2 = samplemax * samplemax * (0.03 * 0.03) * (1 << 4 * level) * 16 * 104
    mugx2 = _fs_window(gx * gx, _FS_KERNEL)
    mugy2 = _fs_window(gy * gy, _FS_KERNEL)
    mugxgy = _fs_window(gx * gy, _FS_KERNEL)
    return (2 * mugxgy + c2) / (mugx2 + mugy2 + c2)


def _fs_luminance(ssim_map, im1, im2, level, samplemax):
    mux = _fs_repbox8(im1)
    muy_col0 = _fs_repbox8(im2)[:, :1]
    # The reference's incremental sweep updates muy with the *x* column
    # sums (tools/dump_fastssim.c:243-245), so away from column 0 the
    # effective muy is muy(0) + mux(i) - mux(0).  Replicated faithfully.
    muy = muy_col0 + mux - mux[:, :1]
    c1 = samplemax * samplemax * (0.01 * 0.01) * 4096 * (1 << 4 * level)
    return ssim_map * (2 * mux * muy + c1) / (mux * mux + muy * muy + c1)


def _fs_downsample(im):
    """2x2 sum downsample with edge replication (the reference clamps
    to w2/h2, an out-of-bounds read for odd level dims; we clamp to the
    last valid sample — identical whenever every level dim is even)."""
    h, w = im.shape
    hi = np.clip(np.arange((h + 1) >> 1) * 2 + 1, 0, h - 1)
    wi = np.clip(np.arange((w + 1) >> 1) * 2 + 1, 0, w - 1)
    return (im[::2][:, ::2] + im[::2][:, wi] + im[hi][:, ::2]
            + im[hi][:, wi])


def fast_ssim(a, b, depth=8):
    """Fast SSIM of two planes (reference: tools/dump_fastssim.c:443-470
    calc_ssim): 4 dyadic levels starting at half resolution, gradient
    structure term at every level, luminance term on the coarsest,
    geometric combination with the renormalized Wang weights."""
    im1 = _fs_downsample(np.asarray(a, np.float64))
    im2 = _fs_downsample(np.asarray(b, np.float64))
    samplemax = (1 << depth) - 1
    ret = 1.0
    for level in range(4):
        smap = _fs_structure(im1, im2, level, samplemax)
        if level == 3:
            smap = _fs_luminance(smap, im1, im2, level, samplemax)
        ret *= float(np.mean(smap)) ** _FS_WEIGHTS[level]
        if level < 3:
            im1 = _fs_downsample(im1)
            im2 = _fs_downsample(im2)
    return ret
