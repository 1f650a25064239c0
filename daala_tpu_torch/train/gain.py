"""Lapped-transform coding gain: measurement and filter search.

Re-implements the reference's transform-design tools
(reference: tools/trans.c:54-200 `coding_gain_search`,
tools/trans_gain.c:1149-1215 `cg_1d`): the 1-D coding gain of the
lapped DCT on an AR(rho) process is

    cg = -(10/N) * sum_j log10( (G R G^T)_jj * ||H_j||^2 )

where G/H are the analysis/synthesis operators including the boundary
pre/post filters, and R is the source autocorrelation over the lapped
support (reference: tools/trans_gain.c:25-80).

The lapped filters are modeled as *continuous* lifting matrices in the
reference's Q6 parameter space (scales + lifting steps; the structure
of src/filter.c:137-232), so the whole objective is differentiable:
`search` runs Adam (torch.optim, the update of the JAX package's optax
Adam up to rounding) with torch.autograd gradients on a device (a CUDA
card unless the caller passes device="cpu"), followed by an integer
polish in the Q6 lattice in numpy float64.  The shipped
`OD_FILTER_PARAMS4 = (85, 75, -15, 33)` sit within a few hundredths of
a dB of the unconstrained optimum found this way.

Dtypes: with xp=np every function computes in float64; with xp=torch
in the dtype of the parameters and on their device (float64 on the CPU
for a tuple of integers), every constant matrix made there too.
`search` ascends in float32, as the JAX package's does with x64 off.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.device import resolve

#: Shipped integer filter parameters (reference: src/filter.c:137-144
#: OD_FILTER_PARAMS4, :234-260 OD_FILTER_PARAMS8).
PARAMS4 = (85, 75, -15, 33)
PARAMS8 = (93, 72, 73, 78, -10, 23, -23, 37, -28, 50)


def _params(params, xp):
    """The parameters as an xp float array: a torch tensor is kept as it
    is (with its autograd history), anything else becomes float64."""
    if xp is torch and isinstance(params, torch.Tensor):
        return params
    if xp is torch:
        return torch.as_tensor(np.asarray(params, np.float64))
    return np.asarray(params, np.float64)


def _const(mat, xp, like=None):
    """The numpy array `mat` as an xp array; for torch on the device and
    in the dtype of the tensor `like` where one is given."""
    if xp is np:
        return np.asarray(mat)
    if like is None:
        return torch.as_tensor(mat)
    return torch.as_tensor(mat, dtype=like.dtype, device=like.device)


def _filter_matrix(params, n, xp=np):
    """(2n, 2n) pre-filter matrix for the n-point boundary filter with
    continuous Q6 `params`: scales s[0..n/2) (innermost first) then
    lifting pairs (p, q) from the outermost coefficient pair inward
    (the dataflow of src/filter.c:146-232 with exact arithmetic)."""
    params = _params(params, xp)
    m = n // 2
    s = [p / 64.0 for p in params[:m]]
    pq = [p / 64.0 for p in params[m:]]
    eye = np.eye(2 * m)
    x = [_const(eye[i], xp, params) for i in range(2 * m)]
    # Butterflies: t[m+k] = x[k] - x[2m-1-k]; t[k] = x[k] - t[m+k]/2.
    t = list(x)
    for k in range(m):
        t[m + (m - 1 - k)] = x[k] - x[2 * m - 1 - k]
    for k in range(m):
        t[k] = x[k] - t[m + (m - 1 - k)] * 0.5
    # Scales: innermost difference (index m) scaled by s[0], outermost
    # (index 2m-1) by s[m-1].
    for k in range(m):
        t[m + k] = t[m + k] * s[k]
    # Lifting pairs, outermost inward: (t[2m-1] += p*t[2m-2];
    # t[2m-2] += q*t[2m-1]), then the next pair, ...
    for i, k in enumerate(range(2 * m - 1, m, -1)):
        t[k] = t[k] + pq[2 * i] * t[k - 1]
        t[k - 1] = t[k - 1] + pq[2 * i + 1] * t[k]
    # Inverse butterflies.
    out = [None] * (2 * m)
    for k in range(m):
        t[k] = t[k] + t[m + (m - 1 - k)] * 0.5
        out[k] = t[k]
        out[2 * m - 1 - k] = t[k] - t[m + (m - 1 - k)]
    return xp.stack(out)


def dct_matrix(n, xp=np, like=None):
    """Orthonormal DCT-II (for torch on `like`'s device, in its dtype)."""
    k = np.arange(n)
    mat = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    mat *= np.sqrt(2.0 / n)
    mat[0] *= np.sqrt(0.5)
    return _const(mat, xp, like)


def ar_autocorrelation(support, rho=0.95, xp=np, like=None):
    i = np.arange(support)
    return _const(rho ** np.abs(i[None, :] - i[:, None]), xp, like)


def coding_gain_1d(params, n=4, filt_n=4, rho=0.95, xp=np):
    """Coding gain (dB) of the n-point lapped DCT whose boundaries use
    the filt_n-point filter with `params`, on an AR(rho) source: a float
    with xp=np, a 0-d tensor (differentiable in `params`) with
    xp=torch."""
    params = _params(params, xp)
    f = filt_n // 2
    support = n + 2 * filt_n
    # Analysis operator: pre-filter at both block edges, then DCT on
    # the center block.
    a = _const(np.eye(support), xp, params)
    pf = _filter_matrix(params, filt_n, xp)
    cat = np.concatenate if xp is np else torch.cat

    def apply_at(mat, op, pos):
        block = op @ mat[pos:pos + 2 * f]
        return cat([mat[:pos], block, mat[pos + 2 * f:]])

    a = apply_at(a, pf, filt_n - f)
    a = apply_at(a, pf, filt_n + n - f)
    d = dct_matrix(n, xp, params)
    g = d @ a[filt_n:filt_n + n]
    # Synthesis operator: transpose flow with the inverse filter.
    pfi = xp.linalg.inv(pf)
    s = _const(np.eye(support), xp, params)[:, filt_n:filt_n + n] @ d.T
    h = cat([
        s[:filt_n - f],
        pfi @ s[filt_n - f:filt_n + f],
        s[filt_n + f:filt_n + n - f],
        pfi @ s[filt_n + n - f:filt_n + n + f],
        s[filt_n + n + f:]])
    r = ar_autocorrelation(support, rho, xp, params)
    var = xp.diagonal(g @ r @ g.T)
    hnorm = (h * h).sum(0)
    if xp is np:
        return float(-10.0 * np.mean(np.log10(var * hnorm)))
    return -10.0 * torch.mean(torch.log10(var * hnorm))


def search(n=4, filt_n=4, rho=0.95, steps=400, lr=0.3, seed=0,
           init=None, polish_radius=1, device="cuda"):
    """Gradient-ascend the coding gain over continuous Q6 filter
    params with Adam on `device` (float32), then polish on the integer
    lattice (numpy float64).  Returns (best_int_params, best_cg,
    float_cg)."""
    dev = resolve(device)
    if init is None:
        init = PARAMS4 if filt_n == 4 else PARAMS8
    theta = torch.tensor(np.array(init, np.float32), device=dev,
                         requires_grad=True)
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8 outside the
    # square root, no eps inside it.
    opt = torch.optim.Adam([theta], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad()
        neg_cg = -coding_gain_1d(theta, n, filt_n, rho, torch)
        neg_cg.backward()
        opt.step()
    with torch.no_grad():
        float_cg = float(coding_gain_1d(theta, n, filt_n, rho, torch))
        theta = theta.cpu().numpy()
    # Integer polish: greedy +-polish_radius sweeps until fixed point.
    best = tuple(int(round(float(t))) for t in theta)
    best_cg = coding_gain_1d(best, n, filt_n, rho)
    improved = True
    while improved:
        improved = False
        for i in range(len(best)):
            for d in range(-polish_radius, polish_radius + 1):
                if d == 0:
                    continue
                cand = best[:i] + (best[i] + d,) + best[i + 1:]
                cg = coding_gain_1d(cand, n, filt_n, rho)
                if cg > best_cg:
                    best, best_cg, improved = cand, cg, True
    return best, best_cg, float_cg


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--filt", type=int, default=4, choices=[4, 8])
    ap.add_argument("--rho", type=float, default=0.95)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--search", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the search (default: cuda)")
    args = ap.parse_args(argv)
    shipped = PARAMS4 if args.filt == 4 else PARAMS8
    print("shipped params %s: cg = %.4f dB"
          % (shipped, coding_gain_1d(shipped, args.n, args.filt, args.rho)))
    m = args.filt // 2
    ident = (64,) * m + (0,) * (2 * (m - 1))
    print("unlapped DCT: cg = %.4f dB"
          % coding_gain_1d(ident, args.n, args.filt, args.rho))
    if args.search:
        best, cg, fcg = search(args.n, args.filt, args.rho, args.steps,
                               device=args.device)
        print("searched params %s: cg = %.4f dB (float optimum %.4f)"
              % (best, cg, fcg))


if __name__ == "__main__":
    main()
