"""Gain-shape VQ codebook training (spherical k-means).

Re-implements the reference's vq_train tool
(reference: tools/vq_train.c:119-161 `vq_train`): sign-invariant
spherical k-means over unit vectors, with the option of excluding
training vectors that the K=2 PVQ codebook already represents better
than the trained codebook (reference: tools/vq_train.c:60-78
`pvq_dist_k2`).

Where the reference is an OpenMP scalar loop, the hot step here is a
single (vectors, dims) x (dims, entries) matmul per iteration, run in
float32 on a torch device (a CUDA card unless the caller passes
device="cpu"), as the JAX package runs it in float32 under jit; numpy
in float64 on request (backend="numpy").  A failure of the device step
raises: nothing falls back to numpy behind the caller's back.

The torch step is deterministic: the scatter-add of the kept rows into
their codewords (`_segment_sums`) sorts the rows by codeword and adds
each codeword's rows in their order, with no atomics.  Two runs on one
device give the same codebook bit for bit (`index_put_` with
accumulate=True does not, on the CPU).
Keep float32 matmuls at full precision
(`torch.backends.cuda.matmul.allow_tf32` False, PyTorch's default):
TF32 would change which codeword wins a near-tie.
"""

from __future__ import annotations

import numpy as np
import torch

from daala_tpu_torch.device import resolve

_SQRT1_2 = 0.7071067811865476


def _normalize(x, axis=-1):
    n = np.sqrt((x * x).sum(axis=axis, keepdims=True)) + 1e-30
    return x / n


def pvq_dist_k2(data: np.ndarray) -> np.ndarray:
    """Distance of each unit row to its best K=2 PVQ codeword: both
    pulses on the largest-magnitude dim, or one on each of the two
    largest (reference: tools/vq_train.c:60-78)."""
    a = np.abs(data)
    top2 = np.partition(a, -2, axis=1)[:, -2:]
    x2, x1 = top2[:, 0], top2[:, 1]
    return 2 - 2 * np.maximum(x1, _SQRT1_2 * (x1 + x2))


def _step_np(data, codebook, exclude_pvq):
    corr = data @ codebook.T
    best = np.argmax(np.abs(corr), axis=1)
    bc = corr[np.arange(len(data)), best]
    sign = np.where(bc > 0, 1.0, -1.0)
    err = 2 - 2 * np.abs(bc)
    if exclude_pvq:
        keep = err < pvq_dist_k2(data)
    else:
        keep = np.ones(len(data), bool)
    acc = np.zeros_like(codebook)
    w = np.where(keep, sign, 0.0)
    np.add.at(acc, best, w[:, None] * data)
    rms = float(np.sqrt(
        (np.where(keep, err, pvq_dist_k2(data))).mean()))
    return _normalize(acc), rms


def _segment_sums(rows, index, entries):
    """(entries, dims) tensor: out[e] = the sum of rows[i] over the i with
    index[i] == e, in rows' dtype.  Deterministic on any device: the
    rows sorted by index (a stable sort, so each entry's rows stay in
    their order), then `segment_reduce`, which adds each entry's rows
    one after the other, as numpy's add.at does; no atomics."""
    order = torch.argsort(index, stable=True)
    return torch.segment_reduce(
        rows[order], "sum", lengths=torch.bincount(index, minlength=entries),
        axis=0)


def _make_step_torch(exclude_pvq, device):
    """step(data, codebook) -> (codebook, rms, best): one k-means step on
    (vectors, dims) and (entries, dims) tensors on `device`, in their
    dtype (float32 in `train`); `rms` a 0-d tensor, `best` each row's
    codeword.  JAX's `_make_step_jax` (daala_tpu/train/vq.py:56)."""
    dev = resolve(device)

    def step(data, codebook):
        if data.device != dev or codebook.device != dev:
            raise ValueError("the k-means step runs on %s, got data on %s "
                             "and the codebook on %s"
                             % (dev, data.device, codebook.device))
        corr = data @ codebook.T
        best = torch.argmax(corr.abs(), dim=1)  # the first maximum
        bc = corr.gather(1, best[:, None])[:, 0]
        one = torch.ones((), dtype=data.dtype, device=dev)
        sign = torch.where(bc > 0, one, -one)
        err = 2 - 2 * bc.abs()
        top2 = torch.topk(data.abs(), 2, dim=1).values
        pvq_err = 2 - 2 * torch.maximum(
            top2[:, 0], _SQRT1_2 * (top2[:, 0] + top2[:, 1]))
        keep = (err < pvq_err) if exclude_pvq else torch.ones_like(
            err, dtype=torch.bool)
        w = torch.where(keep, sign, torch.zeros_like(sign))
        acc = _segment_sums(w[:, None] * data, best, len(codebook))
        norm = torch.sqrt((acc * acc).sum(-1, keepdim=True)) + 1e-30
        rms = torch.sqrt(torch.where(keep, err, pvq_err).mean())
        return acc / norm, rms, best

    return step


def train(data: np.ndarray, nb_entries: int, nb_iter: int = 100,
          exclude_pvq: bool = True, seed: int = 0, backend: str = "auto",
          device="cuda"):
    """(codebook, rms_history).  `data` is (vectors, dims); rows are
    normalized.  Initial codebook is randomly drawn rows plus noise
    (reference: tools/vq_train.c:104-117).

    backend "auto" runs the torch step on `device` in float32 on
    float32 copies, as JAX's step runs; each iteration's codebook comes
    back as float64 and goes in again as float32, as in JAX's.  backend
    "numpy" runs `_step_np` in float64 on the host and ignores
    `device`."""
    if backend not in ("auto", "numpy"):
        raise ValueError("backend must be 'auto' or 'numpy', got %r"
                         % (backend,))
    rng = np.random.default_rng(seed)
    data = _normalize(np.asarray(data, np.float64))
    ids = rng.integers(0, len(data), nb_entries)
    codebook = _normalize(
        data[ids] + 0.01 * rng.integers(-1, 2, (nb_entries, data.shape[1])))
    if backend == "numpy":
        def step(d, c):
            return _step_np(d, c, exclude_pvq)
    else:
        dev = resolve(device)
        step_torch = _make_step_torch(exclude_pvq, dev)
        d32 = torch.from_numpy(data.astype(np.float32)).to(dev)

        def step(d, c):
            c32 = torch.from_numpy(c.astype(np.float32)).to(dev)
            c2, rms, _ = step_torch(d32, c32)
            return c2.cpu().numpy().astype(np.float64), float(rms)
    hist = []
    for _ in range(nb_iter):
        codebook, rms = step(data, codebook)
        hist.append(rms)
    return codebook, hist


def main(argv=None):
    import argparse
    import sys
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dims", type=int)
    ap.add_argument("max_vectors", type=int)
    ap.add_argument("bits", type=int)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--keep-pvq", action="store_true",
                    help="do not exclude PVQ-K2-covered vectors")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the k-means step (default: cuda)")
    args = ap.parse_args(argv)
    rows = []
    for line in sys.stdin:
        vals = [float(v) for v in line.split()]
        if len(vals) == args.dims:
            rows.append(vals)
        if len(rows) >= args.max_vectors:
            break
    data = np.array(rows)
    cb, hist = train(data, 1 << args.bits, args.iters,
                     exclude_pvq=not args.keep_pvq, device=args.device)
    print("/* Trained by daala_tpu_torch.train.vq; final RMS %f. */"
          % hist[-1])
    for row in cb:
        print(", ".join("%f" % v for v in row) + ",")


if __name__ == "__main__":
    main()
