"""pulse_search (csrc/pulse_search.cu): the PVQ greedy pulse search."""

WRAPPER = ("daala_tpu_torch.ops.cuda.pulse_kernels", "pulse_search_cuda")


def work(args):
    """Bytes only: xc (float32) and lane_ok (bool) of every row read
    once, k, g2 (and src) of every searched row, the two rsqrt tables
    (16 and 2,048 float32), y (int32) of every lane and cos_dist and ok
    of every searched row written once.  Its operations depend on each
    row's trip count and are not counted."""
    xc, k = args[0], args[1]
    src = args[6] if len(args) > 6 else None
    rows, n = xc.shape
    m = k.shape[0]
    return (rows * n * 5 + m * (8 if src is None else 12) + 16 * 4
            + 2048 * 4 + m * n * 4 + m * 5), {}
