"""band_prologue (csrc/band_search.cu): the PVQ band search before its
pulse search."""

WRAPPER = ("daala_tpu_torch.ops.cuda.band_kernels", "band_prologue_cuda")


def work(args):
    """Bytes only: each row's n gathered coefficients (and, inter, the
    reference's) and its 13 bytes of descriptors read once, the gather
    and QM tables once; the distinct pulse-search rows (n float32: inter
    the reflected row and x16, keyframe x16), the candidates' 11 fields
    and the row's 3 written once."""
    base, tab, n, kf = args[2], args[4], args[9], args[10]
    m, t = base.shape[0], tab.shape[0]
    c, g = (2, 1) if kf else (14, 2)
    return (m * n * 4 * g + 13 * m + 8 * t * n + g * m * n * 4
            + 44 * c * m + 12 * m), {}
