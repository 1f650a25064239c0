"""band_epilogue (csrc/band_search.cu): the PVQ band search after its
pulse search."""

WRAPPER = ("daala_tpu_torch.ops.cuda.band_kernels", "band_epilogue_cuda")


def work(args):
    """Bytes only, counted once the window has closed (the ok flags are
    on the card): every candidate's ok flag; of the candidates marked ok
    (the only ones that can win) the pulses (n int32), cos_dist, the
    pulse search's ok and the 8 fields the cost reads; the row's 3
    fields; the CDF and node tables once; 6 int32, n int16 and a float32
    written a row."""
    ci, n, k1, sp = args[4], args[7], args[8], args[9]
    c, m = ci.shape[1:]
    tables = (k1.numel() + sp.numel()) * 4 if k1 is not None else 0
    ok = ci[2]

    def later():
        nok = int((ok != 0).sum())
        return (4 * c * m + nok * (n * 4 + 5 + 32) + 12 * m + tables
                + 16 * (2 * n - 3) + m * (24 + 2 * n + 4)), {}
    return later
