"""sad_fields (csrc/sad_fields.cu): the full-pel SAD fields of a tile
against one reference."""

WRAPPER = ("daala_tpu_torch.ops.cuda.sad_kernels", "sad_fields_cuda")


def work(args):
    """The tile and its reference window read once (uint8), the (noff,
    nv, nh) int32 fields written once; one 8-bit absolute difference
    with its accumulation per offset and visible pixel."""
    cur, ref, r, nv, nh = args[:5]
    vh, vw = cur.shape
    noff = (2 * r + 1) ** 2
    return (vh * vw + ref.numel() + 4 * noff * nv * nh,
            {"sad8": noff * vh * vw})
