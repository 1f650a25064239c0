"""dct_frame (csrc/dct_frame.cu): the n-point blockwise DCT of a plane."""

from codecbench.roofline import lifting_ops

WRAPPER = ("daala_tpu_torch.ops.cuda.dct_kernels", "dct_frame_cuda")


def work(args):
    """The plane read and written once (int32); 2n one-dimensional
    networks per n x n block."""
    frame, n, forward = args[:3]
    h, w = frame.shape
    net = lifting_ops(("fdct%d" if forward else "idct%d") % n)
    return 8 * h * w, {"int32": h * w // (n * n) * 2 * n * net}
