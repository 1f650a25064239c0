"""lap_frame (csrc/lap_frame.cu): the frame lapped filter of a plane."""

from codecbench.roofline import lifting_ops

WRAPPER = ("daala_tpu_torch.ops.cuda.lap_kernels", "lap_frame_cuda")


def work(args):
    """The plane read and written once (int32); one 4-point network per
    column across every inner superblock row edge and per row across
    every column edge."""
    frame, sb_x, sb_y, forward = args[:4]
    h, w = frame.shape
    net = lifting_ops("pre_filter4" if forward else "post_filter4")
    edges = (max(h // sb_y - 1, 0) * w + max(w // sb_x - 1, 0) * h)
    return 8 * h * w, {"int32": edges * net}
