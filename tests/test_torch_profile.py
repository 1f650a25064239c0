"""The port's profiler (daala_tpu_torch/utils/profile.py): its trace
reading and its clip, on the CPU.  The profile itself needs a card."""

import numpy as np
import pytest

from daala_tpu_torch.utils import devstats
from daala_tpu_torch.utils.profile import (device_summary, span_device_work,
                                           translation_clip)


def test_device_summary_classes_and_union():
    """Copies, hand kernels and other kernels are told apart; busy time
    is the union of the device intervals, so overlap counts once."""
    ev = [
        {"cat": "kernel", "name": "void dct_frame_kernel<8>(int const*)",
         "ts": 0.0, "dur": 10.0},
        {"cat": "kernel", "name": "void lap_frame_kernel<true>(int*)",
         "ts": 5.0, "dur": 10.0},  # overlaps the first: 15 us in all
        {"cat": "kernel", "name": "at::native::vectorized_elementwise",
         "ts": 100.0, "dur": 4.0},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)",
         "ts": 200.0, "dur": 1000.0},
        {"cat": "cpu_op", "name": "aten::copy_", "ts": 0.0, "dur": 5e5},
        {"ph": "M", "name": "process_name"},
    ]
    s = device_summary(ev, wall_s=0.1)
    assert s["hand_kernels_count"] == 2 and s["hand_kernels_ms"] == 0.02
    assert s["other_kernels_count"] == 1 and s["other_kernels_ms"] == 0.004
    assert s["copies_count"] == 1 and s["copies_ms"] == 1.0
    assert s["device_busy_ms"] == pytest.approx(0.015 + 0.004 + 1.0,
                                                abs=0)
    assert s["device_busy_share"] == pytest.approx(1.019e-3 / 0.1, abs=0)


def test_translation_clip_is_reproducible_420():
    a = translation_clip(64, 48, 2)
    b = translation_clip(64, 48, 2)
    assert len(a) == 2
    assert [p.shape for p in a[0]] == [(48, 64), (24, 32), (24, 32)]
    assert all(p.dtype == np.uint8 for fr in a for p in fr)
    assert all(np.array_equal(p, q) for fa, fb in zip(a, b)
               for p, q in zip(fa, fb))
    # The luma pattern moves between frames (global translation).
    assert not np.array_equal(a[0][0], a[1][0])


def test_devstats_span_accumulates():
    devstats.reset()
    for _ in range(2):
        with devstats.span("x"):
            pass
    with pytest.raises(KeyError):
        with devstats.span("y"):
            raise KeyError("still timed")
    s = devstats.snapshot()["spans_s"]
    assert set(s) == {"x", "y"} and s["x"] >= 0 and s["y"] >= 0
    devstats.reset()
    assert devstats.snapshot()["spans_s"] == {}


def test_hand_kernels_name_every_kernel():
    """Every __global__ function of csrc/ is counted as a hand kernel in
    the traces, and named in its wrapper module's KERNELS."""
    import glob
    import os
    from chip_smoke import global_names
    from daala_tpu_torch.ops.cuda import (dct_kernels, lap_kernels,
                                          obmc_kernels)
    from daala_tpu_torch.utils.profile import HAND_KERNELS
    csrc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "daala_tpu_torch", "csrc")
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        names |= set(global_names(path))
    assert len(names) >= 4
    assert all(any(k in n for k in HAND_KERNELS) for n in names), names
    listed = (dct_kernels.KERNELS + lap_kernels.KERNELS
              + obmc_kernels.KERNELS)
    assert set(listed) == names


def test_span_device_work_reads_ranges_by_correlation():
    """Per record_function range: the launches made inside it and the
    device time of the work they launched (matched by correlation id),
    whenever that work ran; launches outside the range do not count."""
    ev = [
        {"cat": "user_annotation", "name": "band_search", "ts": 100.0,
         "dur": 50.0},
        {"cat": "user_annotation", "name": "band_search", "ts": 300.0,
         "dur": 10.0},
        {"cat": "user_annotation", "name": "other", "ts": 0.0, "dur": 1e4},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110.0,
         "dur": 2.0, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 120.0,
         "dur": 2.0, "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 130.0,
         "dur": 2.0, "args": {"correlation": 3}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 200.0,
         "dur": 2.0, "args": {"correlation": 4}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 305.0,
         "dur": 2.0, "args": {"correlation": 5}},
        {"cat": "kernel", "name": "k1", "ts": 500.0, "dur": 7.0,
         "args": {"correlation": 1}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 510.0, "dur": 3.0,
         "args": {"correlation": 2}},
        {"cat": "kernel", "name": "k4", "ts": 520.0, "dur": 100.0,
         "args": {"correlation": 4}},
        {"cat": "kernel", "name": "k5", "ts": 700.0, "dur": 1.5,
         "args": {"correlation": 5}},
    ]
    got = span_device_work(ev, "band_search")
    assert got == [{"launches": 2, "device_ms": 0.01, "wall_ms": 0.05},
                   {"launches": 1, "device_ms": 0.0015, "wall_ms": 0.01}]
    assert span_device_work(ev, "absent") == []
