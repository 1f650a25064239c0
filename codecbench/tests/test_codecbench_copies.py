"""The benchmark's frozen copies against the port's originals: the clip
maker, the lifting networks, transforms and tables of the reference,
the busy-interval arithmetic and the kernels' byte counts."""

import os
import sys

import numpy as np
import pytest
import torch

from codecbench import roofline, source, trace
from codecbench.reference import intrin, tables, transform

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_natural_clip_is_the_ports():
    from daala_tpu_torch.utils.profile import make_natural_clip
    got = source.natural_clip(96, 64, 3, seed=5)
    want = make_natural_clip(96, 64, 3, seed=5)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_translation_clip_moves_as_the_ports():
    """The port's clip at phase 0 and seed 0's noise: the same pattern
    and motion; the seed moves only the phases and the noise."""
    frames = source.translation_clip(96, 64, 3, seed=9)
    for t in (1, 2):
        assert frames[t][0].shape == (64, 96)
        assert frames[t][1].shape == (32, 48)
    assert not np.array_equal(frames[0][0],
                              source.translation_clip(96, 64, 1, 10)[0][0])


def test_lifting_is_the_ports_text():
    def body(path):
        with open(path) as f:
            return [ln for ln in f if "import" not in ln]
    assert body(os.path.join(REPO, "codecbench", "reference",
                             "lifting.py")) == body(
        os.path.join(REPO, "daala_tpu_torch", "ops", "_lifting.py"))


def test_tables_are_the_ports():
    from daala_tpu_torch.ops import _tables as T
    names = [n for n in dir(T) if n.isupper()]
    assert names
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(tables, n)),
                                      np.asarray(getattr(T, n)), err_msg=n)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_transforms_are_the_ports(n):
    from daala_tpu_torch.ops import intrin as I
    from daala_tpu_torch.ops.cuda.dct_kernels import dct_frame_plain
    from daala_tpu_torch.ops.cuda.lap_kernels import lap_frame_plain
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-2048, 2048, (128, 192), dtype=torch.int32,
                      generator=g)
    for fwd in (True, False):
        assert torch.equal(transform.dct_frame(x, n, fwd),
                           dct_frame_plain(x, n, fwd))
        sb = max(n, 16)
        assert torch.equal(transform.lap_frame(x, sb, sb, fwd),
                           lap_frame_plain(x, sb, sb, fwd))
    a = x.numpy().astype(np.int32)
    np.testing.assert_array_equal(intrin.dct_rshift(a, 3),
                                  I.dct_rshift(a, 3))
    np.testing.assert_array_equal(intrin.c_div(a, 7), I.c_div(a, 7))


def test_busy_union_is_the_ports():
    from daala_tpu_torch.utils.profile import device_summary
    rng = np.random.default_rng(3)
    t0 = rng.integers(0, 10 ** 6, 200)
    dur = rng.integers(1, 5000, 200)
    events = [{"cat": "kernel", "name": "k", "ts": float(a), "dur": float(d)}
              for a, d in zip(t0, dur)]
    want = device_summary(events, 1.0)["device_busy_ms"] / 1e3
    got = trace.union_s([(int(a) * 1000, int(a + d) * 1000)
                         for a, d in zip(t0, dur)])
    assert got == pytest.approx(want, rel=1e-12)


class _T:
    """A stand-in tensor with a shape."""

    def __init__(self, *shape):
        self.shape = shape

    def numel(self):
        return int(np.prod(self.shape))


def test_kernel_counts_are_chip_smokes():
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    k = roofline.load_kernels(REPO)
    cur, ref = _T(1080, 1920), _T(1080 + 32, 1920 + 32)
    nbytes, ops = k["sad_fields"].work((cur, ref, 16, 17, 31, 0, 0))
    assert (nbytes, ops["sad8"] / 4) == cs.sad_work((1080, 1920), 16, 17, 31)
    for kf in (True, False):
        args = (None, None, _T(500), None, _T(6, 32), None, None, None, 1.0,
                32, kf)
        assert k["band_prologue"].work(args)[0] == cs.band_bytes(
            "band_prologue", args)
    for n, fwd in ((8, True), (64, False)):
        nbytes, ops = k["dct_frame"].work((_T(1088, 1920), n, fwd))
        assert (nbytes, ops["int32"]) == cs.dct_work(1088, 1920, n, fwd)
    nbytes, ops = k["lap_frame"].work((_T(544, 960), 32, 32, True))
    assert (nbytes, ops["int32"]) == cs.lap_work(544, 960, 32, True)
    assert roofline.PEAKS["bytes"] == cs.RATES["bytes_per_s"]
    rng = np.random.default_rng(0)
    scal = np.zeros((40, 16), np.int64)
    scal[:, 0:4] = rng.integers(0, 4, (40, 4))
    scal[:, 4:12] = rng.integers(0, 1000, (40, 8))
    scal[:, 13:15] = rng.integers(0, 1080, (40, 2))

    class Host(_T):
        def __init__(self, a):
            super().__init__(*a.shape)
            self.a = a

        def cpu(self):
            return self

        def numpy(self):
            return self.a
    nbytes, ops = k["obmc_leaf_cells"].work((_T(4, 1216, 2048),
                                             _T(1080, 1920), Host(scal),
                                             5))()
    want_bytes, want_ops = cs.obmc_work(scal, 5, 5, (1216, 2048), 1,
                                        (1080, 1920))
    # The same operations; the bytes without the reference windows.
    assert ops == {"int32": want_ops} and 0 < nbytes < want_bytes


def test_stated_qm_is_the_ports():
    """The reference's quantisation matrices, worked out from the
    configuration alone, are those that the port's encoder codes a
    keyframe with."""
    import json
    from codecbench import source, window
    from codecbench.stages import search
    with open(os.path.join(REPO, "codecbench", "configs",
                           "lean_1080p.json")) as f:
        cfg = json.load(f)
    cfg["width"] = cfg["height"] = 64
    enc = window.new_encoder(cfg, torch.device("cpu"))
    enc.encode_frame(source.make_clip("translation", 64, 64, 1, 3)[0])
    qm, pvq_qm = search.stated_qm(cfg)
    np.testing.assert_array_equal(qm, enc.state.qm)
    np.testing.assert_array_equal(pvq_qm, np.array(enc.state.pvq_qm_q4[:3]))
