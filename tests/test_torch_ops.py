"""The port's ops (daala_tpu_torch/ops) against the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions; those
must equal the Pallas kernels (interpret mode, as tests/test_pallas.py
runs them) and the numpy host transforms exactly: every value is an
integer, so the tolerance is zero.  The generated CUDA lifting header
is checked here by compiling it for the host with g++.  The kernels
themselves run only on a card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from daala_tpu.ops import _lifting as L
from daala_tpu.ops import dct as np_dct
from daala_tpu.ops import filter as filt
from daala_tpu.ops.pallas.dct_kernels import dct_frame_pallas
from daala_tpu.ops.pallas.lap_kernels import lap_frame_pallas
from daala_tpu_torch.device import resolve
from daala_tpu_torch.ops import dct as t_dct
from daala_tpu_torch.ops.cuda import _build, dct_kernels, lap_kernels
import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import gen_lifting_cuda  # noqa: E402


def _np_blocks(x, n):
    h, w = x.shape
    return x.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3) \
        .reshape(-1, n, n)


def _np_unblocks(b, h, w):
    n = b.shape[-1]
    return b.reshape(h // n, w // n, n, n).transpose(0, 2, 1, 3) \
        .reshape(h, w)


@pytest.mark.parametrize("dims", [(128, 256), (192, 128)])
@pytest.mark.parametrize("dec", [(0, 0), (1, 1)])
def test_lap_plain_matches_pallas(dims, dec):
    """Plain lap == lap_frame_pallas (interpret) == the host frame
    filter, forward and inverse, and post(pre(x)) == x."""
    h, w = dims
    xdec, ydec = dec
    sb_x, sb_y = 64 >> xdec, 64 >> ydec
    rng = np.random.default_rng(5)
    x = rng.integers(-(1 << 14), 1 << 14, (h, w)).astype(np.int32)
    ref = x.copy()
    filt.apply_prefilter_frame_sbs(ref, w // sb_x, h // sb_y, xdec, ydec)
    got = lap_kernels.lap_frame(torch.from_numpy(x), sb_x, sb_y, True)
    pal = lap_frame_pallas(jnp.asarray(x), sb_x=sb_x, sb_y=sb_y,
                           forward=True, interpret=True)
    assert np.array_equal(got.numpy(), ref)
    assert np.array_equal(got.numpy(), np.asarray(pal))
    back = lap_kernels.lap_frame(got, sb_x, sb_y, False)
    pal_back = lap_frame_pallas(pal, sb_x=sb_x, sb_y=sb_y, forward=False,
                                interpret=True)
    assert np.array_equal(back.numpy(), np.asarray(pal_back))
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_dct_plain_matches_pallas(n):
    """Plain dct_frame == dct_frame_pallas (interpret), both ways."""
    rng = np.random.default_rng(n)
    x = rng.integers(-(1 << 14), 1 << 14, (64, 96)).astype(np.int32)
    for fwd in (True, False):
        got = dct_kernels.dct_frame(torch.from_numpy(x), n, fwd)
        pal = dct_frame_pallas(jnp.asarray(x), n=n, forward=fwd,
                               interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(pal)), fwd


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_dct_plain_matches_host(n):
    """Plain dct_frame and fdct2d/idct2d == daala_tpu.ops.dct (oracle-
    pinned by test_dct2d.py) at every size, and the round trip is exact."""
    rng = np.random.default_rng(100 + n)
    h, w = 128, 192
    x = rng.integers(-(1 << 14), 1 << 14, (h, w)).astype(np.int32)
    want_f = _np_unblocks(np_dct.fdct2d(_np_blocks(x, n)), h, w)
    got_f = dct_kernels.dct_frame(torch.from_numpy(x), n, forward=True)
    assert np.array_equal(got_f.numpy(), want_f)
    want_i = _np_unblocks(np_dct.idct2d(_np_blocks(x, n)), h, w)
    got_i = dct_kernels.dct_frame(torch.from_numpy(x), n, forward=False)
    assert np.array_equal(got_i.numpy(), want_i)
    back = dct_kernels.dct_frame(got_f, n, forward=False)
    assert np.array_equal(back.numpy(), x)
    # The batched (..., n, n) functions on a 4-D batch.
    blocks = torch.from_numpy(_np_blocks(x, n).reshape(2, -1, n, n).copy())
    assert np.array_equal(t_dct.fdct2d(blocks).numpy().reshape(-1, n, n),
                          np_dct.fdct2d(_np_blocks(x, n)))
    assert np.array_equal(t_dct.idct2d(blocks).numpy().reshape(-1, n, n),
                          np_dct.idct2d(_np_blocks(x, n)))


def test_wrappers_check_their_inputs():
    x = torch.zeros((64, 64), dtype=torch.int32)
    with pytest.raises(ValueError):
        dct_kernels.dct_frame(x.to(torch.int64), 8)
    with pytest.raises(ValueError):
        dct_kernels.dct_frame(x, 12)
    with pytest.raises(ValueError):
        dct_kernels.dct_frame(x[:, :60], 8)
    with pytest.raises(ValueError):
        dct_kernels.dct_frame(x.t()[:, :32], 8)  # not contiguous
    with pytest.raises(ValueError):
        lap_kernels.lap_frame(x[None], 64, 64)
    with pytest.raises(ValueError):
        lap_kernels.lap_frame(x.to(torch.int16), 64, 64)
    # The CUDA entry points never take a CPU tensor.
    with pytest.raises(ValueError):
        dct_kernels.dct_frame_cuda(x, 8)
    with pytest.raises(ValueError):
        lap_kernels.lap_frame_cuda(x, 64, 64)


def test_device_resolution():
    assert resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve(None)
    if torch.cuda.is_available():
        assert resolve("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve("cuda")


def test_generated_header_is_current():
    """Regenerating lifting_gen.cuh reproduces the committed bytes."""
    with open(gen_lifting_cuda.DST) as f:
        assert f.read() == gen_lifting_cuda.generate()


_DRIVER = r"""
#include "lifting_gen.cuh"
#include <cstdio>
#include <cstring>
#include <vector>
typedef void (*fn_t)(int32_t *);
static const struct { const char *name; fn_t fn; int n; } NETS[] = {
  {"fdct4", fdct4, 4}, {"idct4", idct4, 4}, {"fdct8", fdct8, 8},
  {"idct8", idct8, 8}, {"fdct16", fdct16, 16}, {"idct16", idct16, 16},
  {"fdct32", fdct32, 32}, {"idct32", idct32, 32}, {"fdct64", fdct64, 64},
  {"idct64", idct64, 64}, {"pre_filter4", pre_filter4, 4},
  {"post_filter4", post_filter4, 4}};
// argv[1]: network name; stdin: nvec * n int32; stdout: the same, lifted.
int main(int argc, char **argv) {
  for (const auto &net : NETS) {
    if (strcmp(net.name, argv[1])) continue;
    std::vector<int32_t> v(net.n);
    while (fread(v.data(), 4, net.n, stdin) == (size_t)net.n) {
      net.fn(v.data());
      fwrite(v.data(), 4, net.n, stdout);
    }
    return 0;
  }
  return 2;
}
"""


@pytest.fixture(scope="module")
def header_exe(tmp_path_factory):
    """The generated header compiled for the host, with the CUDA
    qualifiers defined away and the optimizer on (which would exploit
    any signed overflow left in the code)."""
    d = tmp_path_factory.mktemp("lifting_cuh")
    src = d / "drv.cc"
    src.write_text(_DRIVER)
    exe = d / "drv"
    subprocess.run(["g++", "-O2", "-std=c++17", "-D__device__=",
                    "-D__forceinline__=", "-I",
                    os.path.dirname(gen_lifting_cuda.DST), str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    return str(exe)


@pytest.mark.parametrize("name", gen_lifting_cuda.WANT)
def test_generated_header_matches_numpy(header_exe, name):
    """All 12 networks of lifting_gen.cuh on int32 inputs over the whole
    range (so intermediates overflow) equal the numpy networks, which
    wrap like C's int32."""
    n = int(re.search(r"(\d+)$", name).group(1))
    rng = np.random.default_rng(gen_lifting_cuda.WANT.index(name))
    x = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, (2048, n), dtype=np.int64),
        rng.integers(-(1 << 14), 1 << 14, (256, n), dtype=np.int64),
    ]).astype(np.int32)
    r = subprocess.run([header_exe, name], input=x.tobytes(),
                       capture_output=True, check=True)
    got = np.frombuffer(r.stdout, np.int32).reshape(x.shape)
    with np.errstate(over="ignore"):
        want = np.stack(getattr(L, name)([x[:, k] for k in range(n)]),
                        axis=1)
    assert np.array_equal(got, want)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A kernel that does not build raises; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError, match="nvcc failed"):
        dct_kernels.build()
    assert os.listdir(tmp_path) == []  # no half-written library left


def test_build_cache_key_follows_sources():
    """The library name carries a hash of its sources, one per kernel."""
    a, b = _build._digest("dct_frame"), _build._digest("lap_frame")
    assert a != b and a == _build._digest("dct_frame")
