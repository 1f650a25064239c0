"""The OBMC kernel's launch plan and blend weights (csrc/obmc_plan.cuh),
compiled for the host with g++ and checked for every leaf size and
sample width the kernels take: block shape and shared memory within the
H100's limits, every output pixel owned by exactly one thread, every
shared-memory read inside what the copies fill (or the bytes that
follow, which the taps multiply by 0), and the weights equal to
od_mc_setup_s_split (daala_tpu/codec/mc.py _setup_s_split).  The
kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import os
import subprocess

import numpy as np
import pytest

from daala_tpu.codec.mc import _setup_s_split
import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "daala_tpu_torch", "csrc")

SMEM_PER_BLOCK = 232448  # 227 KB: the most a block can have on an H100


def static_smem(wtab):
    """The kernel's static tables: taps as int32 and packed int8, and
    the blend weights (16 x 4 int4) or their 4-entry stub."""
    return 8 * 6 * 4 + 8 * 2 * 4 + (16 if wtab else 1) * 4 * 16

_DRIVER = r"""
#include <cstdio>
#include "obmc_plan.cuh"
int main() {
  for (int is = 1; is <= 2; is++)
    for (int lx = 2; lx <= 6; lx++)
      for (int ly = 2; ly <= 6; ly++) {
        const ObmcPlan p = obmc_plan(lx, ly, is);
        printf("plan %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d %d\n", is,
               lx, ly, p.rows, p.strips, p.tpl, p.lpb, p.threads, p.copy,
               p.row_words, p.leaf_words, p.stage_bytes, p.smem_bytes,
               p.wtab, p.params, p.min_blocks);
      }
  for (int lx = 2; lx <= 6; lx++)
    for (int ly = 2; ly <= 6; ly++)
      for (int oc = 0; oc < 4; oc++)
        for (int s = 0; s < 4; s++)
          for (int k = 0; k < 4; k++) {
            int a, b, c, d;
            obmc_weight(oc, s, k, lx, ly, a, b, c, d);
            printf("weight %d %d %d %d %d %d %d %d %d\n", lx, ly, oc, s, k,
                   a, b, c, d);
          }
}
"""

FIELDS = ("itemsize", "log_x", "log_y", "rows", "strips", "tpl", "lpb",
          "threads", "copy", "row_words", "leaf_words", "stage_bytes",
          "smem_bytes", "wtab", "params", "min_blocks")


@pytest.fixture(scope="module")
def plan_output(tmp_path_factory):
    d = tmp_path_factory.mktemp("obmc_plan")
    src = d / "drv.cc"
    src.write_text(_DRIVER)
    exe = d / "drv"
    subprocess.run(["g++", "-O1", "-std=c++17", "-I", CSRC, str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    lines = subprocess.run([str(exe)], check=True, capture_output=True,
                           text=True).stdout.splitlines()
    plans = {}
    weights = {}
    for line in lines:
        kind, *vals = line.split()
        vals = list(map(int, vals))
        if kind == "plan":
            p = dict(zip(FIELDS, vals))
            plans[p["itemsize"], p["log_x"], p["log_y"]] = p
        else:
            weights[tuple(vals[:5])] = tuple(vals[5:])
    return plans, weights


CASES = [(i, x, y) for i in (1, 2) for x in range(2, 7) for y in range(2, 7)]


@pytest.mark.parametrize("itemsize,log_x,log_y", CASES)
def test_plan_fits_and_covers(plan_output, itemsize, log_x, log_y):
    p = plan_output[0][itemsize, log_x, log_y]
    nx, ny = 1 << log_x, 1 << log_y
    # Block shape: whole warps (the cells' shuffles), at most 256 threads.
    assert p["threads"] == p["lpb"] * p["tpl"]
    assert 32 <= p["threads"] <= 256 and p["threads"] % 32 == 0
    assert p["rows"] * p["strips"] == ny and p["tpl"] == nx * p["strips"]
    assert p["rows"] % 8 == 0 or ny < 8  # a strip holds whole cell rows
    assert p["smem_bytes"] + static_smem(p["wtab"]) <= SMEM_PER_BLOCK
    assert p["params"] == (p["tpl"] < 32)
    assert p["smem_bytes"] == (2 * p["stage_bytes"]
                               + p["params"] * 2 * p["lpb"] * 32 + 16)
    # The register cap keeps min_blocks resident: at most 1024 threads
    # (64 registers each), and what shared memory allows.
    per_block = p["smem_bytes"] + static_smem(p["wtab"]) + 1024
    assert p["min_blocks"] >= 1
    assert p["min_blocks"] * p["threads"] <= 1024
    assert p["min_blocks"] * per_block <= 228 * 1024
    assert p["stage_bytes"] == p["lpb"] * p["leaf_words"] * 4
    # Every pixel of every leaf of the block, owned exactly once.
    owned = np.zeros((p["lpb"], ny, nx), np.int64)
    for tid in range(p["threads"]):
        li, tl = divmod(tid, p["tpl"])
        strip, c = divmod(tl, nx)
        owned[li, strip * p["rows"]:(strip + 1) * p["rows"], c] += 1
    assert (owned == 1).all()
    # The 8 lanes of a cell are 8 neighbouring lanes of one warp.
    if nx >= 8:
        for tid in range(0, p["threads"], 8):
            li, tl = divmod(tid, p["tpl"])
            assert tl % nx % 8 == 0 and tid // 32 == (tid + 7) // 32
    # Copies: aligned destinations, and every window row filled whatever
    # the row's first byte (o) within its first copy.
    copy, rw = p["copy"], p["row_words"]
    assert copy in (4, 8, 16)
    assert (rw * 4) % copy == 0 and (p["leaf_words"] * 4) % copy == 0
    assert p["leaf_words"] >= 4 * (ny + 5) * rw
    need = (nx + 5) * itemsize
    for o in range(0, copy, itemsize):
        copies = -(-(o + need) // copy)
        assert copies * copy <= rw * 4
        if itemsize == 1:
            # Words q, q+1, q+2 from q = (o + c) >> 2: the bytes the taps
            # use lie in the row; the third word at most one past it.
            last = o + nx - 1
            assert last + 5 < rw * 4
            assert (last >> 2) + 2 <= rw
        else:
            assert o // 2 + nx - 1 + 5 < rw * 2
    # Leaves sharing a warp start an odd multiple of tpl banks apart.
    if p["lpb"] > 1 and p["tpl"] < 32:
        off = p["leaf_words"] % 32
        assert off % p["tpl"] == 0 and (off // p["tpl"]) % 2 == 1


def test_plan_keeps_four_blocks_at_8_bits(plan_output):
    """Every 8-bit plan leaves room for 4 blocks of its size on an SM by
    shared memory (228 KB, 1 KB of each block kept by the hardware), and
    takes the weight table wherever the table still leaves that room."""
    for (itemsize, lx, ly), p in plan_output[0].items():
        per_block = p["smem_bytes"] + 1024
        if itemsize == 1:
            assert 4 * (per_block + static_smem(p["wtab"])) <= 233472, \
                (lx, ly, p)
        assert p["wtab"] == (4 * (per_block + static_smem(1)) <= 233472)


@pytest.mark.parametrize("log_x", [2, 3, 4, 5, 6])
def test_weights_match_setup_s_split(plan_output, log_x):
    weights = plan_output[1]
    for log_y in range(2, 7):
        for oc in range(4):
            for s in range(4):
                want = _setup_s_split(oc, s, log_x, log_y)
                total = [0, 0, 0, 0]
                for k in range(4):
                    got = weights[log_x, log_y, oc, s, k]
                    assert got == tuple(v[k] for v in want)
                    total = [t + g for t, g in zip(total, got)]
                # The blend sum_k p_k w_k relies on the weights of every
                # pixel summing to 2 << (log_x + log_y).
                assert total == [2 << (log_x + log_y), 0, 0, 0]
