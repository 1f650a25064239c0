"""The launch plans of the frame kernels (csrc/frame_plan.cuh), compiled
for the host with g++ and checked at the planes the codec gives (the
1080p luma and chroma planes, the planes of a 192x128 encode, a plane
that is not a multiple of the superblock, 4:2:2 superblocks):

- dct_frame: the strips (and, where the plan keeps the first design,
  its blocks) cover every pixel exactly once; no strip hangs half idle
  over the right edge of those planes; shared memory, threads and
  registers of the planned blocks fit an H100 SM, and at n >= 16 the
  1080p grid is one wave of resident blocks; the 16-byte row accesses
  of 8 neighbouring threads fall in distinct bank groups.
- lap_frame: the tiles cover every pixel exactly once; every band and
  every 4 x 4 corner that a tile filters lies in its tile and halo, and
  the edges a tile filters (lap_edges) are exactly those whose bands
  touch it; the tile algorithm, run here on the plain version's lifting
  with those ranges, equals lap_frame_plain; the 1080p planes take one
  wave of resident blocks.  On a tile of a sharded plane (a tensor that
  starts at an even origin of a larger plane, parallel/sharding.py) the
  edges a block filters (lap_edges_at) are the plane's edges whose
  whole band lies in the tensor and touches the block, and the tile
  algorithm with them equals lap_frame_plain with the same origin.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from daala_tpu_torch.ops import _lifting as L
from daala_tpu_torch.ops.cuda.lap_kernels import lap_frame_plain
import torch_threads

torch_threads.share_cores()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "daala_tpu_torch", "csrc")

SMS = 132
SMEM_PER_SM, SMEM_RESERVED, SMEM_PER_BLOCK = 228 * 1024, 1024, 232448

# (h, w, sizes): the 1080p planes, the planes of a 192x128 encode, and a
# width that no strip divides.
DCT_PLANES = [(1088, 1920, (4, 8, 16, 32, 64)), (544, 960, (4, 8, 16, 32)),
              (128, 192, (4, 8, 16, 32, 64)), (64, 96, (4, 8, 16, 32)),
              (96, 100, (4,))]
DCT_CASES = [(h, w, n) for h, w, sizes in DCT_PLANES for n in sizes]
# (h, w, sb_x, sb_y): 1080p luma and chroma, the 192x128 encode's, a
# plane that is not a multiple of sb (rows of 150 words: not 16-byte
# aligned), 4:2:2 chroma, small superblocks with several bands a tile.
LAP_CASES = [(1088, 1920, 64, 64), (544, 960, 32, 32), (128, 192, 64, 64),
             (64, 96, 32, 32), (100, 150, 32, 32), (1088, 960, 32, 64),
             (100, 150, 64, 32), (76, 132, 8, 16)]

_PLAN_MAIN = r"""
#include <cstdio>
#include "frame_plan.cuh"
int main() {
  const int dct[][3] = {%(dct)s};
  for (const auto &c : dct) {
    const int h = c[0], w = c[1], n = c[2];
    const DctPlan p = dct_plan_for(n, dct_wb(n, w));
    printf("dct %%d %%d %%d %%d %%d %%d %%d %%d %%d %%d %%d %%d %%d\n", h,
           w, n, p.wb, p.pitch, p.smem_bytes, p.regs,
           p.blocks_per_sm, dct_units_x(n, w), dct_units(n, h, w),
           dct_tile(n, w), dct_direct(n, true), dct_direct(n, false));
  }
  const int lap[][4] = {%(lap)s};
  for (const auto &c : lap) {
    const int h = c[0], w = c[1], sbx = c[2], sby = c[3];
    const LapPlan p = lap_plan(h, w);
    printf("lap %%d %%d %%d %%d %%d %%d %%d %%d %%d %%d %%d %%d %%d\n", h, w,
           sbx, sby, p.th, p.tw, p.threads, p.pitch, p.rows, p.smem_bytes,
           p.tiles_y, p.tiles_x, p.blocks_per_sm);
    for (int t = 0; t < p.tiles_y; t++) {
      int lo, hi;
      const int a = t * p.th, b = a + p.th < h ? a + p.th : h;
      lap_edges(a, b, sby, h / sby, lo, hi);
      printf("edges %%d %%d %%d %%d y %%d %%d %%d\n", h, w, sbx, sby, t, lo,
             hi);
    }
    for (int t = 0; t < p.tiles_x; t++) {
      int lo, hi;
      const int a = t * p.tw, b = a + p.tw < w ? a + p.tw : w;
      lap_edges(a, b, sbx, w / sbx, lo, hi);
      printf("edges %%d %%d %%d %%d x %%d %%d %%d\n", h, w, sbx, sby, t, lo,
             hi);
    }
  }
  const int org[][8] = {%(org)s};
  for (const auto &c : org) {
    const int h = c[0], w = c[1], oy = c[2], ox = c[3], ph = c[4],
              pw = c[5], sbx = c[6], sby = c[7];
    const LapPlan p = lap_plan(h, w);
    printf("oplan %%d %%d %%d %%d %%d %%d\n", h, w, oy, ox, p.th, p.tw);
    for (int t = 0; t < p.tiles_y; t++) {
      int lo, hi;
      const int a = t * p.th, b = a + p.th < h ? a + p.th : h;
      lap_edges_at(a, b, sby, ph / sby, oy, h, lo, hi);
      printf("oedges %%d %%d %%d %%d y %%d %%d %%d\n", h, w, oy, ox, t, lo,
             hi);
    }
    for (int t = 0; t < p.tiles_x; t++) {
      int lo, hi;
      const int a = t * p.tw, b = a + p.tw < w ? a + p.tw : w;
      lap_edges_at(a, b, sbx, pw / sbx, ox, w, lo, hi);
      printf("oedges %%d %%d %%d %%d x %%d %%d %%d\n", h, w, oy, ox, t, lo,
             hi);
    }
  }
}
"""

# Tiles of sharded planes, (h, w, oy, ox, ph, pw, sb_x, sb_y): tensors
# that hold rows [oy, oy + h) and columns [ox, ox + w) of a (ph, pw)
# plane, each a tile's interior and its halo of 2 where it has a
# neighbour.  The 1080p luma and chroma planes over a 2 x 2 mesh (the
# rows 9 + 8 superblocks), a one-superblock tile with neighbours all
# round, a frame-border tile, and a tile of a plane whose last
# superblock is ragged.
ORIGIN_CASES = [(578, 962, 0, 958, 1088, 1920, 64, 64),
                (514, 962, 574, 0, 1088, 1920, 64, 64),
                (290, 484, 0, 478, 544, 960, 32, 32),
                (258, 482, 286, 478, 544, 960, 32, 32),
                (68, 68, 62, 126, 192, 320, 64, 64),
                (66, 66, 0, 0, 192, 320, 64, 64),
                (74, 138, 62, 62, 136, 200, 64, 64)]

DCT_FIELDS = ("h", "w", "n", "wb", "pitch", "smem_bytes", "regs",
              "blocks_per_sm", "units_x", "units", "tile", "direct_fwd",
              "direct_inv")
LAP_FIELDS = ("h", "w", "sb_x", "sb_y", "th", "tw", "threads", "pitch",
              "rows", "smem_bytes", "tiles_y", "tiles_x", "blocks_per_sm")


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    d = tmp_path_factory.mktemp("frame_plan")
    src = d / "drv.cc"
    src.write_text(_PLAN_MAIN % dict(
        dct=", ".join("{%d, %d, %d}" % c for c in DCT_CASES),
        lap=", ".join("{%d, %d, %d, %d}" % c for c in LAP_CASES),
        org=", ".join("{%d, %d, %d, %d, %d, %d, %d, %d}" % c
                      for c in ORIGIN_CASES)))
    exe = d / "drv"
    subprocess.run(["g++", "-O1", "-std=c++17", "-I", CSRC, str(src), "-o",
                    str(exe)], check=True, capture_output=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True).stdout.splitlines()
    dct, lap, edges, oedges = {}, {}, {}, {}
    for line in out:
        kind, *vals = line.split()
        if kind == "oplan":
            vals = tuple(map(int, vals))
            oedges.setdefault(vals[:4], {})["plan"] = vals[4:]
        elif kind == "oedges":
            key = tuple(map(int, vals[:4]))
            t, lo, hi = map(int, vals[5:])
            oedges.setdefault(key, {}).setdefault(vals[4], {})[t] = (lo, hi)
        elif kind == "dct":
            p = dict(zip(DCT_FIELDS, map(int, vals)))
            dct[p["h"], p["w"], p["n"]] = p
        elif kind == "lap":
            p = dict(zip(LAP_FIELDS, map(int, vals)))
            lap[p["h"], p["w"], p["sb_x"], p["sb_y"]] = p
        else:
            key = tuple(map(int, vals[:4]))
            t, lo, hi = map(int, vals[5:])
            edges.setdefault(key, {}).setdefault(vals[4], {})[t] = (lo, hi)
    return dct, lap, edges, oedges


def _fits_an_sm(threads, smem, regs, blocks):
    assert 1 <= blocks <= 32
    assert blocks * threads <= 2048
    assert blocks * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    assert smem <= SMEM_PER_BLOCK
    assert blocks * threads * regs <= 65536


@pytest.mark.parametrize("h,w,n", DCT_CASES)
def test_dct_plan_covers_and_fits(plans, h, w, n):
    p = plans[0][h, w, n]
    owner = np.zeros((h, w), np.int64)
    if p["tile"]:
        # The first design: 128 threads a block, one per column, 128 / n
        # tiles; the last block of a row may hang over the right edge.
        assert n == 4 or (n == 8 and w % 128 == 0)
        for by in range(h // n):
            for bx in range(-(-w // 128)):
                owner[by * n:(by + 1) * n, bx * 128:(bx + 1) * 128] += 1
        assert (owner == 1).all()
        return
    wb = p["wb"]
    assert wb % n == 0 and wb >= n
    assert p["pitch"] == wb + 4 and (p["pitch"] // 4) % 2 == 1
    assert p["smem_bytes"] == 4 * n * p["pitch"] <= 48 * 1024
    _fits_an_sm(wb, p["smem_bytes"], p["regs"], p["blocks_per_sm"])
    assert p["direct_fwd"] == 1 and p["direct_inv"] == (n <= 16)
    # Every pixel in exactly one unit (one block each).
    assert p["units_x"] == -(-w // wb) and p["units"] == h // n * p["units_x"]
    for u in range(p["units"]):
        y0, x0 = u // p["units_x"] * n, u % p["units_x"] * wb
        owner[y0:y0 + n, x0:x0 + wb] += 1
    assert (owner == 1).all()
    # No block hangs half idle over the right edge where a strip divides
    # the width (all the codec's planes but the last case).
    if w % 32 == 0:
        assert w % wb == 0
    # The 16-byte accesses of a tile row: 8 neighbouring threads (a
    # quarter warp) on 8 distinct 16-byte bank groups, for n >= 8.
    if n >= 8:
        for t0 in range(0, wb, 8):
            groups = {((t % n) * p["pitch"] + (t - t % n)) // 4 % 8
                      for t in range(t0, t0 + 8)}
            assert len(groups) == 8


def test_dct_plan_at_1080p(plans):
    """The 1080p planes give every SM work at every size (at least 132
    blocks, no half-idle strip), and at n >= 16, where the lifting is
    long, every block is resident at once: one wave, the grid within the
    blocks the plan keeps on 132 SMs."""
    for h, w, sizes in DCT_PLANES[:2]:
        for n in sizes:
            p = plans[0][h, w, n]
            if p["tile"]:
                assert -(-w // 128) * (h // n) >= SMS
                continue
            assert p["units"] >= SMS and w % p["wb"] == 0, (h, w, n)
            if n >= 16:
                assert p["units"] <= p["blocks_per_sm"] * SMS, (h, w, n)


def _touching(a, b, sb, nsb):
    return [k for k in range(1, nsb) if k * sb - 2 < b and k * sb + 1 >= a]


@pytest.mark.parametrize("h,w,sb_x,sb_y", LAP_CASES)
def test_lap_plan_covers_and_holds_every_band(plans, h, w, sb_x, sb_y):
    p = plans[1][h, w, sb_x, sb_y]
    edges = plans[2][h, w, sb_x, sb_y]
    th, tw = p["th"], p["tw"]
    assert th % 4 == 0 and tw % 4 == 0
    assert p["rows"] == th + 4 and p["pitch"] == tw + 8
    assert p["smem_bytes"] == 4 * p["rows"] * p["pitch"]
    _fits_an_sm(p["threads"], p["smem_bytes"], 32, p["blocks_per_sm"])
    assert p["tiles_y"] == -(-h // th) and p["tiles_x"] == -(-w // tw)
    owner = np.zeros((h, w), np.int64)
    for ty in range(p["tiles_y"]):
        for tx in range(p["tiles_x"]):
            owner[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] += 1
    assert (owner == 1).all()
    for axis, size, t_size, sb, halo in (("y", h, th, sb_y, 2),
                                         ("x", w, tw, sb_x, 4)):
        nsb = size // sb
        for t in range(-(-size // t_size)):
            a, b = t * t_size, min((t + 1) * t_size, size)
            lo, hi = edges[axis][t]
            assert list(range(lo, hi + 1)) == _touching(a, b, sb, nsb)
            load = (max(a - halo, 0), min(b + halo, size))
            lifted = (max(a - 2, 0), min(b + 2, size))  # first pass lanes
            for k in range(lo, hi + 1):
                # The band, and so every corner on it, lies in the loaded
                # tile and in the lanes the first pass lifts.
                assert load[0] <= k * sb - 2 and k * sb + 2 <= load[1]
                assert lifted[0] <= k * sb - 2 and k * sb + 2 <= lifted[1]


def test_lap_plan_takes_one_wave_at_1080p(plans):
    for key in ((1088, 1920, 64, 64), (544, 960, 32, 32)):
        p = plans[1][key]
        assert p["tiles_y"] * p["tiles_x"] <= p["blocks_per_sm"] * SMS


def _lift(c, start, axis, inv, lanes):
    """Lift the 4-wide band at `start` along `axis` of c (in place), over
    the lanes [l0, l1) of the other axis."""
    fn = L.post_filter4 if inv else L.pre_filter4
    l0, l1 = lanes
    if axis == 0:
        vals = fn([c[start + k, l0:l1].clone() for k in range(4)])
        for k in range(4):
            c[start + k, l0:l1] = vals[k]
    else:
        vals = fn([c[l0:l1, start + k].clone() for k in range(4)])
        for k in range(4):
            c[l0:l1, start + k] = vals[k]


@pytest.mark.parametrize("h,w,sb_x,sb_y", LAP_CASES)
def test_lap_tiles_equal_the_plain_version(plans, h, w, sb_x, sb_y):
    """The kernel's algorithm with the plan's tiles and edge ranges: each
    tile and halo copied out, the first axis's bands over the tile's
    lanes and 2 of the halo each side, the second axis's over its own,
    then its own pixels stored, equals lap_frame_plain, forward and
    inverse, at int32 extremes too."""
    p = plans[1][h, w, sb_x, sb_y]
    edges = plans[2][h, w, sb_x, sb_y]
    th, tw = p["th"], p["tw"]
    rng = np.random.default_rng(h * w + sb_x)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (h, w), dtype=np.int64)
                         .astype(np.int32))
    x[::3] = torch.from_numpy(rng.integers(-2**14, 2**14, (h, w))
                              .astype(np.int32))[::3]
    for fwd in (True, False):
        out = torch.empty_like(x)
        for ty in range(p["tiles_y"]):
            for tx in range(p["tiles_x"]):
                y0, x0 = ty * th, tx * tw
                y1, x1 = min(y0 + th, h), min(x0 + tw, w)
                ly0, ly1 = max(y0 - 2, 0), min(y1 + 2, h)
                lx0, lx1 = max(x0 - 4, 0), min(x1 + 4, w)
                s = x[ly0:ly1, lx0:lx1].clone()
                ky, kx = edges["y"][ty], edges["x"][tx]
                rows = [(k * sb_y - 2 - ly0, 0) for k in range(ky[0],
                                                               ky[1] + 1)]
                cols = [(k * sb_x - 2 - lx0, 1) for k in range(kx[0],
                                                               kx[1] + 1)]
                if fwd:
                    first, second = rows, cols
                    lanes1 = (max(x0 - 2, 0) - lx0, min(x1 + 2, w) - lx0)
                    lanes2 = (y0 - ly0, y1 - ly0)
                else:
                    first, second = cols, rows
                    lanes1 = (max(y0 - 2, 0) - ly0, min(y1 + 2, h) - ly0)
                    lanes2 = (x0 - lx0, x1 - lx0)
                for start, axis in first:
                    _lift(s, start, axis, not fwd, lanes1)
                for start, axis in second:
                    _lift(s, start, axis, not fwd, lanes2)
                out[y0:y1, x0:x1] = s[y0 - ly0:y1 - ly0, x0 - lx0:x1 - lx0]
        assert torch.equal(out, lap_frame_plain(x, sb_x, sb_y, fwd)), fwd


@pytest.mark.parametrize("h,w,oy,ox,ph,pw,sb_x,sb_y", ORIGIN_CASES)
def test_lap_tiles_at_an_origin_equal_the_plain_version(
        plans, h, w, oy, ox, ph, pw, sb_x, sb_y):
    """The kernel's algorithm on a tile of a sharded plane, with the
    plan's blocks and lap_edges_at's edge ranges (band starts k * sb - 2
    less the origin): each range is the plane's edges whose whole band
    lies in the tensor and touches the block, and the result equals
    lap_frame_plain with the tile's origin, forward and inverse."""
    edges = plans[3][h, w, oy, ox]
    th, tw = edges["plan"]
    for axis, size, t_size, sb, o, plane in (("y", h, th, sb_y, oy, ph),
                                             ("x", w, tw, sb_x, ox, pw)):
        for t in range(-(-size // t_size)):
            a, b = t * t_size, min((t + 1) * t_size, size)
            lo, hi = edges[axis][t]
            want = [k for k in _touching(a + o, b + o, sb, plane // sb)
                    if o <= k * sb - 2 and k * sb + 2 <= o + size]
            assert list(range(lo, hi + 1)) == want
    rng = np.random.default_rng(h * w + oy)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (h, w), dtype=np.int64)
                         .astype(np.int32))
    for fwd in (True, False):
        out = torch.empty_like(x)
        for ty in range(-(-h // th)):
            for tx in range(-(-w // tw)):
                y0, x0 = ty * th, tx * tw
                y1, x1 = min(y0 + th, h), min(x0 + tw, w)
                ly0, ly1 = max(y0 - 2, 0), min(y1 + 2, h)
                lx0, lx1 = max(x0 - 4, 0), min(x1 + 4, w)
                s = x[ly0:ly1, lx0:lx1].clone()
                ky, kx = edges["y"][ty], edges["x"][tx]
                rows = [(k * sb_y - 2 - oy - ly0, 0)
                        for k in range(ky[0], ky[1] + 1)]
                cols = [(k * sb_x - 2 - ox - lx0, 1)
                        for k in range(kx[0], kx[1] + 1)]
                if fwd:
                    first, second = rows, cols
                    lanes1 = (max(x0 - 2, 0) - lx0, min(x1 + 2, w) - lx0)
                    lanes2 = (y0 - ly0, y1 - ly0)
                else:
                    first, second = cols, rows
                    lanes1 = (max(y0 - 2, 0) - ly0, min(y1 + 2, h) - ly0)
                    lanes2 = (x0 - lx0, x1 - lx0)
                for start, axis in first:
                    assert 0 <= start and start + 4 <= s.shape[axis]
                    _lift(s, start, axis, not fwd, lanes1)
                for start, axis in second:
                    assert 0 <= start and start + 4 <= s.shape[axis]
                    _lift(s, start, axis, not fwd, lanes2)
                out[y0:y1, x0:x1] = s[y0 - ly0:y1 - ly0, x0 - lx0:x1 - lx0]
        assert torch.equal(out, lap_frame_plain(x, sb_x, sb_y, fwd, (oy, ox),
                                                (ph, pw))), fwd
