"""The SAD-field kernel's work split (csrc/sad_fields.cu), emulated in
numpy and held to the plain version (ops/cuda/sad_kernels.py
sad_fields_plain) exactly, at r = 0, 1, 16 and 64 on ragged tiles.

The emulation follows the kernel step by step: the windows' spans; the
staging of each row in 16-byte chunks read from aligned addresses of a
byte memory where the planes start off 16-byte boundaries, realigned by
word selection and a funnel shift, the bytes past the row zero (and a
check that no chunk read lies wholly outside its row; rows that start on
16 bytes come by cp.async, which gives the same chunks); the warp items of
3 dy by 36 dx; a lane's s = dx mod 4 and its part of the rows (y = p,
p + 8, ...); the reference words shifted by s bytes; the ragged path's
masks; the 8- and 16-word paths; vabsdiff4; the sum of the 8 parts; and the offsets that the lanes
of part 0 write.  The staged reference rows that the kernel never
writes hold a sentinel, so a read of one that reached a written field
would show.  It also checks that the 8 rows a warp's lanes read at once
fall in distinct shared-memory banks, and that the shared memory of
r = 64 fits the 48 KB a launch takes without opting in.

The constants mirror the kernel's.  Every value is an integer, so the
tolerance is zero.  The kernel itself runs only on a card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from daala_tpu_torch.ops.cuda import sad_kernels as SK

WARPS, WIN, CUR_W, CUR_P, A, T, PARTS = 11, 64, 16, 20, 3, 9, 8
DXC, RW = 4 * T, T + CUR_W
SENTINEL = 0xA5A5A5A5


def dx_chunks(r):
    return (2 * r + 1 + DXC - 1) // DXC


def ref_pitch(r):
    p = max(T * (dx_chunks(r) - 1) + RW, (WIN + 2 * r + 3) // 4)
    p = (p + 3) & ~3
    return p if p & 7 else p + 4


def ref_rows(r):
    return WIN + 2 * r + A - 1


def smem_bytes(r):
    return 4 * (WIN * CUR_P + ref_rows(r) * ref_pitch(r) + 4)


def window_span(v, o, size):
    ncells = (size + 7) // 8
    a, b = max(0, 8 * v - o), min(ncells, 8 * v - o + 8)
    return 8 * a, (8 * a if b <= a else min(8 * b, size))


def row_chunk(mem, src, length, j):
    """The kernel's row_chunk on the byte memory `mem`: 4 words."""
    b0 = 16 * j
    if b0 >= length:
        return np.zeros(4, np.uint64)
    at = src + b0
    m = at & 15
    lo = mem[at - m:at - m + 16]
    assert at - m < src + length  # the chunk holds a byte of the row
    if m and b0 + 16 - m < length:
        assert at - m + 16 < src + length
        hi = mem[at - m + 16:at - m + 32]
    else:
        hi = np.zeros(16, np.uint8)
    w = np.concatenate([lo, hi]).view(np.uint32).astype(np.uint64)
    o, sh = m >> 2, 8 * (m & 3)
    v = w[o:o + 5]
    out = np.zeros(4, np.uint64)
    for q in range(4):
        valid = length - (b0 + 4 * q)
        mask = (0xFFFFFFFF if valid >= 4 else 0 if valid <= 0
                else (1 << (8 * valid)) - 1)
        out[q] = (((v[q + 1] << 32) | v[q]) >> sh) & 0xFFFFFFFF & mask
    return out


def stage(mem, src, spitch, rows, length, dpitch, alloc_rows):
    words = np.full((alloc_rows, dpitch), SENTINEL, np.uint64)
    for y in range(rows):
        for j in range(dpitch // 4):
            words[y, 4 * j:4 * j + 4] = row_chunk(mem, src + y * spitch,
                                                  length, j)
    return words


def vsadu4(a, b):
    """__vsadu4 over uint64 arrays holding 32-bit words."""
    out = np.zeros(np.broadcast(a, b).shape, np.int64)
    for byte in range(4):
        x = ((a >> (8 * byte)) & 255).astype(np.int64)
        y = ((b >> (8 * byte)) & 255).astype(np.int64)
        out += np.abs(x - y)
    return out


def item_fields(cur_s, ref_s, h, w, dy0, c0):
    """One warp item: (A, 4 s, T) sums, each the sum over the 8 row
    parts of a lane's sums over its rows.  The kernel's paths: a window
    64 wide over 16 words, one 32 wide over 8, any other the ragged path
    (masks) over 8 words up to 32 wide, else 16."""
    kw = 16 if w > WIN // 2 else 8
    ragged = w not in (WIN, WIN // 2)
    valid = w - 4 * np.arange(kw)
    msk = np.where(valid >= 4, 0xFFFFFFFF, np.where(
        valid <= 0, 0, (1 << (8 * np.clip(valid, 0, 3))) - 1)).astype(
            np.uint64)
    if not ragged:
        msk[:] = 0xFFFFFFFF
    w0 = c0 >> 2
    rk = T + kw
    ys = np.arange(h)
    cw = cur_s[ys, :kw]                                     # (h, kw)
    rows = ys[:, None] + dy0 + np.arange(A)[None, :]        # (h, A)
    rr = ref_s[rows[..., None], w0 + np.arange(rk)]         # (h, A, rk)
    s = np.arange(4, dtype=np.uint64)[None, None, :, None]
    sh = (((rr[:, :, None, 1:] << 32) | rr[:, :, None, :-1]) >> (8 * s)) \
        & 0xFFFFFFFF                                        # (h,A,4,rk-1)
    idx = np.arange(T)[:, None] + np.arange(kw)[None, :]    # (T, kw)
    words = sh[:, :, :, idx] & msk                          # (h,A,4,T,kw)
    d = vsadu4(cw[:, None, None, None, :], words).sum(-1)   # (h, A, 4, T)
    parts = [d[p::PARTS].sum(0) for p in range(PARTS)]
    return np.sum(parts, axis=0)


def emulate(cur, ref, r, nv, nh, oy, ox, cur_at, ref_at):
    """The kernel's (noff, nv, nh) int32 fields, the planes placed at
    byte offsets cur_at and ref_at of a byte memory (apart)."""
    vh, vw = cur.shape
    rw = vw + 2 * r
    assert cur_at + cur.size <= ref_at
    mem = np.zeros(ref_at + ref.size + 64, np.uint8)
    mem[cur_at:cur_at + cur.size] = cur.ravel()
    mem[ref_at:ref_at + ref.size] = ref.ravel()
    d = 2 * r + 1
    out = np.full((d * d, nv, nh), -1, np.int64)
    pitch = ref_pitch(r)
    for vi in range(nv):
        for vj in range(nh):
            y0, y1 = window_span(vi, oy, vh)
            x0, x1 = window_span(vj, ox, vw)
            h, w = y1 - y0, x1 - x0
            if h <= 0 or w <= 0:
                out[:, vi, vj] = 0
                continue
            cur_s = stage(mem, cur_at + y0 * vw + x0, vw, h, w, CUR_P, WIN)
            ref_s = stage(mem, ref_at + y0 * rw + x0, rw, h + 2 * r,
                          w + 2 * r, pitch, ref_rows(r))
            groups = (d + A - 1) // A
            items = groups * dx_chunks(r)
            done = set()
            for warp in range(WARPS):
                for it in range(warp, items, WARPS):
                    g, c = it % groups, it // groups
                    dy0, c0 = A * g, DXC * c
                    acc = item_fields(cur_s, ref_s, h, w, dy0, c0)
                    for a in range(A):
                        for s in range(4):
                            for t in range(T):
                                dy, dx = dy0 + a, c0 + s + 4 * t
                                if dy < d and dx < d:
                                    assert acc[a, s, t] < 2 ** 31
                                    out[dy * d + dx, vi, vj] = acc[a, s, t]
                                    done.add((dy, dx))
            assert len(done) == d * d  # every offset, once
    return out


def _tile(seed, vh, vw, r):
    rng = np.random.default_rng(seed)
    cur = rng.integers(0, 256, (vh, vw), np.uint8)
    ref = rng.integers(0, 256, (vh + 2 * r, vw + 2 * r), np.uint8)
    ref[: vh // 2] = np.clip(ref[: vh // 2] // 8 + 120, 0, 255)  # near
    return cur, ref


# (vh, vw, oy, ox, nv, nh): ragged edges (partial cells, widths that are
# no multiple of 4), windows clipped by the margins, one 64-wide window;
# the last tile's rows start on 16 bytes, so the kernel stages it by
# cp.async (the same chunks).
TILES = [(75, 101, 4, 3, 2, 2), (96, 136, 4, 4, 2, 3), (21, 13, 0, 2, 1, 1),
         (88, 112, 4, 4, 2, 3)]


@pytest.mark.parametrize("r", [0, 1, 16, 64])
@pytest.mark.parametrize("tile", range(len(TILES)))
def test_work_split_matches_plain(r, tile):
    vh, vw, oy, ox, nv, nh = TILES[tile]
    cur, ref = _tile(r + 10 * tile, vh, vw, r)
    want = SK.sad_fields_plain(torch.from_numpy(cur), torch.from_numpy(ref),
                               r, nv, nh, oy, ox).numpy()
    cur_at = 16 * tile + 3
    got = emulate(cur, ref, r, nv, nh, oy, ox, cur_at=cur_at,
                  ref_at=cur_at + cur.size + 4 * r + 6)
    np.testing.assert_array_equal(got, want)


def test_tiles_reach_every_path():
    """The tiles hold windows of each of the kernel's paths: 64 wide,
    32 wide (the margins'), ragged up to 32 wide and ragged over 32."""
    widths = {b - a for vh, vw, oy, ox, nv, nh in TILES
              for a, b in (window_span(v, ox, vw) for v in range(nh))}
    assert WIN in widths and WIN // 2 in widths
    assert any(w < WIN // 2 and w % 4 for w in widths)
    assert any(WIN // 2 < w < WIN for w in widths)


@pytest.mark.parametrize("r", [0, 1, 16, 64])
def test_banks_and_shared_memory(r):
    """The 8 rows that a warp's lanes read at once (one row part each,
    rows p + 8 i + dy) start in distinct 4-bank groups, for the current
    rows and the reference rows; the shared memory fits 48 KB."""
    assert smem_bytes(r) <= 48 * 1024
    assert smem_bytes(16) == 16112 and smem_bytes(64) == 45488
    for pitch in (CUR_P, ref_pitch(r)):
        assert pitch % 8 == 4
        for base in range(8):
            groups = {(base + p) * pitch % 32 // 4 for p in range(PARTS)}
            assert len(groups) == PARTS
    # The reference rows hold the last chunk's 25 words, and the rows'.
    assert ref_pitch(r) >= T * (dx_chunks(r) - 1) + RW
    assert 4 * ref_pitch(r) >= WIN + 2 * r
