// The full-pel SAD fields of models/mefield.py: for every offset (dy, dx)
// of a +-r window and every level-0 vertex window of a tile, the sum of
// |cur - ref shifted by (dy, dx)| over the window's visible pixels.
//
// Replaces _fullpel_fields (daala_tpu/models/mefield.py:42), which JAX
// computes in XLA, not Pallas: a map over the (2r + 1)^2 offsets of a
// whole-plane difference, cell sums and window sums.  The port's plain
// version (ops/cuda/sad_kernels.py sad_fields_plain) takes one dy at a
// time with every dx at once, and so reads the two planes through HBM
// once for each of 2r + 1 unfolded int16 copies.
//
// What bounds it: operations.  At 1080p and r = 16 the fields are
// 2.26e9 byte differences, against 4.2 MB of planes read and 2.4 MB of
// fields written.  One vabsdiff4 with its accumulator takes the absolute
// differences of 4 byte pairs and adds them to a sum, at about 62 lanes
// a clock per SM on an H100 SXM (chip_smoke.py's probe).
//
// Design: one block of 11 warps an SM, each taking the vertex windows
// b, b + blocks, ... in turn.  For each window the block copies its
// current pixels (at most 64 x 64) and the reference pixels under every
// offset ((64 + 2r)^2) into shared memory once, the bytes past each row's
// width zero: by cp.async into the other of two buffers while it computes
// the window before (where the rows start on 16 bytes, as the codec's
// tiles' do), else by 16-byte loads realigned in registers.  (A block per
// window, staging through registers, spent 2-2.5 us of its 14-15 us on
// the copy, with nothing else on its SM.)
// The offsets are split evenly: a warp item is 3 dy by 36 dx (dx = 36 c +
// s + 4 t, t < 9); a lane owns one s = dx mod 4 of the item and one of 8
// interleaved parts of the window's rows (y = p, p + 8, ...), and keeps
// the item's 27 sums in registers.  For each of its rows a lane loads the
// current row's 16 words once and, for each of its 3 dy, the reference
// row's 25 words at the item's dx, shifts them by s bytes (24 funnel
// shifts) and runs 9 x 16 vabsdiff4: each loaded word feeds 9 (reference)
// or 27 (current) of them.  Then the 8 row parts' sums meet over three
// shuffles, and the lanes of part 0 write the item's fields.  Rows are
// padded to 20 and 28 words (4 mod 8), so the 8 rows that a warp's lanes
// read at once fall in distinct banks, and a lane's 16-byte loads are
// conflict-free.  Neither the per-offset planes nor the cell sums ever
// reach HBM.
//
// Windows: vertex (vi, vj) covers cells [8 vi - oy, 8 vi + 8 - oy) of the
// tile's cell grid, clipped to its ch = ceil(vh / 8) cells (and likewise
// across), which is the plain version's cell grid placed at (oy, ox) of
// the zero (8 nv, 8 nh) grid.  Its pixels are those cells' pixels within
// the visible (vh, vw): the plain version's mask of a partial edge cell.
// A window 32 wide (the margins' half windows) runs over 8 words of its
// rows; any other window narrower than 64 takes the ragged path, over 8
// or 16 words, which masks the reference bytes past its width in every
// word (the current bytes there are zero).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 11;
constexpr int THREADS = 32 * WARPS;
constexpr int WIN = 64;     // a vertex window's pixels a side
constexpr int CUR_W = 16;   // words of a window row
constexpr int CUR_P = 20;   // words a staged current row (4 mod 8)
constexpr int A = 3;        // dy an item
constexpr int T = 9;        // dx a lane of an item: s + 4 t
constexpr int DXC = 4 * T;  // dx an item
constexpr int RW = T + CUR_W;  // reference words a lane reads a row
constexpr int PARTS = 8;    // row parts: lanes with one s

__host__ __device__ inline int dx_chunks(int r) {
  return (2 * r + 1 + DXC - 1) / DXC;
}

// Words a staged reference row: the last chunk's words, and at least the
// row's (64 + 2r bytes), rounded up to 4 mod 8.
__host__ __device__ inline int ref_pitch(int r) {
  int p = T * (dx_chunks(r) - 1) + RW;
  const int row = (WIN + 2 * r + 3) / 4;
  p = p > row ? p : row;
  p = (p + 3) & ~3;
  return (p & 7) ? p : p + 4;
}

// Staged reference rows: the window's, and A - 1 more that the last item
// may read for offsets past 2r (its sums are not written).
__host__ __device__ inline int ref_rows(int r) {
  return WIN + 2 * r + A - 1;
}

__host__ __device__ inline int smem_bytes(int r) {
  // + 4 words: a lane's last 16-byte load may pass its row's pitch by 3.
  return 4 * (WIN * CUR_P + ref_rows(r) * ref_pitch(r) + 4);
}

// |a - b| summed over the 4 byte pairs, plus acc: one vabsdiff4 with its
// accumulator (__vsadu4(a, b) + acc compiles to a vabsdiff4 and an add).
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(acc));
  return d;
}

// A vertex window's span on one axis in the tile: [p0, p1) pixels.
__device__ inline void window_span(int v, int o, int size, int *p0,
                                   int *p1) {
  const int ncells = (size + 7) / 8;
  int a = 8 * v - o, b = a + 8;
  a = a < 0 ? 0 : a;
  b = b > ncells ? ncells : b;
  *p0 = 8 * a;
  *p1 = b <= a ? 8 * a : (8 * b < size ? 8 * b : size);
}

// Bytes [16 j, 16 j + 16) of a row of `len` bytes at `src`, those past
// len zero.  Reads the 16-byte-aligned chunks that hold bytes of the row
// (at most two), never a chunk without one: a CUDA allocation starts on
// 256 bytes, so such a chunk lies in the row's allocation.
__device__ __forceinline__ uint4 row_chunk(const uint8_t *src, int len,
                                           int j) {
  uint4 out = make_uint4(0, 0, 0, 0);
  const int b0 = 16 * j;
  if (b0 >= len) return out;
  const uintptr_t at = (uintptr_t)(src + b0);
  const int m = (int)(at & 15);
  const uint4 *p = (const uint4 *)(at - m);
  const uint4 lo = __ldg(p);
  const uint4 hi = (m != 0 && b0 + 16 - m < len) ? __ldg(p + 1) : out;
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int o = m >> 2, sh = 8 * (m & 3);
  uint32_t v[5];
#pragma unroll
  for (int q = 0; q < 5; q++)
    v[q] = o == 0 ? w[q] : o == 1 ? w[q + 1] : o == 2 ? w[q + 2] : w[q + 3];
  uint32_t r[4];
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const int valid = len - (b0 + 4 * q);  // bytes of word q in the row
    const uint32_t mask = valid >= 4   ? 0xffffffffu
                          : valid <= 0 ? 0u
                                       : (1u << (8 * valid)) - 1;
    r[q] = __funnelshift_r(v[q], v[q + 1], sh) & mask;
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// Stage a window: `crows` rows of `clen` bytes from cur (row pitch
// `cpitch` bytes) and `rrows` rows of `rlen` bytes from ref (`rpitch`)
// into shared memory rows of CUR_P and `dpitch` words, whole 16-byte
// chunks, the bytes past each row zero.  Where every row starts on 16
// bytes (the codec's tiles: widths and window columns multiples of 16),
// a chunk is one cp.async, which returns at once (the caller waits for
// the group); otherwise row_chunk's loads, realigned in registers, up to
// 4 a thread in flight together.
__device__ __forceinline__ void stage(const uint8_t *cur, size_t cpitch,
                                      int crows, int clen, uint32_t *cur_s,
                                      const uint8_t *ref, size_t rpitch,
                                      int rrows, int rlen, uint32_t *ref_s,
                                      int dpitch, bool async) {
  constexpr int CC = CUR_P / 4;  // chunks a staged current row
  const int rc = dpitch / 4, ncur = crows * CC, total = ncur + rrows * rc;
  if (async) {
    for (int k = threadIdx.x; k < total; k += THREADS) {
      const bool isc = k < ncur;
      const int kk = isc ? k : k - ncur, per = isc ? CC : rc;
      const int y = kk / per, j = kk - y * per;
      uint32_t *dst =
          isc ? cur_s + y * CUR_P + 4 * j : ref_s + y * dpitch + 4 * j;
      const int left = (isc ? clen : rlen) - 16 * j;
      if (left <= 0) {
        *(uint4 *)dst = make_uint4(0, 0, 0, 0);
        continue;
      }
      const uint8_t *src = (isc ? cur + (size_t)y * cpitch
                                : ref + (size_t)y * rpitch) + 16 * j;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                      "r"(left < 16 ? left : 16));
    }
    asm volatile("cp.async.commit_group;\n");
    return;
  }
  for (int k0 = threadIdx.x; k0 < total; k0 += 4 * THREADS) {
    uint4 v[4];
    uint32_t *at[4];
#pragma unroll
    for (int u = 0; u < 4; u++) {
      const int k = k0 + u * THREADS;
      at[u] = nullptr;
      if (k < ncur) {
        const int y = k / CC, j = k - y * CC;
        v[u] = row_chunk(cur + (size_t)y * cpitch, clen, j);
        at[u] = cur_s + y * CUR_P + 4 * j;
      } else if (k < total) {
        const int y = (k - ncur) / rc, j = k - ncur - y * rc;
        v[u] = row_chunk(ref + (size_t)y * rpitch, rlen, j);
        at[u] = ref_s + y * dpitch + 4 * j;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; u++)
      if (at[u]) *(uint4 *)at[u] = v[u];
  }
}

// One warp item: dy in [dy0, dy0 + A), dx = c0 + s + 4 t, over the first
// KW words of the window's rows (16, or 8 for a window at most 32 wide).
// Returns the lane's partial sums over its rows in acc.
template <bool RAGGED, int KW>
__device__ __forceinline__ void item_sums(const uint32_t *cur_s,
                                          const uint32_t *ref_s, int pitch,
                                          int h, int w, int dy0, int c0,
                                          int s, int p, uint32_t acc[A][T]) {
  constexpr int RK = T + KW;  // reference words a lane reads a row
  uint32_t msk[KW];
#pragma unroll
  for (int k = 0; k < KW; k++) {
    const int valid = w - 4 * k;
    msk[k] = !RAGGED || valid >= 4 ? 0xffffffffu
             : valid <= 0          ? 0u
                                   : (1u << (8 * valid)) - 1;
  }
  const int w0 = c0 >> 2;  // the item's first reference word
  const int sh = 8 * s;
  for (int y = p; y < h; y += PARTS) {
    uint32_t cw[KW];
#pragma unroll
    for (int q = 0; q < KW / 4; q++) {
      const uint4 v = *(const uint4 *)(cur_s + y * CUR_P + 4 * q);
      cw[4 * q] = v.x;
      cw[4 * q + 1] = v.y;
      cw[4 * q + 2] = v.z;
      cw[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int a = 0; a < A; a++) {
      const uint32_t *rr = ref_s + (y + dy0 + a) * pitch + w0;
      uint32_t rw[RK + 3];
      if ((w0 & 3) == 0) {
#pragma unroll
        for (int q = 0; q < (RK + 3) / 4; q++) {
          const uint4 v = *(const uint4 *)(rr + 4 * q);
          rw[4 * q] = v.x;
          rw[4 * q + 1] = v.y;
          rw[4 * q + 2] = v.z;
          rw[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < RK; q++) rw[q] = rr[q];
      }
      // rw[j] becomes the reference word at byte 4 j + s of the item.
#pragma unroll
      for (int j = 0; j < RK - 1; j++)
        rw[j] = __funnelshift_r(rw[j], rw[j + 1], sh);
      // k outer: the 9 sums of a step are independent.
#pragma unroll
      for (int k = 0; k < KW; k++)
#pragma unroll
        for (int t = 0; t < T; t++)
          acc[a][t] = sad4(cw[k], RAGGED ? rw[t + k] & msk[k] : rw[t + k],
                           acc[a][t]);
    }
  }
}

// A window's pixels in the tile: rows [y0, y0 + h), columns [x0, x0 + w).
struct Span {
  int y0, h, x0, w;
};

__device__ inline Span window(int win, int nh, int vh, int vw, int oy,
                              int ox) {
  int y0, y1, x0, x1;
  window_span(win / nh, oy, vh, &y0, &y1);
  window_span(win % nh, ox, vw, &x0, &x1);
  return {y0, y1 - y0, x0, x1 - x0};
}

__global__ void __launch_bounds__(THREADS, 1) sad_fields_kernel(
    const uint8_t *__restrict__ cur, const uint8_t *__restrict__ ref,
    int32_t *__restrict__ out, int vh, int vw, int r, int nv, int nh,
    int oy, int ox) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int pitch = ref_pitch(r);
  const int rw = vw + 2 * r;  // the reference window's row length
  const int d = 2 * r + 1, noff = d * d, nwin = nv * nh;
  const size_t plane = (size_t)nwin;
  const bool rows16 = (uintptr_t)cur % 16 == 0 && vw % 16 == 0 &&
                      (uintptr_t)ref % 16 == 0 && rw % 16 == 0;
  // Stage window `win` into buffer `b`; true if it came by cp.async.
  auto stage_win = [&](int win, int b, bool async) {
    const Span sp = window(win, nh, vh, vw, oy, ox);
    if (sp.h <= 0 || sp.w <= 0) return;
    uint32_t *cur_s = smem + b * (smem_bytes(r) / 4);
    stage(cur + (size_t)sp.y0 * vw + sp.x0, vw, sp.h, sp.w, cur_s,
          ref + (size_t)sp.y0 * rw + sp.x0, rw, sp.h + 2 * r, sp.w + 2 * r,
          cur_s + WIN * CUR_P, pitch, async);
  };
  auto async_ok = [&](int win) {
    return rows16 && window(win, nh, vh, vw, oy, ox).x0 % 16 == 0;
  };
  // Persistent blocks: block b takes windows b, b + gridDim.x, ...; while
  // it computes one window, the next one's cp.async copies arrive in the
  // other buffer.
  if (blockIdx.x < nwin)
    stage_win(blockIdx.x, 0, async_ok(blockIdx.x));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = lane & 3, p = lane >> 2;
  const int groups = (d + A - 1) / A, items = groups * dx_chunks(r);
  int i = 0;
  for (int win = blockIdx.x; win < nwin; win += gridDim.x, i++) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this window staged; the other buffer free
    const int next = win + gridDim.x;
    const bool next_async = next < nwin && async_ok(next);
    if (next_async) stage_win(next, (i + 1) & 1, true);
    const Span sp = window(win, nh, vh, vw, oy, ox);
    const int h = sp.h, w = sp.w;
    if (h <= 0 || w <= 0) {
      for (int off = threadIdx.x; off < noff; off += THREADS)
        out[off * plane + win] = 0;
    } else {
      const uint32_t *cur_s = smem + (i & 1) * (smem_bytes(r) / 4);
      const uint32_t *ref_s = cur_s + WIN * CUR_P;
      for (int it = warp; it < items; it += WARPS) {
        const int g = it % groups, c = it / groups;
        const int dy0 = A * g, c0 = DXC * c;
        uint32_t acc[A][T];
#pragma unroll
        for (int a = 0; a < A; a++)
#pragma unroll
          for (int t = 0; t < T; t++) acc[a][t] = 0;
        // Block-uniform: a full window, one of 32 (the margins'), or a
        // ragged one, whose reference bytes past its width are masked.
        if (w == WIN)
          item_sums<false, 16>(cur_s, ref_s, pitch, h, w, dy0, c0, s, p,
                               acc);
        else if (w == WIN / 2)
          item_sums<false, 8>(cur_s, ref_s, pitch, h, w, dy0, c0, s, p,
                              acc);
        else if (w < WIN / 2)
          item_sums<true, 8>(cur_s, ref_s, pitch, h, w, dy0, c0, s, p, acc);
        else
          item_sums<true, 16>(cur_s, ref_s, pitch, h, w, dy0, c0, s, p,
                              acc);
        // The 8 row parts' sums, lanes s, s + 4, ..., s + 28.
#pragma unroll
        for (int a = 0; a < A; a++)
#pragma unroll
          for (int t = 0; t < T; t++)
#pragma unroll
            for (int o = 4; o < 32; o <<= 1)
              acc[a][t] += __shfl_xor_sync(0xffffffffu, acc[a][t], o);
        if (p == 0) {
#pragma unroll
          for (int a = 0; a < A; a++)
#pragma unroll
            for (int t = 0; t < T; t++) {
              const int dy = dy0 + a, dx = c0 + s + 4 * t;
              if (dy < d && dx < d)
                out[(size_t)(dy * d + dx) * plane + win] =
                    (int32_t)acc[a][t];
            }
        }
      }
    }
    // A next window whose rows are not all on 16 bytes is staged through
    // registers now, into the buffer that no thread reads this round.
    if (next < nwin && !next_async) stage_win(next, (i + 1) & 1, false);
  }
}

}  // namespace

// cur: (vh, vw) uint8, the tile's visible current pixels; ref: (vh + 2r,
// vw + 2r) uint8, the reference from (-r, -r) of the tile; out: (noff, nv,
// nh) int32, noff = (2r + 1)^2.  The tile's cells sit at (oy, ox) of the
// vertices' (8 nv, 8 nh) cell grid (0 <= oy, oy + ceil(vh / 8) <= 8 nv,
// likewise across).  0 <= r <= 64.
extern "C" int sad_fields(const void *cur, const void *ref, void *out,
                          int vh, int vw, int r, int nv, int nh, int oy,
                          int ox, void *stream) {
  if (vh <= 0 || vw <= 0 || r < 0 || r > 64 || nv <= 0 || nh <= 0 ||
      oy < 0 || ox < 0 || oy + (vh + 7) / 8 > 8 * nv ||
      ox + (vw + 7) / 8 > 8 * nh)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // Two stage buffers: 32,224 bytes at r = 16, 90,976 at r = 64 (past
  // the 48 KB a launch may take without opting in).
  const int bytes = 2 * smem_bytes(r);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(sad_fields_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = nv * nh < sms ? nv * nh : sms;  // one an SM
  sad_fields_kernel<<<blocks, THREADS, bytes, (cudaStream_t)stream>>>(
      (const uint8_t *)cur, (const uint8_t *)ref, (int32_t *)out, vh, vw, r,
      nv, nh, oy, ox);
  return (int)cudaGetLastError();
}
