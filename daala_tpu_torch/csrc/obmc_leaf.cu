// Per-leaf OBMC prediction (od_state_pred_block_from_setup, reference
// src/state.c:628-672; od_mc_predict1fmv8, src/mc.c:92-206; the merged
// blend od_mc_blend_full_split, src/mc.c:1700-1750) with two epilogues:
//
//   obmc_blend       the blended (ny, nx) prediction of every leaf, in the
//                    planes' type (uint8, or uint16 for 12-bit references),
//                    stored modulo 2^8 or 2^16 as daala_tpu's astype does:
//                    the (oc, s) weights of non-square leaves (mc.py
//                    _setup_s_split) can take the blend out of range.
//                    Replaces obmc_blend_pallas
//                    (daala_tpu/ops/pallas/obmc_kernels.py:191).
//   obmc_leaf_cells  the 8-bit prediction's |pred - cur| over the visible
//                    area, summed per 8x8 cell: (L, n/8, n/8) int32.
//                    Replaces obmc_leaf_cells_pallas (same file, :208).
//
// One block per leaf.  For each of the leaf's 4 corners, one after the
// other: the (ny+5) x (nx+5) window at (sy, sx) of its source plane goes
// into shared memory, then the 6-tap horizontal subpel filter into a
// shared (ny+5) x nx buffer, then the 6-tap vertical filter, clip and
// blend into per-thread registers (at most 16 pixels a thread).  Shared
// memory at n = 64: 19,044 + 17,664 bytes, under the 48 KB a block gets
// without cudaFuncSetAttribute.  The blend weights are evaluated from the
// 16 coefficients of od_mc_setup_s_split (s0 + i dsdi + j dsdj + i j dd,
// i the column, j the row; daala_tpu/codec/mc.py _setup_s_split), not
// read from a (64, n, n) table: the table would cost 48 KB of reads per
// n = 64 leaf, more than its 4 windows.
//
// Per-leaf arguments, (L, 16) int32 (ops/cuda/obmc_kernels.py leaf_args):
// [0:4] source slots, [4:8] window rows sy, [8:12] window columns sx,
// [12] oc * 4 + s, [13] py, [14] px (the leaf's position in the plane),
// [15] subpel phases, 6 bits per corner k at bit 6k: mvx & 7, then
// mvy & 7.  The taps come from the 8-phase table below, so a leaf uploads
// 64 bytes.  The host checks that every window lies inside its plane;
// nothing here clamps.
//
// What bounds it on the card: the gather of 4 windows per leaf (about
// 19 KB of bytes at n = 64, from L2 when neighbours share rows) and, for
// the sweep, the host cost of hundreds of small calls per frame; the two
// filters are 12 multiply-adds per pixel and corner.  The Pallas kernel's
// (8, 128)-aligned DMAs, pltpu.roll realignment, int32 staging of the
// planes and SMEM chunking at 1024 leaves are TPU artefacts: here every
// block computes its own offsets and one launch covers all L leaves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 6-tap windowed-sinc subpel filters, Q7 (daala_tpu/codec/mc.py
// SUBPEL_FILTER_SET; reference src/mc.c:66-79).
__constant__ int32_t kSubpel[8][6] = {
    {0, 0, 128, 0, 0, 0},     {1, -9, 122, 18, -5, 1},
    {3, -15, 112, 37, -11, 2}, {3, -18, 97, 58, -15, 3},
    {4, -20, 80, 80, -20, 4},  {3, -15, 58, 97, -18, 3},
    {2, -11, 37, 112, -15, 3}, {1, -5, 18, 122, -9, 1}};

constexpr int MAX_THREADS = 256;
constexpr int MAX_PER_THREAD = 64 * 64 / MAX_THREADS;

// The reference's od_mc buffer is int16: the 8-bit horizontal pass wraps
// there.  Written as mask and sign extension, not as a narrowing cast.
// With 8-bit input the value lies in -26584..26456 (the negative taps of a
// phase sum to -40 at most, the positive ones to 168, times 255, less
// 128 << 7), so no input can show a wrong wrap; it is kept because it is
// the normative width.
__device__ __forceinline__ int32_t wrap16(int32_t v) {
  return ((v & 0xFFFF) ^ 0x8000) - 0x8000;
}

// od_mc_setup_s_split: coefficient `k` of the merged blend weight
// s0 + i * dsdi + j * dsdj + i * j * dd for setup (oc, s).  Every value
// halved is even, so the shifts are exact.
__device__ __forceinline__ void setup_s_split(int oc, int s, int log_x,
                                              int log_y, int k, int &w0,
                                              int &wi, int &wj, int &wij) {
  int s0[4] = {2 << (log_x + log_y), 0, 0, 0};
  int dsdi[4] = {-(2 << log_x), 2 << log_x, 0, 0};
  int dsdj[4] = {-(2 << log_y), 0, 0, 2 << log_y};
  int dd[4] = {2, -2, 2, -2};
#pragma unroll
  for (int side = 0; side < 2; side++) {
    if (s & (1 << side)) continue;
    const int m = (oc + (side ? 3 : 1)) & 3;
    s0[m] >>= 1;
    s0[oc] += s0[m];
    dsdi[m] >>= 1;
    dsdi[oc] += dsdi[m];
    dsdj[m] >>= 1;
    dsdj[oc] += dsdj[m];
    dd[m] >>= 1;
    dd[oc] += dd[m];
  }
  w0 = s0[k];
  wi = dsdi[k];
  wj = dsdj[k];
  wij = dd[k];
}

// The blended prediction of the block's leaf.  Thread t owns pixels
// e = t + q * blockDim.x (row e >> log_x, column e & (nx - 1)); out[q] is
// valid for e < nx * ny.  win: (ny+5) * (nx+5) ints, hbuf: (ny+5) * nx.
template <typename T, bool HI>
__device__ void predict_leaf(const T *__restrict__ planes, int hp, int wp,
                             const int32_t *__restrict__ sc, int log_x,
                             int log_y, int32_t *win, int32_t *hbuf,
                             int32_t (&out)[MAX_PER_THREAD]) {
  const int nx = 1 << log_x, ny = 1 << log_y;
  const int nwx = nx + 5, nwy = ny + 5;
  const int npix = nx * ny;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lb2p1 = log_x + log_y + 1;
  const int oc = sc[12] >> 2, s = sc[12] & 3;
  int32_t p0[MAX_PER_THREAD];
  for (int k = 0; k < 4; k++) {
    const T *plane = planes + (size_t)sc[k] * hp * wp;
    const int sy = sc[4 + k], sx = sc[8 + k];
    const int phase = sc[15] >> (6 * k);
    const int32_t *fx = kSubpel[phase & 7];
    const int32_t *fy = kSubpel[(phase >> 3) & 7];
    int w0, wi, wj, wij;
    setup_s_split(oc, s, log_x, log_y, k, w0, wi, wj, wij);
    __syncthreads();  // the previous corner is done with win and hbuf
    for (int e = tid; e < nwy * nwx; e += nt) {
      const int r = e / nwx, c = e - r * nwx;
      win[e] = plane[(size_t)(sy + r) * wp + sx + c];
    }
    __syncthreads();
    for (int e = tid; e < nwy * nx; e += nt) {
      const int32_t *w = win + (e >> log_x) * nwx + (e & (nx - 1));
      int32_t v = 0;
#pragma unroll
      for (int m = 0; m < 6; m++) v += w[m] * fx[m];
      hbuf[e] = HI ? v - (128 << 11) : wrap16(v - (128 << 7));
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < MAX_PER_THREAD; q++) {
      const int e = tid + q * nt;
      if (e >= npix) break;
      const int r = e >> log_x, c = e & (nx - 1);
      const int32_t *h = hbuf + e;
      int32_t a = 0;
#pragma unroll
      for (int m = 0; m < 6; m++) a += h[m * nx] * fy[m];
      const int32_t p =
          HI ? min(max(((a + (1 << 13)) >> 14) + (128 << 4), 0), 4095)
             : min(max((a + (1 << 13) + (128 << 14)) >> 14, 0), 255);
      if (k == 0) {
        p0[q] = p;
        out[q] = (p << lb2p1) + (1 << (lb2p1 - 1));
      } else {
        out[q] += (p - p0[q]) * (w0 + c * wi + r * wj + c * r * wij);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < MAX_PER_THREAD; q++) {
    if (tid + q * nt >= npix) break;
    out[q] >>= lb2p1;
  }
}

template <typename T, bool HI>
__global__ void obmc_blend_kernel(const T *__restrict__ planes, int hp,
                                  int wp, const int32_t *__restrict__ scal,
                                  int log_x, int log_y, T *__restrict__ out) {
  extern __shared__ int32_t smem[];
  const int nx = 1 << log_x, ny = 1 << log_y;
  int32_t *win = smem;
  int32_t *hbuf = win + (ny + 5) * (nx + 5);
  int32_t v[MAX_PER_THREAD];
  predict_leaf<T, HI>(planes, hp, wp, scal + (size_t)blockIdx.x * 16, log_x,
                      log_y, win, hbuf, v);
  const int npix = nx * ny;
  T *dst = out + (size_t)blockIdx.x * npix;
#pragma unroll
  for (int q = 0; q < MAX_PER_THREAD; q++) {
    const int e = threadIdx.x + q * blockDim.x;
    if (e >= npix) break;
    dst[e] = (T)v[q];
  }
}

// cur: the visible current luma, (vh, vw) uint8.  Pixels at or past the
// visible edge count 0.
__global__ void obmc_leaf_cells_kernel(const uint8_t *__restrict__ planes,
                                       int hp, int wp,
                                       const uint8_t *__restrict__ cur,
                                       int vh, int vw,
                                       const int32_t *__restrict__ scal,
                                       int log_n, int32_t *__restrict__ out) {
  extern __shared__ int32_t smem[];
  const int n = 1 << log_n, nc = n >> 3;
  int32_t *win = smem;
  int32_t *hbuf = win + (n + 5) * (n + 5);
  int32_t *cells = hbuf + (n + 5) * n;
  for (int e = threadIdx.x; e < nc * nc; e += blockDim.x) cells[e] = 0;
  const int32_t *sc = scal + (size_t)blockIdx.x * 16;
  int32_t v[MAX_PER_THREAD];
  // predict_leaf's first barrier orders the zeroing before the sums.
  predict_leaf<uint8_t, false>(planes, hp, wp, sc, log_n, log_n, win, hbuf,
                               v);
  const int py = sc[13], px = sc[14];
#pragma unroll
  for (int q = 0; q < MAX_PER_THREAD; q++) {
    const int e = threadIdx.x + q * blockDim.x;
    if (e >= n * n) break;
    const int r = e >> log_n, c = e & (n - 1);
    if (r < vh - py && c < vw - px) {
      // The stored 8-bit prediction, as _leaf_cells_xla reads it.
      const int d = (int)(uint8_t)v[q] - cur[(size_t)(py + r) * vw + px + c];
      atomicAdd(&cells[(r >> 3) * nc + (c >> 3)], d < 0 ? -d : d);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nc * nc; e += blockDim.x)
    out[(size_t)blockIdx.x * nc * nc + e] = cells[e];
}

// One thread per pixel up to MAX_THREADS, in whole warps.
int threads_for(int npix) {
  const int t = npix < MAX_THREADS ? npix : MAX_THREADS;
  return (t + 31) / 32 * 32;
}

}  // namespace

// planes: (4, hp, wp) uint8 (hi = 0) or uint16 (hi = 1); scal: (L, 16)
// int32; out: (L, 1 << log_y, 1 << log_x) of the planes' type.  All
// contiguous on the device.  log_x, log_y in 2..6.  Returns the launch's
// cudaGetLastError().
extern "C" int obmc_blend(const void *planes, int hi, int hp, int wp,
                          const void *scal, int nleaves, int log_x,
                          int log_y, void *out, void *stream) {
  if (nleaves <= 0 || log_x < 2 || log_x > 6 || log_y < 2 || log_y > 6)
    return (int)cudaErrorInvalidValue;
  const int nx = 1 << log_x, ny = 1 << log_y;
  const size_t smem = sizeof(int32_t) * ((ny + 5) * (nx + 5) + (ny + 5) * nx);
  const int threads = threads_for(nx * ny);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t *sc = (const int32_t *)scal;
  if (hi) {
    obmc_blend_kernel<uint16_t, true><<<nleaves, threads, smem, s>>>(
        (const uint16_t *)planes, hp, wp, sc, log_x, log_y,
        (uint16_t *)out);
  } else {
    obmc_blend_kernel<uint8_t, false><<<nleaves, threads, smem, s>>>(
        (const uint8_t *)planes, hp, wp, sc, log_x, log_y, (uint8_t *)out);
  }
  return (int)cudaGetLastError();
}

// planes: (4, hp, wp) uint8; cur: (vh, vw) uint8; scal: (L, 16) int32;
// out: (L, n/8, n/8) int32 with n = 1 << log_n, log_n in 3..6.
extern "C" int obmc_leaf_cells(const void *planes, int hp, int wp,
                               const void *cur, int vh, int vw,
                               const void *scal, int nleaves, int log_n,
                               void *out, void *stream) {
  if (nleaves <= 0 || log_n < 3 || log_n > 6)
    return (int)cudaErrorInvalidValue;
  const int n = 1 << log_n, nc = n >> 3;
  const size_t smem =
      sizeof(int32_t) * ((n + 5) * (n + 5) + (n + 5) * n + nc * nc);
  obmc_leaf_cells_kernel<<<nleaves, threads_for(n * n), smem,
                           (cudaStream_t)stream>>>(
      (const uint8_t *)planes, hp, wp, (const uint8_t *)cur, vh, vw,
      (const int32_t *)scal, log_n, (int32_t *)out);
  return (int)cudaGetLastError();
}
