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
// What bounds it on the card: integer operations.  A leaf of n x n
// pixels reads 4 windows of (n+5)^2 samples (about 9 MB of plane bytes
// for the leaves tiling a 1080p plane, mostly from L2) and needs about
// 55 int32-lane instructions per pixel at n = 64 (6 taps over (n+5)/n
// horizontal samples, 4 to a dp4a, and 6 vertical taps, 2 to a dp2a,
// for each of 4 corners, then the blend): at 132 SMs x 64 lanes x
// 1.98 GHz about 7 us per 1080p plane, against 2.5 us of bytes
// (chip_smoke.py obmc_work and bound count it for each call).
//
// The design, and the fault of the first version that each part
// answers:
//
// 1. Compile-time sizes.  The body is a template on the leaf size and
//    the sample type; every per-thread array has its exact size and
//    every loop over rows unrolls with constant offsets.  The host
//    dispatches over the 25 (log_x, log_y) pairs x 2 sample types of
//    obmc_blend and the 4 sizes of obmc_leaf_cells, nothing else.
//    __launch_bounds__ holds a thread to the registers that let the
//    blocks shared memory allows stay resident: 64 for 4 blocks of 256.
// 2. Loads overlap compute.  A block walks leaf groups (`lpb` leaves)
//    with a stride of the grid, which holds as many blocks as fit on
//    the SMs.  All 4 corner windows of a group are copied at once, in
//    the planes' own type, with cp.async of 16, 8 or 4 bytes (the
//    window row widened to aligned copies: the planes' rows are 16-byte
//    aligned, which the wrapper checks) into one of two stages of
//    shared memory; the next group's copies are in flight while the
//    current group computes.  One barrier per group.  Where leaves
//    share a warp, the copies' addresses come from a small table of
//    each window's offset and copy count, written one group ahead:
//    18-30% faster at n = 8 and 16; at n = 64 the table cost registers
//    (spills) and time, so there each copy reads the leaf arguments.
// 3. No H buffer.  A thread owns one column and a strip of `rows`
//    (16, or ny when smaller) output rows of a leaf.  It computes the
//    horizontal pass for its rows + 5 window rows in registers and feeds
//    each new value into the vertical taps of the rows that need it, so
//    there is no buffer and no barrier between the passes; the price is
//    (rows + 5) / rows horizontal samples per pixel (21/16 at n >= 16,
//    13/8 at n = 8, 9/4 at n = 4, as a whole-leaf buffer would need).
//    At 8 bits a horizontal sample is 3 shared loads of 32-bit words,
//    2 byte permutes and 2 dp4a (uint8 x int8 dot products of 4), and
//    consecutive samples are packed in pairs of int16 (which is the
//    reference's int16 wrap) for 3 dp2a (int16 x int8 dot products of
//    2) per vertical output; the taps are int8, with phase 0's 128
//    stored as -128 and the sum negated.  At 12 bits a horizontal
//    sample is 6 uint16 loads and 6 multiply-adds, a vertical output 6
//    multiply-adds.
// 4. Several leaves per block at small sizes: `lpb` = 256 / threads per
//    leaf (fewer where shared memory would keep fewer than 4 blocks on
//    an SM); a ragged last group skips its missing leaves.  The blend
//    weights of the 16 setups sit in a shared table where it costs no
//    occupancy, else each thread evaluates its corner's.
// 5. Cells without atomics.  A thread sums its column's |pred - cur| in
//    registers per cell row; __shfl_xor_sync adds the 8 lanes of a
//    cell, and one lane stores it.
//
// The blend: the 4 corner weights of every pixel sum to 2 << (log_x +
// log_y) for every (oc, s), so p0 << (lb2 + 1) + sum_k (p_k - p0) w_k
// equals sum_k p_k w_k exactly (int32, no overflow: |w| <= 8192, p <=
// 4095), which needs no per-pixel p0.
//
// Per-leaf arguments, (L, 16) int32 (ops/cuda/obmc_kernels.py leaf_args):
// [0:4] source slots, [4:8] window rows sy, [8:12] window columns sx,
// [12] oc * 4 + s, [13] py, [14] px (the leaf's position in the plane),
// [15] subpel phases, 6 bits per corner k at bit 6k: mvx & 7, then
// mvy & 7.  The host checks that every window lies inside its plane;
// nothing here clamps.  Launch plans: csrc/obmc_plan.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "obmc_plan.cuh"

namespace {

// 6-tap windowed-sinc subpel filters, Q7 (daala_tpu_torch/codec/mc.py
// SUBPEL_FILTER_SET; reference src/mc.c:66-79).
__device__ const int32_t kSubpel[8][6] = {
    {0, 0, 128, 0, 0, 0},     {1, -9, 122, 18, -5, 1},
    {3, -15, 112, 37, -11, 2}, {3, -18, 97, 58, -15, 3},
    {4, -20, 80, 80, -20, 4},  {3, -15, 58, 97, -18, 3},
    {2, -11, 37, 112, -15, 3}, {1, -5, 18, 122, -9, 1}};

// c + the sum over 4 bytes of a (unsigned) times b (signed).
__device__ __forceinline__ int32_t dp4a_us(uint32_t a, uint32_t b,
                                           int32_t c) {
  int32_t d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// c + the two int16 halves of a times bytes 0-1 (lo) or 2-3 (hi) of b,
// all signed.
__device__ __forceinline__ int32_t dp2a_lo(uint32_t a, uint32_t b,
                                           int32_t c) {
  int32_t d;
  asm("dp2a.lo.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ int32_t dp2a_hi(uint32_t a, uint32_t b,
                                           int32_t c) {
  int32_t d;
  asm("dp2a.hi.s32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void *src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The copy parameters of leaf group g into prm (lpb x 4 corners): the
// byte offset in the planes of each window's first aligned copy, and the
// number of copies of each of its rows (0 for leaves past the end).
// The planes hold fewer than 2^32 bytes (the wrapper checks).
template <typename T, int LX, int LY>
__device__ __forceinline__ void params(int hp, int wp,
                                       const int32_t *__restrict__ scal,
                                       int nleaves, int g, uint2 *prm) {
  constexpr ObmcPlan P = obmc_plan(LX, LY, sizeof(T));
  constexpr int NX = 1 << LX, S = sizeof(T);
  const uint32_t pitch = (uint32_t)wp * S;
  for (int i = threadIdx.x; i < P.lpb * 4; i += P.threads) {
    const int leaf = g * P.lpb + (i >> 2), k = i & 3;
    uint2 v = {0, 0};
    if (leaf < nleaves) {
      const int32_t *sc = scal + (size_t)leaf * 16;
      const uint32_t sxb = __ldg(sc + 8 + k) * S;
      const uint32_t o = sxb & (P.copy - 1);
      v.x = (__ldg(sc + k) * (uint32_t)hp + __ldg(sc + 4 + k)) * pitch +
            (sxb - o);
      v.y = (o + (NX + 5) * S + P.copy - 1) / P.copy;
    }
    prm[i] = v;
  }
}

// Copy the 4 corner windows of leaf group g into the stage at shared
// address `stage`: each window row as the aligned copies that cover it,
// neighbouring threads on neighbouring copies of a row (a thread that
// took whole rows instead was 5-15% slower).  With a parameter table
// (prm, the plan's `params`), each copy reads its window's offset and
// copy count there; without, from the leaf arguments.
template <typename T, int LX, int LY>
__device__ __forceinline__ void copy_group(const T *__restrict__ planes,
                                           int hp, int wp,
                                           const int32_t *__restrict__ scal,
                                           int nleaves, int g,
                                           const uint2 *prm, uint32_t stage) {
  constexpr ObmcPlan P = obmc_plan(LX, LY, sizeof(T));
  constexpr int NX = 1 << LX, NY = 1 << LY, S = sizeof(T);
  constexpr int CW = P.copy / 4;  // words per copy
  constexpr int PER_ROW = P.row_words / CW;
  constexpr int PER_WIN = (NY + 5) * PER_ROW;
  const size_t pitch = (size_t)wp * S;
  for (int e = threadIdx.x; e < P.lpb * 4 * PER_WIN; e += P.threads) {
    const int w = e / PER_WIN;  // leaf * 4 + corner
    const int rem = e - w * PER_WIN;
    const int row = rem / PER_ROW, cp = rem - row * PER_ROW;
    const char *src;
    if constexpr (P.params) {
      const uint2 v = prm[w];
      if (cp >= (int)v.y) continue;
      src = (const char *)planes + v.x + row * pitch;
    } else {
      const int leaf = g * P.lpb + (w >> 2), k = w & 3;
      if (leaf >= nleaves) break;
      const int32_t *sc = scal + (size_t)leaf * 16;
      const int sxb = __ldg(sc + 8 + k) * S;
      const int o = sxb & (P.copy - 1);
      if (cp * P.copy >= o + (NX + 5) * S) continue;
      src = (const char *)planes + __ldg(sc + k) * pitch * hp +
            (size_t)(__ldg(sc + 4 + k) + row) * pitch + (sxb - o);
    }
    cp_async<P.copy>(stage + 4 * ((w >> 2) * P.leaf_words +
                                  ((w & 3) * (NY + 5) + row) * P.row_words +
                                  cp * CW),
                     src + cp * P.copy);
  }
}

// acc[j] = sum_k p_k(r0 + j, c) * w_k(r0 + j, c) + the blend's rounding,
// for the thread's column c and rows r0..r0+R-1 of the leaf whose
// windows start at `lw`.
template <typename T, int LX, int LY, int R>
__device__ __forceinline__ void predict(const uint32_t *lw,
                                        const int32_t *__restrict__ sc, int c,
                                        int r0, const int32_t (*taps)[6],
                                        const uint32_t (*taps8)[2],
                                        const int4 (*wtab)[4],
                                        int32_t (&acc)[R]) {
  constexpr ObmcPlan P = obmc_plan(LX, LY, sizeof(T));
  constexpr int RW = P.row_words, NY = 1 << LY;
  static_assert(R == P.rows, "rows per thread");
  constexpr int LB2P1 = LX + LY + 1;
  constexpr bool HI = sizeof(T) == 2;
#pragma unroll
  for (int j = 0; j < R; j++) acc[j] = 1 << (LB2P1 - 1);
  const int setup = __ldg(sc + 12);  // oc * 4 + s
  const int phases = __ldg(sc + 15);
#pragma unroll 1
  for (int k = 0; k < 4; k++) {
    int4 w;  // w0, wi, wj, wij
    if constexpr (P.wtab)
      w = wtab[setup][k];
    else
      obmc_weight(setup >> 2, setup & 3, k, LX, LY, w.x, w.y, w.z, w.w);
    const int wstep = w.z + c * w.w;           // weight step per row
    const int wrow = w.x + c * w.y + r0 * wstep;  // weight at row r0
    const int ph = phases >> (6 * k);
    const int fxp = ph & 7, fyp = (ph >> 3) & 7;
    const int o = (__ldg(sc + 8 + k) * (int)sizeof(T)) & (P.copy - 1);
    const uint32_t *win = lw + (k * (NY + 5) + r0) * RW;
    int32_t h[R + 5];
    if constexpr (!HI) {
      // Taps as int8, 4 to a word; phase 0's 128 is stored as -128 and
      // the sum negated (sgnx, sgny).
      const uint32_t xlo = taps8[fxp][0], xhi = taps8[fxp][1];
      const uint32_t ylo = taps8[fyp][0], yhi = taps8[fyp][1];
      const int sgnx = fxp ? 1 : -1, sgny = fyp ? 1 : -1;
      const int b = o + c;
      const uint32_t *rp = win + (b >> 2);
      const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(b & 3);
      // pair[r]: the horizontal outputs of rows r and r + 1 as two int16
      // halves.  Keeping the low 16 bits is the reference's int16 wrap of
      // the od_mc buffer (with 8-bit input the values lie in
      // -26584..26456, so no input shows it).
      uint32_t pair[R + 4];
#pragma unroll
      for (int rr = 0; rr < R + 5; rr++) {
        const uint32_t a0 = rp[rr * RW], a1 = rp[rr * RW + 1],
                       a2 = rp[rr * RW + 2];
        const int32_t v = dp4a_us(__byte_perm(a0, a1, sel), xlo,
                                  dp4a_us(__byte_perm(a1, a2, sel), xhi, 0));
        h[rr] = v * sgnx - (128 << 7);
        if (rr >= 1) pair[rr - 1] = __byte_perm(h[rr - 1], h[rr], 0x5410);
        if (rr >= 5) {
          const int j = rr - 5;
          const int32_t a = dp2a_lo(
              pair[j], ylo,
              dp2a_hi(pair[j + 2], ylo, dp2a_lo(pair[j + 4], yhi, 0)));
          const int32_t p =
              min(max((a * sgny + (1 << 13) + (128 << 14)) >> 14, 0), 255);
          acc[j] += p * (wrow + j * wstep);
        }
      }
    } else {
      int fx[6], fy[6];
#pragma unroll
      for (int m = 0; m < 6; m++) {
        fx[m] = taps[fxp][m];
        fy[m] = taps[fyp][m];
      }
      const uint16_t *rp = (const uint16_t *)win + (o >> 1) + c;
#pragma unroll
      for (int rr = 0; rr < R + 5; rr++) {
        int32_t v = 0;
#pragma unroll
        for (int m = 0; m < 6; m++) v += rp[rr * 2 * RW + m] * fx[m];
        h[rr] = v - (128 << 11);
        if (rr >= 5) {
          const int j = rr - 5;
          int32_t a = 0;
#pragma unroll
          for (int m = 0; m < 6; m++) a += h[j + m] * fy[m];
          const int32_t p =
              min(max(((a + (1 << 13)) >> 14) + (128 << 4), 0), 4095);
          acc[j] += p * (wrow + j * wstep);
        }
      }
    }
  }
}

// The body of both kernels: the ring over leaf groups, predict, then the
// blend's store (blocks) or the cell sums (cells, with cur).
template <typename T, int LX, int LY, bool CELLS>
__device__ __forceinline__ void obmc_body(
    const T *__restrict__ planes, int hp, int wp,
    const int32_t *__restrict__ scal, int nleaves,
    const uint8_t *__restrict__ cur, int vh, int vw, T *__restrict__ blocks,
    int32_t *__restrict__ cells) {
  constexpr ObmcPlan P = obmc_plan(LX, LY, sizeof(T));
  constexpr int NX = 1 << LX, NY = 1 << LY, R = P.rows;
  constexpr int LB2P1 = LX + LY + 1;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int32_t taps[8][6];
  __shared__ uint32_t taps8[8][2];
  // [oc * 4 + s][corner]: the blend weights, where the plan keeps them.
  __shared__ int4 wtab[P.wtab ? 16 : 1][4];
  const int tid = threadIdx.x;
  for (int i = tid; i < (P.wtab ? 64 : 0); i += P.threads) {
    int4 w;
    obmc_weight(i >> 4, (i >> 2) & 3, i & 3, LX, LY, w.x, w.y, w.z, w.w);
    wtab[i >> 2][i & 3] = w;
  }
  for (int i = tid; i < 48; i += P.threads)
    taps[i / 6][i % 6] = kSubpel[i / 6][i % 6];
  if (tid < 8) {
    uint32_t lo = 0, hi = 0;
    for (int m = 0; m < 4; m++)
      lo |= (uint32_t)(kSubpel[tid][m] & 255) << 8 * m;
    for (int m = 0; m < 2; m++)
      hi |= (uint32_t)(kSubpel[tid][4 + m] & 255) << 8 * m;
    taps8[tid][0] = lo;
    taps8[tid][1] = hi;
  }
  const int li = tid / P.tpl, tl = tid - li * P.tpl;
  const int strip = tl / NX, c = tl - strip * NX, r0 = strip * R;
  const int ngroups = (nleaves + P.lpb - 1) / P.lpb;
  const int grid = gridDim.x;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  // Group g's stage and parameter buffer are it & 1: the parameters of
  // group g + 2 * grid are written while group g computes, after every
  // thread has started group g's copies from that buffer.
  uint2 *const prm = (uint2 *)(smem + P.stage_bytes / 2);
  constexpr int PRM = P.lpb * 4;  // entries per parameter buffer
  int g = blockIdx.x;
  if (g >= ngroups) return;
  if constexpr (P.params) {
    params<T, LX, LY>(hp, wp, scal, nleaves, g, prm);
    __syncthreads();
  }
  copy_group<T, LX, LY>(planes, hp, wp, scal, nleaves, g, prm, sbase);
  cp_async_commit();
  if (P.params && g + grid < ngroups)
    params<T, LX, LY>(hp, wp, scal, nleaves, g + grid, prm + PRM);
  for (int it = 0; g < ngroups; g += grid, it++) {
    const int st = it & 1;
    cp_async_wait_all();
    // The group's windows (and at first the taps) are visible to all,
    // the next group's parameters too, and every thread is done with
    // the other stage and with this stage's parameters.
    __syncthreads();
    if (g + grid < ngroups)
      copy_group<T, LX, LY>(planes, hp, wp, scal, nleaves, g + grid,
                       prm + (st ^ 1) * PRM,
                       sbase + (st ^ 1) * P.stage_bytes);
    cp_async_commit();
    if (P.params && g + 2 * grid < ngroups)
      params<T, LX, LY>(hp, wp, scal, nleaves, g + 2 * grid,
                        prm + st * PRM);
    const int leaf = g * P.lpb + li;
    const bool valid = leaf < nleaves;
    const int32_t *sc = scal + (size_t)(valid ? leaf : 0) * 16;
    int32_t acc[R];
    const uint32_t *lw = smem + st * (P.stage_bytes / 4) + li * P.leaf_words;
    predict<T, LX, LY, R>(lw, sc, c, r0, taps, taps8, wtab, acc);
    if constexpr (CELLS) {
      constexpr int NC = NX >> 3;
      const int py = __ldg(sc + 13), px = __ldg(sc + 14);
      const bool col_vis = valid && c < vw - px;
      int32_t cs[R / 8];
#pragma unroll
      for (int i = 0; i < R / 8; i++) cs[i] = 0;
#pragma unroll
      for (int j = 0; j < R; j++) {
        if (col_vis && r0 + j < vh - py) {
          // The stored 8-bit prediction, as _leaf_cells_xla reads it.
          const int d = (int)(uint8_t)(acc[j] >> LB2P1) -
                        cur[(size_t)(py + r0 + j) * vw + px + c];
          cs[j >> 3] += d < 0 ? -d : d;
        }
      }
#pragma unroll
      for (int i = 0; i < R / 8; i++) {
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], off);
        if (valid && (c & 7) == 0)
          cells[(size_t)leaf * NC * NC + ((r0 >> 3) + i) * NC + (c >> 3)] =
              cs[i];
      }
    } else if (valid) {
      T *dst = blocks + (size_t)leaf * NX * NY + r0 * NX + c;
#pragma unroll
      for (int j = 0; j < R; j++) dst[j * NX] = (T)(acc[j] >> LB2P1);
    }
  }
}

// The block size and register cap of one instantiation (its plan's).
template <typename T, int LX, int LY>
struct Bounds {
  static constexpr int threads = obmc_plan(LX, LY, sizeof(T)).threads;
  static constexpr int min_blocks = obmc_plan(LX, LY, sizeof(T)).min_blocks;
};

template <typename T, int LX, int LY>
__global__ void __launch_bounds__(Bounds<T, LX, LY>::threads,
                                  Bounds<T, LX, LY>::min_blocks)
    obmc_blend_kernel(const T *__restrict__ planes, int hp, int wp,
                      const int32_t *__restrict__ scal, int nleaves,
                      T *__restrict__ out) {
  obmc_body<T, LX, LY, false>(planes, hp, wp, scal, nleaves, nullptr, 0, 0,
                              out, nullptr);
}

// cur: the visible current luma, (vh, vw) uint8.  Pixels at or past the
// visible edge count 0.
template <int LN>
__global__ void __launch_bounds__(Bounds<uint8_t, LN, LN>::threads,
                                  Bounds<uint8_t, LN, LN>::min_blocks)
    obmc_leaf_cells_kernel(const uint8_t *__restrict__ planes, int hp,
                           int wp, const uint8_t *__restrict__ cur, int vh,
                           int vw, const int32_t *__restrict__ scal,
                           int nleaves, int32_t *__restrict__ out) {
  obmc_body<uint8_t, LN, LN, true>(planes, hp, wp, scal, nleaves, cur, vh,
                                   vw, nullptr, out);
}

struct Args {
  const void *planes;
  int hp, wp;
  const void *cur;
  int vh, vw;
  const int32_t *scal;
  int nleaves;
  void *out;
  cudaStream_t stream;
};

// Sets the kernel's shared-memory limit and reads how many of its blocks
// fit on an SM (first use only; 0 on success, else the CUDA error).
template <typename K>
int prepare(K kernel, const ObmcPlan &p, int &per_sm, int &sms) {
  if (sms) return 0;
  int dev = 0, n = 0, blocks = 0;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, p.threads, p.smem_bytes);
  if (err) return err;
  per_sm = blocks > 0 ? blocks : 1;
  sms = n;
  return 0;
}

// One instantiation: its plan, and its kernel set up on first use.  The
// grid holds as many blocks as fit on the card's SMs at once, or one
// per leaf group when there are fewer groups.
template <typename T, int LX, int LY, bool CELLS>
struct Inst {
  static constexpr ObmcPlan P = obmc_plan(LX, LY, sizeof(T));
  static int per_sm, sms;

  static int setup() {
    if constexpr (CELLS)
      return prepare(obmc_leaf_cells_kernel<LX>, P, per_sm, sms);
    else
      return prepare(obmc_blend_kernel<T, LX, LY>, P, per_sm, sms);
  }

  static int launch(const Args &a) {
    if (const int err = setup()) return err;
    const int groups = (a.nleaves + P.lpb - 1) / P.lpb;
    const int grid = groups < per_sm * sms ? groups : per_sm * sms;
    if constexpr (CELLS)
      obmc_leaf_cells_kernel<LX><<<grid, P.threads, P.smem_bytes, a.stream>>>(
          (const uint8_t *)a.planes, a.hp, a.wp, (const uint8_t *)a.cur,
          a.vh, a.vw, a.scal, a.nleaves, (int32_t *)a.out);
    else
      obmc_blend_kernel<T, LX, LY>
          <<<grid, P.threads, P.smem_bytes, a.stream>>>(
              (const T *)a.planes, a.hp, a.wp, a.scal, a.nleaves,
              (T *)a.out);
    return (int)cudaGetLastError();
  }

  // out[0..5]: threads per block, leaves per block, copy bytes, dynamic
  // shared bytes, blocks per SM, rows per thread.
  static int info(int *out) {
    if (const int err = setup()) return err;
    const int v[6] = {P.threads, P.lpb, P.copy, P.smem_bytes, per_sm,
                      P.rows};
    for (int i = 0; i < 6; i++) out[i] = v[i];
    return 0;
  }
};
template <typename T, int LX, int LY, bool CELLS>
int Inst<T, LX, LY, CELLS>::per_sm = 0;
template <typename T, int LX, int LY, bool CELLS>
int Inst<T, LX, LY, CELLS>::sms = 0;

struct Entry {
  int (*launch)(const Args &);
  int (*info)(int *);
};
#define OBMC_INST(T, LX, LY, C) \
  Entry { Inst<T, LX, LY, C>::launch, Inst<T, LX, LY, C>::info }
#define OBMC_ROW(T, LX)                                                  \
  {                                                                      \
    OBMC_INST(T, LX, 2, false), OBMC_INST(T, LX, 3, false),              \
        OBMC_INST(T, LX, 4, false), OBMC_INST(T, LX, 5, false),          \
        OBMC_INST(T, LX, 6, false)                                       \
  }
// The instantiations the entry points accept, and no other.
const Entry kBlend[2][5][5] = {
    {OBMC_ROW(uint8_t, 2), OBMC_ROW(uint8_t, 3), OBMC_ROW(uint8_t, 4),
     OBMC_ROW(uint8_t, 5), OBMC_ROW(uint8_t, 6)},
    {OBMC_ROW(uint16_t, 2), OBMC_ROW(uint16_t, 3), OBMC_ROW(uint16_t, 4),
     OBMC_ROW(uint16_t, 5), OBMC_ROW(uint16_t, 6)}};
const Entry kCells[4] = {
    OBMC_INST(uint8_t, 3, 3, true), OBMC_INST(uint8_t, 4, 4, true),
    OBMC_INST(uint8_t, 5, 5, true), OBMC_INST(uint8_t, 6, 6, true)};
#undef OBMC_ROW
#undef OBMC_INST

}  // namespace

// planes: (4, hp, wp) uint8 (hi = 0) or uint16 (hi = 1), base and rows
// 16-byte aligned; scal: (L, 16) int32; out: (L, 1 << log_y, 1 << log_x)
// of the planes' type.  All contiguous on the device.  log_x, log_y in
// 2..6.  Returns the launch's CUDA error (0 when it was queued).
extern "C" int obmc_blend(const void *planes, int hi, int hp, int wp,
                          const void *scal, int nleaves, int log_x,
                          int log_y, void *out, void *stream) {
  if (nleaves <= 0 || log_x < 2 || log_x > 6 || log_y < 2 || log_y > 6)
    return (int)cudaErrorInvalidValue;
  const Args a{planes, hp,   wp, nullptr, 0, 0, (const int32_t *)scal,
               nleaves, out, (cudaStream_t)stream};
  return kBlend[hi ? 1 : 0][log_x - 2][log_y - 2].launch(a);
}

// planes: (4, hp, wp) uint8, aligned as above; cur: (vh, vw) uint8;
// scal: (L, 16) int32; out: (L, n/8, n/8) int32 with n = 1 << log_n,
// log_n in 3..6.
extern "C" int obmc_leaf_cells(const void *planes, int hp, int wp,
                               const void *cur, int vh, int vw,
                               const void *scal, int nleaves, int log_n,
                               void *out, void *stream) {
  if (nleaves <= 0 || log_n < 3 || log_n > 6)
    return (int)cudaErrorInvalidValue;
  const Args a{planes, hp,   wp, cur, vh, vw, (const int32_t *)scal,
               nleaves, out, (cudaStream_t)stream};
  return kCells[log_n - 3].launch(a);
}

// The plan of one instantiation, for reports: out[0..5] = threads per
// block, leaves per block, copy bytes, dynamic shared bytes, blocks per
// SM (the occupancy calculator's), rows per thread.
extern "C" int obmc_plan_info(int log_x, int log_y, int hi, int cells,
                              int *out) {
  if (log_x < 2 || log_x > 6 || log_y < 2 || log_y > 6)
    return (int)cudaErrorInvalidValue;
  if (!cells) return kBlend[hi ? 1 : 0][log_x - 2][log_y - 2].info(out);
  if (hi || log_x != log_y || log_x < 3) return (int)cudaErrorInvalidValue;
  return kCells[log_x - 3].info(out);
}
