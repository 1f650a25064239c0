// Blockwise n x n reversible integer lifting DCT of an (H, W) int32 frame,
// forward or inverse, n in {4, 8, 16, 32, 64}.
//
// Replaces dct_frame_pallas (daala_tpu/ops/pallas/dct_kernels.py:83).  The
// Pallas kernel runs a column pass per stripe and leaves the per-tile
// transposes between passes to XLA, so the frame crosses device memory four
// times.  Here one block does the whole 2-D transform of its tiles in
// shared memory, so the frame is read once and written once, with the
// reference composition (daala_tpu/ops/dct.py):
//   forward  cols_T(cols_T(x)):  thread i lifts column i, writes row i;
//   inverse  rows_T(rows_T(y)):  thread i lifts row i, writes column i;
// twice.  The lifting rounds, so this order is normative.
//
// What bounds it: bytes at n <= 16 (a 1080p luma plane moves 16.6 MB, 5 us
// at 3.35 TB/s), int32 operations at n = 64 (idct64 is about 1,640 per
// column; chip_smoke.py lifting_ops counts them).  With a cold L2 the first
// design (dct_tile_kernel below: two shared buffers per tile, one 4-byte
// load per thread and row with 4 in flight) reached 43-71% of that bound
// on luma and 18-40% on chroma, least at n = 32 and 64.  The strip design
// (dct_frame_kernel), one block per unit of work (csrc/frame_plan.cuh):
//
// 1. A strip of n rows by wb columns: wb / n tiles side by side, one
//    thread per column.  wb is the widest of 128, 64 and 32 that divides
//    the plane's width (64 at n = 64), so no block hangs half idle over
//    the 960-wide chroma plane.
// 2. The first pass straight from the frame: thread t loads its column
//    (forward: 4-byte loads, neighbouring threads on neighbouring words,
//    all n in flight) or its tile row (inverse, n <= 16: 16-byte loads)
//    into registers, lifts, and writes the result transposed into shared
//    memory.  The inverse at n = 32 and 64 copies the strip in by 16-byte
//    loads first (its rows read straight were slower).
// 3. One shared buffer, lifted in place: a pass reads its vectors into
//    registers, waits at a barrier, lifts, and writes them back
//    transposed.  At n = 64 a block of 64 threads takes 17 KB, so the
//    registers (149-164 a thread, no spills) and not shared memory set
//    how many blocks an SM holds.
// 4. The strip leaves by 16-byte stores, neighbouring threads on
//    neighbouring chunks; rows are 16-byte aligned because w % n == 0 and
//    the wrapper checks the base.
// 5. Bank conflicts: a shared row is wb + 4 words, so the column walk and
//    the 16-byte row accesses (8 threads on 8 distinct bank groups, n >= 8)
//    are both free of them.
// 6. A plan per shape: at n = 4, and at n = 8 on planes whose width is a
//    multiple of 128, the first design was as fast or faster (both run at
//    about the speed of a copy of the plane), so those shapes keep it.
//
// A ring of two stages with a persistent grid (the next strip's cp.async
// in flight while one lifts) was tried and dropped: at the 1080p shapes
// every block of n >= 16 is resident at once, so it never overlapped
// anything, and at n = 4 and 8 it was slower than one strip per block.
//
// Integer wraparound goes through od_add / od_sub / ... of lifting_gen.cuh
// (nvcc has no -fwrapv).

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_plan.cuh"
#include "lifting_gen.cuh"

namespace {

template <int N, bool FWD>
__device__ __forceinline__ void lift(int32_t *v) {
  if constexpr (FWD) {
    if constexpr (N == 4) fdct4(v);
    if constexpr (N == 8) fdct8(v);
    if constexpr (N == 16) fdct16(v);
    if constexpr (N == 32) fdct32(v);
    if constexpr (N == 64) fdct64(v);
  } else {
    if constexpr (N == 4) idct4(v);
    if constexpr (N == 8) idct8(v);
    if constexpr (N == 16) idct16(v);
    if constexpr (N == 32) idct32(v);
    if constexpr (N == 64) idct64(v);
  }
}

// Copy the strip (n rows from y0, wb columns from x0) into shared memory
// and back: 16-byte copies, neighbouring threads on neighbouring chunks,
// all of a thread's n / 4 copies in flight; chunks past the right edge
// are skipped (their tiles are dead: w % n == 0).
template <int N, int WB>
__device__ __forceinline__ void load_unit(const int32_t *__restrict__ in,
                                          int w, int y0, int x0,
                                          int32_t *s) {
  constexpr int P = WB + 4, CPR = WB / 4;
#pragma unroll
  for (int j = 0; j < N / 4; j++) {  // N * CPR chunks over WB threads
    const int e = threadIdx.x + j * WB, r = e / CPR, c = e % CPR;
    if (x0 + 4 * c < w)
      *(int4 *)(s + r * P + 4 * c) =
          __ldg((const int4 *)(in + (size_t)(y0 + r) * w + x0 + 4 * c));
  }
}

template <int N, int WB>
__device__ __forceinline__ void store_unit(int32_t *__restrict__ out, int w,
                                           int y0, int x0,
                                           const int32_t *s) {
  constexpr int P = WB + 4, CPR = WB / 4;
#pragma unroll
  for (int j = 0; j < N / 4; j++) {
    const int e = threadIdx.x + j * WB, r = e / CPR, c = e % CPR;
    if (x0 + 4 * c < w)
      *(int4 *)(out + (size_t)(y0 + r) * w + x0 + 4 * c) =
          *(const int4 *)(s + r * P + 4 * c);
  }
}

// One lifting pass over the strip in shared memory, in place.  Thread t
// is lane i = t % n of tile t / n.  Forward: it lifts column t of the
// strip (tile column i) and writes tile row i; inverse: it lifts tile
// row i and writes column t.
template <int N, int WB, bool FWD>
__device__ __forceinline__ void pass(int32_t *s) {
  constexpr int P = WB + 4;
  const int t = threadIdx.x, i = t % N;
  int32_t *row = s + i * P + (t - i);  // tile row i
  int32_t v[N];
  if constexpr (FWD) {
#pragma unroll
    for (int k = 0; k < N; k++) v[k] = s[k * P + t];
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const int4 q = *(const int4 *)(row + k);
      v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
    }
  }
  __syncthreads();  // every thread holds its vector: the strip is free
  lift<N, FWD>(v);
  if constexpr (FWD) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *(int4 *)(row + k) = make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; k++) s[k * P + t] = v[k];
  }
  __syncthreads();
}

// The first pass straight from the frame (direct plans): thread t loads
// its column (forward; 4-byte loads, neighbouring threads on neighbouring
// words, all N in flight) or its tile row (inverse; 16-byte loads), lifts
// it and writes it transposed into the strip `s`.  Dead tiles (past the
// right edge) lift zeros and are never stored.
template <int N, int WB, bool FWD>
__device__ __forceinline__ void pass_from(const int32_t *__restrict__ in,
                                          int w, int y0, int x0,
                                          int32_t *s) {
  constexpr int P = WB + 4;
  const int t = threadIdx.x, i = t % N;
  int32_t *row = s + i * P + (t - i);
  int32_t v[N];
  if (x0 + t < w) {
    if constexpr (FWD) {
#pragma unroll
      for (int k = 0; k < N; k++)
        v[k] = __ldg(in + (size_t)(y0 + k) * w + x0 + t);
    } else {
      const int32_t *rp = in + (size_t)(y0 + i) * w + x0 + (t - i);
#pragma unroll
      for (int k = 0; k < N; k += 4) {
        const int4 q = __ldg((const int4 *)(rp + k));
        v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; k++) v[k] = 0;
  }
  lift<N, FWD>(v);
  if constexpr (FWD) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *(int4 *)(row + k) = make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; k++) s[k * P + t] = v[k];
  }
  __syncthreads();
}

// The first design, kept for the plans that take it (dct_tile): 128 / n
// tiles side by side in a block of 128 threads, each tile in two shared
// buffers of n rows of n + 1 words; 4-byte loads and stores, neighbouring
// threads on neighbouring columns.
template <int N, bool FWD>
__device__ __forceinline__ void tile_pass(const int32_t *src, int32_t *dst,
                                          int i) {
  constexpr int P = N + 1;
  int32_t v[N];
#pragma unroll
  for (int k = 0; k < N; k++) v[k] = FWD ? src[k * P + i] : src[i * P + k];
  lift<N, FWD>(v);
#pragma unroll
  for (int k = 0; k < N; k++) {
    if constexpr (FWD) {
      dst[i * P + k] = v[k];
    } else {
      dst[k * P + i] = v[k];
    }
  }
}

template <int N, bool FWD>
__global__ void __launch_bounds__(kDctTileThreads)
    dct_tile_kernel(const int32_t *__restrict__ in,
                    int32_t *__restrict__ out, int h, int w) {
  constexpr int P = N + 1, TILE_WORDS = N * P;
  __shared__ int32_t a[kDctTileThreads / N * TILE_WORDS];
  __shared__ int32_t b[kDctTileThreads / N * TILE_WORDS];
  const int t = threadIdx.x, tile = t / N, lane = t % N;
  const int y0 = blockIdx.y * N;
  const int x = blockIdx.x * kDctTileThreads + t;
  const bool live = x < w;  // the last block may hang over the right edge
  int32_t *ta = a + tile * TILE_WORDS;
  int32_t *tb = b + tile * TILE_WORDS;
  if (live) {
#pragma unroll 4
    for (int r = 0; r < N; r++) ta[r * P + lane] = in[(size_t)(y0 + r) * w + x];
  }
  __syncthreads();
  if (live) tile_pass<N, FWD>(ta, tb, lane);
  __syncthreads();
  if (live) tile_pass<N, FWD>(tb, ta, lane);
  __syncthreads();
  if (live) {
#pragma unroll 4
    for (int r = 0; r < N; r++)
      out[(size_t)(y0 + r) * w + x] = ta[r * P + lane];
  }
}

template <int N, int WB>
struct Bounds {
  static constexpr DctPlan P = dct_plan_for(N, WB);
};

template <int N, int WB, bool FWD>
__global__ void __launch_bounds__(WB, Bounds<N, WB>::P.blocks_per_sm)
    dct_frame_kernel(const int32_t *__restrict__ in,
                     int32_t *__restrict__ out, int h, int w) {
  extern __shared__ __align__(16) int32_t s[];
  const int units_x = (w + WB - 1) / WB;
  const int u = blockIdx.x;
  const int y0 = u / units_x * N, x0 = u % units_x * WB;
  if constexpr (dct_direct(N, FWD)) {
    pass_from<N, WB, FWD>(in, w, y0, x0, s);
  } else {
    load_unit<N, WB>(in, w, y0, x0, s);
    __syncthreads();
    pass<N, WB, FWD>(s);
  }
  pass<N, WB, FWD>(s);
  store_unit<N, WB>(out, w, y0, x0, s);
}

// Shared memory stays under the 48 KB a launch may take without an
// attribute (17 KB at most: n = 64, wb = 64).
template <int N, int WB, bool FWD>
int launch(const int32_t *in, int32_t *out, int h, int w,
           cudaStream_t stream) {
  constexpr DctPlan P = dct_plan_for(N, WB);
  static_assert(P.smem_bytes <= 48 * 1024, "dynamic shared memory");
  dct_frame_kernel<N, WB, FWD>
      <<<dct_units(N, h, w), WB, P.smem_bytes, stream>>>(in, out, h, w);
  return (int)cudaGetLastError();
}

template <int N, bool FWD>
int launch_wb(const int32_t *in, int32_t *out, int h, int w,
              cudaStream_t s) {
  if constexpr (N <= 8) {
    if (dct_tile(N, w)) {
      const dim3 grid((w + kDctTileThreads - 1) / kDctTileThreads, h / N);
      dct_tile_kernel<N, FWD><<<grid, kDctTileThreads, 0, s>>>(in, out, h,
                                                               w);
      return (int)cudaGetLastError();
    }
  }
  // The strip plans (n = 4 has none: it always takes the first design).
  if constexpr (N >= 64) {
    return launch<N, 64, FWD>(in, out, h, w, s);
  } else if constexpr (N > 4) {
    switch (dct_wb(N, w)) {
      case 128: return launch<N, 128, FWD>(in, out, h, w, s);
      case 64: return launch<N, 64, FWD>(in, out, h, w, s);
      default: return launch<N, 32, FWD>(in, out, h, w, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <int N>
int launch_dir(const int32_t *in, int32_t *out, int h, int w, int forward,
               cudaStream_t s) {
  return forward ? launch_wb<N, true>(in, out, h, w, s)
                 : launch_wb<N, false>(in, out, h, w, s);
}

}  // namespace

// in, out: (h, w) int32, contiguous, distinct, 16-byte aligned; h and w
// multiples of n.  Returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported n or an empty plane).
extern "C" int dct_frame(const void *in, void *out, int h, int w, int n,
                         int forward, void *stream) {
  const int32_t *src = (const int32_t *)in;
  int32_t *dst = (int32_t *)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 4: return launch_dir<4>(src, dst, h, w, forward, s);
    case 8: return launch_dir<8>(src, dst, h, w, forward, s);
    case 16: return launch_dir<16>(src, dst, h, w, forward, s);
    case 32: return launch_dir<32>(src, dst, h, w, forward, s);
    case 64: return launch_dir<64>(src, dst, h, w, forward, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
