// Frame lapped pre/post filter of an (H, W) int32 plane: the reversible
// 4-tap lifting (pre_filter4 / post_filter4) across the 4 rows or columns
// straddling every superblock edge (starts k * sb - 2, k = 1 .. H/sb - 1).
// Forward filters rows (horizontal edges) then columns; inverse filters
// columns then rows (reference: src/filter.c:1529-1610).
//
// Replaces lap_frame_pallas (daala_tpu/ops/pallas/lap_kernels.py:78).  The
// Pallas kernel holds a full-height column stripe in VMEM and leaves the
// transpose for the vertical edges to XLA.
//
// What bounds it: bytes.  Only a few percent of the pixels are lifted, so
// the kernel should run at the speed of one read and one write of the
// plane (16.6 MB at 1080p luma, 5 us at 3.35 TB/s).  The first design took
// two launches (a copy pass with a thread per pixel and two runtime
// divisions each, then a pass over the second axis's bands) and reached
// 17-38% of that bound with a cold L2.  This one is one launch:
//
// 1. Tiles with a halo.  A block owns an aligned tile (32 x 128 pixels on
//    wide planes, 32 x 64 otherwise; csrc/frame_plan.cuh lap_plan) and
//    copies it into shared memory with 2 rows above and below and 4
//    columns left and right.  Tile edges lie on multiples of 4 and band
//    starts on 2 modulo 4, so every band that touches the tile, and every
//    4 x 4 corner where a row band crosses a column band, lies in the
//    tile and its halo.  A band that crosses a tile edge is lifted by both
//    tiles; each stores its own pixels.
// 2. In shared memory: the first axis's bands, over the tile's columns
//    (forward) or rows (inverse) and the 2 of the halo on each side that
//    the corners need; a barrier; the second axis's bands over the
//    tile's own rows or columns; a barrier; the store of the tile.
// 3. Every load of the tile in flight at once: cp.async of 16 bytes where
//    the plane's base and rows are 16-byte aligned (the halo of 4 keeps
//    every copy aligned), of 4 bytes otherwise (w = 150, or a view with an
//    odd storage offset); 16-byte stores (4-byte ones) from shared memory.
// 4. Band positions come from two divisions per tile and axis
//    (lap_edges), none per pixel.
//
// One tile per block, every block resident at once at 1080p.  A ring
// over tiles (a persistent grid, the next tile's copies in flight while
// one is filtered and stored) was tried and was slower.
//
// A tile of a sharded plane (parallel/sharding.py): the tensor holds rows
// [oy, oy + h) and columns [ox, ox + w) of a (ph, pw) plane, its interior
// and a halo of 2 on each side that has a neighbour.  The kernel filters
// the plane's edges (k = 1 .. ph/sb - 1) whose whole band lies in the
// tensor (lap_edges_at), at their places in the tensor.  The origin is
// even, so a band start is even in the tensor and every band and corner
// that touches a block's tile still lies in the tile and its halo.  A
// halo of 2 rather than a whole superblock: 4 more columns a 960-wide
// tile, not 128.  With the origin 0 and the plane the tensor's own, this
// is the unsharded filter.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_plan.cuh"
#include "lifting_gen.cuh"

namespace {

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void *src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES));
}

template <bool FWD>
__device__ __forceinline__ void lift4(int32_t *v) {
  if constexpr (FWD) {
    pre_filter4(v);
  } else {
    post_filter4(v);
  }
}

// Lift the bands of edges k_lo..k_hi across `lanes` lanes [l0, l1) of the
// tile in shared memory.  ROWS: the bands are 4 rows (vertical lifting),
// the lanes columns; otherwise 4 columns, the lanes rows.
// r0, c0: the tensor's row and column at shared (0, 0); o: the plane
// position of the tensor's first row (ROWS) or column.
template <bool ROWS, bool FWD>
__device__ __forceinline__ void bands(int32_t *s, int pitch, int r0, int c0,
                                      int sb, int o, int k_lo, int k_hi,
                                      int l0, int l1) {
  const int nl = l1 - l0;
  const int items = (k_hi - k_lo + 1) * nl;
  for (int e = threadIdx.x; e < items; e += kLapThreads) {
    const int kb = e / nl, l = l0 + (e - kb * nl);
    const int start = (k_lo + kb) * sb - 2 - o;
    int32_t *p = ROWS ? s + (start - r0) * pitch + (l - c0)
                      : s + (l - r0) * pitch + (start - c0);
    const int step = ROWS ? pitch : 1;
    int32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; k++) v[k] = p[k * step];
    lift4<FWD>(v);
#pragma unroll
    for (int k = 0; k < 4; k++) p[k * step] = v[k];
  }
}

template <bool FWD>
__global__ void __launch_bounds__(kLapThreads)
    lap_frame_kernel(const int32_t *__restrict__ in,
                     int32_t *__restrict__ out, int h, int w, int sb_x,
                     int sb_y, int oy, int ox, int ph, int pw, int th,
                     int tw, int pitch, int vec) {
  extern __shared__ __align__(16) int32_t s[];
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const int y1 = min(y0 + th, h), x1 = min(x0 + tw, w);
  const int r0 = y0 - 2, c0 = x0 - 4;  // tensor position of s[0]
  // The loaded region: the tile, its halo, clipped to the plane.
  const int ly0 = max(y0 - 2, 0), ly1 = min(y1 + 2, h);
  const int lx0 = max(x0 - 4, 0), lx1 = min(x1 + 4, w);
  const int tid = threadIdx.x;
  // Every copy of the tile in flight at once (cp.async), then one wait.
  const uint32_t sb = (uint32_t)__cvta_generic_to_shared(s);
  if (vec) {
    const int cpr = (lx1 - lx0) >> 2;  // 16-byte chunks per row
    for (int e = tid; e < (ly1 - ly0) * cpr; e += kLapThreads) {
      const int r = ly0 + e / cpr, c = lx0 + 4 * (e % cpr);
      cp_async<16>(sb + 4 * ((r - r0) * pitch + (c - c0)),
                   in + (size_t)r * w + c);
    }
  } else {
    const int cols = lx1 - lx0;
    for (int e = tid; e < (ly1 - ly0) * cols; e += kLapThreads) {
      const int r = ly0 + e / cols, c = lx0 + e % cols;
      cp_async<4>(sb + 4 * ((r - r0) * pitch + (c - c0)),
                  in + (size_t)r * w + c);
    }
  }
  // Edges whose bands touch the tile, per axis: their divisions run
  // while the copies are in flight.
  int ky_lo, ky_hi, kx_lo, kx_hi;
  lap_edges_at(y0, y1, sb_y, ph / sb_y, oy, h, ky_lo, ky_hi);
  lap_edges_at(x0, x1, sb_x, pw / sb_x, ox, w, kx_lo, kx_hi);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (FWD) {
    // Row bands over the tile's columns and 2 of the halo each side.
    bands<true, FWD>(s, pitch, r0, c0, sb_y, oy, ky_lo, ky_hi,
                     max(x0 - 2, 0), min(x1 + 2, w));
    __syncthreads();
    bands<false, FWD>(s, pitch, r0, c0, sb_x, ox, kx_lo, kx_hi, y0, y1);
  } else {
    bands<false, FWD>(s, pitch, r0, c0, sb_x, ox, kx_lo, kx_hi,
                      max(y0 - 2, 0), min(y1 + 2, h));
    __syncthreads();
    bands<true, FWD>(s, pitch, r0, c0, sb_y, oy, ky_lo, ky_hi, x0, x1);
  }
  __syncthreads();
  if (vec) {
    const int cpr = (x1 - x0) >> 2;
    for (int e = tid; e < (y1 - y0) * cpr; e += kLapThreads) {
      const int r = y0 + e / cpr, c = x0 + 4 * (e % cpr);
      *(int4 *)(out + (size_t)r * w + c) =
          *(const int4 *)(s + (r - r0) * pitch + (c - c0));
    }
  } else {
    const int cols = x1 - x0;
    for (int e = tid; e < (y1 - y0) * cols; e += kLapThreads) {
      const int r = y0 + e / cols, c = x0 + e % cols;
      out[(size_t)r * w + c] = s[(r - r0) * pitch + (c - c0)];
    }
  }
}

template <bool FWD>
int launch(const int32_t *in, int32_t *out, int h, int w, int sb_x,
           int sb_y, int oy, int ox, int ph, int pw, cudaStream_t s) {
  const LapPlan p = lap_plan(h, w);
  const int vec = w % 4 == 0 && (uintptr_t)in % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  const dim3 grid(p.tiles_x, p.tiles_y);
  lap_frame_kernel<FWD><<<grid, kLapThreads, p.smem_bytes, s>>>(
      in, out, h, w, sb_x, sb_y, oy, ox, ph, pw, p.th, p.tw, p.pitch, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: (h, w) int32, contiguous, distinct, 4-byte aligned, holding
// rows [oy, oy + h) and columns [ox, ox + w) of a (ph, pw) plane (oy, ox
// even; 0, 0, h, w for a whole plane).  Returns the launch's
// cudaGetLastError().
extern "C" int lap_frame(const void *in, void *out, int h, int w, int sb_x,
                         int sb_y, int oy, int ox, int ph, int pw,
                         int forward, void *stream) {
  const int32_t *src = (const int32_t *)in;
  int32_t *dst = (int32_t *)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (h <= 0 || w <= 0 || sb_x < 4 || sb_y < 4 || (oy & 1) || (ox & 1) ||
      ph <= 0 || pw <= 0)
    return (int)cudaErrorInvalidValue;
  return forward ? launch<true>(src, dst, h, w, sb_x, sb_y, oy, ox, ph, pw, s)
                 : launch<false>(src, dst, h, w, sb_x, sb_y, oy, ox, ph, pw,
                                 s);
}
