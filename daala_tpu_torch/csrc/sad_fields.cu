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
// fields written.  One __vsadu4 takes the absolute differences of 4
// byte pairs and their sum.
//
// Design: a block per vertex window.  It copies the window's current
// pixels (at most 64 x 64) and the reference pixels under every offset
// ((64 + 2r)^2) into shared memory as bytes, once.  Each thread then
// takes offsets (tid, tid + blockDim, ...) and, for each, walks the
// window's rows in 4-byte words: the current word, the reference word at
// the offset (a funnel shift of two aligned words), and one __vsadu4.
// Neither the per-offset planes nor the cell sums ever reach HBM: each
// offset's window sum is written once.
//
// Windows: vertex (vi, vj) covers cells [8 vi - oy, 8 vi + 8 - oy) of the
// tile's cell grid, clipped to its ch = ceil(vh / 8) cells (and likewise
// across), which is the plain version's cell grid placed at (oy, ox) of
// the zero (8 nv, 8 nh) grid.  Its pixels are those cells' pixels within
// the visible (vh, vw): the plain version's mask of a partial edge cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WIN = 64;     // a vertex window's pixels a side
constexpr int CUR_W = 16;   // words a row of the current window

__host__ __device__ inline int ref_pitch(int r) {  // words a reference row
  return (WIN + 2 * r + 3) / 4 + 1;
}

__host__ __device__ inline int smem_bytes(int r) {
  return 4 * (WIN * CUR_W + (WIN + 2 * r) * ref_pitch(r));
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

__global__ void __launch_bounds__(THREADS) sad_fields_kernel(
    const uint8_t *__restrict__ cur, const uint8_t *__restrict__ ref,
    int32_t *__restrict__ out, int vh, int vw, int r, int nv, int nh,
    int oy, int ox) {
  extern __shared__ uint32_t smem[];
  uint32_t *cur_s = smem;                 // WIN rows x CUR_W words
  uint32_t *ref_s = smem + WIN * CUR_W;   // (WIN + 2r) rows x pitch words
  const int vi = blockIdx.y, vj = blockIdx.x;
  const int pitch = ref_pitch(r);
  const int rw = vw + 2 * r;  // the reference window's row length
  int y0, y1, x0, x1;
  window_span(vi, oy, vh, &y0, &y1);
  window_span(vj, ox, vw, &x0, &x1);
  const int h = y1 - y0, w = x1 - x0;
  const int d = 2 * r + 1, noff = d * d;
  const size_t plane = (size_t)nv * nh, at = (size_t)vi * nh + vj;
  if (h <= 0 || w <= 0) {
    for (int off = threadIdx.x; off < noff; off += THREADS)
      out[off * plane + at] = 0;
    return;
  }
  // Zeros first: the bytes past the window's width in its last word.
  const int words = WIN * CUR_W + (WIN + 2 * r) * pitch;
  for (int k = threadIdx.x; k < words; k += THREADS) smem[k] = 0;
  __syncthreads();
  uint8_t *cb = (uint8_t *)cur_s, *rb = (uint8_t *)ref_s;
  for (int k = threadIdx.x; k < h * w; k += THREADS) {
    const int y = k / w, x = k - y * w;
    cb[y * 4 * CUR_W + x] = cur[(size_t)(y0 + y) * vw + x0 + x];
  }
  const int rh = h + 2 * r, rww = w + 2 * r;
  for (int k = threadIdx.x; k < rh * rww; k += THREADS) {
    const int y = k / rww, x = k - y * rww;
    rb[y * 4 * pitch + x] = ref[(size_t)(y0 + y) * rw + x0 + x];
  }
  __syncthreads();
  // The window's full words, then its last word with the reference bytes
  // past the width masked (the current bytes there are zero).
  const int nw = (w + 3) / 4;
  const uint32_t last = (w & 3) ? (1u << (8 * (w & 3))) - 1 : 0xffffffffu;
  for (int off = threadIdx.x; off < noff; off += THREADS) {
    const int dy = off / d, dx = off - dy * d;
    const int q = dx >> 2, sh = 8 * (dx & 3);
    uint32_t acc = 0;
    for (int y = 0; y < h; y++) {
      const uint32_t *rr = ref_s + (y + dy) * pitch + q;
      const uint32_t *cr = cur_s + y * CUR_W;
      uint32_t lo = rr[0];
      for (int k = 0; k < nw - 1; k++) {
        const uint32_t hi = rr[k + 1];
        acc += __vsadu4(cr[k], __funnelshift_r(lo, hi, sh));
        lo = hi;
      }
      const uint32_t rv = __funnelshift_r(lo, rr[nw], sh) & last;
      acc += __vsadu4(cr[nw - 1], rv);
    }
    out[off * plane + at] = (int32_t)acc;
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
  // At most 41,728 bytes (r = 64): under the 48 KB a launch may take
  // without opting in.
  sad_fields_kernel<<<dim3(nh, nv), THREADS, smem_bytes(r),
                      (cudaStream_t)stream>>>(
      (const uint8_t *)cur, (const uint8_t *)ref, (int32_t *)out, vh, vw, r,
      nv, nh, oy, ox);
  return (int)cudaGetLastError();
}
