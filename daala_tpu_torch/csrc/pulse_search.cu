// The PVQ pulse search (models/pvqsearch.py _pulse_search), whole, one
// launch a call: for each row, the masked magnitudes and their sums, the
// floor-projection init and the rate penalties, then min(iters, ceil(kf -
// i)) steps that each add one pulse at the lane of the highest score (the
// first one on a tie), then the signed pulses, ok and the cosine distance.
//
// Replaces _pulse_search (daala_tpu/models/pvqsearch.py:318), which JAX
// runs in XLA (a while_loop), not a Pallas kernel.  The port's plain
// version (ops/cuda/pulse_kernels.py pulse_search_plain) takes about 80
// launches around its loop and about 60 a step, and reads the trip count
// back to the host once a call.
//
// What bounds it: bytes, at the codec's band lengths (n = 8, 15, 32, 128):
// each row's lanes are read once and its pulses written once, and a row
// takes a few steps of a dozen float operations a lane.  In practice it
// waits on latency: a call takes as long as its longest row's chain of
// steps, each a score, an argmax across the row's lanes and an update.
//
// Design:
// - Rows of n <= 8 take 8 lanes and rows of n <= 16 take 16, so a warp
//   holds 4 or 2 rows; longer rows take a warp, lanes strided over n
//   (lane l holds elements l, l + 32, ...: PER of them in registers).
//   After the sums, every shuffle and warp reduction names the row's
//   lanes only, and each row runs its own trip count, so the rows of a
//   warp never wait for each other.
// - The row sums are chains in XLA:CPU's order: for n <= 32 one chain of
//   fused multiply-adds from element 0 up, for longer rows one chain for
//   each chunk of 32 lanes (XLA's reduce-window; register c of the 32
//   lanes is chunk c), then the chunk sums in order.  A chain is serial
//   and its float64 steps are costly, so each runs once, in one thread:
//   the block stages its rows in shared memory and thread r PER + c runs
//   the chains of row r's chunk c, reading a bank of its own.  (Run by
//   every lane of the row, on elements broadcast by shuffles, the chains
//   cost 30-60 times the instructions and made an inter call of 83,076
//   rows of 32 lanes take 208 us.)
// - A step's argmax is two warp reductions: the maximum of an int32 key
//   that orders the scores (ps_key), then the lowest element index among
//   the lanes at that key, which is torch's first maximum.  The chosen
//   lane's x and pulse count come from its owner in one shuffle each.
// - Every float operation is the plain version's, in its association,
//   through csrc/pulse_step.cuh, so the kernel equals the plain version
//   bit for bit; _rsqrt's zero-gives-inf is carried into cos_dist.
// - A row may search another row of xc and lane_ok (src): band_search's
//   14 candidates of a row search 2 distinct rows, which its prologue
//   writes once each.
// Nothing is read back to the host.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "pulse_step.cuh"

namespace {

constexpr int WARPS = 8;  // warps a block
constexpr int CH = 33;    // floats a staged chunk of 32 lanes (+1: banks)
constexpr unsigned FULL = 0xffffffffu;

// G lanes a row (8, 16 or 32), PER elements a lane (n <= G * PER; PER > 1
// only with G = 32).
template <int G, int PER>
__global__ void __launch_bounds__(WARPS * 32) pulse_search_kernel(
    const float *__restrict__ xc, const int32_t *__restrict__ kin,
    const float *__restrict__ g2in, const uint8_t *__restrict__ lane_ok,
    const int32_t *__restrict__ src, const float *__restrict__ rsq16, const int32_t *__restrict__ seed,
    int32_t *__restrict__ y_out, float *__restrict__ cos_out,
    uint8_t *__restrict__ ok_out, int m, int n, int iters, float lam,
    float d0, float a0, float d1, float a1) {
  static_assert(G == 8 || G == 16 || G == 32, "a row takes 8, 16 or 32 lanes");
  static_assert(PER == 1 || G == 32, "only a warp-wide row spans registers");
  constexpr int RPW = 32 / G;        // rows a warp
  constexpr int RB = WARPS * RPW;    // rows a block
  constexpr int RS = PER * CH;       // floats a staged row
  // The block's rows staged for the sums' chains: element 32 c + j of
  // row r at r RS + c CH + j, so that the chain of (row r, chunk c),
  // thread r PER + c, reads bank (thread + j) mod 32: no conflicts.
  __shared__ float xs[RB * RS], ys[RB * RS];
  __shared__ float part[RB * PER][3];  // a chain's sums
  const int lane = threadIdx.x & 31;
  const int gl = lane % G, sub = lane / G;
  const unsigned gmask =
      G == 32 ? FULL : ((FULL >> (32 - G)) << (sub * G));
  const int rb = (threadIdx.x >> 5) * RPW + sub;  // the row in the block
  const int row = blockIdx.x * RB + rb;
  const bool live = row < m;  // the rest only meet the block's barriers
  const size_t base = (size_t)row * n;
  // The row's lanes and lane flags: row src[row] of xc and lane_ok.
  const size_t xbase = src != nullptr && live ? (size_t)src[row] * n : base;
  const int32_t k = live ? kin[row] : 0;
  const float kf = (float)k;
  float xr[PER], yr[PER];
  bool neg[PER], okr[PER];
#pragma unroll
  for (int q = 0; q < PER; q++) {
    const int j = gl + G * q;
    okr[q] = live && j < n && lane_ok[xbase + j];
    const float v = okr[q] ? xc[xbase + j] : 0.0f;
    neg[q] = v < 0.0f;
    xr[q] = fabsf(v);
    xs[rb * RS + q * CH + gl] = xr[q];
  }
  __syncthreads();
  // The chains of the row sums, one thread each (a row's, or for rows
  // over 32 lanes a chunk's): x.x and |x|_1.  Lanes past n hold zeros,
  // and adding a zero to a sum of non-negative values leaves it as it is.
  const int ct = threadIdx.x;  // this thread's chain: (ct / PER, ct % PER)
  const int nj = PER == 1 ? n : 32;
  if (ct < RB * PER) {
    const float *v = xs + (ct / PER) * RS + (ct % PER) * CH;
    float a = 0.0f, b = 0.0f;
    for (int j = 0; j < nj; j++) {
      a = ps_dot_step(a, v[j], v[j], PER > 1);
      b = ps_add(b, v[j]);
    }
    part[ct][0] = a;
    part[ct][1] = b;
  }
  __syncthreads();
  // The chunk sums in order (a row of at most 32 lanes has one).
  float xx = 0.0f, l1 = 0.0f;
#pragma unroll
  for (int c = 0; c < PER; c++) {
    xx = ps_add(xx, part[rb * PER + c][0]);
    l1 = ps_add(l1, part[rb * PER + c][1]);
  }
#pragma unroll
  for (int q = 0; q < PER; q++) {
    yr[q] = ps_init_pulses(k, kf, xr[q], l1);
    ys[rb * RS + q * CH + gl] = yr[q];
  }
  __syncthreads();
  // The sums of the init's pulses: x.y, y.y and their count.
  if (ct < RB * PER) {
    const int at = (ct / PER) * RS + (ct % PER) * CH;
    const float *v = xs + at, *p = ys + at;
    float a = 0.0f, b = 0.0f, c = 0.0f;
    for (int j = 0; j < nj; j++) {
      a = ps_dot_step(a, v[j], p[j], PER > 1);
      b = ps_dot_step(b, p[j], p[j], PER > 1);
      c = ps_add(c, p[j]);
    }
    part[ct][0] = a;
    part[ct][1] = b;
    part[ct][2] = c;
  }
  __syncthreads();
  if (!live) return;  // the row's lanes, together: no barrier follows
  float xy = 0.0f, yy = 0.0f, i = 0.0f;
#pragma unroll
  for (int c = 0; c < PER; c++) {
    xy = ps_add(xy, part[rb * PER + c][0]);
    yy = ps_add(yy, part[rb * PER + c][1]);
    i = ps_add(i, part[rb * PER + c][2]);
  }
  const float norm_1 = ps_rsqrt(ps_add(1e-30f, xx), seed);
  const float lamr = ps_div(lam, ps_add(1e-30f, g2in[row]));
  const float rdo = (float)((k >> 2) + 1);
  float pen[PER];
#pragma unroll
  for (int q = 0; q < PER; q++)
    pen[q] = ps_rate_pen(lamr, gl + G * q, k == 1 ? d1 : d0,
                         k == 1 ? a1 : a0);
  const int trips = ps_trips(kf, i, iters);
  for (int t = 0; t < trips; t++) {
    const bool phase2 = i >= ps_add(kf, -rdo);
    // This lane's first maximum; a lane past n holds no element and keeps
    // INT_MIN, below every score's key (-inf's included).
    int32_t key = INT_MIN;
    int pos = INT_MAX;
#pragma unroll
    for (int q = 0; q < PER; q++) {
      const int j = gl + G * q;
      if (j < n) {
        const int32_t kq = ps_key(
            okr[q] ? ps_score(xr[q], yr[q], pen[q], xy, yy, norm_1, phase2,
                              rsq16, seed)
                   : -INFINITY);
        if (kq > key) {
          key = kq;
          pos = j;
        }
      }
    }
    const int32_t best = __reduce_max_sync(gmask, key);
    const int p = __reduce_min_sync(gmask, key == best ? pos : INT_MAX);
    const int owner = p % G, qo = p / G;
    float xa = 0.0f, yo = 0.0f;
#pragma unroll
    for (int q = 0; q < PER; q++)
      if (q == qo) {
        xa = xr[q];
        yo = yr[q];
      }
    xa = __shfl_sync(gmask, xa, owner, G);
    yo = __shfl_sync(gmask, yo, owner, G);
    float ynew;
    ps_update(xa, yo, kf, &ynew, &xy, &yy, &i);
#pragma unroll
    for (int q = 0; q < PER; q++)
      if (gl == owner && q == qo) yr[q] = ynew;
  }
#pragma unroll
  for (int q = 0; q < PER; q++) {
    const int j = gl + G * q;
    if (j < n)
      y_out[base + j] = k == 0 ? 0 : (int32_t)(neg[q] ? -yr[q] : yr[q]);
  }
  if (gl == 0) {
    ok_out[row] = i >= kf;
    cos_out[row] = ps_cos_dist(k, xy, xx, yy, seed);
  }
}

struct Args {
  const float *xc;
  const int32_t *k;
  const float *g2;
  const uint8_t *lane_ok;
  const int32_t *src;
  const float *rsq16;
  const int32_t *seed;
  int32_t *y;
  float *cos_dist;
  uint8_t *ok;
  int m, n, iters;
  float lam, d0, a0, d1, a1;
};

template <int G, int PER>
cudaError_t launch(const Args &a, cudaStream_t s) {
  const int rows = WARPS * (32 / G);  // rows a block
  pulse_search_kernel<G, PER><<<(a.m + rows - 1) / rows, WARPS * 32, 0, s>>>(
      a.xc, a.k, a.g2, a.lane_ok, a.src, a.rsq16, a.seed, a.y, a.cos_dist, a.ok,
      a.m, a.n, a.iters, a.lam, a.d0, a.a0, a.d1, a.a1);
  return cudaGetLastError();
}

}  // namespace

// xc: (m, n) float32; k: (m,) int32; g2: (m,) float32; lane_ok: (m, n)
// bytes (bool); src: null, or (m,) int32, and then row r searches row
// src[r] of xc and lane_ok, which may hold any number of rows; rsq16: 16
// float32; seed: 2048 int32.  Writes y (m, n)
// int32, cos_dist (m,) float32 and ok (m,) bytes (bool).  lam and the
// rate constants (d0, a0 for k != 1, d1, a1 for k = 1) are float32.
// 1 <= n <= 512, m >= 1.
extern "C" int pulse_search(const void *xc, const void *k, const void *g2,
                            const void *lane_ok, const void *src,
                            const void *rsq16,
                            const void *seed, void *y, void *cos_dist,
                            void *ok, int m, int n, int iters, float lam,
                            float d0, float a0, float d1, float a1,
                            void *stream) {
  if (m <= 0 || n <= 0 || n > 512 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{(const float *)xc,      (const int32_t *)k,
               (const float *)g2,      (const uint8_t *)lane_ok,
               (const int32_t *)src,   (const float *)rsq16,   (const int32_t *)seed,
               (int32_t *)y,           (float *)cos_dist,
               (uint8_t *)ok,          m,
               n,                      iters,
               lam,                    d0,
               a0,                     d1,
               a1};
  const cudaStream_t s = (cudaStream_t)stream;
  if (n <= 8) return (int)launch<8, 1>(a, s);
  if (n <= 16) return (int)launch<16, 1>(a, s);
  if (n <= 32) return (int)launch<32, 1>(a, s);
  if (n <= 64) return (int)launch<32, 2>(a, s);
  if (n <= 128) return (int)launch<32, 4>(a, s);
  if (n <= 256) return (int)launch<32, 8>(a, s);
  return (int)launch<32, 16>(a, s);
}
