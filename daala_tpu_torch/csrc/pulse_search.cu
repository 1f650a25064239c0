// The greedy loop of the PVQ pulse search (models/pvqsearch.py
// _pulse_search): for each row, min(iters, ceil(kf - i)) steps that each
// add one pulse at the lane of the highest score (the first one on a
// tie), with the row's sums xy, yy and i updated as it goes.
//
// Replaces the loop of _pulse_search (daala_tpu/models/pvqsearch.py:318),
// which JAX runs as an XLA while_loop, not a Pallas kernel.  In the port's
// plain version (ops/cuda/pulse_kernels.py pulse_loop_plain) every step is
// about 60 small launches over the whole batch, and the trip count costs
// one host sync a call.
//
// What bounds it: bytes, at the codec's band lengths (n = 8, 15, 32, 128):
// each row's lanes are read once and its pulses written once, and a row
// takes a few steps of a dozen float operations a lane.  In practice the
// latency of the steps, each a warp-wide argmax, is what it waits on.
//
// Design: one warp a row, lanes strided over n (lane l holds elements
// l, l + 32, ...: PER of them in registers, n <= 32 PER), so a step is the
// lanes' scores (csrc/pulse_step.cuh, the plain version's arithmetic
// operation by operation), a butterfly argmax over the warp's shuffles
// that breaks ties by the lowest index, and the chosen lane's owner
// broadcasting its x and pulse count to the warp for the row's update.
// Each row runs its own trip count, so no row waits for the batch's
// largest, and nothing is read back to the host.
//
// Bit for bit with the plain loop on the same inputs: the loop holds no
// reduction across lanes in float (the sums before it stay in torch), the
// argmax is exact, and the step's float operations are the plain ones in
// the plain order with no contraction (pulse_step.cuh).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "pulse_step.cuh"

namespace {

constexpr int WARPS = 4;  // rows a block
constexpr unsigned FULL = 0xffffffffu;

template <int PER>
__global__ void __launch_bounds__(WARPS * 32) pulse_search_kernel(
    const float *__restrict__ x, const float *__restrict__ yp_in,
    const float *__restrict__ rate_pen, const uint8_t *__restrict__ ok,
    const float *__restrict__ xy_in, const float *__restrict__ yy_in,
    const float *__restrict__ i_in, const float *__restrict__ kf_in,
    const float *__restrict__ rdo_in, const float *__restrict__ norm_in,
    const float *__restrict__ rsq16, const int32_t *__restrict__ seed,
    float *__restrict__ yp_out, float *__restrict__ xy_out,
    float *__restrict__ yy_out, float *__restrict__ i_out, int m, int n,
    int iters) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= m) return;  // the whole warp: a warp is one row
  const size_t base = (size_t)row * n;
  float xr[PER], yr[PER], pr[PER];
  bool okr[PER];
#pragma unroll
  for (int q = 0; q < PER; q++) {
    const int j = lane + 32 * q;
    const bool in = j < n;
    xr[q] = in ? x[base + j] : 0.0f;
    yr[q] = in ? yp_in[base + j] : 0.0f;
    pr[q] = in ? rate_pen[base + j] : 0.0f;
    okr[q] = in && ok[base + j];
  }
  float xy = xy_in[row], yy = yy_in[row], i = i_in[row];
  const float kf = kf_in[row], rdo = rdo_in[row], norm_1 = norm_in[row];
  const int trips = ps_trips(kf, i, iters);
  for (int t = 0; t < trips; t++) {
    const bool phase2 = i >= ps_add(kf, -rdo);
    // This lane's first maximum (pos INT_MAX: the lane holds no element).
    float best = -INFINITY;
    int pos = INT_MAX;
#pragma unroll
    for (int q = 0; q < PER; q++) {
      const int j = lane + 32 * q;
      if (j < n) {
        const float s = okr[q] ? ps_score(xr[q], yr[q], pr[q], xy, yy,
                                          norm_1, phase2, rsq16, seed)
                               : -INFINITY;
        if (pos == INT_MAX || s > best) {
          best = s;
          pos = j;
        }
      }
    }
    // The warp's first maximum: the higher score, on a tie the lower
    // index.  A total order, so every lane ends with the same (best, pos).
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, d);
      const int op = __shfl_xor_sync(FULL, pos, d);
      if (ob > best || (ob == best && op < pos)) {
        best = ob;
        pos = op;
      }
    }
    const int owner = pos & 31, qo = pos >> 5;
    float xa = 0.0f, yo = 0.0f;
#pragma unroll
    for (int q = 0; q < PER; q++)
      if (q == qo) {
        xa = xr[q];
        yo = yr[q];
      }
    xa = __shfl_sync(FULL, xa, owner);
    yo = __shfl_sync(FULL, yo, owner);
    float ynew;
    ps_update(xa, yo, kf, &ynew, &xy, &yy, &i);
#pragma unroll
    for (int q = 0; q < PER; q++)
      if (lane == owner && q == qo) yr[q] = ynew;
  }
#pragma unroll
  for (int q = 0; q < PER; q++) {
    const int j = lane + 32 * q;
    if (j < n) yp_out[base + j] = yr[q];
  }
  if (lane == 0) {
    xy_out[row] = xy;
    yy_out[row] = yy;
    i_out[row] = i;
  }
}

template <int PER>
cudaError_t launch(const float *x, const float *yp, const float *rate_pen,
                   const uint8_t *ok, const float *xy, const float *yy,
                   const float *i, const float *kf, const float *rdo,
                   const float *norm_1, const float *rsq16,
                   const int32_t *seed, float *yp_out, float *xy_out,
                   float *yy_out, float *i_out, int m, int n, int iters,
                   cudaStream_t s) {
  const int blocks = (m + WARPS - 1) / WARPS;
  pulse_search_kernel<PER><<<blocks, WARPS * 32, 0, s>>>(
      x, yp, rate_pen, ok, xy, yy, i, kf, rdo, norm_1, rsq16, seed, yp_out,
      xy_out, yy_out, i_out, m, n, iters);
  return cudaGetLastError();
}

}  // namespace

// x, yp, rate_pen: (m, n) float32; ok: (m, n) bytes (bool); xy, yy, i,
// kf, rdo, norm_1: (m,) float32; rsq16: 16 float32; seed: 2048 int32.
// Writes yp_out (m, n) and xy_out, yy_out, i_out (m,).  n <= 512, m >= 1.
extern "C" int pulse_search(const void *x, const void *yp,
                            const void *rate_pen, const void *ok,
                            const void *xy, const void *yy, const void *i,
                            const void *kf, const void *rdo,
                            const void *norm_1, const void *rsq16,
                            const void *seed, void *yp_out, void *xy_out,
                            void *yy_out, void *i_out, int m, int n,
                            int iters, void *stream) {
  if (m <= 0 || n <= 0 || n > 512 || iters < 0)
    return (int)cudaErrorInvalidValue;
  const int per = (n + 31) / 32;
#define PS_ARGS                                                          \
  (const float *)x, (const float *)yp, (const float *)rate_pen,          \
      (const uint8_t *)ok, (const float *)xy, (const float *)yy,         \
      (const float *)i, (const float *)kf, (const float *)rdo,           \
      (const float *)norm_1, (const float *)rsq16, (const int32_t *)seed, \
      (float *)yp_out, (float *)xy_out, (float *)yy_out, (float *)i_out,  \
      m, n, iters, (cudaStream_t)stream
  cudaError_t err;
  if (per <= 1)
    err = launch<1>(PS_ARGS);
  else if (per <= 2)
    err = launch<2>(PS_ARGS);
  else if (per <= 4)
    err = launch<4>(PS_ARGS);
  else if (per <= 8)
    err = launch<8>(PS_ARGS);
  else
    err = launch<16>(PS_ARGS);
#undef PS_ARGS
  return (int)err;
}
