// The PVQ pulse search's arithmetic for one row, shared by the CUDA kernel
// (csrc/pulse_search.cu) and a host build with g++
// (tests/test_torch_pulse_plan.py), so that the arithmetic the card runs
// is the arithmetic the CPU tests hold bit for bit against the plain
// version (ops/cuda/pulse_kernels.py pulse_search_plain): the prologue's
// init and rate penalties, a step of the row sums in XLA:CPU's order, a
// step of the greedy loop, and the epilogue.
//
// Every float operation is written out as one IEEE operation in the plain
// version's order and association: on the card through __fadd_rn,
// __fmul_rn, __fdiv_rn and __fmaf_rn, which nvcc never contracts into
// another fused multiply-add (the build's flags leave -fmad on); on the
// host as plain C++ operators and fmaf, compiled with -ffp-contract=off.
//
// Why no NaN can arise in the loop: tyy = (yy + 2 yp) + 1 >= 1, since yy
// and yp are sums of non-negative integers, so the division of score1 and
// the reciprocal square root of score2 (of max(tyy, 1)) are finite.  x (an
// int16 coefficient's magnitude) and norm_1 (a reciprocal square root of
// 1e-30 + xx) are finite, and so is rate_pen: band_search's distortion
// scales g2 are >= 0, so lam / (1e-30 + g2) is at most lam * 1e30.
// Masked lanes score -inf and never win against a finite score; a row
// whose lanes are all masked takes lane 0, as torch's argmax does.

#pragma once

#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define PS_HD __host__ __device__ __forceinline__
#else
#define PS_HD inline
#endif

PS_HD float ps_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

PS_HD float ps_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

PS_HD float ps_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// pulse_kernels.py _fma32: a * b + c rounded once to float, as XLA:CPU's
// contractions (hardware FMAs) round it.
PS_HD float ps_fma32(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}

PS_HD int32_t ps_bits(float v) {
#ifdef __CUDA_ARCH__
  return __float_as_int(v);
#else
  int32_t b;
  memcpy(&b, &v, 4);
  return b;
#endif
}

PS_HD float ps_float(int32_t b) {
#ifdef __CUDA_ARCH__
  return __int_as_float(b);
#else
  float v;
  memcpy(&v, &b, 4);
  return v;
#endif
}

// pvqsearch.py _rsqrt of v >= 1: the 12-bit seed from `seed` (the 2048
// int32 float bit patterns of _rsqrt_seed), scaled by the exponent, then
// two Newton steps u = fma(v y, y, -1), y = fma(-y / 2, u, y).
PS_HD float ps_rsqrt(float v, const int32_t *seed) {
  const int32_t b = ps_bits(v);
  const int32_t e = (b >> 23) - 127;
  const int32_t par = e & 1;
  const int32_t s = seed[(par << 10) | ((b >> 13) & 1023)];
  float y = ps_float(s - (((e - par) >> 1) << 23));
  for (int k = 0; k < 2; k++) {
    const float u = ps_fma32(ps_mul(v, y), y, -1.0f);
    y = ps_fma32(ps_mul(y, -0.5f), u, y);
  }
  return y;
}

// The score of adding a pulse at a lane holding x (|coefficient|) and yp
// (its pulses), for a row with xy, yy, norm_1; phase2: the RDO score with
// the lane's rate penalty rate_pen, else the plain correlation score.
// rsq16: the 16 float32 entries of _rsqrt16.
PS_HD float ps_score(float x, float yp, float rate_pen, float xy, float yy,
                     float norm_1, bool phase2, const float *rsq16,
                     const int32_t *seed) {
  const float txy = ps_add(xy, x);
  const float tyy = ps_add(ps_add(yy, ps_mul(2.0f, yp)), 1.0f);
  if (!phase2) return ps_div(ps_mul(txy, txy), tyy);
  const float c = tyy < 1.0f ? 1.0f : (tyy > 16.0f ? 16.0f : tyy);
  const float tyy_r = tyy <= 16.0f ? rsq16[(int)c - 1]
                                   : ps_rsqrt(tyy < 1.0f ? 1.0f : tyy, seed);
  return ps_fma32(ps_mul(ps_mul(2.0f, txy), norm_1), tyy_r, -rate_pen);
}

// The steps a row runs: the pulses it still needs, min(iters,
// ceil(kf - i)), and none when it needs none.  The batched loop runs the
// most any row needs, but a row that has its pulses is frozen there
// (every update adds 0), so each row's own count gives the same result.
PS_HD int ps_trips(float kf, float i, int iters) {
  const float d = ps_add(kf, -i);  // integers in float: exact
  if (!(d > 0.0f)) return 0;
  const int need = (int)d + ((float)(int)d < d ? 1 : 0);
  return need < iters ? need : iters;
}

// The row's update after the argmax chose a lane holding xadd and yold:
// the lane's pulse count (returned through *yp_new) and the row's sums.
PS_HD void ps_update(float xadd, float yold, float kf, float *yp_new,
                     float *xy, float *yy, float *i) {
  const bool active = *i < kf;
  const float one = active ? 1.0f : 0.0f;
  *yp_new = ps_add(yold, one);
  *xy = ps_add(*xy, active ? xadd : 0.0f);
  *yy = ps_add(*yy, active ? ps_add(ps_mul(2.0f, yold), 1.0f) : 0.0f);
  *i = ps_add(*i, one);
}

// A step of a row sum in XLA:CPU's order (pulse_kernels.py ordered_dot):
// rows of at most 32 lanes chain fused multiply-adds, longer rows add
// each product rounded to float32.
PS_HD float ps_dot_step(float acc, float a, float b, bool chunked) {
  return chunked ? ps_add(acc, ps_mul(a, b)) : ps_fma32(a, b, acc);
}

// The floor-projection init of a lane holding x, for a row with k target
// pulses (kf as float) and l1 = |x|_1: floor(kf x / max(l1, 1e-30)),
// at least 0, and no pulse at all for k <= 2.
PS_HD float ps_init_pulses(int32_t k, float kf, float x, float l1) {
  if (k <= 2) return 0.0f;
  const float l1c = l1 < 1e-30f ? 1e-30f : l1;
  const float v = floorf(ps_div(ps_mul(kf, x), l1c));
  return v < 0.0f ? 0.0f : v;
}

// The rate penalty of lane j: (lamr j) fma(j, accel, delta), the
// contraction XLA:CPU makes of delta + j accel.
PS_HD float ps_rate_pen(float lamr, int j, float delta, float accel) {
  const float fj = (float)j;
  return ps_mul(ps_mul(lamr, fj), ps_fma32(fj, accel, delta));
}

// An int32 key with the order of the scores (-0 taken as +0, which torch's
// argmax holds equal): the maximum key is the maximum score.
PS_HD int32_t ps_key(float score) {
  const int32_t b = ps_bits(ps_add(score, 0.0f));
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// pulse_kernels.py _rsqrt of v >= 0: zero gives inf.
PS_HD float ps_rsqrt0(float v, const int32_t *seed) {
  return v == 0.0f ? ps_float(0x7f800000) : ps_rsqrt(v, seed);
}

// The epilogue's cosine distance, xy / sqrt(xx yy) as XLA:CPU computes
// it (xy times the rsqrt of the product), 0 for k = 0.
PS_HD float ps_cos_dist(int32_t k, float xy, float xx, float yy,
                        const int32_t *seed) {
  return k == 0 ? 0.0f : ps_mul(xy, ps_rsqrt0(ps_mul(xx, yy), seed));
}

#ifndef __CUDACC__
// The whole search for one row on the host, in the plain version's order:
// the masked magnitudes, the sums (one chain, or 32-lane chunks for rows
// over 32), the init, the loop with the lanes one after another and the
// first maximum kept, then the epilogue.  xc: n floats; ok_lanes: n bytes
// (0: the lane is masked); d0, a0 / d1, a1: the rate constants for k != 1
// / k = 1.  Writes y (n), *cos_dist and *ok; returns the steps it ran.
inline int ps_search_row_host(int n, const float *xc, int32_t k, float g2,
                              float lam, const uint8_t *ok_lanes, int iters,
                              float d0, float a0, float d1, float a1,
                              const float *rsq16, const int32_t *seed,
                              int32_t *y, float *cos_dist, uint8_t *ok) {
  float x[512], yp[512], pen[512];
  const int nc = (n + 31) / 32;
  const bool chunked = n > 32;
  const float kf = (float)k;
  for (int j = 0; j < n; j++) {
    x[j] = fabsf(ok_lanes[j] ? xc[j] : 0.0f);
  }
  auto row_sum = [&](const float *a, const float *b, bool dot) {
    if (!chunked) {
      float acc = 0.0f;
      for (int j = 0; j < n; j++)
        acc = dot ? ps_dot_step(acc, a[j], b[j], false) : ps_add(acc, a[j]);
      return acc;
    }
    float total = 0.0f;
    for (int c = 0; c < nc; c++) {
      float acc = 0.0f;
      for (int j = 32 * c; j < 32 * c + 32; j++) {
        const float av = j < n ? a[j] : 0.0f, bv = j < n ? b[j] : 0.0f;
        acc = dot ? ps_dot_step(acc, av, bv, true) : ps_add(acc, av);
      }
      total = ps_add(total, acc);
    }
    return total;
  };
  const float xx = row_sum(x, x, true), l1 = row_sum(x, x, false);
  for (int j = 0; j < n; j++) yp[j] = ps_init_pulses(k, kf, x[j], l1);
  float xy = row_sum(x, yp, true), yy = row_sum(yp, yp, true);
  float i = row_sum(yp, yp, false);
  const float norm_1 = ps_rsqrt(ps_add(1e-30f, xx), seed);
  const float lamr = ps_div(lam, ps_add(1e-30f, g2));
  const float rdo = (float)((k >> 2) + 1);
  for (int j = 0; j < n; j++)
    pen[j] = ps_rate_pen(lamr, j, k == 1 ? d1 : d0, k == 1 ? a1 : a0);
  const int trips = ps_trips(kf, i, iters);
  for (int t = 0; t < trips; t++) {
    const bool phase2 = i >= ps_add(kf, -rdo);
    int pos = 0;
    int32_t best = INT_MIN;
    for (int j = 0; j < n; j++) {
      const float s = ok_lanes[j] ? ps_score(x[j], yp[j], pen[j], xy, yy,
                                             norm_1, phase2, rsq16, seed)
                                  : -__builtin_inff();
      if (ps_key(s) > best) {
        best = ps_key(s);
        pos = j;
      }
    }
    ps_update(x[pos], yp[pos], kf, &yp[pos], &xy, &yy, &i);
  }
  for (int j = 0; j < n; j++) {
    const float v = ok_lanes[j] ? xc[j] : 0.0f;
    y[j] = k == 0 ? 0 : (int32_t)(v < 0.0f ? -yp[j] : yp[j]);
  }
  *ok = i >= kf;
  *cos_dist = ps_cos_dist(k, xy, xx, yy, seed);
  return trips;
}
#endif
