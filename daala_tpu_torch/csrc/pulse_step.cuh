// One step of the greedy PVQ pulse search for one row, shared by the CUDA
// kernel (csrc/pulse_search.cu) and a host build with g++
// (tests/test_torch_pulse_plan.py), so that the arithmetic the card runs
// is the arithmetic the CPU tests hold bit for bit against the plain
// loop (ops/cuda/pulse_kernels.py pulse_loop_plain).
//
// Every float operation is written out as one IEEE operation in the plain
// loop's order and association: on the card through __fadd_rn,
// __fmul_rn, __fdiv_rn, __dadd_rn and __dmul_rn, which nvcc never
// contracts into a fused multiply-add (the build's flags leave -fmad on);
// on the host as plain C++ operators, compiled with -ffp-contract=off.
//
// Why no NaN can arise: tyy = (yy + 2 yp) + 1 >= 1, since yy and yp are
// sums of non-negative integers, so the division of score1 and the
// reciprocal square root of score2 (of max(tyy, 1)) are finite.  x (an
// int16 coefficient's magnitude) and norm_1 (a reciprocal square root of
// 1e-30 + xx) are finite, and so is rate_pen: band_search's distortion
// scales g2 are >= 0, so lam / (1e-30 + g2) is at most lam * 1e30.
// Masked lanes score -inf and never win against a finite score; a row
// whose lanes are all masked takes lane 0, as torch's argmax does.

#pragma once

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

// pvqsearch.py _fma32: the product of two floats in double (exact), the
// sum in double (one rounding), then one rounding to float.
PS_HD float ps_fma32(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
#else
  return (float)((double)a * (double)b + (double)c);
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

#ifndef __CUDACC__
// The whole loop for one row on the host: the lanes one after another,
// the first maximum kept.  x, yp, rate_pen: n floats; ok: n bytes (0: the
// lane is masked).
inline void ps_row_host(int n, const float *x, float *yp,
                        const float *rate_pen, const uint8_t *ok, float *xy,
                        float *yy, float *i, float kf, float rdo,
                        float norm_1, int iters, const float *rsq16,
                        const int32_t *seed) {
  const int trips = ps_trips(kf, *i, iters);
  for (int t = 0; t < trips; t++) {
    const bool phase2 = *i >= ps_add(kf, -rdo);
    int pos = 0;
    float best = 0.0f;
    for (int j = 0; j < n; j++) {
      const float s = ok[j] ? ps_score(x[j], yp[j], rate_pen[j], *xy, *yy,
                                       norm_1, phase2, rsq16, seed)
                            : -__builtin_inff();
      if (j == 0 || s > best) {
        best = s;
        pos = j;
      }
    }
    ps_update(x[pos], yp[pos], kf, &yp[pos], xy, yy, i);
  }
}
#endif
