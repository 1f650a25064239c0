// The PVQ band search's arithmetic around its pulse search, shared by the
// CUDA kernels (csrc/band_search.cu) and a host build with g++
// (tests/test_torch_band_plan.py), so that what the card runs is what the
// CPU tests hold bit for bit against the plain versions
// (ops/cuda/band_kernels.py band_prologue_plain, band_epilogue_plain):
//
// - the prologue of one row, its lane loops through a policy (SerialLanes:
//   one thread; the kernel's GroupLanes: a group of 8, 16 or 32 lanes of a
//   warp), its integer sums fused into three reductions;
// - the epilogue in stages: a node's CDF symbol (node_term), its cost from
//   two logs (term_cost), XLA's ordered sums of a candidate's costs over
//   the list of its coding nodes (rate_chunks; lanes8_part, then
//   lanes8_rest), a candidate's cost (finish_cand) and a row's decision
//   (decide_row).  br_epilogue_host runs them in one thread in the order
//   and grouping in which the kernel's warp runs them.
//
// Integers: the plain versions compute in int64 with torch's rules, and so
// does this header: a left shift by less than 0 or 64 or more gives 0, a
// right shift by those the sign; products and sums wrap (through uint64,
// as C++ has no -fwrapv); int32 and int16 wraps take the low bits.
//
// Floats: every float32 operation is one IEEE operation in the plain
// version's order, through pulse_step.cuh's ps_add, ps_mul, ps_div and
// ps_fma32 (a fused multiply-add rounded once: the plain versions'
// _fma32), which nvcc never contracts.  The two transcendentals are
// written out, as XLA:CPU computes them for JAX on the CPU: XLA's log
// (br::log) and glibc's atan2f (br::atan2f_glibc), so the card, the host
// build and the plain versions compute the same arccos.

#pragma once

#include "pulse_step.cuh"

namespace br {

// ---- constants (ops/pvq.py) ----
constexpr int CGAIN_SHIFT = 8;
constexpr int RCP_B15 = 2731;  // beta_rcp(BETA_1_5)
constexpr int BETA1 = 4096;
constexpr float INV_CS2 = 1.0f / 65536.0f;  // 1 / OD_CGAIN_SCALE^2
constexpr float TQ_SCALE = 1.0f / 32768.0f;  // XLA's folded theta scale
constexpr float TRIG = 1.0f / 32768.0f;      // 1 / OD_TRIG_SCALE

PS_HD float f32(uint32_t bits) { return ps_float((int32_t)bits); }

// float32(1.4), float32(65536 / pi), float32(1 / ln 2), and
// float32(float32(1 / ln 2) * float32(0.9)).
PS_HD float gw() { return f32(0x3FB33333u); }
PS_HD float theta_c() { return f32(0x46A2F983u); }
PS_HD float log2e() { return f32(0x3FB8AA3Bu); }
PS_HD float trate_c() { return f32(0x3FA632CEu); }

// ---- int64 with torch's rules ----
PS_HD int64_t shl(int64_t a, int64_t s) {
  return (s < 0 || s >= 64) ? 0 : (int64_t)((uint64_t)a << s);
}
PS_HD int64_t shr(int64_t a, int64_t s) {
  return (s < 0 || s >= 64) ? (a < 0 ? -1 : 0) : (a >> s);
}
PS_HD int64_t mul(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a * (uint64_t)b);
}
PS_HD int64_t add(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}
PS_HD int64_t wrap32(int64_t v) {
  return (int64_t)(int32_t)(uint32_t)((uint64_t)v & 0xFFFFFFFFu);
}
PS_HD int64_t wrap16(int64_t v) {
  return (int64_t)(int16_t)(uint16_t)((uint64_t)v & 0xFFFFu);
}
// The magnitude of an int32 as torch's int32 abs gives it (-2^31 stays).
PS_HD int64_t abs32(int64_t v) { return wrap32(v < 0 ? -v : v); }
PS_HD int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
PS_HD int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
PS_HD int64_t floordiv(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
// floordiv where |a| < 2^53 and 0 < b < 2^31, the operands of the gains'
// companding and of compute_theta: the double quotient of a / b is within
// 2^-53 |a / b| < 1 of the true one, so its floor is within one of
// floor(a / b), and the remainder a - q b (exact in int64: |q b| < |a| + b)
// moves it there.  Elsewhere int64 division.  The same on the card and on
// the host (IEEE division, rounded to nearest).
PS_HD int64_t floordiv_q(int64_t a, int64_t b) {
  constexpr int64_t A = 1LL << 53;
  if (b <= 0 || b >= (1LL << 31) || a <= -A || a >= A) return floordiv(a, b);
  int64_t q = (int64_t)floor((double)a / (double)b);
  const int64_t r = a - q * b;
  if (r < 0)
    q--;
  else if (r >= b)
    q++;
  return q;
}
// OD_ILOG of the low 32 bits: their bit length.
PS_HD int64_t ilog(int64_t x) {
  const uint32_t u = (uint32_t)((uint64_t)x & 0xFFFFFFFFu);
#ifdef __CUDA_ARCH__
  return 32 - __clz((int)u);
#else
  return u == 0 ? 0 : 32 - __builtin_clz(u);
#endif
}
PS_HD int64_t ilog_c(int64_t x) { return x < 0 ? 32 : ilog(x); }
PS_HD int64_t shl32(int64_t a, int64_t s) { return wrap32(shl(a, s)); }
// _shr_round with a constant shift s (0 <= s < 63), and with a variable one.
PS_HD int64_t shr_round(int64_t x, int s) {
  return shr(add(x, (int64_t)((1LL << s) >> 1)), s);
}
PS_HD int64_t shr_round_v(int64_t x, int64_t s) {
  return shr(add(x, shr(shl(1, s), 1)), s);
}
PS_HD int64_t vshr(int64_t x, int64_t s) {
  return s > 0 ? shr(x, s) : shl32(x, -s);
}
PS_HD int64_t vshr_round(int64_t x, int64_t s) {
  return s > 0 ? shr_round_v(x, s) : shl32(x, -s);
}
PS_HD int64_t q15(int64_t a, int64_t b) { return shr(mul(a, b), 15); }
PS_HD int64_t q16(int64_t a, int64_t b) { return shr(mul(a, b), 16); }
PS_HD int64_t qbeta(int64_t a, int64_t b) { return shr(mul(a, b), 12); }

// ---- the fixed-point helpers (band_kernels.py, same names) ----
PS_HD int64_t od_rcp(int64_t x) {
  const int64_t i = ilog_c(x) - 1;
  const int64_t n = wrap16(vshr_round(x, i - 15) - (1 << 15));
  int64_t r = wrap16(30840 + q15(-15420, n));
  r = wrap16(r - q15(r, q15(r, n) + r - 32768));
  r = wrap16(r - (1 + q15(r, q15(r, n) + r - 32768)));
  return wrap16(vshr_round(r, i - 14));
}
PS_HD int64_t rsqrt_norm(int64_t t) {
  const int64_t n = t - 32768;
  const int64_t r = 23565 + q15(n, -13481 + q15(n, 6711));
  const int64_t r2 = mul(r, r);
  const int64_t y = shr(add(mul(shr(r2, 15), n), r2), 12) - 131077;
  const int64_t ry = mul(r, y);
  return r + shr(shr(mul(shr(ry, 16), 3 * y), 3) - ry, 18);
}
PS_HD int64_t sqrt_norm(int64_t x) {
  return imin(shr_round(mul(x, rsqrt_norm(x)), 15), 32767);
}
PS_HD void od_sqrt(int64_t x, int64_t *v, int64_t *shift) {
  const int64_t k = (ilog(x) - 1) >> 1;
  const int64_t s = 2 * k - 14;
  const int64_t t = vshr(x, s);
  *v = x == 0 ? 0 : sqrt_norm(t);
  *shift = x == 0 ? 0 : 15 - ((s + 16) >> 1);
}
PS_HD int64_t od_exp2(int64_t x) {
  const int64_t integer = x >> 15;
  const int64_t xf = x - shl32(integer, 15);
  const int64_t frac =
      q15(xf, 22709 + q15(xf, 7913 + q15(xf, 1704 + q15(xf, 443))));
  int64_t out = vshr_round(32768 + frac, -integer) + 1;
  if (integer > 14) out = 0x7F000000;
  if (integer < -15) out = 0;
  return out;
}
PS_HD int64_t od_log2(int64_t x) {
  return x + q15(x, 14482 + q15(x, -23234 + q15(x, 13643 +
                                              q15(x, -6403 + q15(x, 1515)))));
}
PS_HD int64_t od_pow(int64_t x, int64_t beta) {
  const int64_t log2_x = ilog(x) - 1;
  const int64_t t = vshr(x, log2_x - 15) - (1 << 15);
  const int64_t logr = qbeta(beta, od_log2(t) + (log2_x - 12) * 32768);
  return x == 0 ? 0 : od_exp2(logr);
}
// g is an int32 (a wrapped shift of the root, or the root itself), so
// 256 g + q0 / 2 is below 2^40 in magnitude; od_pow's result is at most
// 2^31, so expr + q0 / 2 is below 2^37: floordiv_q is exact for q0 > 0.
PS_HD int64_t gain_compand(int64_t g, int64_t q0, bool b15) {
  if (!b15) return floordiv_q(256 * g + (q0 >> 1), q0);
  const int64_t expr = shl(od_pow(g, RCP_B15), 5);
  return floordiv_q(expr + (q0 >> 1), q0);
}
// The companded gain and the gain of a row whose squares sum to acc.
PS_HD void compute_gain(int64_t acc, int64_t q0, bool b15, int64_t bshift,
                        int64_t *cg, int64_t *g) {
  int64_t irt, sh;
  od_sqrt(acc, &irt, &sh);
  *g = vshr_round(irt, sh - bshift);
  *cg = gain_compand(*g, q0, b15);
}
PS_HD int64_t cos_pi_2(int64_t x) {
  const int64_t x2 = q15(x, x);
  return imin(32767, shr(1073758164 - mul(x, x) +
                             mul(x2, -7654 + q16(x2, 16573 + q16(-2529, x2))),
                         15));
}
PS_HD int64_t pvq_cos(int64_t x) {
  x = x & 0x1FFFF;
  if (x > (1 << 16)) x = (1 << 17) - x;
  if (x & 0x7FFF) return x < (1 << 15) ? cos_pi_2(x) : -cos_pi_2(65536 - x);
  return (x & 0xFFFF) ? 0 : ((x & 0x1FFFF) ? -32767 : 32767);
}
PS_HD int64_t pvq_sin(int64_t x) { return pvq_cos(32768 - x); }
PS_HD int64_t max_theta(int64_t qcg, bool b15) {
  const int64_t ts = shr_round(mul(qcg, qbeta(b15 ? RCP_B15 : BETA1, 402)),
                               16);
  return wrap32(qcg < 358 ? 1 : ts);
}
// The prologue's t is >= 0 (a clamped floor plus 0..3) and mt an int32,
// so for mt > 0 the dividend lies in [0, 2^47): floordiv_q is exact.
PS_HD int64_t compute_theta(int64_t t, int64_t mt) {
  t = imin(t, mt - 1);
  return mt != 0 ? floordiv_q(32768 * t + (mt >> 1), imax(mt, 1)) : 0;
}
PS_HD int64_t k_theta(int64_t itheta, int64_t rt0) {
  const int64_t k = imax(1, shr_round(mul(shl32(itheta, 15) - 6554, rt0),
                                      25));
  return wrap32(itheta == 0 ? 0 : k);
}
PS_HD int64_t k_noref(int64_t qcg, int n, bool b15, int64_t rt1) {
  int64_t k = imax(1, shr_round(mul(qcg - 51, qbeta(b15 ? RCP_B15 : BETA1,
                                                    rt1)),
                                18));
  if (qcg == 0) k = 0;
  if (n == 15 && b15 && qcg == 256) k = 1;
  return wrap32(k);
}

// ---- float32 ----
PS_HD float sub(float a, float b) { return ps_add(a, -b); }

// XLA:CPU's float32 log of a positive value (band_kernels.py xla_log).
PS_HD float log(float x) {
  const float p0 = f32(0x3D9021BBu), p1 = f32(0xBDEBD1B8u);
  const float p2 = f32(0x3DEF251Au), p3 = f32(0xBDFE5D4Fu);
  const float p4 = f32(0x3E11E9BFu), p5 = f32(0xBE2AAE50u);
  const float p6 = f32(0x3E4CCEACu), p7 = f32(0xBE7FFFFCu);
  const float p8 = f32(0x3EAAAAAAu), q1 = f32(0xB95E8083u);
  const float q2 = f32(0x3F318000u), sqrthf = f32(0x3F3504F3u);
  if (x < f32(0x00800000u)) x = f32(0x00800000u);
  const int32_t b = ps_bits(x);
  float e = ps_add((float)((b >> 23) - 127), 1.0f);
  const float m = ps_float((b & (int32_t)0x807FFFFF) | 0x3F000000);
  const bool small = m < sqrthf;
  e = sub(e, small ? 1.0f : 0.0f);
  const float r = ps_add(sub(m, 1.0f), small ? m : 0.0f);
  const float x2 = ps_mul(r, r), x3 = ps_mul(x2, r);
  float y = ps_fma32(r, p0, p1), y1 = ps_fma32(r, p3, p4);
  float y2 = ps_fma32(r, p6, p7);
  y = ps_fma32(y, r, p2);
  y1 = ps_fma32(y1, r, p5);
  y2 = ps_fma32(y2, r, p8);
  y = ps_fma32(y, x3, y1);
  y = ps_fma32(y, x3, y2);
  y = ps_fma32(y, x3, ps_mul(e, q1));
  const float s = ps_add(ps_fma32(x2, -0.5f, r), y);
  return ps_fma32(e, q2, s);
}

// glibc 2.36's float32 atan (fdlibm's __atanf, sysdeps/ieee754/flt-32/
// s_atanf.c): the argument's range picks its reduction (none below 0.4375,
// then about atan(0.5), atan(1), atan(1.5) and atan(inf)), one polynomial
// of 11 terms in x^2, split odd and even; |x| < 2^-29 and |x| >= 2^25 return
// at once.  band_kernels.py atanf_glibc is its plain version.
PS_HD float atanf_glibc(float x) {
  const float t0 = f32(0x3EAAAAABu), t1 = f32(0xBE4CCCCDu);
  const float t2 = f32(0x3E124925u), t3 = f32(0xBDE38E38u);
  const float t4 = f32(0x3DBA2E6Eu), t5 = f32(0xBD9D8795u);
  const float t6 = f32(0x3D886B35u), t7 = f32(0xBD6EF16Bu);
  const float t8 = f32(0x3D4BDA59u), t9 = f32(0xBD15A221u);
  const float t10 = f32(0x3C8569D7u);
  const int32_t hx = ps_bits(x), ix = hx & 0x7fffffff;
  // atan(0.5), atan(1), atan(1.5) and atan(inf), each in two parts.
  auto hi = [](int id) {
    return f32(id == 0 ? 0x3EED6338u : id == 1 ? 0x3F490FDAu
               : id == 2 ? 0x3F7B985Eu : 0x3FC90FDAu);
  };
  auto lo = [](int id) {
    return f32(id == 0 ? 0x31AC3769u : id == 1 ? 0x33222168u
               : id == 2 ? 0x33140FB4u : 0x33A22168u);
  };
  if (ix >= 0x4c000000) {  // |x| >= 2^25, or NaN
    if (ix > 0x7f800000) return ps_add(x, x);
    const float v = ps_add(hi(3), lo(3));
    return hx > 0 ? v : -v;
  }
  int id = -1;
  if (ix < 0x3ee00000) {  // |x| < 0.4375
    if (ix < 0x31000000) return x;  // |x| < 2^-29
  } else {
    const float a = ps_float(ix);
    if (ix < 0x3f300000) {  // < 11/16
      id = 0;
      x = ps_div(sub(ps_mul(2.0f, a), 1.0f), ps_add(2.0f, a));
    } else if (ix < 0x3f980000) {  // < 19/16
      id = 1;
      x = ps_div(sub(a, 1.0f), ps_add(a, 1.0f));
    } else if (ix < 0x401c0000) {  // < 2.4375
      id = 2;
      x = ps_div(sub(a, 1.5f), ps_add(1.0f, ps_mul(1.5f, a)));
    } else {
      id = 3;
      x = ps_div(-1.0f, a);
    }
  }
  const float z = ps_mul(x, x), w = ps_mul(z, z);
  const float s1 = ps_mul(
      z, ps_add(t0, ps_mul(w, ps_add(t2, ps_mul(w, ps_add(t4, ps_mul(
             w, ps_add(t6, ps_mul(w, ps_add(t8, ps_mul(w, t10)))))))))));
  const float s2 = ps_mul(
      w, ps_add(t1, ps_mul(w, ps_add(t3, ps_mul(w, ps_add(t5, ps_mul(
             w, ps_add(t7, ps_mul(w, t9)))))))));
  const float xs = ps_mul(x, ps_add(s1, s2));
  if (id < 0) return sub(x, xs);
  const float v = sub(hi(id), sub(sub(xs, lo(id)), x));
  return hx < 0 ? -v : v;
}

// glibc 2.36's float32 atan2 (fdlibm's __ieee754_atan2f,
// sysdeps/ieee754/flt-32/e_atan2f.c), the atan2f that XLA:CPU calls in
// JAX's arccos: NaNs, x = 1, zeros and infinities first, then atan(|y / x|)
// moved to the quadrant of (x, y).  band_kernels.py atan2f_glibc is its
// plain version.
PS_HD float atan2f_glibc(float y, float x) {
  const float pi = f32(0x40490FDBu), pi_lo = f32(0xB3BBBD2Eu);
  const float pi_o_4 = f32(0x3F490FDBu), pi_o_2 = f32(0x3FC90FDBu);
  const float tiny = f32(0x0DA24260u);  // 1e-30
  const int32_t hx = ps_bits(x), ix = hx & 0x7fffffff;
  const int32_t hy = ps_bits(y), iy = hy & 0x7fffffff;
  if (ix > 0x7f800000 || iy > 0x7f800000) return ps_add(x, y);
  if (hx == 0x3f800000) return atanf_glibc(y);
  const int m = ((hy >> 31) & 1) | ((hx >> 30) & 2);  // 2 sign(x) + sign(y)
  const float half_pi = ps_add(pi_o_2, tiny), full_pi = ps_add(pi, tiny);
  if (iy == 0) return m < 2 ? y : (m == 2 ? full_pi : -full_pi);
  if (ix == 0) return hy < 0 ? -half_pi : half_pi;
  if (ix == 0x7f800000) {
    float v;
    if (iy == 0x7f800000)
      v = ps_add(m < 2 ? pi_o_4 : ps_mul(3.0f, pi_o_4), tiny);
    else
      v = m < 2 ? 0.0f : full_pi;
    return (m & 1) ? -v : v;
  }
  if (iy == 0x7f800000) return hy < 0 ? -half_pi : half_pi;
  const int32_t k = (iy - ix) >> 23;
  float z;
  if (k > 60)
    z = ps_add(pi_o_2, ps_mul(0.5f, pi_lo));
  else if (hx < 0 && k < -60)
    z = 0.0f;
  else
    z = atanf_glibc(fabsf(ps_div(y, x)));
  if (m == 0) return z;
  if (m == 1) return -z;
  return m == 2 ? sub(pi, sub(z, pi_lo)) : sub(sub(z, pi_lo), pi);
}

// JAX's arccos of c in [-1, 1] as XLA:CPU computes it (band_kernels.py
// acos_xla): atan2(sqrt((1 - c)(1 + c)), c).
PS_HD float acos_xla(float c) {
  return atan2f_glibc(sqrtf(ps_mul(sub(1.0f, c), ps_add(c, 1.0f))), c);
}

// float32 -> int64 through floor, NaN -> 0 (as XLA converts).
PS_HD int64_t floor_i(float v) { return v != v ? 0 : (int64_t)floorf(v); }

// ---- a row's lanes ----

// The prologue's lane loops go through a policy: SerialLanes runs them in
// one thread (the host build); csrc/band_search.cu's GroupLanes spreads
// them over a group of lanes, every lane of the group running the row's
// scalar code alike.  Integer sums wrap, so they come out the same in any
// order; a first maximum is the largest value at its lowest index.  The
// independent sums of a row are fused: sums<K> takes K at once (one
// butterfly of K values on the card), sums_argmax<K> also the first
// maximum of g.
struct SerialLanes {
  template <int K, typename F>
  PS_HD void sums(int n, F f, int64_t *s) const {
    for (int q = 0; q < K; q++) s[q] = 0;
    for (int j = 0; j < n; j++) {
      int64_t v[K];
      f(j, v);
      for (int q = 0; q < K; q++) s[q] = add(s[q], v[q]);
    }
  }
  // The sums, and the lowest j at which g(j) (>= 0) is largest.
  template <int K, typename F, typename G>
  PS_HD int sums_argmax(int n, F f, G g, int64_t *s) const {
    sums<K>(n, f, s);
    int64_t best = -1;
    int at = 0;
    for (int j = 0; j < n; j++) {
      const int64_t v = g(j);
      if (v > best) {
        best = v;
        at = j;
      }
    }
    return at;
  }
  // f(j) for each j < n, for its writes.
  template <typename F>
  PS_HD void each(int n, F f) const {
    for (int j = 0; j < n; j++) f(j);
  }
  PS_HD bool leader() const { return true; }
};

// ---- the prologue of one row ----

// What the prologue writes for one row: the rows that the pulse search
// reads, once each (inter: the reflected row of the theta candidates,
// then the noref candidates' x16 row; keyframe: x16), with their lane
// flags, and for each of its C candidates (14 inter, 2 keyframe) the row
// it searches, [g2, sinp, dth, qcgf, trate] and [i, j, ok, k, ts, kk];
// then the row's [cgf, skip_dist, dist0].  Strides: the pulse-search row
// of group g at (g m + row) n; candidate c's row index at c m + row;
// candidate field f of candidate c at (f C + c) m + row.  A lane group
// past the call's last row runs that row again and writes nothing (live
// false): its warp's reductions need every lane.
struct Out {
  float *xs;
  uint8_t *lane_ok;
  int32_t *src;
  float *cf;
  int32_t *ci;
  float *rf;
  int64_t m, row;
  int C;
  bool live;
};

PS_HD void put_cand(const Out &o, int c, float g2, float sinp, float dth,
                    float qcgf, float trate, int64_t i, int64_t j, bool ok,
                    int64_t k, int64_t ts) {
  if (!o.live) return;
  const float f[5] = {g2, sinp, dth, qcgf, trate};
  const int64_t v[6] = {i, j, ok ? 1 : 0, k, ts, ok ? k : 0};
  for (int q = 0; q < 5; q++) o.cf[((int64_t)q * o.C + c) * o.m + o.row] = f[q];
  for (int q = 0; q < 6; q++)
    o.ci[((int64_t)q * o.C + c) * o.m + o.row] = (int32_t)v[q];
}

PS_HD float trate(int64_t ts, int64_t i, int64_t icgr) {
  const float t = (float)ts;
  return ps_fma32(log(t < 1.0f ? 1.0f : t), trate_c(),
                  i == icgr ? -0.5f : -0.0f);
}

PS_HD float dth_of(int64_t theta_q, int64_t qth) {
  return sub(2.0f, ps_mul(ps_mul(2.0f, (float)pvq_cos(theta_q - qth)), TRIG));
}

// One row, through the lane policy L.  X, R, QM: the row's n gathered
// coefficients, reference coefficients (zeros on keyframes) and QM
// values; q0, b15: its quantizer and beta-1.5 flag; rt0 / rt1: the theta
// / noref square-root table entries of n.  Its integer sums are three
// fused reductions (inter; keyframe two): the squares of both vectors and
// the reference's nonzero lanes; the gains' energies, the correlation and
// the reference's largest lane; the reflected reference's energy and
// projection.
template <typename Lanes>
PS_HD void prologue_row(const Lanes &L, int n, bool keyframe, float lam,
                        const int32_t *X, const int32_t *R,
                        const int32_t *QM, int64_t q0, bool b15, int64_t rt0,
                        int64_t rt1, const Out &o) {
  // vector_log_mag: the shifts that bring each vector to 16 bits.
  int64_t t1[3];
  L.template sums<3>(n, [&](int j, int64_t *v) {
    const int64_t tx = (int64_t)X[j] >> 8, tr = (int64_t)R[j] >> 8;
    v[0] = mul(tx, tx);
    v[1] = mul(tr, tr);
    v[2] = R[j] != 0 ? 1 : 0;
  }, t1);
  const bool any_r = t1[2] != 0;
  const int64_t xshift = imax(0, 9 + floordiv(ilog(n + t1[0]), 2) - 15);
  const int64_t rshift = imax(0, 9 + floordiv(ilog(n + t1[1]), 2) - 14);
  auto x16 = [&](int j) {
    return vshr_round(mul(X[j], QM[j]), 11 + xshift);
  };
  auto r16 = [&](int j) {
    return vshr_round(mul(R[j], QM[j]), 11 + rshift);
  };
  int64_t t2[3] = {0, 0, 0};
  int mpos = 0;
  if (keyframe) {
    L.template sums<1>(n, [&](int j, int64_t *v) {
      const int64_t a = x16(j);
      v[0] = mul(a, a);
    }, t2);
  } else {
    mpos = L.template sums_argmax<3>(n, [&](int j, int64_t *v) {
      const int64_t a = x16(j), b = r16(j);
      v[0] = mul(a, a);
      v[1] = mul(b, b);
      v[2] = mul(a, b);
    }, [&](int j) {
      const int64_t b = r16(j);
      return b < 0 ? -b : b;
    }, t2);
  }
  const int64_t accx = t2[0];
  int64_t cg, g;
  compute_gain(accx, q0, b15, xshift, &cg, &g);
  const float cgf = (float)cg;
  const float w = gw();
  const int C = keyframe ? 2 : 14;
  const int G = keyframe ? 1 : 2;  // pulse-search rows a row
  float skip_dist, dist0 = ps_mul(ps_mul(ps_mul(w, cgf), cgf), INV_CS2);
  int64_t icgr = 0, gain_offset = 0, theta_q = 0, i_base = 0,
          gain_bound = 0;
  bool noref_on = true, theta_on = false;
  float tq_s = 0.0f, dist_gate = 0.0f;
  if (keyframe) {
    skip_dist = dist0;
  } else {
    const int64_t accr = t2[1], corr_i = t2[2];
    int64_t cgr, gr;
    compute_gain(accr, q0, b15, rshift, &cgr, &gr);
    icgr = shr_round(cgr, CGAIN_SHIFT);
    gain_offset = cgr - shl32(icgr, CGAIN_SHIFT);
    const float cgrf = (float)cgr;
    float corr = ps_div(ps_mul((float)corr_i,
                               (float)shl32(1, xshift + rshift)),
                        ps_mul((float)g, (float)gr));
    corr = corr < -1.0f ? -1.0f : (corr > 1.0f ? 1.0f : corr);
    const float t_corr = sub(2.0f, ps_mul(2.0f, corr));
    float d = sub(cgf, cgrf);
    skip_dist = ps_mul(ps_fma32(t_corr, ps_mul(cgrf, cgf),
                                ps_mul(w, ps_mul(d, d))),
                       INV_CS2);
    if (icgr == 0) {
      const float fo = (float)gain_offset;
      const float scgr = fo < 0.0f ? 0.0f : fo;
      d = sub(cgf, scgr);
      dist0 = ps_mul(ps_fma32(t_corr, ps_mul(scgr, cgf),
                              ps_mul(w, ps_mul(d, d))),
                     INV_CS2);
    }
    theta_on = any_r && corr > 0.0f;
    // The Householder reflection of r16, its largest lane moved by the
    // reference gain, applied to x16; then lane mpos deleted.
    const int64_t rm = r16(mpos);
    const int64_t bump = shr_round_v(mul(gr, rm > 0 ? 1 : -1), rshift);
    const int64_t rm_refl = wrap16(rm + bump);
    auto rr = [&](int j) { return j == mpos ? rm_refl : r16(j); };
    int64_t t3[2];
    L.template sums<2>(n, [&](int j, int64_t *v) {
      const int64_t b = rr(j);
      v[0] = mul(b, b);
      v[1] = mul(b, x16(j));
    }, t3);
    const int64_t l2r = t3[0], proj = t3[1];
    const int64_t l2r_shift = (ilog(l2r) - 1) - 14;
    const int64_t rcp = od_rcp(wrap16(vshr_round(l2r, l2r_shift)));
    const int64_t proj_shift = (ilog(proj < 0 ? -proj : proj) - 1) - 14;
    const int64_t proj_1 =
        wrap16(q15(wrap16(vshr_round(proj, proj_shift)), rcp));
    const int64_t outshift = imin(30, 14 - proj_shift - 1 + l2r_shift);
    auto xr_full = [&](int j) {
      const int64_t tmp = mul(rr(j), proj_1);
      const int64_t sp = imax(outshift, 0);
      const int64_t v = outshift >= 0
                            ? shr(add(tmp, shr(shl(1, sp), 1)), sp)
                            : shl32(tmp, imax(-outshift, 0));
      return wrap16(x16(j) - v);
    };
    // The theta candidates' row: the reflected lanes with lane mpos
    // deleted, over n - 1 lanes.
    if (o.live)
      L.each(n, [&](int j) {
        const int src = j + (j >= mpos ? 1 : 0);
        const int64_t at = o.row * n + j;
        o.xs[at] = j < n - 1 ? (float)xr_full(src < n - 1 ? src : n - 1)
                             : 0.0f;
        o.lane_ok[at] = j < n - 1;
      });
    theta_q = floor_i(ps_fma32(acos_xla(corr), theta_c(), 0.5f));
    gain_bound = (cg - gain_offset) >> CGAIN_SHIFT;
    i_base = imax(gain_bound - 1, 1);
    noref_on = corr < 0.5f || cg < shl32(2, CGAIN_SHIFT);
    tq_s = ps_mul((float)theta_q, TQ_SCALE);
    dist_gate = ps_add(dist0, lam);
  }
  // The noref candidates' row: x16 over every lane.
  if (o.live)
    L.each(n, [&](int j) {
      const int64_t at = ((int64_t)(G - 1) * o.m + o.row) * n + j;
      o.xs[at] = (float)x16(j);
      o.lane_ok[at] = 1;
    });
  // Theta candidate c: gain gi = c / 4 of 3, theta tj = c % 4 of 4.
  auto theta_cand = [&](int c) {
    const int64_t i3 = wrap32(i_base + (c >> 2));
    const int64_t tj = c & 3;
    const bool gain_ok = i3 <= gain_bound + 1;
    const int64_t qcg = shl32(i3, CGAIN_SHIFT) + gain_offset;
    const int64_t ts = max_theta(qcg, b15);
    const float tsf = (float)ts;
    const float tpos = ps_mul(tq_s, tsf);
    const int64_t t_lower = imax(floor_i(ps_fma32(tq_s, tsf, 0.5f)) - 2, 0);
    const int64_t t_lower_ok = imax(floor_i(ps_add(tpos, 0.5f)) - 2, 0);
    const int64_t t_upper = imin(ts - 1, (int64_t)ceilf(tpos));
    const float qcgf = (float)qcg;
    const float dq = sub(qcgf, cgf);
    const float sq = ps_mul(dq, dq);
    const float qc = ps_mul(qcgf, cgf);
    const float s_th = ps_mul((float)pvq_sin(theta_q), TRIG);
    const int64_t j = t_lower + tj, j_ok = t_lower_ok + tj;
    const int64_t qth = wrap32(compute_theta(j, ts));
    const int64_t k = k_theta(j, rt0);
    const int64_t k_ok = k_theta(j_ok, rt0);
    const float dth_ok = dth_of(theta_q, wrap32(compute_theta(j_ok, ts)));
    const float dist_pre =
        ps_mul(ps_fma32(sq, w, ps_mul(qc, dth_ok)), INV_CS2);
    const bool ok = theta_on && gain_ok && j_ok <= t_upper && j_ok >= 0 &&
                    !(dist_pre > dist_gate && k_ok != 0);
    const float sinp = ps_mul(s_th, ps_mul((float)pvq_sin(qth), TRIG));
    put_cand(o, c, ps_mul(ps_mul(qc, sinp), INV_CS2), sinp,
             dth_of(theta_q, qth), qcgf, trate(ts, i3, icgr), i3, j, ok, k,
             ts);
  };
  // Noref candidate c: gain q = c - (C - 2) of 2.
  const int64_t gb_nr = cg >> CGAIN_SHIFT;
  auto noref_cand = [&](int c) {
    const int64_t i = wrap32(imax(gb_nr, 1) + (c - (C - 2)));
    const bool gain_ok = i <= gb_nr + 1;
    const int64_t qcg = shl32(i, CGAIN_SHIFT);
    const int64_t k = k_noref(qcg, n, b15, rt1);
    const float qcgf = (float)qcg;
    const float dq = sub(qcgf, cgf);
    const float dist_pre = ps_mul(ps_mul(w, ps_mul(dq, dq)), INV_CS2);
    const bool ok = noref_on && gain_ok && !(dist_pre > dist0 && k != 0);
    put_cand(o, c, ps_mul(ps_mul(qcgf, cgf), INV_CS2), 0.0f,
             dth_of(theta_q, 0), qcgf, trate(0, i, icgr), i, -1, ok, k, 0);
  };
  L.each(C, [&](int c) {
    const bool nr = c >= C - 2;
    if (nr)
      noref_cand(c);
    else
      theta_cand(c);
    if (o.live)
      o.src[(int64_t)c * o.m + o.row] =
          (int32_t)((nr ? (int64_t)(G - 1) * o.m : 0) + o.row);
  });
  if (L.leader() && o.live) {
    o.rf[o.row] = cgf;
    o.rf[o.m + o.row] = skip_dist;
    o.rf[2 * o.m + o.row] = dist0;
  }
}

// ---- the epilogue ----

// A node of a split tree that spans more than one lane (the others never
// code), as band_kernels.py node_table packs it into 4 int32: w0 = e |
// base << 8 | size << 16 | psize << 24 and w1 = pbase | szctx7 << 8, with
// e its place among all the tree's nodes in preorder (the order of XLA's
// sums), base and size its span, pbase and psize its parent's (psize 0 at
// the root), szctx7 seven times its size context; k1off the offset of its
// k1 CDF row, tot1 the flat index of that row's total.
struct Node {
  int32_t w0, w1, k1off, tot1;
};

// One coding node of a candidate, in the epilogue's list: key = e | k1 <<
// 8 | shift << 9; a, b: its CDF row's total and its symbol's range, then
// (term_cost) a: its cost.
struct Term {
  int32_t key;
  float a, b;
};
PS_HD int term_e(const Term &t) { return t.key & 0xFF; }
PS_HD bool term_k1(const Term &t) { return (t.key >> 8) & 1; }

// Whether node nd codes, from the prefix sums cs of the candidate's pulse
// magnitudes and ws of the magnitudes times their lane, and then its
// term: the node codes when it holds pulses and none of its
// ancestors ends coding (holds no pulse, or one in at most 16 lanes).  A
// k = 1 leaf (one pulse in at most 16 lanes) codes its pulse's position
// (the node's weighted sum less its base, as the plain version takes it)
// from its k1 CDF row (the k1 table's last index last1); a split codes its
// right half's count, its top bits from a split CDF row (the split table
// w2 wide, rows2 rows), the `shift` rest raw.
PS_HD bool node_term(const Node &nd, const int64_t *cs,
                     const int64_t *ws, const int32_t *k1, int64_t last1,
                     const int32_t *sp, int w2, int rows2, Term *t) {
  const int e = nd.w0 & 0xFF, base = (nd.w0 >> 8) & 0xFF;
  const int size = (nd.w0 >> 16) & 0xFF, psize = (nd.w0 >> 24) & 0xFF;
  const int64_t kn = cs[base + size] - cs[base];
  if (kn <= 0) return false;
  // Going up the tree, spans and pulse counts only grow: an ancestor holds
  // pulses, and can hold just one only when this node does, and then the
  // parent is the nearest that can span at most 16 lanes.
  if (kn == 1 && psize != 0 && psize <= 16) {
    const int pbase = nd.w1 & 0xFF;
    if (cs[pbase + psize] - cs[pbase] == 1) return false;
  }
  const bool is_k1 = kn == 1 && size <= 16;
  int64_t shift = 0, sym, last;
  const int32_t *cdf;
  float tot;
  if (is_k1) {
    sym = imin(imax(add(ws[base + size], -ws[base]) - base, 0), size - 1);
    tot = (float)k1[nd.tot1];
    cdf = k1 + nd.k1off;
    last = last1 - nd.k1off;
  } else {
    const int64_t count_right = cs[base + size] - cs[base + (size >> 1)];
    shift = imax(ilog(kn) - 3, 0);
    sym = count_right >> shift;
    const int64_t t_red = kn >> shift;
    const int64_t fctx =
        imin(imax((nd.w1 >> 8) + t_red - 1, 0), rows2 - 1);
    cdf = sp + fctx * w2;
    last = w2 - 1;
    tot = (float)cdf[imin(t_red, last)];
  }
  const float hi = (float)cdf[imin(sym, last)];
  const float lo = sym > 0 ? (float)cdf[imin(imax(sym - 1, 0), last)] : 0.0f;
  t->key = e | (is_k1 ? 1 << 8 : 0) | (int)(shift << 9);
  t->a = tot;
  t->b = sub(hi, lo);
  return true;
}

// The term's cost: log2(total) - log2(the symbol's range), XLA's forms
// (a k = 1 leaf fma(-log p, c, log2 tot); a split fma(log tot, c, -log2 p)
// plus its raw bits).
PS_HD float term_cost(const Term &t) {
  const float c = log2e();
  const float lt = log(t.a < 1.0f ? 1.0f : t.a);
  const float lp = log(t.b < 1.0f ? 1.0f : t.b);
  if (term_k1(t)) return ps_fma32(-lp, c, ps_mul(lt, c));
  return ps_add(ps_fma32(lt, c, -ps_mul(lp, c)), (float)(t.key >> 9 & 31));
}

// XLA's sums of a candidate's node costs (the k = 1 leaves' and the
// splits', each its own sum, then added), over the costs of its coding
// nodes t[b..e) in preorder; the other nodes cost +0, and adding +0 to a
// sum that starts at +0 changes nothing, so they are skipped.  NN nodes:
// below 16 one chain; from 16 to 32 8 lanes, lane i summing the nodes e <
// body = 8 floor(NN / 8) with e % 8 == i (lanes8_part), halved (i + 4, +
// 2, + 1), then the rest in order (lanes8_rest); above 32 chunks of 32 with
// lead zeros in front (XLA's split of the padding), each a chain, then the
// chunks' sums in order (rate_chunks, which also takes the one chain).
PS_HD bool sums_in_lanes8(int NN) { return NN >= 16 && NN <= 32; }

PS_HD float rate_chunks(const Term *t, int b, int e, int NN) {
  const int nc = NN <= 32 ? 1 : (NN + 31) / 32;
  const int lead = NN <= 32 ? 0 : (nc * 32 - NN) / 2;
  float s1 = 0.0f, s2 = 0.0f, p1 = 0.0f, p2 = 0.0f;
  int ch = 0;
  for (int q = b; q < e; q++) {
    const int c = (term_e(t[q]) + lead) >> 5;
    if (c != ch) {
      s1 = ps_add(s1, p1);
      s2 = ps_add(s2, p2);
      p1 = p2 = 0.0f;
      ch = c;
    }
    if (term_k1(t[q]))
      p1 = ps_add(p1, t[q].a);
    else
      p2 = ps_add(p2, t[q].a);
  }
  return ps_add(ps_add(s1, p1), ps_add(s2, p2));
}

PS_HD void lanes8_part(const Term *t, int b, int e, int body, int i,
                       float *p1, float *p2) {
  float a1 = 0.0f, a2 = 0.0f;
  for (int q = b; q < e; q++) {
    const int v = term_e(t[q]);
    if (v >= body || (v & 7) != i) continue;
    if (term_k1(t[q]))
      a1 = ps_add(a1, t[q].a);
    else
      a2 = ps_add(a2, t[q].a);
  }
  *p1 = a1;
  *p2 = a2;
}

PS_HD float lanes8_rest(const Term *t, int b, int e, int body, float a1,
                        float a2) {
  for (int q = b; q < e; q++) {
    if (term_e(t[q]) < body) continue;
    if (term_k1(t[q]))
      a1 = ps_add(a1, t[q].a);
    else
      a2 = ps_add(a2, t[q].a);
  }
  return ps_add(a1, a2);
}

// The fast rate model of one row (band_kernels.py _fast_rate).
template <typename Y>
PS_HD float fast_rate(Y y, int n, int n_eff, int32_t k) {
  const bool chunked = n > 32;
  const int nc = (n + 31) / 32;
  float total = 0.0f;
  for (int ch = 0; ch < (chunked ? nc : 1); ch++) {
    float acc = 0.0f;
    const int j0 = chunked ? 32 * ch : 0, j1 = chunked ? 32 * ch + 32 : n;
    for (int j = j0; j < j1; j++) {
      const float ya = (float)(j < n ? abs32(y(j)) : 0);
      acc = ps_add(acc, j < n && j < n_eff ? ps_mul((float)j, ya) : 0.0f);
    }
    total = chunked ? ps_add(total, acc) : acc;
  }
  const float kf0 = (float)k;
  const float kf = kf0 < 1.0f ? 1.0f : kf0;
  const float nf = (float)n;
  const float f = ps_div(total, ps_mul(kf, nf));
  float lg = log(ps_mul((float)(n * 2.0), ps_add(f, 0.025f)));
  lg = lg < 0.0f ? 0.0f : lg;
  const float rate =
      ps_add(ps_mul(ps_mul(ps_add(1.0f, ps_mul(0.4f, f)), nf),
                    ps_mul(log(ps_add(1.0f, ps_div(ps_mul(lg, kf), nf))),
                           log2e())),
             3.0f);
  return k == 0 ? 0.0f : rate;
}

// What the epilogue reads: the pulse search's result on the prologue's
// rows (y_c (C m, n), cos_dist and ok_p (C m)), the prologue's cf, ci and
// rf, the CDF tables (use_cdf false: the fast rate model), and the call's
// constants.
struct EpiIn {
  const int32_t *y_c;
  const float *cos_dist;
  const uint8_t *ok_p;
  const float *cf;
  const int32_t *ci;
  const float *rf;
  const int32_t *k1, *sp;
  int64_t last1;
  int w2, rows2;
  bool use_cdf, keyframe;
  int64_t m;
  int n, C;
  float lam;
};

// The nodes of candidate c's split tree (n - 1 lanes for a theta
// candidate, n for a noref one, the last two).
PS_HD int cand_nn(const EpiIn &a, int c) {
  return 2 * (c >= a.C - 2 ? a.n : a.n - 1) - 1;
}

// A candidate's fields, read ahead of its rate, and what the row's
// decision takes of it.
struct CandIn {
  float cos_dist, sinp, dth, qcgf, trate, cgf;
  int32_t i, j, ok, k, ts;
  uint8_t ok_p;
};
struct Cand {
  float cost, cost_y, kept;
  int32_t i, j, ts, k;
  uint8_t ok, ok_p;
};

PS_HD CandIn load_cand(const EpiIn &a, int64_t row, int c) {
  const int64_t rc = (int64_t)c * a.m + row;
  auto f = [&](int q) { return a.cf[((int64_t)q * a.C + c) * a.m + row]; };
  auto i = [&](int q) { return a.ci[((int64_t)q * a.C + c) * a.m + row]; };
  return CandIn{a.cos_dist[rc], f(1), f(2), f(3), f(4), a.rf[row],
                i(0), i(1), i(2), i(3), i(4), a.ok_p[rc]};
}

// Candidate c's distortion, cost and the cost by which JAX's pulses are
// selected, from its rate: XLA:CPU contracts dist + lam rate into fma(lam,
// rate, dist) everywhere but in the inter fusion that carries the pulses,
// which rounds lam rate first; the keyframe fusion that keeps the best
// distortion contracts the other product.
PS_HD Cand finish_cand(const EpiIn &a, int c, const CandIn &in, float rate) {
  const bool isnr = c >= a.C - 2;
  rate = ps_add(rate, isnr ? 0.0f : in.trate);
  float t = sub(2.0f, ps_mul(2.0f, in.cos_dist));
  if (!isnr) t = ps_fma32(in.sinp, t, in.dth);
  const float dq = sub(in.qcgf, in.cgf);
  const float sq = ps_mul(dq, dq), qc = ps_mul(in.qcgf, in.cgf);
  const float dist = ps_mul(ps_fma32(sq, gw(), ps_mul(qc, t)), INV_CS2);
  Cand o;
  o.kept = a.keyframe ? ps_mul(ps_fma32(t, qc, ps_mul(gw(), sq)), INV_CS2)
                      : dist;
  o.cost = ps_fma32(rate, a.lam, dist);
  o.cost_y = a.keyframe ? o.cost : ps_add(dist, ps_mul(rate, a.lam));
  o.i = in.i;
  o.j = in.j;
  o.ts = in.ts;
  o.k = in.k;
  o.ok = in.ok != 0;
  o.ok_p = in.ok_p;
  return o;
}

// JAX's scan over a row's C candidates cd (band_kernels.py _select): the
// best cost starts at the initial candidate's (-1), dist0, and candidate c
// in order replaces it when ok and its cost is below it (theta) or not
// above it (noref, the last two); a NaN compares false.  The winner is the
// last to replace it; the candidate whose pulses are the row's is the last
// whose cost_y passes the same test against the best cost before it.
// skip_dist, dist0: the row's rf[1], rf[2].  Writes ints (6 int32) and
// skip_diff of the row; returns that candidate (-1: the initial
// candidate's zeros).
PS_HD int decide_row(const EpiIn &a, int64_t row, const Cand *cd,
                     float skip_dist, float dist0, int32_t *ints,
                     float *skip_diff) {
  float b = dist0;
  int win = -1, win_y = -1;
  bool valid = true;
  for (int c = 0; c < a.C; c++) {
    if (!cd[c].ok) continue;
    if (!cd[c].ok_p) valid = false;
    const bool nr = c >= a.C - 2;
    const float v = cd[c].cost, vy = cd[c].cost_y;
    if (nr ? vy <= b : vy < b) win_y = c;
    if (nr ? v <= b : v < b) {
      b = v;
      win = c;
    }
  }
  const bool sel = win >= 0;
  const int64_t best_k = sel ? cd[win].k : 0;
  valid = valid && best_k <= 32767;
  int32_t *o = ints + row * 6;
  o[0] = sel ? (win >= a.C - 2 ? 1 : 0) : (a.keyframe ? 1 : 0);
  o[1] = sel ? cd[win].i : 0;
  o[2] = sel ? cd[win].j : (a.keyframe ? -1 : 0);
  o[3] = sel ? cd[win].ts : 0;
  o[4] = (int32_t)best_k;
  o[5] = valid ? 1 : 0;
  skip_diff[row] = sub(skip_dist, sel ? cd[win].kept : dist0);
  return win_y;
}

// ---- the epilogue's plan (csrc/band_search.cu) ----

// A warp takes a task of rpw rows (inter 1, keyframe 1 to 7), CW = rpw C
// <= 14 candidates.  Only the ok ones can win, so only their rates are
// computed: they take the task's slots in order, in passes of CPP: a pass
// reads a candidate's pulses over LPC lanes, VPL a lane, into prefix sums,
// then lists the coding nodes of its tree.  The list holds LCAP terms;
// before a pass that could overflow it, and after the last, the warp
// computes the listed terms' costs and the rates of the candidates listed
// (a flush).  NMAX: the instantiation's widest band.
constexpr int EPI_CW = 14;
constexpr int EPI_LCAP = 256;
PS_HD int epi_nmax(int n) {
  return n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : 128;
}
PS_HD int epi_lpc(int nmax) { return nmax < 32 ? nmax : 32; }
PS_HD int epi_cpp(int nmax) { return 32 / epi_lpc(nmax); }
PS_HD int epi_pass_max(int nmax) { return epi_cpp(nmax) * (nmax - 1); }

}  // namespace br

#ifndef __CUDACC__
// The prologue and epilogue of every row on the host, in one thread (the
// g++ test's entry points).
inline void br_prologue_host(int m, int n, bool keyframe, float lam,
                             const int32_t *X, const int32_t *R,
                             const int32_t *QM, const int32_t *q0,
                             const uint8_t *b15, int64_t rt0, int64_t rt1,
                             float *xs, uint8_t *lane_ok, int32_t *src,
                             float *cf, int32_t *ci, float *rf) {
  const br::Out base{xs, lane_ok, src, cf, ci, rf, m, 0, keyframe ? 2 : 14,
                     true};
  for (int r = 0; r < m; r++) {
    br::Out o = base;
    o.row = r;
    br::prologue_row(br::SerialLanes(), n, keyframe, lam, X + (size_t)r * n,
                     R + (size_t)r * n, QM + (size_t)r * n, q0[r],
                     b15[r] != 0, rt0, rt1, o);
  }
}

// The epilogue of every row, task by task as the kernel's warp runs them
// (rpw rows a task), in one thread: the ok candidates' slots, each pass's
// prefix sums and terms into the list, a flush where the kernel flushes
// (the terms' costs, then each listed candidate's sums, chain by chain),
// then the candidates' costs, the rows' decisions and their pulses.
// nodes_th / nodes_nr: the split trees' coding nodes (ni_th, ni_nr of
// them).  flushes: counts the flushes before a task's end, which only a
// list that could overflow makes.
inline void br_epilogue_host(const br::EpiIn &a, const br::Node *nodes_th,
                             int ni_th, const br::Node *nodes_nr, int ni_nr,
                             int rpw, int32_t *ints, int16_t *y_out,
                             float *skip_diff, int64_t *flushes) {
  const int nmax = br::epi_nmax(a.n), cpp = br::epi_cpp(nmax);
  const int CW = rpw * a.C;
  br::Term list[br::EPI_LCAP];
  int64_t cs[129], ws[129];
  int seg[br::EPI_CW + 1], slot[br::EPI_CW];
  float rate[br::EPI_CW];
  br::CandIn in[br::EPI_CW];
  br::Cand cd[br::EPI_CW];
  for (int64_t r0 = 0; r0 < a.m; r0 += rpw) {
    auto pulses = [&](int wc) {
      return a.y_c + ((int64_t)(wc % a.C) * a.m + r0 + wc / a.C) * a.n;
    };
    int nok = 0;
    for (int wc = 0; wc < CW; wc++) {
      rate[wc] = 0.0f;
      if (r0 + wc / a.C >= a.m) continue;
      in[wc] = br::load_cand(a, r0 + wc / a.C, wc % a.C);
      if (in[wc].ok) slot[nok++] = wc;
    }
    int count = 0, first = 0;
    auto flush = [&](int last) {
      for (int q = 0; q < count; q++) list[q].a = br::term_cost(list[q]);
      for (int s = first; s < last; s++) {
        const int b = seg[s], e = s + 1 < last ? seg[s + 1] : count;
        const int NN = br::cand_nn(a, slot[s] % a.C);
        if (br::sums_in_lanes8(NN)) {
          float a1[8], a2[8];
          for (int i = 0; i < 8; i++)
            br::lanes8_part(list, b, e, NN & ~7, i, &a1[i], &a2[i]);
          for (int h = 4; h > 0; h >>= 1)
            for (int i = 0; i < h; i++) {
              a1[i] = ps_add(a1[i], a1[i + h]);
              a2[i] = ps_add(a2[i], a2[i + h]);
            }
          rate[slot[s]] = br::lanes8_rest(list, b, e, NN & ~7, a1[0], a2[0]);
        } else {
          rate[slot[s]] = br::rate_chunks(list, b, e, NN);
        }
      }
      count = 0;
      first = last;
    };
    if (a.use_cdf) {
      for (int p0 = 0; p0 < nok; p0 += cpp) {
        if (count + br::epi_pass_max(nmax) > br::EPI_LCAP) {
          flush(p0);
          ++*flushes;
        }
        for (int s = p0; s < p0 + cpp && s < nok; s++) {
          seg[s] = count;
          const int wc = slot[s];
          const bool isnr = wc % a.C >= a.C - 2;
          const int nt = isnr ? a.n : a.n - 1;
          const int32_t *y = pulses(wc);
          cs[0] = ws[0] = 0;
          for (int j = 0; j < a.n; j++) {
            const int64_t v = j < nt ? br::abs32(y[j]) : 0;
            cs[j + 1] = br::add(cs[j], v);
            ws[j + 1] = br::add(ws[j], br::mul(v, j));
          }
          if (cs[a.n] == 0) continue;  // no pulse: no node codes
          const br::Node *nodes = isnr ? nodes_nr : nodes_th;
          for (int q = 0; q < (isnr ? ni_nr : ni_th); q++)
            if (br::node_term(nodes[q], cs, ws, a.k1, a.last1, a.sp, a.w2,
                              a.rows2, &list[count]))
              count++;
        }
      }
      flush(nok);
    } else {
      for (int s = 0; s < nok; s++) {
        const int wc = slot[s], c = wc % a.C;
        const int32_t *y = pulses(wc);
        rate[wc] = br::fast_rate([&](int j) { return (int64_t)y[j]; }, a.n,
                                 c >= a.C - 2 ? a.n : a.n - 1, in[wc].k);
      }
    }
    for (int wc = 0; wc < CW; wc++)
      if (r0 + wc / a.C < a.m)
        cd[wc] = br::finish_cand(a, wc % a.C, in[wc], rate[wc]);
    for (int rl = 0; rl < rpw && r0 + rl < a.m; rl++) {
      const int64_t row = r0 + rl;
      const int win = br::decide_row(a, row, cd + rl * a.C, a.rf[a.m + row],
                                     a.rf[2 * a.m + row], ints, skip_diff);
      for (int j = 0; j < a.n; j++)
        y_out[row * a.n + j] =
            win >= 0 ? (int16_t)a.y_c[((int64_t)win * a.m + row) * a.n + j]
                     : 0;
    }
  }
}
#endif
