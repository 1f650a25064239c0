// The PVQ band search's arithmetic around its pulse search, one row (the
// prologue) or one candidate of a row (the epilogue) at a time, its lane
// loops through a policy (SerialLanes: one thread; the kernels' WarpLanes:
// a warp), shared by the CUDA kernels (csrc/band_search.cu) and a host
// build with g++ (tests/test_torch_band_plan.py), so that what the card
// runs is what the CPU tests hold bit for bit against the plain versions
// (ops/cuda/band_kernels.py band_prologue_plain, band_epilogue_plain).
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
PS_HD int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
PS_HD int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
PS_HD int64_t floordiv(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
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
PS_HD int64_t gain_compand(int64_t g, int64_t q0, bool b15) {
  if (!b15) return floordiv(256 * g + (q0 >> 1), q0);
  const int64_t expr = shl(od_pow(g, RCP_B15), 5);
  return floordiv(expr + (q0 >> 1), q0);
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
PS_HD int64_t compute_theta(int64_t t, int64_t mt) {
  t = imin(t, mt - 1);
  return mt != 0 ? floordiv(32768 * t + (mt >> 1), imax(mt, 1)) : 0;
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

// The lane loops of a row go through a policy: SerialLanes runs them in
// one thread (the host build); csrc/band_search.cu's WarpLanes spreads them
// over a warp, every lane running the row's scalar code alike.  Integer
// sums wrap, so they come out the same in any order; a first maximum is
// the largest value at its lowest index; the ordered float sums stay
// serial.
struct SerialLanes {
  // The wrapping sum of f(j) over j < n.
  template <typename F>
  PS_HD int64_t sum(int n, F f) const {
    int64_t s = 0;
    for (int j = 0; j < n; j++) s = add(s, f(j));
    return s;
  }
  template <typename F>
  PS_HD bool any(int n, F f) const {
    bool a = false;
    for (int j = 0; j < n; j++) a = a || f(j);
    return a;
  }
  // The lowest j at which f(j) (>= 0) is largest.
  template <typename F>
  PS_HD int argmax(int n, F f) const {
    int64_t best = -1;
    int at = 0;
    for (int j = 0; j < n; j++) {
      const int64_t v = f(j);
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
  // cs[j], j <= n: the wrapping sum of a(i) over i < j.  a(j) is read
  // before cs[j + 1] is written, so a may read it.
  template <typename F>
  PS_HD void prefix(int n, F a, int64_t *cs) const {
    cs[0] = 0;
    for (int j = 0; j < n; j++) {
      const int64_t v = a(j);
      cs[j + 1] = add(cs[j], v);
    }
  }
  // The float32 sums, e from 0 up, of the pairs f(e, &c1, &c2), e < span.
  template <typename F>
  PS_HD void chain(int span, F f, float *p1, float *p2) const {
    float a = 0.0f, b = 0.0f;
    for (int e = 0; e < span; e++) {
      float c1, c2;
      f(e, &c1, &c2);
      a = ps_add(a, c1);
      b = ps_add(b, c2);
    }
    *p1 = a;
    *p2 = b;
  }
  // The same sums in 8 lanes (span <= 32; band_kernels.py node_sum): lane
  // i sums e = i, i + 8, ... below 8 floor(span / 8), the lanes are halved
  // (i + 4, + 2, + 1), then the rest are added in order.
  // The lanes rotate through a[0] (constant indices keep them in
  // registers on the card): after 8 k elements lane i is back in a[i].
  template <typename F>
  PS_HD void lanes8(int span, F f, float *p1, float *p2) const {
    float a[8] = {}, b[8] = {};
    const int body = span & ~7;
    for (int e = 0; e < body; e++) {
      float c1, c2;
      f(e, &c1, &c2);
      const float na = ps_add(a[0], c1), nb = ps_add(b[0], c2);
      for (int i = 0; i < 7; i++) {
        a[i] = a[i + 1];
        b[i] = b[i + 1];
      }
      a[7] = na;
      b[7] = nb;
    }
    for (int i = 0; i < 4; i++) {
      a[i] = ps_add(a[i], a[i + 4]);
      b[i] = ps_add(b[i], b[i + 4]);
    }
    for (int i = 0; i < 2; i++) {
      a[i] = ps_add(a[i], a[i + 2]);
      b[i] = ps_add(b[i], b[i + 2]);
    }
    a[0] = ps_add(a[0], a[1]);
    b[0] = ps_add(b[0], b[1]);
    for (int e = body; e < span; e++) {
      float c1, c2;
      f(e, &c1, &c2);
      a[0] = ps_add(a[0], c1);
      b[0] = ps_add(b[0], c2);
    }
    *p1 = a[0];
    *p2 = b[0];
  }
};

// ---- the prologue of one row ----

// What the prologue writes for one row: the rows that the pulse search
// reads, once each (inter: the reflected row of the theta candidates,
// then the noref candidates' x16 row; keyframe: x16), with their lane
// flags, and for each of its C candidates (14 inter, 2 keyframe) the row
// it searches, [g2, sinp, dth, qcgf, trate] and [i, j, ok, k, ts, kk];
// then the row's [cgf, skip_dist, dist0].  Strides: the pulse-search row
// of group g at (g m + row) n; candidate c's row index at c m + row;
// candidate field f of candidate c at (f C + c) m + row.
struct Out {
  float *xs;
  uint8_t *lane_ok;
  int32_t *src;
  float *cf;
  int32_t *ci;
  float *rf;
  int64_t m, row;
  int C;
};

PS_HD void put_cand(const Out &o, int c, float g2, float sinp, float dth,
                    float qcgf, float trate, int64_t i, int64_t j, bool ok,
                    int64_t k, int64_t ts) {
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
// / noref square-root table entries of n.
template <typename Lanes>
PS_HD void prologue_row(const Lanes &L, int n, bool keyframe, float lam,
                        const int32_t *X, const int32_t *R,
                        const int32_t *QM, int64_t q0, bool b15, int64_t rt0,
                        int64_t rt1, const Out &o) {
  // vector_log_mag: the shifts that bring each vector to 16 bits.
  const int64_t xs_tot = L.sum(n, [&](int j) {
    const int64_t t = (int64_t)X[j] >> 8;
    return mul(t, t);
  });
  const int64_t rs_tot = L.sum(n, [&](int j) {
    const int64_t t = (int64_t)R[j] >> 8;
    return mul(t, t);
  });
  const bool any_r = L.any(n, [&](int j) { return R[j] != 0; });
  const int64_t xshift = imax(0, 9 + floordiv(ilog(n + xs_tot), 2) - 15);
  const int64_t rshift = imax(0, 9 + floordiv(ilog(n + rs_tot), 2) - 14);
  auto x16 = [&](int j) {
    return vshr_round(mul(X[j], QM[j]), 11 + xshift);
  };
  auto r16 = [&](int j) {
    return vshr_round(mul(R[j], QM[j]), 11 + rshift);
  };
  const int64_t accx = L.sum(n, [&](int j) { return mul(x16(j), x16(j)); });
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
    const int64_t accr =
        L.sum(n, [&](int j) { return mul(r16(j), r16(j)); });
    const int64_t corr_i =
        L.sum(n, [&](int j) { return mul(x16(j), r16(j)); });
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
    const int mpos = L.argmax(n, [&](int j) {
      const int64_t b = r16(j);
      return b < 0 ? -b : b;
    });
    const int64_t rm = r16(mpos);
    const int64_t bump = shr_round_v(mul(gr, rm > 0 ? 1 : -1), rshift);
    const int64_t rm_refl = wrap16(rm + bump);
    auto rr = [&](int j) { return j == mpos ? rm_refl : r16(j); };
    const int64_t l2r = L.sum(n, [&](int j) { return mul(rr(j), rr(j)); });
    const int64_t proj =
        L.sum(n, [&](int j) { return mul(rr(j), x16(j)); });
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
    o.src[(int64_t)c * o.m + o.row] =
        (int32_t)((nr ? (int64_t)(G - 1) * o.m : 0) + o.row);
  });
  if (L.leader()) {
    o.rf[o.row] = cgf;
    o.rf[o.m + o.row] = skip_dist;
    o.rf[2 * o.m + o.row] = dist0;
  }
}

// ---- the epilogue ----

// A node of the split tree, as band_kernels.py node_table packs it.
struct Node {
  int32_t base, size, parent, k1off, szctx7, tot1;
};

// The two costs of node v (c1: a k = 1 leaf's, c2: a split's; at most one
// is not zero) from the prefix sums cs of the row's pulse magnitudes and
// the k1 and split CDF tables (the k1 table's last index last1; the split
// table w2 wide, rows2 rows).  The node codes when it holds pulses, spans
// more than one lane, and none of its ancestors ends coding: holds no
// pulse, or one in at most 16 lanes.
PS_HD void node_cost(const Node *nodes, int v, const int64_t *cs,
                     const int32_t *k1, int64_t last1, const int32_t *sp,
                     int w2, int rows2, float *c1, float *c2) {
  const float c = log2e();
  const Node nd = nodes[v];
  const int64_t kn = cs[nd.base + nd.size] - cs[nd.base];
  *c1 = 0.0f;
  *c2 = 0.0f;
  if (kn <= 0 || nd.size <= 1) return;
  // Going up the tree, spans and pulse counts only grow: an ancestor holds
  // pulses, and can hold just one only when this node does, and then the
  // parent is the nearest that can span at most 16 lanes.
  if (kn == 1 && nd.parent >= 0) {
    const Node p = nodes[nd.parent];
    if (p.size <= 16 && cs[p.base + p.size] - cs[p.base] == 1) return;
  }
  const bool is_k1 = kn == 1 && nd.size <= 16;
  // A k = 1 leaf codes its pulse's position from its k1 CDF row; a split
  // codes its right half's count (its top bits) from a split CDF row, and
  // the rest raw.  Both cost log2(total) - log2(the symbol's range).
  int64_t shift = 0, sym;
  const int32_t *cdf;
  int64_t last;
  float tot;
  if (is_k1) {
    // The position of its one pulse: the lanes q >= 1 before which the
    // node holds no pulse.
    sym = 0;
    for (int q = 1; q < 16; q++)
      sym += q < nd.size && cs[nd.base + q] == cs[nd.base] ? 1 : 0;
    tot = (float)k1[nd.tot1];
    cdf = k1 + nd.k1off;
    last = last1 - nd.k1off;
  } else {
    const int64_t count_right =
        cs[nd.base + nd.size] - cs[nd.base + (nd.size >> 1)];
    shift = imax(ilog(kn) - 3, 0);
    sym = count_right >> shift;
    const int64_t t_red = kn >> shift;
    const int64_t fctx = imin(imax(nd.szctx7 + t_red - 1, 0), rows2 - 1);
    cdf = sp + fctx * w2;
    last = w2 - 1;
    tot = (float)cdf[imin(t_red, last)];
  }
  const float hi = (float)cdf[imin(sym, last)];
  const float lo = sym > 0 ? (float)cdf[imin(imax(sym - 1, 0), last)] : 0.0f;
  const float pr = sub(hi, lo);
  const float lt = log(tot < 1.0f ? 1.0f : tot);
  const float lp = log(pr < 1.0f ? 1.0f : pr);
  if (is_k1)
    *c1 = ps_fma32(-lp, c, ps_mul(lt, c));
  else
    *c2 = ps_add(ps_fma32(lt, c, -ps_mul(lp, c)), (float)shift);
}

// The codeword rate of one row of pulses y (n lanes, the first n_tree
// coded) over the NN nodes of its split tree (preorder), through the lane
// policy L; y(j): the pulse at lane j (int64).  cs: scratch of n + 1
// (y may read cs[j + 1]: it is read before it is written).
template <typename Lanes, typename Y>
PS_HD float codeword_rate(const Lanes &L, Y y, int n, int n_tree,
                          const Node *nodes, int NN, const int32_t *k1,
                          int64_t last1, const int32_t *sp, int w2,
                          int rows2, int64_t *cs) {
  L.prefix(n, [&](int j) -> int64_t {
    const int64_t v = y(j);
    return j < n_tree ? (v < 0 ? -v : v) : 0;
  }, cs);
  auto cost = [&](int v, float *c1, float *c2) {
    node_cost(nodes, v, cs, k1, last1, sp, w2, rows2, c1, c2);
  };
  float sum1 = 0.0f, sum2 = 0.0f;
  // XLA's node sums: one chain below 16 nodes, 8 lanes from 16 to 32, else
  // chunks of 32 with pad // 2 zeros in front, then the chunks' sums in
  // order.
  if (NN >= 16 && NN <= 32) {
    L.lanes8(NN, cost, &sum1, &sum2);
    return ps_add(sum1, sum2);
  }
  const int nc = NN <= 32 ? 1 : (NN + 31) / 32;
  const int span = NN <= 32 ? NN : 32;
  const int lead = NN <= 32 ? 0 : (nc * 32 - NN) / 2;
  for (int ch = 0; ch < nc; ch++) {
    float p1, p2;
    L.chain(span, [&](int e, float *c1, float *c2) {
      const int v = ch * 32 + e - lead;
      if (v >= 0 && v < NN) {
        cost(v, c1, c2);
      } else {
        *c1 = 0.0f;
        *c2 = 0.0f;
      }
    }, &p1, &p2);
    sum1 = ps_add(sum1, p1);
    sum2 = ps_add(sum2, p2);
  }
  return ps_add(sum1, sum2);
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
      const int64_t v = j < n ? y(j) : 0;
      const float ya = (float)(v < 0 ? -v : v);
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

// A candidate's distortion for the cost, and the one XLA keeps as the best
// (the keyframe fusion that keeps it contracts the other product).
PS_HD void cand_dist(bool isnr, bool keyframe, float cos_dist, float sinp,
                     float dth, float qcgf, float cgf, float *dist,
                     float *kept) {
  float t = sub(2.0f, ps_mul(2.0f, cos_dist));
  if (!isnr) t = ps_fma32(sinp, t, dth);
  const float dq = sub(qcgf, cgf);
  const float sq = ps_mul(dq, dq), qc = ps_mul(qcgf, cgf);
  *dist = ps_mul(ps_fma32(sq, gw(), ps_mul(qc, t)), INV_CS2);
  *kept = keyframe ? ps_mul(ps_fma32(t, qc, ps_mul(gw(), sq)), INV_CS2)
                   : *dist;
}

// JAX's scan over a row's C candidates (band_kernels.py _select): the best
// cost starts at best_cost (the initial candidate, -1), and candidate c in
// order replaces it when ok(c) and cost(c) is below it (theta) or not above
// it (noref, the last two); a NaN compares false.  *win: the last to
// replace it.  *win_y: the last c whose cost_y(c) passes the same test
// against the best cost before c: the fusion that carries JAX's pulses
// computes the cost its own way (see epilogue_cand).
template <typename Cost, typename CostY, typename Ok>
PS_HD void select(float best_cost, int C, Cost cost, CostY cost_y, Ok ok,
                  int *win, int *win_y) {
  float b = best_cost;
  *win = -1;
  *win_y = -1;
  for (int c = 0; c < C; c++) {
    if (!ok(c)) continue;
    const bool nr = c >= C - 2;
    const float v = cost(c), vy = cost_y(c);
    if (nr ? vy <= b : vy < b) *win_y = c;
    if (nr ? v <= b : v < b) {
      b = v;
      *win = c;
    }
  }
}

// What the epilogue reads: the pulse search's result on the prologue's
// rows (y_c (C m, n), cos_dist and ok_p (C m)), the prologue's cf, ci and
// rf, the split trees of n - 1 (theta) and n (noref) lanes, the CDF tables
// (use_cdf false: the fast rate model), and the call's constants.
struct EpiIn {
  const int32_t *y_c;
  const float *cos_dist;
  const uint8_t *ok_p;
  const float *cf;
  const int32_t *ci;
  const float *rf;
  const Node *nodes_th, *nodes_nr;
  int nn_th, nn_nr;
  const int32_t *k1, *sp;
  int64_t last1;
  int w2, rows2;
  bool use_cdf, keyframe;
  int64_t m;
  int n, C;
  float lam;
};

PS_HD float epi_f(const EpiIn &a, int f, int c, int64_t row) {
  return a.cf[((int64_t)f * a.C + c) * a.m + row];
}
PS_HD int32_t epi_i(const EpiIn &a, int f, int c, int64_t row) {
  return a.ci[((int64_t)f * a.C + c) * a.m + row];
}

// Candidate c of a row, through the lane policy L: its cost, the cost by
// which JAX's pulses are selected, the distortion XLA keeps, and whether it
// is ok.  XLA:CPU contracts dist + lam rate into fma(lam, rate, dist)
// everywhere but in the inter fusion that carries the pulses, which rounds
// lam rate first.  y: its n pulses (row c m + row of y_c, or a copy), as
// y(j) (int64); cs: scratch of n + 1 (y may read cs[j + 1]: codeword_rate
// reads it before it writes it).
template <typename Lanes, typename Y>
PS_HD void epilogue_cand(const Lanes &L, const EpiIn &a, int64_t row, int c,
                         Y y, int64_t *cs, float *cost, float *cost_y,
                         float *kept, bool *ok) {
  const bool isnr = c >= a.C - 2;
  const int64_t rc = (int64_t)c * a.m + row;
  float rate;
  if (a.use_cdf)
    rate = codeword_rate(L, y, a.n, isnr ? a.n : a.n - 1,
                         isnr ? a.nodes_nr : a.nodes_th,
                         isnr ? a.nn_nr : a.nn_th, a.k1, a.last1, a.sp,
                         a.w2, a.rows2, cs);
  else
    rate = fast_rate(y, a.n, isnr ? a.n : a.n - 1, epi_i(a, 3, c, row));
  rate = ps_add(rate, isnr ? 0.0f : epi_f(a, 4, c, row));
  float dist;
  cand_dist(isnr, a.keyframe, a.cos_dist[rc], epi_f(a, 1, c, row),
            epi_f(a, 2, c, row), epi_f(a, 3, c, row), a.rf[row], &dist, kept);
  *cost = ps_fma32(rate, a.lam, dist);
  *cost_y = a.keyframe ? *cost : ps_add(dist, ps_mul(rate, a.lam));
  *ok = epi_i(a, 2, c, row) != 0;
}

// The row's decision from its candidates' cost(c), cost_y(c), kept(c),
// ok(c) and the pulse search's ok_p: writes ints (6 int32) and skip_diff;
// returns the candidate whose pulses are the row's (-1: the initial
// candidate's zeros).
template <typename Cost, typename CostY, typename Kept, typename Ok>
PS_HD int epilogue_row(const EpiIn &a, int64_t row, Cost cost, CostY cost_y,
                       Kept kept, Ok ok, int32_t *ints, float *skip_diff) {
  const float dist0 = a.rf[2 * a.m + row];
  int win, win_y;
  select(dist0, a.C, cost, cost_y, ok, &win, &win_y);
  bool valid = true;
  for (int c = 0; c < a.C; c++)
    if (ok(c) && !a.ok_p[(int64_t)c * a.m + row]) valid = false;
  const bool sel = win >= 0;
  const int64_t best_k = sel ? epi_i(a, 3, win, row) : 0;
  valid = valid && best_k <= 32767;
  int32_t *o = ints + row * 6;
  o[0] = sel ? (win >= a.C - 2 ? 1 : 0) : (a.keyframe ? 1 : 0);
  o[1] = sel ? epi_i(a, 0, win, row) : 0;
  o[2] = sel ? epi_i(a, 1, win, row) : (a.keyframe ? -1 : 0);
  o[3] = sel ? epi_i(a, 4, win, row) : 0;
  o[4] = (int32_t)best_k;
  o[5] = valid ? 1 : 0;
  skip_diff[row] = sub(a.rf[a.m + row], sel ? kept(win) : dist0);
  return win_y;
}

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
  const br::Out base{xs, lane_ok, src, cf, ci, rf, m, 0, keyframe ? 2 : 14};
  for (int r = 0; r < m; r++) {
    br::Out o = base;
    o.row = r;
    br::prologue_row(br::SerialLanes(), n, keyframe, lam, X + (size_t)r * n,
                     R + (size_t)r * n, QM + (size_t)r * n, q0[r],
                     b15[r] != 0, rt0, rt1, o);
  }
}

inline void br_epilogue_host(const br::EpiIn &a, int32_t *ints,
                             int16_t *y_out, float *skip_diff) {
  int64_t cs[129];
  float cost[14], cost_y[14], kept[14];
  bool ok[14];
  for (int64_t r = 0; r < a.m; r++) {
    for (int c = 0; c < a.C; c++) {
      const int32_t *y = a.y_c + ((int64_t)c * a.m + r) * a.n;
      br::epilogue_cand(br::SerialLanes(), a, r, c,
                        [&](int j) { return (int64_t)y[j]; }, cs, &cost[c],
                        &cost_y[c], &kept[c], &ok[c]);
    }
    const int win = br::epilogue_row(
        a, r, [&](int c) { return cost[c]; }, [&](int c) { return cost_y[c]; },
        [&](int c) { return kept[c]; }, [&](int c) { return ok[c]; }, ints,
        skip_diff);
    for (int j = 0; j < a.n; j++)
      y_out[r * a.n + j] =
          win >= 0 ? (int16_t)a.y_c[((int64_t)win * a.m + r) * a.n + j] : 0;
  }
}
#endif
