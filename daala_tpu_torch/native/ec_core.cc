// Native range-coder core for daala-tpu.
//
// C++ implementation of the Daala-compatible multisymbol range coder,
// written from this project's Python reference implementation
// (daala_tpu/entropy/ec.py) and validated byte-for-byte against it by
// differential fuzzing (tests/test_ec_native.py).  Behavioral parity
// target: src/entenc.c, src/entdec.c, src/entcode.c of the upstream
// reference (15-bit probabilities, carry-less pre-carry buffer, raw bits
// written backward from the stream end, reduced-overhead partition).
//
// Exposed as a flat extern "C" API consumed via ctypes (no pybind11 in
// this environment).  All handles are opaque pointers; buffers grow
// automatically.

#include <climits>
#include <chrono>
#include <cstdio>
double g_prof_pvq = 0, g_prof_rate = 0, g_prof_snap = 0;
double g_prof_dct = 0, g_prof_dering = 0, g_prof_dist = 0, g_prof_filt = 0;
double g_prof_me_glob = 0, g_prof_me_full = 0, g_prof_me_mesh = 0,
       g_prof_me_refine = 0, g_prof_me_pred = 0, g_prof_me_sad = 0;
double g_prof_pvq_search = 0, g_prof_pvq_rate = 0;
double g_prof_blk = 0, g_prof_haardc = 0, g_prof_reorder = 0;
// Stage timers are compiled out by default (build with -DFC_PROF=1 to
// enable; the chrono calls are measurable on per-block paths).
#ifndef FC_PROF
# define FC_PROF 0
#endif
static inline double now_s() {
#if FC_PROF
  return std::chrono::duration<double>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
#else
  return 0.0;
#endif
}

#if defined(__AVX2__)
# include <immintrin.h>
#endif
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kWindowSize = 32;
constexpr int kUintBits = 4;   // OD_EC_UINT_BITS
constexpr int kBitres = 3;     // OD_BITRES
constexpr int32_t kLotsOfBits = 0x4000;

inline int ilog_z(uint32_t x) { return x == 0 ? 0 : 32 - __builtin_clz(x); }

inline uint32_t subsatu(uint32_t a, uint32_t b) { return a - (a < b ? a : b); }

inline uint32_t partition_fn(uint32_t f, uint32_t d, uint32_t e) {
  uint32_t me = f < e ? f : e;
  uint32_t sd = subsatu(f, e) >> 1;
  return f + me + (sd < d ? sd : d);
}

// The uniform Q15 CDFs for sizes 2..16, installed from Python at startup
// (the normative table OD_UNIFORM_CDFS_Q15).
static int32_t g_uniform[17][17];
static bool g_uniform_set = false;

struct EcEnc {
  uint32_t low = 0;
  uint32_t rng = 0x8000;
  int32_t cnt = -9;
  std::vector<uint16_t> precarry;
  uint32_t end_window = 0;
  int32_t nend_bits = 0;
  std::vector<uint8_t> end_bytes;
  int32_t error = 0;

  void normalize(uint32_t l, uint32_t r) {
    int32_t c = cnt;
    int d = 16 - ilog_z(r);
    int32_t s = c + d;
    if (s >= 0) {
      c += 16;
      uint32_t m = (1u << c) - 1;
      if (s >= 8) {
        precarry.push_back((uint16_t)((l >> c) & 0xFFFF));
        l &= m;
        c -= 8;
        m >>= 8;
      }
      precarry.push_back((uint16_t)((l >> c) & 0xFFFF));
      s = c + d - 24;
      l &= m;
    }
    low = l << d;
    rng = (r << d) & 0xFFFF;
    cnt = s;
  }

  void encode(uint32_t fl, uint32_t fh, uint32_t ft) {
    uint32_t l = low, r = rng;
    int s = (r - ft >= ft) ? 1 : 0;
    ft <<= s; fl <<= s; fh <<= s;
    uint32_t d = r - ft;
    uint32_t e = subsatu(2 * d, ft);
    uint32_t u = partition_fn(fl, d, e);
    uint32_t v = partition_fn(fh, d, e);
    normalize(l + u, v - u);
  }

  void encode_q15(uint32_t fl, uint32_t fh) {
    uint32_t l = low, r = rng;
    uint32_t u = (fl * r) >> 15;
    uint32_t v = (fh * r) >> 15;
    normalize(l + u, v - u);
  }

  void encode_unscaled(uint32_t fl, uint32_t fh, uint32_t ft) {
    int s = 15 - ilog_z(ft - 1);
    encode(fl << s, fh << s, ft << s);
  }

  void encode_bool_q15(int val, uint32_t fz) {
    uint32_t r = rng;
    uint32_t v = (fz * r) >> 15;
    uint32_t l = low + (val ? v : 0);
    normalize(l, val ? r - v : v);
  }

  void encode_bits(uint32_t fl, int ftb) {
    uint32_t ew = end_window;
    int32_t ne = nend_bits;
    if (ne + ftb > kWindowSize) {
      while (ne >= 8) {
        end_bytes.push_back((uint8_t)(ew & 0xFF));
        ew >>= 8;
        ne -= 8;
      }
    }
    ew |= fl << ne;
    ne += ftb;
    end_window = ew;
    nend_bits = ne;
  }

  void encode_uint(uint32_t fl, uint32_t ft) {
    if (ft > (1u << kUintBits)) {
      ft--;
      int ftb = ilog_z(ft) - kUintBits;
      uint32_t ft1 = (ft >> ftb) + 1;
      uint32_t s = fl >> ftb;
      const int32_t *cdf = g_uniform[ft1];
      encode_q15(s > 0 ? (uint32_t)cdf[s - 1] : 0, (uint32_t)cdf[s]);
      encode_bits(fl & ((1u << ftb) - 1), ftb);
    } else {
      const int32_t *cdf = g_uniform[ft];
      encode_q15(fl > 0 ? (uint32_t)cdf[fl - 1] : 0, (uint32_t)cdf[fl]);
    }
  }

  void patch_initial_bits(uint32_t val, int nbits) {
    int shift = 8 - nbits;
    uint32_t mask = ((1u << nbits) - 1) << shift;
    if (!precarry.empty()) {
      precarry[0] = (uint16_t)((precarry[0] & ~mask) | (val << shift));
    } else if (9 + cnt + (rng == 0x8000 ? 1 : 0) > nbits) {
      low = (low & ~(mask << (16 + cnt))) | (val << (16 + cnt + shift));
    } else {
      error = -1;
    }
  }

  int tell() const {
    return (int)((precarry.size() + end_bytes.size()) * 8) + cnt +
           nend_bits + 10;
  }

  // done() writes into out (caller sizes it via done_size upper bound).
  int done(uint8_t *out) {
    uint32_t l = low, r = rng;
    int32_t c = cnt;
    int32_t s = 9;
    uint32_t m = 0x7FFF;
    uint32_t e = (l + m) & ~m;
    while ((e | m) >= l + r) {
      s++;
      m >>= 1;
      e = (l + m) & ~m;
    }
    s += c;
    std::vector<uint16_t> pc = precarry;
    if (s > 0) {
      uint32_t n = (1u << (c + 16)) - 1;
      do {
        pc.push_back((uint16_t)((e >> (c + 16)) & 0xFFFF));
        e &= n;
        s -= 8;
        c -= 8;
        n >>= 8;
      } while (s > 0);
    }
    uint32_t ew = end_window;
    int32_t ne = nend_bits;
    std::vector<uint8_t> eb = end_bytes;
    int32_t neg_s = -s;
    while (ne > neg_s) {
      eb.push_back((uint8_t)(ew & 0xFF));
      ew >>= 8;
      ne -= 8;
    }
    size_t np = pc.size();
    uint32_t carry = 0;
    for (size_t i = np; i-- > 0;) {
      uint32_t v = pc[i] + carry;
      out[i] = (uint8_t)(v & 0xFF);
      carry = v >> 8;
    }
    if (ne > 0 && np > 0) out[np - 1] |= (uint8_t)(ew & 0xFF);
    size_t pos = np;
    for (size_t i = eb.size(); i-- > 0;) out[pos++] = eb[i];
    return (int)pos;
  }
};

struct EcDec {
  const uint8_t *buf;
  int32_t len;
  int32_t bpos = 0;
  int32_t epos;
  uint32_t end_window = 0;
  int32_t nend_bits = 0;
  int32_t tell_offs;
  uint32_t dif = 0;
  uint32_t rng = 0x8000;
  int32_t cnt = -15;
  int32_t error = 0;

  EcDec(const uint8_t *b, int32_t n) : buf(b), len(n), epos(n) {
    tell_offs = 10 - (kWindowSize - 8);
    refill();
  }

  void refill() {
    int32_t s = kWindowSize - 9 - (cnt + 15);
    while (s >= 0 && bpos < len) {
      dif |= (uint32_t)buf[bpos] << s;
      cnt += 8;
      bpos++;
      s -= 8;
    }
    if (bpos >= len) {
      tell_offs += kLotsOfBits - cnt;
      cnt = kLotsOfBits;
    }
  }

  int normalize(uint32_t d, uint32_t r, int ret) {
    int dd = 16 - ilog_z(r);
    cnt -= dd;
    dif = d << dd;
    rng = r << dd;
    if (cnt < 0) refill();
    return ret;
  }

  int decode_bool_q15(uint32_t fz) {
    uint32_t d = dif, r = rng;
    uint32_t v = (fz * r) >> 15;
    uint32_t vw = v << (kWindowSize - 16);
    if (d >= vw) return normalize(d - vw, r - v, 1);
    return normalize(d, v, 0);
  }

  int decode_cdf_dyadic(const int32_t *cdf, int ftb) {
    uint32_t d = dif, r = rng;
    uint32_t c = d >> (kWindowSize - 16);
    uint32_t v = 0, u;
    int ret = -1;
    do {
      u = v;
      ret++;
      v = ((uint32_t)cdf[ret] * r) >> ftb;
    } while (v <= c);
    return normalize(d - (u << (kWindowSize - 16)), v - u, ret);
  }

  int decode_cdf(const int32_t *cdf, int n) {
    uint32_t d0 = dif, r = rng;
    uint32_t ft = (uint32_t)cdf[n - 1];
    int s = (r - ft >= ft) ? 1 : 0;
    ft <<= s;
    uint32_t d = r - ft;
    uint32_t c = d0 >> (kWindowSize - 16);
    // Signed intermediates: c - d and 2c + 1 - e can go negative and must
    // lose the max() (the Python reference uses arbitrary-precision ints).
    int64_t q = c >> 1;
    if ((int64_t)c - d > q) q = (int64_t)c - d;
    uint32_t e = subsatu(2 * d, ft);
    int64_t q2 = ((int64_t)2 * c + 1 - e);
    q2 = q2 >= 0 ? q2 / 3 : -((-q2 + 2) / 3);  // floor division
    if (q2 > q) q = q2;
    q >>= s;
    uint32_t fl = 0;
    int ret = 0;
    uint32_t fh = (uint32_t)cdf[0];
    while ((int64_t)fh <= q) {
      fl = fh;
      ret++;
      fh = (uint32_t)cdf[ret];
    }
    fl <<= s;
    fh <<= s;
    uint32_t u = partition_fn(fl, d, e);
    uint32_t v = partition_fn(fh, d, e);
    return normalize(d0 - (u << (kWindowSize - 16)), v - u, ret);
  }

  int decode_cdf_unscaled(const int32_t *cdf, int n) {
    uint32_t d0 = dif, r = rng;
    uint32_t ft = (uint32_t)cdf[n - 1];
    int s = 15 - ilog_z(ft - 1);
    ft <<= s;
    if (r - ft >= ft) {
      ft <<= 1;
      s++;
    }
    uint32_t d = r - ft;
    uint32_t c = d0 >> (kWindowSize - 16);
    int64_t q = c >> 1;
    if ((int64_t)c - d > q) q = (int64_t)c - d;
    uint32_t e = subsatu(2 * d, ft);
    int64_t q2 = ((int64_t)2 * c + 1 - e);
    q2 = q2 >= 0 ? q2 / 3 : -((-q2 + 2) / 3);
    if (q2 > q) q = q2;
    q >>= s;
    uint32_t fl = 0;
    int ret = 0;
    uint32_t fh = (uint32_t)cdf[0];
    while ((int64_t)fh <= q) {
      fl = fh;
      ret++;
      fh = (uint32_t)cdf[ret];
    }
    fl <<= s;
    fh <<= s;
    uint32_t u = partition_fn(fl, d, e);
    uint32_t v = partition_fn(fh, d, e);
    return normalize(d0 - (u << (kWindowSize - 16)), v - u, ret);
  }

  uint32_t decode_bits(int ftb) {
    uint32_t window = end_window;
    int32_t available = nend_bits;
    if (available < ftb) {
      while (available <= kWindowSize - 8) {
        if (epos <= 0) {
          tell_offs += kLotsOfBits - available;
          available = kLotsOfBits;
          break;
        }
        epos--;
        window |= (uint32_t)buf[epos] << available;
        available += 8;
      }
    }
    uint32_t ret = window & ((1u << ftb) - 1);
    window >>= ftb;
    available -= ftb;
    end_window = window;
    nend_bits = available;
    return ret;
  }

  uint32_t decode_uint(uint32_t ft) {
    if (ft > (1u << kUintBits)) {
      ft--;
      int ftb = ilog_z(ft) - kUintBits;
      uint32_t ft1 = (ft >> ftb) + 1;
      uint32_t t = (uint32_t)decode_cdf_dyadic(g_uniform[ft1], 15);
      t = (t << ftb) | decode_bits(ftb);
      if (t <= ft) return t;
      error = 1;
      return ft;
    }
    return (uint32_t)decode_cdf_dyadic(g_uniform[ft], 15);
  }

  int tell() const {
    return (int)((len - epos) + bpos) * 8 - cnt - nend_bits + tell_offs;
  }
};

int tell_frac_impl(int nbits_total, uint32_t rng) {
  int nbits = nbits_total << kBitres;
  int l = 0;
  for (int i = 0; i < kBitres; i++) {
    rng = (rng * rng) >> 15;
    int b = (int)(rng >> 16);
    l = (l << 1) | b;
    rng >>= b;
  }
  return nbits - l;
}

}  // namespace

extern "C" {

void ec_set_uniform_cdfs(const int32_t *flat) {
  int pos = 0;
  for (int n = 2; n <= 16; n++) {
    for (int i = 0; i < n; i++) g_uniform[n][i] = flat[pos++];
  }
  g_uniform_set = true;
}

// ---- encoder ----
void *ec_enc_new() { return new EcEnc(); }
void ec_enc_free(void *h) { delete (EcEnc *)h; }
void ec_enc_reset(void *h) { *(EcEnc *)h = EcEnc(); }
void ec_encode(void *h, int fl, int fh, int ft) {
  ((EcEnc *)h)->encode(fl, fh, ft);
}
void ec_encode_q15(void *h, int fl, int fh) {
  ((EcEnc *)h)->encode_q15(fl, fh);
}
void ec_encode_unscaled(void *h, int fl, int fh, int ft) {
  ((EcEnc *)h)->encode_unscaled(fl, fh, ft);
}
void ec_encode_bool_q15(void *h, int val, int fz) {
  ((EcEnc *)h)->encode_bool_q15(val, fz);
}
void ec_encode_cdf_q15(void *h, int s, const int32_t *cdf) {
  EcEnc *e = (EcEnc *)h;
  e->encode_q15(s > 0 ? (uint32_t)cdf[s - 1] : 0, (uint32_t)cdf[s]);
}
void ec_encode_cdf_unscaled(void *h, int s, const int32_t *cdf, int n) {
  EcEnc *e = (EcEnc *)h;
  e->encode_unscaled(s > 0 ? (uint32_t)cdf[s - 1] : 0, (uint32_t)cdf[s],
                     (uint32_t)cdf[n - 1]);
}
void ec_enc_uint(void *h, unsigned fl, unsigned ft) {
  ((EcEnc *)h)->encode_uint(fl, ft);
}
void ec_enc_bits(void *h, unsigned fl, int ftb) {
  ((EcEnc *)h)->encode_bits(fl, ftb);
}
void ec_enc_patch_initial_bits(void *h, unsigned val, int nbits) {
  ((EcEnc *)h)->patch_initial_bits(val, nbits);
}
int ec_enc_tell(void *h) { return ((EcEnc *)h)->tell(); }
int ec_enc_tell_frac(void *h) {
  EcEnc *e = (EcEnc *)h;
  return tell_frac_impl(e->tell(), e->rng);
}
int ec_enc_done_size(void *h) {
  EcEnc *e = (EcEnc *)h;
  return (int)(e->precarry.size() + e->end_bytes.size()) + 16;
}
int ec_enc_done(void *h, uint8_t *out) { return ((EcEnc *)h)->done(out); }
int ec_enc_error(void *h) { return ((EcEnc *)h)->error; }

// checkpoint: pack state into a caller buffer of 8 int64s.
void ec_enc_checkpoint(void *h, int64_t *cp) {
  EcEnc *e = (EcEnc *)h;
  cp[0] = e->low;
  cp[1] = e->rng;
  cp[2] = e->cnt;
  cp[3] = (int64_t)e->precarry.size();
  cp[4] = e->end_window;
  cp[5] = e->nend_bits;
  cp[6] = (int64_t)e->end_bytes.size();
  cp[7] = e->error;
}
void ec_enc_rollback(void *h, const int64_t *cp) {
  EcEnc *e = (EcEnc *)h;
  e->low = (uint32_t)cp[0];
  e->rng = (uint32_t)cp[1];
  e->cnt = (int32_t)cp[2];
  e->precarry.resize((size_t)cp[3]);
  e->end_window = (uint32_t)cp[4];
  e->nend_bits = (int32_t)cp[5];
  e->end_bytes.resize((size_t)cp[6]);
  e->error = (int32_t)cp[7];
}

// ---- decoder ----
void *ec_dec_new(const uint8_t *buf, int len) {
  // The decoder borrows the caller's buffer; the Python wrapper keeps the
  // bytes object alive for the decoder's lifetime.
  return new EcDec(buf, len);
}
void ec_dec_free(void *h) { delete (EcDec *)h; }
int ec_decode_bool_q15(void *h, int fz) {
  return ((EcDec *)h)->decode_bool_q15(fz);
}
int ec_decode_cdf_q15(void *h, const int32_t *cdf) {
  return ((EcDec *)h)->decode_cdf_dyadic(cdf, 15);
}
int ec_decode_cdf(void *h, const int32_t *cdf, int n) {
  return ((EcDec *)h)->decode_cdf(cdf, n);
}
int ec_decode_cdf_unscaled(void *h, const int32_t *cdf, int n) {
  return ((EcDec *)h)->decode_cdf_unscaled(cdf, n);
}
unsigned ec_dec_uint(void *h, unsigned ft) {
  return ((EcDec *)h)->decode_uint(ft);
}
unsigned ec_dec_bits(void *h, int ftb) { return ((EcDec *)h)->decode_bits(ftb); }
int ec_dec_tell(void *h) { return ((EcDec *)h)->tell(); }
int ec_dec_tell_frac(void *h) {
  EcDec *d = (EcDec *)h;
  return tell_frac_impl(d->tell(), d->rng);
}
int ec_dec_error(void *h) { return ((EcDec *)h)->error; }
void ec_dec_set_error(void *h, int v) { ((EcDec *)h)->error = v; }

int ec_tell_frac(int nbits_total, unsigned rng) {
  return tell_frac_impl(nbits_total, rng);
}

// ---- PVQ codeword coder -----------------------------------------------
// Recursive binary pulse-count splitting with adaptive CDFs; written from
// this project's Python implementation (daala_tpu/codec/pvq_codec.py:39-131,
// behavioral parity: src/laplace_encoder.c:38-80).  The rate entry point
// runs the whole measurement (scratch coder + scratch CDFs) in one call —
// this is the encoder's innermost RDO loop.

static void cdf_adapt_enc(EcEnc *e, int val, int32_t *cdf, int n,
                          int inc) {
  e->encode_unscaled(val > 0 ? (uint32_t)cdf[val - 1] : 0,
                     (uint32_t)cdf[val], (uint32_t)cdf[n - 1]);
  if (cdf[n - 1] + inc > 32767) {
    for (int i = 0; i < n; i++) cdf[i] = (cdf[i] >> 1) + i + 1;
  }
  for (int i = val; i < n; i++) cdf[i] += inc;
}

// ---- adaptation undo journal -------------------------------------------
// High-frequency encoder checkpoints (the per-block PVQ skip RDO and the
// late block-skip RDO) used to memcpy the entire ~28KB adaptation state;
// a block only touches a handful of CDF rows, so the native frame encoder
// records old values at each mutation site instead and replays them in
// reverse on rollback.  Spans nest (pvq-skip inside late-skip): each span
// remembers the journal marks at open.  The full-snapshot path remains
// for the block-size RDO merge (which needs roll-FORWARD restores).
struct AdaptJournal {
  struct Row {
    int32_t *p;
    int32_t v[16];
    int32_t n;
  };
  struct E64 {
    int64_t *p;
    int64_t v;
  };
  std::vector<Row> rows;
  std::vector<E64> e64;
  int depth = 0;
};

static thread_local AdaptJournal *g_adapt_journal = nullptr;

static inline void jr_row(int32_t *p, int n) {
  AdaptJournal *j = g_adapt_journal;
  if (!j || !j->depth) return;
  j->rows.emplace_back();
  AdaptJournal::Row &r = j->rows.back();
  r.p = p;
  r.n = n;
  std::memcpy(r.v, p, (size_t)n * sizeof(int32_t));
}

static inline void jr_64(int64_t *p) {
  AdaptJournal *j = g_adapt_journal;
  if (!j || !j->depth) return;
  j->e64.push_back({p, *p});
}

static inline void jr_rollback(AdaptJournal &j, size_t r0, size_t e0) {
  for (size_t i = j.rows.size(); i > r0; i--) {
    AdaptJournal::Row &r = j.rows[i - 1];
    std::memcpy(r.p, r.v, (size_t)r.n * sizeof(int32_t));
  }
  j.rows.resize(r0);
  for (size_t i = j.e64.size(); i > e0; i--) {
    *j.e64[i - 1].p = j.e64[i - 1].v;
  }
  j.e64.resize(e0);
}

static inline void jr_commit(AdaptJournal &j) {
  if (--j.depth == 0) {
    j.rows.clear();
    j.e64.clear();
  }
}

static inline int pvq_size_ctx(int n) {
  int logn = ilog_z((uint32_t)(n - 1));
  int odd = n & 1;
  return 2 * logn - 1 - odd - 7 * (n == 14);
}

static inline int pvq_k1_ctx(int n, int orig) {
  return orig ? 8 + 2 * (n > 8) + (n & 1) : pvq_size_ctx(n);
}

struct PvqCwCtx {
  int32_t *k1_cdf;     // 12 rows x 16
  int32_t *split_cdf;  // 98 rows x 8
  int32_t k1_inc, split_inc;
  // Lazy per-row copy-on-read for the rate simulation: when src/epoch
  // pointers are set, a row is copied from the live CDFs into the
  // scratch arrays the first time this call touches it (stale rows from
  // earlier calls are detected by epoch).  Real coding leaves these
  // null and mutates the live CDFs directly.
  const int32_t *k1_src = nullptr, *sp_src = nullptr;
  uint32_t *k1_ep = nullptr, *sp_ep = nullptr;
  uint32_t epoch = 0;
};

static inline int32_t *cw_k1_row(PvqCwCtx *c, int id) {
  int32_t *row = c->k1_cdf + 16 * id;
  if (c->k1_ep) {
    if (c->k1_ep[id] != c->epoch) {
      std::memcpy(row, c->k1_src + 16 * id, 16 * sizeof(int32_t));
      c->k1_ep[id] = c->epoch;
    }
  } else {
    // Real coding (not the COW rate simulation): live rows are about to
    // be adapted — journal them for the RDO checkpoint spans.
    jr_row(row, 16);
  }
  return row;
}

static inline int32_t *cw_sp_row(PvqCwCtx *c, int fctx) {
  int32_t *row = c->split_cdf + 8 * fctx;
  if (c->sp_ep) {
    if (c->sp_ep[fctx] != c->epoch) {
      std::memcpy(row, c->sp_src + 8 * fctx, 8 * sizeof(int32_t));
      c->sp_ep[fctx] = c->epoch;
    }
  } else {
    jr_row(row, 8);
  }
  return row;
}

static void enc_pvq_split(EcEnc *e, PvqCwCtx *c, int count, int total,
                          int ctx) {
  if (total == 0) return;
  int shift = ilog_z((uint32_t)total) - 3;
  if (shift < 0) shift = 0;
  int rest = 0;
  if (shift) {
    rest = count & ((1 << shift) - 1);
    count >>= shift;
    total >>= shift;
  }
  int fctx = 7 * ctx + total - 1;
  cdf_adapt_enc(e, count, cw_sp_row(c, fctx), total + 1,
                c->split_inc);
  if (shift) e->encode_bits((uint32_t)rest, shift);
}

static void enc_band_splits(EcEnc *e, PvqCwCtx *c, const int32_t *y,
                            int n, int k, int level) {
  if (n <= 1 || k == 0) return;
  if (k == 1 && n <= 16) {
    int cdf_id = pvq_k1_ctx(n, level == 0);
    int pos = 0;
    while (!y[pos]) pos++;
    cdf_adapt_enc(e, pos, cw_k1_row(c, cdf_id), n, c->k1_inc);
  } else {
    int mid = n >> 1;
    int cr = k;
    for (int i = 0; i < mid; i++) cr -= y[i] < 0 ? -y[i] : y[i];
    enc_pvq_split(e, c, cr, k, pvq_size_ctx(n));
    enc_band_splits(e, c, y, mid, k - cr, level + 1);
    enc_band_splits(e, c, y + mid, n - mid, cr, level + 1);
  }
}

void ec_pvq_codeword_encode(void *h, const int32_t *y, int n, int k,
                            int32_t *k1_cdf, int32_t *split_cdf,
                            int k1_inc, int split_inc) {
  EcEnc *e = (EcEnc *)h;
  PvqCwCtx c{k1_cdf, split_cdf, k1_inc, split_inc};
  enc_band_splits(e, &c, y, n, k, 0);
  for (int i = 0; i < n; i++) {
    if (y[i]) e->encode_bits(y[i] < 0 ? 1 : 0, 1);
  }
}

void ec_cdf_adapt_enc(void *h, int val, int32_t *cdf, int n, int inc) {
  cdf_adapt_enc((EcEnc *)h, val, cdf, n, inc);
}

static int cdf_adapt_dec(EcDec *d, int32_t *cdf, int n, int inc) {
  int val = d->decode_cdf_unscaled(cdf, n);
  if (cdf[n - 1] + inc > 32767) {
    for (int i = 0; i < n; i++) cdf[i] = (cdf[i] >> 1) + i + 1;
  }
  for (int i = val; i < n; i++) cdf[i] += inc;
  return val;
}

static int dec_pvq_split(EcDec *d, PvqCwCtx *c, int total, int ctx) {
  if (total == 0) return 0;
  int shift = ilog_z((uint32_t)total) - 3;
  if (shift < 0) shift = 0;
  int fctx = 7 * ctx + (total >> shift) - 1;
  int msbs = cdf_adapt_dec(d, c->split_cdf + 8 * fctx,
                           (total >> shift) + 1, c->split_inc);
  int count = shift ? (int)d->decode_bits(shift) : 0;
  count += msbs << shift;
  if (count > total) {
    count = total;
    d->error = 1;
  }
  return count;
}

static void dec_band_splits(EcDec *d, PvqCwCtx *c, int32_t *y, int n,
                            int k, int level) {
  if (n == 1) {
    y[0] = k;
    return;
  }
  if (k == 0) {
    for (int i = 0; i < n; i++) y[i] = 0;
    return;
  }
  if (k == 1 && n <= 16) {
    for (int i = 0; i < n; i++) y[i] = 0;
    int pos = cdf_adapt_dec(d, c->k1_cdf + 16 * pvq_k1_ctx(n, level == 0),
                            n, c->k1_inc);
    y[pos] = 1;
    return;
  }
  int mid = n >> 1;
  int cr = dec_pvq_split(d, c, k, pvq_size_ctx(n));
  dec_band_splits(d, c, y, mid, k - cr, level + 1);
  dec_band_splits(d, c, y + mid, n - mid, cr, level + 1);
}

int ec_cdf_adapt_dec(void *h, int32_t *cdf, int n, int inc) {
  return cdf_adapt_dec((EcDec *)h, cdf, n, inc);
}

void ec_pvq_codeword_decode(void *h, int32_t *y, int n, int k,
                            int32_t *k1_cdf, int32_t *split_cdf,
                            int k1_inc, int split_inc) {
  EcDec *d = (EcDec *)h;
  PvqCwCtx c{k1_cdf, split_cdf, k1_inc, split_inc};
  dec_band_splits(d, &c, y, n, k, 0);
  for (int i = 0; i < n; i++) {
    if (y[i] && d->decode_bits(1)) y[i] = -y[i];
  }
}

int ec_pvq_codeword_rate_q3(const int32_t *y, int n, int k,
                            const int32_t *k1_cdf,
                            const int32_t *split_cdf, int k1_inc,
                            int split_inc) {
  // Hot RDO path: reuse one simulation encoder per thread (the vectors
  // keep their capacity) instead of constructing/destroying one per
  // candidate.
  static thread_local EcEnc e;
  e.low = 0;
  e.rng = 0x8000;
  e.cnt = -9;
  e.precarry.clear();
  e.end_window = 0;
  e.nend_bits = 0;
  e.end_bytes.clear();
  e.error = 0;
  // Scratch CDFs are populated lazily per row (copy-on-read): a rate
  // call typically touches a handful of the 110 rows, so copying all
  // ~3.9KB per candidate dominated this path.
  static thread_local int32_t k1[12 * 16];
  static thread_local int32_t sp[98 * 8];
  static thread_local uint32_t k1_ep[12], sp_ep[98];
  static thread_local uint32_t epoch = 0;
  if (++epoch == 0) {
    std::memset(k1_ep, 0, sizeof(k1_ep));
    std::memset(sp_ep, 0, sizeof(sp_ep));
    epoch = 1;
  }
  PvqCwCtx c{k1, sp, k1_inc, split_inc};
  c.k1_src = k1_cdf;
  c.sp_src = split_cdf;
  c.k1_ep = k1_ep;
  c.sp_ep = sp_ep;
  c.epoch = epoch;
  int tell = tell_frac_impl(e.tell(), e.rng);
  enc_band_splits(&e, &c, y, n, k, 0);
  int nsigns = 0;
  for (int i = 0; i < n; i++) nsigns += (y[i] != 0);
  // Each sign is one raw bit: exactly 8 in tell_frac Q3 units.
  return tell_frac_impl(e.tell(), e.rng) - tell + 8 * nsigns;
}

/* Codeword rate in Q3 units measured by coding into a thread-local
 * scratch range coder against the REAL codeword CDFs (which adapt
 * exactly as a live encode would) — the cost-only fast trial's
 * codeword accounting (frame_enc.inc pvq_encode_partition). */
int ec_pvq_codeword_cost_enc_q3(const int32_t *y, int n, int k,
                                int32_t *k1_cdf, int32_t *split_cdf,
                                int k1_inc, int split_inc) {
  static thread_local EcEnc e;
  e.low = 0;
  e.rng = 0x8000;
  e.cnt = -9;
  e.precarry.clear();
  e.end_window = 0;
  e.nend_bits = 0;
  e.end_bytes.clear();
  e.error = 0;
  int tell = tell_frac_impl(e.tell(), e.rng);
  ec_pvq_codeword_encode((void *)&e, y, n, k, k1_cdf, split_cdf,
                         k1_inc, split_inc);
  return tell_frac_impl(e.tell(), e.rng) - tell;
}

}  // extern "C"

// ---- PVQ fixed-point math core ----------------------------------------
// Ported from this project's validated Python implementation
// (daala_tpu/ops/pvq.py; behavioral parity: src/pvq.c).  int64
// intermediates reproduce Python's arbitrary-precision results for
// in-range inputs; OD_SHL wraps to 32 bits explicitly.

namespace pvqm {

constexpr int kCgainShift = 8;
constexpr int64_t kCgainScale = 1 << kCgainShift;
constexpr int kThetaShift = 15;
constexpr int64_t kMaxThetaScale = 1 << kThetaShift;
constexpr int64_t kTrigScale = 32768;
constexpr int kBetaShift = 12;
constexpr int kCompandShift = 12;  // 8 + OD_COEFF_SHIFT(4)
constexpr int kQmShift = 11;
constexpr int kQmInvShift = 12;
constexpr int kRcpInShift = 15, kRcpOutShift = 14;
constexpr int kRsqrtInShift = 16, kRsqrtOutShift = 14;
constexpr int kSqrtInShift = 16, kSqrtOutShift = 15;
constexpr int kExp2InShift = 15;
constexpr int kLog2InShift = 15, kLog2OutShift = 15;
constexpr int64_t kLog2OutScale = 1 << kLog2OutShift;
constexpr int64_t kBeta1 = 1 << kBetaShift;          // OD_BETA(1.0)
constexpr int64_t kBeta15 = (int64_t)(0.5 + 1.5 * (1 << kBetaShift));

inline int ilog(int64_t x) {
  if (x <= 0) return 0;
  int n = 0;
  uint64_t u = (uint64_t)x;
  while (u) { n++; u >>= 1; }
  return n;
}

inline int64_t shr_round(int64_t x, int shift) {
  return (x + ((int64_t)1 << shift >> 1)) >> shift;
}

inline int64_t shl32(int64_t a, int shift) {
  uint32_t v = (uint32_t)((uint64_t)a << shift);
  return (int64_t)(int32_t)v;
}

inline int64_t vshr(int64_t x, int shift) {
  return shift > 0 ? x >> shift : shl32(x, -shift);
}

inline int64_t vshr_round(int64_t x, int shift) {
  return shift > 0 ? shr_round(x, shift) : shl32(x, -shift);
}

inline int64_t q15mul(int64_t a, int64_t b) { return (a * b) >> 15; }
inline int64_t q16mul(int64_t a, int64_t b) { return (a * b) >> 16; }
inline int64_t qbmul(int64_t a, int64_t b) { return (a * b) >> kBetaShift; }

inline int64_t cos_pi_2(int64_t x) {
  int64_t x2 = q15mul(x, x);
  int64_t v = (1073758164 - x * x
               + x2 * (-7654 + q16mul(x2, 16573 + q16mul(-2529, x2))))
              >> 15;
  return v < 32767 ? v : 32767;
}

inline int64_t pvq_cos(int64_t x) {
  x = x & 0x1FFFF;
  if (x > (1 << 16)) x = (1 << 17) - x;
  if (x & 0x7FFF) {
    if (x < (1 << 15)) return cos_pi_2(x);
    return -cos_pi_2(65536 - x);
  }
  if (x & 0xFFFF) return 0;
  if (x & 0x1FFFF) return -32767;
  return 32767;
}

inline int64_t pvq_sin(int64_t x) { return pvq_cos(32768 - x); }

// od_val16 assignment semantics: wrap to int16.  The reference's
// fixed-point vectors are int16 and boundary values (e.g. a Householder
// l2r_norm that rounds to exactly 32768) wrap; the wrapped results are
// normative (reference: src/pvq.c od_val16 locals).
inline int64_t wrap16(int64_t v) {
  return (int64_t)(int16_t)(uint16_t)v;
}

inline int64_t od_rcp(int64_t x) {
  // OD_ILOG via CLZ sees the sign bit for (wrapped) negative inputs
  // (reference: src/odintrin.h:236-241).
  int i = (x < 0 ? 32 : ilog(x)) - 1;
  int64_t n = wrap16(vshr_round(x, i - kRcpInShift)
                     - ((int64_t)1 << kRcpInShift));
  int64_t r = wrap16(30840 + q15mul(-15420, n));
  r = wrap16(r - q15mul(r, q15mul(r, n) + r - 32768));
  r = wrap16(r - (1 + q15mul(r, q15mul(r, n) + r - 32768)));
  return wrap16(vshr_round(r, i - kRcpOutShift));
}

inline int64_t rsqrt_norm(int64_t t) {
  int64_t n = t - 32768;
  int64_t r = 23565 + q15mul(n, -13481 + q15mul(n, 6711));
  int64_t r2 = r * r;
  int64_t y = (((r2 >> 15) * n + r2) >> 12) - 131077;
  int64_t ry = r * y;
  return r + ((((ry >> 16) * (3 * y) >> 3) - ry) >> 18);
}

inline int64_t od_rsqrt(int64_t x, int *shift) {
  int k = (ilog(x) - 1) >> 1;
  int s = 2 * k - (kRsqrtInShift - 2);
  int64_t t = vshr(x, s);
  *shift = kRsqrtOutShift + ((s + kRsqrtInShift) >> 1);
  return rsqrt_norm(t);
}

inline int64_t sqrt_norm(int64_t x) {
  int64_t v = shr_round(x * rsqrt_norm(x), kSqrtOutShift);
  return v < 32767 ? v : 32767;
}

inline int64_t od_sqrt(int64_t x, int *shift) {
  if (x == 0) { *shift = 0; return 0; }
  int k = (ilog(x) - 1) >> 1;
  int s = 2 * k - (kSqrtInShift - 2);
  int64_t t = vshr(x, s);
  *shift = kSqrtOutShift - ((s + kSqrtInShift) >> 1);
  return sqrt_norm(t);
}

inline int64_t od_exp2(int64_t x) {
  int64_t integer = x >> kExp2InShift;
  if (integer > 14) return 0x7F000000;
  if (integer < -15) return 0;
  int64_t xf = x - shl32(integer, kExp2InShift);
  int64_t frac = q15mul(xf, 22709 + q15mul(xf, 7913 + q15mul(
      xf, 1704 + q15mul(xf, 443))));
  return vshr_round(32768 + frac, (int)-integer) + 1;
}

inline int64_t od_log2(int64_t x) {
  return x + q15mul(x, 14482 + q15mul(x, -23234 + q15mul(
      x, 13643 + q15mul(x, -6403 + q15mul(x, 1515)))));
}

inline int64_t od_pow(int64_t x, int64_t beta) {
  if (x == 0) return 0;
  int log2_x = ilog(x) - 1;
  int xshift = log2_x - kLog2InShift;
  int64_t t = vshr(x, xshift) - ((int64_t)1 << kLog2InShift);
  int64_t logr = od_log2(t) + (int64_t)(log2_x - kCompandShift)
                                * kLog2OutScale;
  logr = qbmul(beta, logr);
  return od_exp2(logr);
}

inline int64_t beta_rcp(int64_t beta) {
  if (beta == kBeta1) return kBeta1;
  if (beta == kBeta15)
    return (int64_t)(0.5 + (1.0 / 1.5) * (1 << kBetaShift));
  int64_t rcp_b = od_rcp(beta << (kRcpInShift - 1 - kBetaShift));
  return shr_round(rcp_b, kRcpOutShift + 1 - kBetaShift);
}

inline int64_t gain_compand(int64_t g, int64_t q0, int64_t beta) {
  if (beta == kBeta1) return (kCgainScale * g + (q0 >> 1)) / q0;
  int64_t expr = od_pow(g, beta_rcp(beta));
  expr <<= kCgainShift + kCompandShift - 15;  // OD_EXP2_OUTSHIFT = 15
  return (expr + (q0 >> 1)) / q0;
}

inline int64_t gain_expand(int64_t cg0, int64_t q0, int64_t beta) {
  if (beta == kBeta1) return shr_round(cg0 * q0, kCgainShift);
  if (beta == kBeta15) {
    int sqrt_outshift;
    int64_t irt = od_sqrt(cg0 * q0, &sqrt_outshift);
    int sqrt_inshift = (kCgainShift + kCompandShift) >> 1;
    int64_t tmp = cg0 * q0 * irt;
    return vshr_round(tmp, kCgainShift + sqrt_outshift + sqrt_inshift);
  }
  int64_t cg = shr_round(cg0 * q0, kCgainShift);
  int64_t expr = od_pow(cg, beta);
  return shr_round(expr, 15 - kCompandShift);
}

inline int64_t compute_gain(const int64_t *x, int n, int64_t q0,
                            int64_t beta, int bshift, int64_t *g_out) {
  int64_t acc = 0;
  for (int i = 0; i < n; i++) acc += x[i] * x[i];
  int sqrt_shift;
  int64_t irt = od_sqrt(acc, &sqrt_shift);
  int64_t g = vshr_round(irt, sqrt_shift - bshift);
  *g_out = g;
  return gain_compand(g, q0, beta);
}

inline int64_t compute_max_theta(int64_t qcg, int64_t beta) {
  int64_t qconst_pi_2 = (int64_t)(0.5 + (3.141592653589793 / 2)
                                  * (1 << kCgainShift));
  int64_t ts = shr_round(qcg * qbmul(beta_rcp(beta), qconst_pi_2),
                         kCgainShift * 2);
  if (qcg < (int64_t)(0.5 + 1.4 * (1 << kCgainShift))) ts = 1;
  return ts;
}

inline int64_t compute_theta(int64_t t, int64_t max_theta) {
  if (max_theta != 0) {
    int64_t tm = t < max_theta - 1 ? t : max_theta - 1;
    return (kMaxThetaScale * tm + (max_theta >> 1)) / max_theta;
  }
  return 0;
}

static const int kSqrtTable[2][13] = {
    {0, 0, 0, 0, 2290, 2985, 4222, 0, 8256, 0, 16416, 0, 32767},
    {0, 0, 0, 0, 2401, 3072, 4284, 0, 8287, 0, 16432, 0, 32767}};
constexpr int kSqrtTblShift = 10;
constexpr int kIthetaShift = 15;

inline int64_t compute_k(int64_t qcg, int64_t itheta, int noref, int n,
                         int64_t beta) {
  if (noref) {
    if (qcg == 0) return 0;
    if (n == 15 && qcg == kCgainScale
        && beta > (int64_t)(0.5 + 1.25 * (1 << kBetaShift)))
      return 1;
    int64_t rt = kSqrtTable[1][ilog(n + 1)];
    int64_t v = shr_round(
        (qcg - (int64_t)(0.5 + 0.2 * (1 << kCgainShift)))
            * qbmul(beta_rcp(beta), rt),
        kCgainShift + kSqrtTblShift);
    return v > 1 ? v : 1;
  }
  if (itheta == 0) return 0;
  int64_t rt = kSqrtTable[0][ilog(n + 1)];
  int64_t v = vshr_round(
      (shl32(itheta, kIthetaShift)
       - (int64_t)(0.5 + 0.2 * (1 << kIthetaShift))) * rt,
      kSqrtTblShift + kIthetaShift);
  return v > 1 ? v : 1;
}

inline void compute_householder(int64_t *r, int n, int64_t gr, int shift,
                                int *m_out, int *s_out) {
  int m = 0;
  int64_t best = -1;
  for (int i = 0; i < n; i++) {
    int64_t a = r[i] < 0 ? -r[i] : r[i];
    if (a > best) { best = a; m = i; }
  }
  int s = r[m] > 0 ? 1 : -1;
  r[m] = wrap16(r[m] + shr_round(gr * s, shift));  // r is od_val16
  *m_out = m;
  *s_out = s;
}

inline void apply_householder(int64_t *x, const int64_t *r, int n) {
  int64_t l2r = 0, proj = 0;
  for (int i = 0; i < n; i++) {
    l2r += r[i] * r[i];
    proj += r[i] * x[i];
  }
  int l2r_shift = (ilog(l2r) - 1) - 14;
  // l2r_norm / proj_norm / proj_1 and the output vector are od_val16 in
  // the reference: they wrap to int16 and the wraps are normative.
  int64_t l2r_norm = wrap16(vshr_round(l2r, l2r_shift));
  int64_t rcp = od_rcp(l2r_norm);
  int64_t pabs = proj < 0 ? -proj : proj;
  int proj_shift = (ilog(pabs) - 1) - 14;
  int64_t proj_norm = wrap16(vshr_round(proj, proj_shift));
  int64_t proj_1 = wrap16(q15mul(proj_norm, rcp));
  int outshift = kRcpOutShift - proj_shift - 1 + l2r_shift;
  if (outshift > 30) outshift = 30;
  for (int i = 0; i < n; i++) {
    int64_t tmp;
    if (outshift >= 0) {
      tmp = r[i] * proj_1;
      tmp = (tmp + ((int64_t)1 << outshift >> 1)) >> outshift;
    } else {
      tmp = shl32(r[i] * proj_1, -outshift);
    }
    x[i] = wrap16(x[i] - tmp);
  }
}

inline void synthesis_partial(const int32_t *ypulse, const int64_t *r16,
                              int n, int noref, int64_t g, int64_t theta,
                              int m, int s, const int32_t *qm_inv,
                              int32_t *out) {
  int nn = n - (noref ? 0 : 1);
  int64_t yy = 0;
  for (int i = 0; i < nn; i++) yy += (int64_t)ypulse[i] * ypulse[i];
  int gshift = ilog(g) - 14;
  if (gshift < 0) gshift = 0;
  int64_t scale = 0;
  if (yy != 0) {
    int rsqrt_shift;
    int64_t rs = od_rsqrt(yy, &rsqrt_shift);
    scale = vshr_round(rs * g, rsqrt_shift + gshift - 16);
  }
  int qshift = kQmInvShift - gshift;
  if (noref) {
    for (int i = 0; i < n; i++) {
      int64_t x = ((int64_t)ypulse[i] * scale) >> 16;
      out[i] = (int32_t)shr_round(x * qm_inv[i], qshift);
    }
    return;
  }
  int64_t sintheta = pvq_sin(theta);
  int64_t costheta = pvq_cos(theta);
  // Same double-promotion order as the reference (src/pvq.c:1091,1096).
  int64_t scale_s = (int64_t)__builtin_floor(
      0.5 + (double)scale * (1.0 / (double)kTrigScale) * (double)sintheta);
  // x is an od_val16 vector in the reference (int16 wrap).
  int64_t x[1024];
  for (int i = 0; i < m; i++)
    x[i] = wrap16(((int64_t)ypulse[i] * scale_s) >> 16);
  x[m] = wrap16((int64_t)__builtin_floor(
      0.5 + (double)(-s * shr_round(g, gshift))
                * (1.0 / (double)kTrigScale) * (double)costheta));
  for (int i = m + 1; i < n; i++)
    x[i] = wrap16(((int64_t)ypulse[i - 1] * scale_s) >> 16);
  apply_householder(x, r16, n);
  for (int i = 0; i < n; i++)
    out[i] = (int32_t)shr_round(x[i] * qm_inv[i], qshift);
}

inline int vector_log_mag(const int32_t *x, int n) {
  int64_t total = 0;
  for (int i = 0; i < n; i++) {
    int64_t t = (int64_t)x[i] >> 8;
    total += t * t;
  }
  return 8 + 1 + ilog(n + total) / 2;
}

inline int64_t neg_interleave(int64_t x, int64_t ref) {
  if (x < ref) return -2 * (x - ref) - 1;
  if (x < 2 * ref) return 2 * (x - ref);
  return x - 1;
}

}  // namespace pvqm

extern "C" {

// ---- PVQ greedy pulse search ------------------------------------------
// Scalar port of the RDO pulse search (written from this project's
// Python implementation, daala_tpu/codec/pvq_codec.py
// pvq_search_rdo_double; behavioral parity: src/pvq_encoder.c:93-227).
// Plain double arithmetic in the reference's loop order so decisions
// match the C encoder bit for bit.

static const double kRsqrtTab[16] = {
    1.000000, 0.707107, 0.577350, 0.500000, 0.447214, 0.408248,
    0.377964, 0.353553, 0.333333, 0.316228, 0.301511, 0.288675,
    0.277350, 0.267261, 0.258199, 0.250000};

static inline double rsqrt_tab(int i) {
  if (i <= 16) return kRsqrtTab[i - 1];
  return 1.0 / __builtin_sqrt((double)i);
}

double ec_pvq_search_rdo_double(const double *xcoeff, int n, int k,
                                int32_t *ypulse, double g2,
                                double pvq_norm_lambda, int prev_k);

// ---- single-block reversible DCTs -------------------------------------
// Lifting kernels generated from the normative networks (see the .inc
// header for provenance); 2-D composition mirrors daala_tpu/ops/dct.py
// (reference: src/dct.c:152-163).  The kernels are type-generic
// templates (scalar int32_t or GCC vector types), so they must live
// outside the extern "C" block.

}  // extern "C" (paused for the template kernels)

#include "lifting_gen.inc"

// Vector lanes for batched column transforms: elementwise integer ops
// are lane-exact, so these produce bit-identical coefficients to the
// scalar kernels.
typedef int32_t dct_v4 __attribute__((vector_size(16)));
typedef int32_t dct_v8 __attribute__((vector_size(32)));
typedef int32_t dct_v16 __attribute__((vector_size(64)));

extern "C" {

typedef void (*lift_fn)(int32_t *);
static lift_fn fdct_tab(int n) {
  switch (n) {
    case 4: return fdct4_c<int32_t>;
    case 8: return fdct8_c<int32_t>;
    case 16: return fdct16_c<int32_t>;
    case 32: return fdct32_c<int32_t>;
    default: return fdct64_c<int32_t>;
  }
}
static lift_fn idct_tab(int n) {
  switch (n) {
    case 4: return idct4_c<int32_t>;
    case 8: return idct8_c<int32_t>;
    case 16: return idct16_c<int32_t>;
    case 32: return idct32_c<int32_t>;
    default: return idct64_c<int32_t>;
  }
}

// cols_T: out[i][j] = f(in[:, i])[j]  (write transform of column i as
// row i), matching dct.py's composition.
static void dct_cols_T(const int32_t *in, int32_t *out, int n,
                       lift_fn f) {
  int32_t L[64];
  for (int i = 0; i < n; i++) {
    for (int k = 0; k < n; k++) L[k] = in[k * n + i];
    f(L);
    for (int k = 0; k < n; k++) out[i * n + k] = L[k];
  }
}

// rows_T: out[j][i] = f(in[i, :])[j]  (write transform of row i as
// column i).
static void dct_rows_T(const int32_t *in, int32_t *out, int n,
                       lift_fn f) {
  int32_t L[64];
  for (int i = 0; i < n; i++) {
    for (int k = 0; k < n; k++) L[k] = in[i * n + k];
    f(L);
    for (int k = 0; k < n; k++) out[k * n + i] = L[k];
  }
}

void ec_dct2d_batch(int32_t *blocks, int nblk, int n, int forward) {
  int32_t tmp[4096];
  lift_fn f = forward ? fdct_tab(n) : idct_tab(n);
  for (int b = 0; b < nblk; b++) {
    int32_t *blk = blocks + (int64_t)b * n * n;
    if (forward) {
      dct_cols_T(blk, tmp, n, f);
      dct_cols_T(tmp, blk, n, f);
    } else {
      dct_rows_T(blk, tmp, n, f);
      dct_rows_T(tmp, blk, n, f);
    }
  }
}

// memo_k/memo_rate: optional 1-entry memo for the codeword rate.  The
// candidate loops in ec_pvq_theta only regenerate the pulse vector when
// k changes, so consecutive candidates with equal k share the exact
// codeword cost (the adaptation CDFs are fixed during the search).
static double pvq_rate_c(int64_t qg, int64_t icgr, int64_t theta,
                         int64_t ts, const int32_t *y0, int64_t k, int n,
                         int is_keyframe, int pli, int speed,
                         const int32_t *k1_cdf, const int32_t *split_cdf,
                         int k1_inc, int split_inc,
                         int64_t *memo_k = nullptr,
                         double *memo_rate = nullptr) {
  double t0r = now_s();
  struct RProf { double t0; ~RProf() { g_prof_pvq_rate += now_s() - t0; } } rp{t0r};
  double rate;
  if (k == 0) {
    rate = 0.0;
  } else if (memo_k && *memo_k == k) {
    rate = *memo_rate;
  } else if (speed > 0) {
    int lim = n - (theta != -1 ? 1 : 0);
    int64_t total = 0;
    for (int i = 0; i < lim; i++) {
      int64_t a = y0[i] < 0 ? -(int64_t)y0[i] : y0[i];
      total += (int64_t)i * a;
    }
    double f = (double)total / (double)(k * n);
    double lg = __builtin_log(n * 2 * (1 * f + 0.025)) * k / n;
    if (lg < 0.0) lg = 0.0;
    rate = (1 + .4 * f) * n * __builtin_log2(1 + lg) + 3;
  } else {
    rate = ec_pvq_codeword_rate_q3(y0, n - (theta != -1 ? 1 : 0), (int)k,
                                   k1_cdf, split_cdf, k1_inc,
                                   split_inc) / 8.0;
  }
  if (memo_k && k != 0) {
    *memo_k = k;
    *memo_rate = rate;
  }
  if (qg > 0 && theta >= 0) {
    rate += .9 * __builtin_log2((double)ts);
    if (is_keyframe && pli == 0) rate += 6;
    if (qg == icgr) rate -= .5;
  }
  return rate;
}

// Full per-band PVQ search (ported from daala_tpu/codec/pvq_codec.py
// pvq_theta; behavioral parity: src/pvq_encoder.c:333-636).  Outputs:
// res_i[0..3] = qg_coded, itheta, max_theta, k; *skip_diff_delta.
void ec_pvq_theta(int32_t *out, const int32_t *x0, const int32_t *r0,
                  int n, int q0, int32_t *y, int beta, int is_keyframe,
                  int pli, const int32_t *qm, const int32_t *qm_inv,
                  double pvq_norm_lambda, int speed, int32_t *k1_cdf,
                  int32_t *split_cdf, int k1_inc, int split_inc,
                  int32_t *res_i, double *skip_diff_delta) {
  using namespace pvqm;
  const double gain_weight = 1.4;
  const double cg2 = (double)(kCgainScale * kCgainScale);
  int xshift = vector_log_mag(x0, n) - 15;
  if (xshift < 0) xshift = 0;
  int rshift = vector_log_mag(r0, n) - 14;
  if (rshift < 0) rshift = 0;
  int64_t x16[1024], r16[1024], r16_refl[1024];
  int64_t corr_i = 0;
  for (int i = 0; i < n; i++) {
    x16[i] = shr_round((int64_t)x0[i] * qm[i], kQmShift + xshift);
    r16[i] = shr_round((int64_t)r0[i] * qm[i], kQmShift + rshift);
    corr_i += x16[i] * r16[i];
  }
  int cfl_enabled = is_keyframe && pli != 0;
  int64_t g, gr;
  int64_t cg = compute_gain(x16, n, q0, beta, xshift, &g);
  int64_t cgr = compute_gain(r16, n, q0, beta, rshift, &gr);
  if (cfl_enabled) cgr = kCgainScale;
  int64_t icgr = shr_round(cgr, kCgainShift);
  int64_t gain_offset = cgr - shl32(icgr, kCgainShift);
  int64_t qg = 0;
  double dist = gain_weight * (double)cg * (double)cg / cg2;
  double best_dist = dist;
  double best_cost = dist;  // k=0, qg=0 -> rate 0
  int noref = 1;
  int64_t best_k = 0;
  int64_t itheta = -1;
  int64_t max_theta = 0;
  for (int i = 0; i < n; i++) y[i] = 0;
  int64_t best_qtheta = 0;
  int m = 0, sgn = 1;
  double corr = (double)corr_i
                / (1e-100 + (double)g * (double)gr
                              / (double)shl32(1, xshift + rshift));
  if (corr > 1.0) corr = 1.0;
  if (corr < -1.0) corr = -1.0;
  double skip_dist;
  if (is_keyframe) {
    skip_dist = gain_weight * (double)cg * (double)cg / cg2;
  } else {
    skip_dist = (gain_weight * (double)(cg - cgr) * (double)(cg - cgr)
                 + (double)cgr * (double)cg * (2 - 2 * corr)) / cg2;
  }
  if (!is_keyframe) {
    double scgr = (double)gain_offset;
    if (scgr < 0.0) scgr = 0.0;
    if (icgr == 0) {
      best_dist = (gain_weight * ((double)cg - scgr)
                       * ((double)cg - scgr)
                   + scgr * (double)cg * (2 - 2 * corr)) / cg2;
    }
    best_cost = best_dist;  // k=0, qg=0 -> rate 0
    best_qtheta = 0;
    itheta = 0;
    max_theta = 0;
    noref = 0;
  }
  double dist0 = best_dist;
  for (int i = 0; i < n; i++) r16_refl[i] = r16[i];
  int any_r0 = 0;
  for (int i = 0; i < n; i++) {
    if (r0[i]) { any_r0 = 1; break; }
  }
  int64_t theta = 0;
  if (n <= 128 && any_r0 && corr > 0) {
    theta = (int64_t)__builtin_floor(
        0.5 + (double)kMaxThetaScale * 2 / 3.141592653589793
                  * __builtin_acos(corr));
    compute_householder(r16_refl, n, gr, rshift, &m, &sgn);
    int64_t xr_full[1024];
    for (int i = 0; i < n; i++) xr_full[i] = x16[i];
    apply_householder(xr_full, r16_refl, n);
    double xr_d[1024];
    for (int i = 0; i < m; i++) xr_d[i] = (double)xr_full[i];
    for (int i = m + 1; i < n; i++) xr_d[i - 1] = (double)xr_full[i];
    int64_t gain_bound = (cg - gain_offset) >> kCgainShift;
    struct Item {
      int64_t k, i, j, qcg, qtheta, ts;
    };
    Item items[256];
    int nitems = 0;
    int64_t ilo = gain_bound - 1 > 1 ? gain_bound - 1 : 1;
    int64_t ihi = gain_bound + 1;
    if (speed >= 2) {
      // Fast trial mode: restrict to the 2x2 neighborhood at and just
      // below the projection (nearest quantized gain/theta and one
      // step down — the step the RD tradeoff usually prefers) instead
      // of the reference's +-1 gain x 4-theta set.  Only the
      // block-size RDO trial pass runs here (frame_enc.inc speed
      // mapping); the final pass always searches the full set.
      int64_t i0 = shr_round(cg - gain_offset, kCgainShift);
      if (i0 < 1) i0 = 1;
      ilo = i0 - 1 > 1 ? i0 - 1 : 1;
      ihi = i0;
    }
    for (int64_t i = ilo; i <= ihi; i++) {
      int64_t qcg = shl32(i, kCgainShift) + gain_offset;
      int64_t ts = compute_max_theta(qcg, beta);
      double theta_scale_1 = 1.0 / ((1 << 15) * 2.0 / 3.141592653589793);
      double tpos = (double)theta * theta_scale_1 * 2
                    / 3.141592653589793 * (double)ts;
      int64_t theta_lower = (int64_t)__builtin_floor(0.5 + tpos) - 2;
      if (theta_lower < 0) theta_lower = 0;
      int64_t theta_upper = (int64_t)__builtin_ceil(tpos);
      if (theta_upper > ts - 1) theta_upper = ts - 1;
      if (speed >= 2) {
        int64_t j0 = (int64_t)__builtin_floor(0.5 + tpos);
        if (j0 < 0) j0 = 0;
        if (j0 > ts - 1) j0 = ts - 1;
        theta_lower = j0 - 1 > 0 ? j0 - 1 : 0;
        theta_upper = j0;
      }
      for (int64_t j = theta_lower;
           j <= theta_upper && nitems < 256; j++) {
        Item it;
        it.k = compute_k(qcg, j, 0, n, beta);
        it.i = i;
        it.j = j;
        it.qcg = qcg;
        it.qtheta = compute_theta(j, ts);
        it.ts = ts;
        items[nitems++] = it;
      }
    }
    // Stable sort by (k, i) — matches Python's list.sort with that key.
    for (int a = 1; a < nitems; a++) {
      Item key = items[a];
      int b = a - 1;
      while (b >= 0 && (items[b].k > key.k
                        || (items[b].k == key.k && items[b].i > key.i))) {
        items[b + 1] = items[b];
        b--;
      }
      items[b + 1] = key;
    }
    int32_t y_tmp[1024];
    for (int i = 0; i < n; i++) y_tmp[i] = 0;
    double cos_dist = 0.0;
    int64_t prev_k = 0;
    int64_t memo_k = -1;
    double memo_rate = 0.0;
    for (int idx = 0; idx < nitems; idx++) {
      int64_t k = items[idx].k, gi = items[idx].i, j = items[idx].j;
      int64_t qcg = items[idx].qcg, qtheta = items[idx].qtheta;
      int64_t ts = items[idx].ts;
      double dist_theta =
          2 - 2.0 * (double)pvq_cos(theta - qtheta) / (double)kTrigScale;
      double d1 = gain_weight * (double)(qcg - cg) * (double)(qcg - cg)
                  + (double)qcg * (double)cg * dist_theta;
      d1 /= cg2;
      if (d1 > dist0 + 1.0 * pvq_norm_lambda && k != 0) continue;
      double sin_prod = ((double)pvq_sin(theta) / (double)kTrigScale)
                        * ((double)pvq_sin(qtheta) / (double)kTrigScale);
      if (k == 0) {
        cos_dist = 0.0;
        for (int i = 0; i < n - 1; i++) y_tmp[i] = 0;
      } else if (k != prev_k) {
        double t0s = now_s();
        cos_dist = ec_pvq_search_rdo_double(
            xr_d, n - 1, (int)k, y_tmp,
            (double)qcg * (double)cg * sin_prod / cg2,
            pvq_norm_lambda, (int)prev_k);
        g_prof_pvq_search += now_s() - t0s;
      }
      prev_k = k;
      dist_theta =
          2 - 2.0 * (double)pvq_cos(theta - qtheta) / (double)kTrigScale
          + sin_prod * (2 - 2 * cos_dist);
      double d2 = gain_weight * (double)(qcg - cg) * (double)(qcg - cg)
                  + (double)qcg * (double)cg * dist_theta;
      d2 /= cg2;
      double cost = d2 + pvq_norm_lambda
                            * pvq_rate_c(gi, icgr, j, ts, y_tmp, k, n,
                                         is_keyframe, pli, speed, k1_cdf,
                                         split_cdf, k1_inc, split_inc,
                                         &memo_k, &memo_rate);
      if (cost < best_cost) {
        best_cost = cost;
        best_dist = d2;
        qg = gi;
        best_k = k;
        best_qtheta = qtheta;
        itheta = j;
        max_theta = ts;
        noref = 0;
        for (int i = 0; i < n - 1; i++) y[i] = y_tmp[i];
      }
    }
  }
  if (n <= 128 && ((is_keyframe && pli == 0) || corr < 0.5
                   || cg < shl32(2, kCgainShift))) {
    int64_t gain_bound = cg >> kCgainShift;
    int64_t prev_k = 0;
    int64_t memo_k2 = -1;
    double memo_rate2 = 0.0;
    int32_t y_tmp[1024];
    for (int i = 0; i < n; i++) y_tmp[i] = 0;
    double x16_d[1024];
    for (int i = 0; i < n; i++) x16_d[i] = (double)x16[i];
    int64_t ilo = gain_bound > 1 ? gain_bound : 1;
    int64_t ihi_nr = gain_bound + 1;
    // (speed >= 2 keeps the exact 2-candidate noref gain range — it is
    // already minimal.)
    for (int64_t i = ilo; i <= ihi_nr; i++) {
      int64_t qcg = shl32(i, kCgainShift);
      int64_t k = compute_k(qcg, -1, 1, n, beta);
      double d1 = gain_weight * (double)(qcg - cg) * (double)(qcg - cg);
      d1 /= cg2;
      if (d1 > dist0 && k != 0) continue;
      double t0s = now_s();
      double cos_dist = ec_pvq_search_rdo_double(
          x16_d, n, (int)k, y_tmp,
          (double)qcg * (double)cg / cg2, pvq_norm_lambda, (int)prev_k);
      g_prof_pvq_search += now_s() - t0s;
      prev_k = k;
      double d2 = gain_weight * (double)(qcg - cg) * (double)(qcg - cg)
                  + (double)qcg * (double)cg * (2 - 2 * cos_dist);
      d2 /= cg2;
      double cost = d2 + pvq_norm_lambda
                            * pvq_rate_c(i, 0, -1, 0, y_tmp, k, n,
                                         is_keyframe, pli, speed, k1_cdf,
                                         split_cdf, k1_inc, split_inc,
                                         &memo_k2, &memo_rate2);
      if (cost <= best_cost) {
        best_cost = cost;
        best_dist = d2;
        qg = i;
        noref = 1;
        best_k = k;
        itheta = -1;
        max_theta = 0;
        for (int ii = 0; ii < n; ii++) y[ii] = y_tmp[ii];
      }
    }
  }
  int64_t k = best_k;
  theta = best_qtheta;
  int skip = 0;
  if (noref) {
    if (qg == 0) skip = 1;  // OD_PVQ_SKIP_ZERO
  } else {
    if (!is_keyframe && qg == 0) skip = icgr ? 1 : 2;
    if (qg == icgr && itheta == 0 && !cfl_enabled) skip = 2;
  }
  if (skip) {
    if (skip == 2) {
      for (int i = 0; i < n; i++) out[i] = r0[i];
    } else {
      for (int i = 0; i < n; i++) out[i] = 0;
    }
  } else {
    if (noref) gain_offset = 0;
    int64_t gexp = gain_expand(shl32(qg, kCgainShift) + gain_offset, q0,
                               beta);
    synthesis_partial(y, r16_refl, n, noref, gexp, theta, m, sgn, qm_inv,
                      out);
  }
  *skip_diff_delta = skip_dist - best_dist;
  int64_t qg_coded;
  if (is_keyframe) {
    qg_coded = noref ? qg : neg_interleave(qg, icgr);
  } else {
    qg_coded = noref ? qg - 1 : neg_interleave(qg + 1, icgr + 1);
  }
  res_i[0] = (int32_t)qg_coded;
  res_i[1] = (int32_t)itheta;
  res_i[2] = (int32_t)max_theta;
  res_i[3] = (int32_t)k;
}

// Replay a device band decision (models/pvqsearch.py band_search)
// through the exact normative tail — skip determination, synthesis and
// gain-coding transform; mirrors pvq_codec._pvq_theta_forced
// bit-exactly (reference tail: src/pvq_encoder.c:594-636).  fmeta:
// [noref, qg, itheta, max_theta, k, valid]; yvec: the band's pulse
// vector; fskip_diff: the device-computed skip_diff delta.
void ec_pvq_theta_forced(int32_t *out, const int32_t *x0,
                         const int32_t *r0, int n, int q0, int32_t *y,
                         int beta, int is_keyframe, int pli,
                         const int32_t *qm, const int32_t *qm_inv,
                         const int32_t *fmeta, const int32_t *yvec,
                         double fskip_diff, int32_t *res_i,
                         double *skip_diff_delta) {
  using namespace pvqm;
  (void)x0;
  int noref = fmeta[0] != 0;
  int64_t qg = fmeta[1], itheta = fmeta[2], max_theta = fmeta[3];
  int64_t k = fmeta[4];
  int rshift = vector_log_mag(r0, n) - 14;
  if (rshift < 0) rshift = 0;
  int64_t r16_refl[1024];
  for (int i = 0; i < n; i++)
    r16_refl[i] = shr_round((int64_t)r0[i] * qm[i], kQmShift + rshift);
  int64_t gr;
  int64_t cgr = compute_gain(r16_refl, n, q0, beta, rshift, &gr);
  int cfl_enabled = is_keyframe && pli != 0;
  if (cfl_enabled) cgr = kCgainScale;
  int64_t icgr = shr_round(cgr, kCgainShift);
  int64_t gain_offset = cgr - shl32(icgr, kCgainShift);
  int m = 0, sgn = 1;
  int64_t best_qtheta = 0;
  if (!noref) {
    compute_householder(r16_refl, n, gr, rshift, &m, &sgn);
    if (itheta >= 0 && max_theta > 0)
      best_qtheta = compute_theta(itheta, max_theta);
  }
  for (int i = 0; i < n; i++) y[i] = 0;
  int lim = noref ? n : n - 1;
  for (int i = 0; i < lim; i++) y[i] = yvec[i];
  int64_t theta = best_qtheta;
  int skip = 0;
  if (noref) {
    if (qg == 0) skip = 1;  // OD_PVQ_SKIP_ZERO
  } else {
    if (!is_keyframe && qg == 0) skip = icgr ? 1 : 2;
    if (qg == icgr && itheta == 0 && !cfl_enabled) skip = 2;
  }
  if (skip) {
    if (skip == 2) {
      for (int i = 0; i < n; i++) out[i] = r0[i];
    } else {
      for (int i = 0; i < n; i++) out[i] = 0;
    }
  } else {
    if (noref) gain_offset = 0;
    int64_t gexp = gain_expand(shl32(qg, kCgainShift) + gain_offset, q0,
                               beta);
    synthesis_partial(y, r16_refl, n, noref, gexp, theta, m, sgn, qm_inv,
                      out);
  }
  *skip_diff_delta = fskip_diff;
  int64_t qg_coded;
  if (is_keyframe) {
    qg_coded = noref ? qg : neg_interleave(qg, icgr);
  } else {
    qg_coded = noref ? qg - 1 : neg_interleave(qg + 1, icgr + 1);
  }
  res_i[0] = (int32_t)qg_coded;
  res_i[1] = (int32_t)itheta;
  res_i[2] = (int32_t)max_theta;
  res_i[3] = (int32_t)k;
}

double ec_pvq_search_rdo_double(const double *xcoeff, int n, int k,
                                int32_t *ypulse, double g2,
                                double pvq_norm_lambda, int prev_k) {
  double x[1024];
  double xx = 0, xy = 0, yy = 0;
  int i, j;
  for (j = 0; j < n; j++) {
    x[j] = xcoeff[j] < 0 ? -xcoeff[j] : xcoeff[j];
    xx += x[j] * x[j];
  }
  double norm_1 = 1.0 / __builtin_sqrt(1e-30 + xx);
  double lambda = pvq_norm_lambda / (1e-30 + g2);
  i = 0;
  if (0 < prev_k && prev_k <= k) {
    for (j = 0; j < n; j++) {
      ypulse[j] = ypulse[j] < 0 ? -ypulse[j] : ypulse[j];
      xy += x[j] * ypulse[j];
      yy += (double)ypulse[j] * ypulse[j];
      i += ypulse[j];
    }
  } else if (k > 2) {
    double l1_norm = 0;
    for (j = 0; j < n; j++) l1_norm += x[j];
    double l1_inv = 1.0 / (l1_norm > 1e-100 ? l1_norm : 1e-100);
    for (j = 0; j < n; j++) {
      double tmp = k * x[j] * l1_inv;
      double fl = __builtin_floor(tmp);
      int v = (int)fl;
      if (v < 0) v = 0;
      ypulse[j] = v;
      xy += x[j] * ypulse[j];
      yy += (double)ypulse[j] * ypulse[j];
      i += ypulse[j];
    }
  } else {
    for (j = 0; j < n; j++) ypulse[j] = 0;
  }
  int rdo_pulses = 1 + k / 4;
  double delta_rate = 3.0 / n;
  double accel_rate = 0.0;
  if (k == 1) {
    if (n == 15) {
      accel_rate = -8.0 / n;
      delta_rate = 4.5 / n - accel_rate;
    } else if (n == 8) {
      accel_rate = 5.7 / n;
      delta_rate = 9.3 / n - accel_rate;
    }
  }
  // Both argmax scans below process fixed-width chunks: the chunk pass
  // evaluates every candidate against the best from BEFORE the chunk
  // (vectorizable, branch-free) and only chunks containing at least one
  // improvement are rescanned in order.  A candidate that beats the
  // running best also beats the older chunk-entry best (the running
  // best only improves), and the rescan replays the exact sequential
  // comparisons, so the selected pulse positions are identical to the
  // plain loop (and to the Python implementation).
  constexpr int kChunk = 16;
  typedef double ps_v8df __attribute__((vector_size(64)));
  typedef int32_t ps_v8si __attribute__((vector_size(32)));
  typedef int64_t ps_v8di __attribute__((vector_size(64)));
  while (i < k - rdo_pulses) {
    int pos = 0;
    // j == 0 seeds the best unconditionally (mirrors the Python loop).
    double best_xy = (xy + x[0]) * (xy + x[0]);
    double best_yy = yy + 2 * ypulse[0] + 1;
    for (int j0 = 1; j0 < n; j0 += kChunk) {
      int j1 = j0 + kChunk < n ? j0 + kChunk : n;
      int any = 0;
      j = j0;
      // SIMD any-detection: identical per-lane arithmetic to the scalar
      // expressions below, so the improvement mask is exact.
      for (; j + 8 <= j1; j += 8) {
        ps_v8df vx;
        ps_v8si vyp;
        std::memcpy(&vx, x + j, sizeof(vx));
        std::memcpy(&vyp, ypulse + j, sizeof(vyp));
        ps_v8df t_xy = xy + vx;
        ps_v8df t_yy =
            (yy + __builtin_convertvector(2 * vyp, ps_v8df)) + 1.0;
        t_xy *= t_xy;
        ps_v8di m = (t_xy * best_yy > best_xy * t_yy);
        int64_t mm[8];
        std::memcpy(mm, &m, sizeof(mm));
        any |= (mm[0] | mm[1] | mm[2] | mm[3] | mm[4] | mm[5] | mm[6]
                | mm[7]) != 0;
      }
      for (; j < j1; j++) {
        double tmp_xy = xy + x[j];
        double tmp_yy = yy + 2 * ypulse[j] + 1;
        tmp_xy *= tmp_xy;
        any |= (tmp_xy * best_yy > best_xy * tmp_yy);
      }
      if (!any) continue;
      for (j = j0; j < j1; j++) {
        double tmp_xy = xy + x[j];
        double tmp_yy = yy + 2 * ypulse[j] + 1;
        tmp_xy *= tmp_xy;
        if (tmp_xy * best_yy > best_xy * tmp_yy) {
          best_xy = tmp_xy;
          best_yy = tmp_yy;
          pos = j;
        }
      }
    }
    xy += x[pos];
    yy += 2 * ypulse[pos] + 1;
    ypulse[pos]++;
    i++;
  }
  while (i < k) {
    double rst[4];
    for (int ii = 0; ii < 4; ii++) {
      rst[ii] = rsqrt_tab((int)yy + 2 * ii + 1);
    }
    int pos = 0;
    double best_cost;
    {
      double tmp_xy = xy + x[0];
      int yj = ypulse[0];
      double tmp_yy = yj < 4 ? rst[yj]
                             : rsqrt_tab((int)yy + 2 * yj + 1);
      best_cost = 2 * tmp_xy * norm_1 * tmp_yy;
    }
    for (int j0 = 1; j0 < n; j0 += kChunk) {
      int j1 = j0 + kChunk < n ? j0 + kChunk : n;
      int any = 0;
      j = j0;
      // SIMD any-detection (exact): vector lanes evaluate the same
      // expressions; groups where some ypulse >= 4 (rare — pulses
      // concentrate late) fall back to the scalar loop below.
      for (; j + 8 <= j1; j += 8) {
        ps_v8si vyp;
        std::memcpy(&vyp, ypulse + j, sizeof(vyp));
        int32_t yl[8];
        std::memcpy(yl, &vyp, sizeof(yl));
        if ((yl[0] | yl[1] | yl[2] | yl[3] | yl[4] | yl[5] | yl[6]
             | yl[7]) & ~3)
          break;
        ps_v8df vx;
        std::memcpy(&vx, x + j, sizeof(vx));
        ps_v8df t_yy = {rst[yl[0]], rst[yl[1]], rst[yl[2]], rst[yl[3]],
                        rst[yl[4]], rst[yl[5]], rst[yl[6]], rst[yl[7]]};
        ps_v8df vj = {(double)(j + 0), (double)(j + 1), (double)(j + 2),
                      (double)(j + 3), (double)(j + 4), (double)(j + 5),
                      (double)(j + 6), (double)(j + 7)};
        ps_v8df t = 2 * (xy + vx) * norm_1 * t_yy
                    - lambda * vj * (delta_rate + vj * accel_rate);
        ps_v8di m = (t > best_cost);
        int64_t mm[8];
        std::memcpy(mm, &m, sizeof(mm));
        any |= (mm[0] | mm[1] | mm[2] | mm[3] | mm[4] | mm[5] | mm[6]
                | mm[7]) != 0;
      }
      for (; j < j1; j++) {
        double tmp_xy = xy + x[j];
        int yj = ypulse[j];
        double tmp_yy = yj < 4 ? rst[yj]
                               : rsqrt_tab((int)yy + 2 * yj + 1);
        tmp_xy = 2 * tmp_xy * norm_1 * tmp_yy
                 - lambda * j * (delta_rate + j * accel_rate);
        any |= (tmp_xy > best_cost);
      }
      if (!any) continue;
      for (j = j0; j < j1; j++) {
        double tmp_xy = xy + x[j];
        int yj = ypulse[j];
        double tmp_yy = yj < 4 ? rst[yj]
                               : rsqrt_tab((int)yy + 2 * yj + 1);
        tmp_xy = 2 * tmp_xy * norm_1 * tmp_yy
                 - lambda * j * (delta_rate + j * accel_rate);
        if (tmp_xy > best_cost) {
          best_cost = tmp_xy;
          pos = j;
        }
      }
    }
    xy += x[pos];
    yy += 2 * ypulse[pos] + 1;
    ypulse[pos]++;
    i++;
  }
  for (j = 0; j < n; j++) {
    if (xcoeff[j] < 0) ypulse[j] = -ypulse[j];
  }
  return xy / (1e-100 + __builtin_sqrt(xx * yy));
}

}  // extern "C"

/* ---- OBMC motion-compensated prediction ---------------------------------
 * Native mirror of the live OBMC path (reference: src/mc.c:92-206 subpel
 * interpolation, src/mc.c:352-378 + 1650-1750 blending, src/state.c:628-724
 * recursive mesh prediction).  Used by the encoder's motion search where
 * the objective must be the true decoder-side OBMC prediction, and by the
 * frame-level predictor.  Luma and chroma (xdec/ydec) supported. */

namespace obmc {

constexpr int LOG_MVBSIZE_MIN = 3;
constexpr int LOG_MVB_DELTA0 = 3;

static const int32_t SUBPEL[8][6] = {
  {0, 0, 128, 0, 0, 0},    {1, -9, 122, 18, -5, 1},
  {3, -15, 112, 37, -11, 2}, {3, -18, 97, 58, -15, 3},
  {4, -20, 80, 80, -20, 4},  {3, -15, 58, 97, -18, 3},
  {2, -11, 37, 112, -15, 3}, {1, -5, 18, 122, -9, 1}};
static const int VERT_D[22] =
  {0, 0, 1, 1, 0, 0, 1, 2, 0, 0, 2, 1, 0, -1, 1, 1, 0, -1, 0, 1, 1, -1};
/* OD_VERT_DX = VERT_D+1, OD_VERT_DY = VERT_D+0 */
static const int DX_OFF[4][4] =
  {{9, 1, 9, 1}, {13, 13, 1, 1}, {18, 1, 18, 1}, {5, 5, 1, 1}};
static const int DY_OFF[4][4] =
  {{4, 4, 0, 0}, {8, 0, 8, 0}, {12, 12, 0, 0}, {17, 0, 17, 0}};

/* Memoizes predict1fmv outputs for the encoder's ME candidate loops.
 * Keyed on everything the prediction depends on (ref index, leaf
 * origin/size, MV); entries stay valid for a whole frame because the
 * reference planes are fixed, so a hit returns bytes identical to
 * recomputation.  In the refinement loops only one vertex MV changes
 * per candidate, so three of a leaf's four corner predictions hit. */
struct PredCache {
  struct Ent { uint64_t key; uint32_t off; };
  static constexpr int kLogSlots = 16;
  static constexpr uint32_t kEmpty = 0xFFFFFFFFu;
  std::vector<Ent> tab;
  std::vector<uint8_t> pool;
  size_t used = 0;

  void reset() {
    tab.assign((size_t)1 << kLogSlots, Ent{0, kEmpty});
    pool.resize((size_t)4 << 20);
    used = 0;
  }
  /* Call between top-level evals: one eval inserts well under 1 MB, so
   * pointers handed out inside a single pred_block tree never dangle. */
  void flush_if_full() {
    if (used + ((size_t)1 << 20) > pool.size()) {
      std::fill(tab.begin(), tab.end(), Ent{0, kEmpty});
      used = 0;
    }
  }
};

struct Ctx {
  const uint8_t* valid;
  const uint8_t* refidx;
  const int32_t* mv;   /* (nv+1, nh+1, 2): x then y, 1/8 pel */
  const int32_t* mv1;  /* NEXT-reference vectors, same layout */
  int nh, nv;
  const uint8_t* planes[4]; /* padded plane per ref INDEX (not slot) */
  int pstride;
  int pad;
  int xdec, ydec;
  uint8_t* dst;
  int dstride;
  PredCache* cache = nullptr;
  /* When set (not INT_MIN), pred_block_from_setup skips leaves whose
   * four blend corners do not include this vertex: their prediction
   * cannot depend on it, and the destination already holds it. */
  int fvx = INT_MIN, fvy = INT_MIN;
  /* Optional recorder: every blended leaf appends (x, y, nx, ny). */
  std::vector<int>* rects = nullptr;
  /* Record the leaf rects WITHOUT predicting or blending: the leaf
   * decomposition and the fvx/fvy reference filter depend only on the
   * mesh validity structure, so the collected set is exactly the set a
   * real prediction pass would blend.  Used by the ME refinement to
   * price a candidate's fixed (unaffected-cell) SAD before paying for
   * the OBMC prediction. */
  bool collect_only = false;
};

static inline int div_pow2_re(int x, int shift) {
  if (!shift) return x;
  return (x + (((1 << shift) + ((x >> shift) & 1) - 1) >> 1)) >> shift;
}

static inline void get_mv(const Ctx& c, int gy, int gx,
                          int* mx, int* my, int* src) {
  int idx = gy * (c.nh + 1) + gx;
  int r = c.refidx[idx];
  const int32_t* m = (r == 2) ? c.mv1 : c.mv; /* OD_FRAME_NEXT == 2 */
  *mx = m[2 * idx];
  *my = m[2 * idx + 1];
  *src = r;
}

/* 6-tap 1/8-pel prediction of an (ny, nx) block; matches the Python/
 * reference bit-exactly including the int16 wrap of the first stage. */
static void predict1fmv(const Ctx& c, int src, int y0, int x0,
                        int mvx, int mvy, int ny, int nx,
                        uint8_t* __restrict__ out, int ostride) {
  const uint8_t* plane = c.planes[src];
  const int ps = c.pstride;
  int sy = c.pad + y0 + (mvy >> 3);
  int sx = c.pad + x0 + (mvx >> 3);
  int fxi = mvx & 7;
  int fyi = mvy & 7;
  if (!fxi && !fyi) {
    for (int r = 0; r < ny; r++) {
      memcpy(out + r * ostride, plane + (size_t)(sy + r) * ps + sx, nx);
    }
    return;
  }
  const int32_t* fx = SUBPEL[fxi];
  const int32_t* fy = SUBPEL[fyi];
  // Stack buffer covers the OBMC block sizes (<= 64); the encoder-side
  // whole-frame searches spill to a heap buffer.
  int16_t buff_s[69][64];
  int16_t* buff;
  int bstride;
  static thread_local std::vector<int16_t> buff_h;
  if (nx <= 64 && ny <= 64) {
    buff = &buff_s[0][0];
    bstride = 64;
  } else {
    buff_h.resize((size_t)(ny + 5) * nx);
    buff = buff_h.data();
    bstride = nx;
  }
  int nrows = ny + 5;
  for (int r = 0; r < nrows; r++) {
    const uint8_t* __restrict__ w =
        plane + (size_t)(sy - 2 + r) * ps + sx - 2;
    int16_t* __restrict__ br = buff + (size_t)r * bstride;
    if (fxi) {
      // Unrolled 6-tap so the column loop auto-vectorizes.
      int32_t f0 = fx[0], f1 = fx[1], f2 = fx[2], f3 = fx[3], f4 = fx[4],
              f5 = fx[5];
      for (int col = 0; col < nx; col++) {
        int32_t acc = w[col] * f0 + w[col + 1] * f1 + w[col + 2] * f2
                      + w[col + 3] * f3 + w[col + 4] * f4
                      + w[col + 5] * f5;
        br[col] = (int16_t)(acc - (128 << 7));
      }
    } else {
      for (int col = 0; col < nx; col++) {
        br[col] = (int16_t)((w[col + 2] << 7) - (128 << 7));
      }
    }
  }
  for (int r = 0; r < ny; r++) {
    uint8_t* __restrict__ o = out + r * ostride;
    if (fyi) {
      const int16_t* __restrict__ b0 = buff + (size_t)r * bstride;
      const int16_t* __restrict__ b1 = b0 + bstride;
      const int16_t* __restrict__ b2 = b1 + bstride;
      const int16_t* __restrict__ b3 = b2 + bstride;
      const int16_t* __restrict__ b4 = b3 + bstride;
      const int16_t* __restrict__ b5 = b4 + bstride;
      int32_t f0 = fy[0], f1 = fy[1], f2 = fy[2], f3 = fy[3], f4 = fy[4],
              f5 = fy[5];
      for (int col = 0; col < nx; col++) {
        int32_t acc = (int32_t)b0[col] * f0 + (int32_t)b1[col] * f1
                      + (int32_t)b2[col] * f2 + (int32_t)b3[col] * f3
                      + (int32_t)b4[col] * f4 + (int32_t)b5[col] * f5;
        int32_t v = (acc + (1 << 13) + (128 << 14)) >> 14;
        o[col] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    } else {
      const int16_t* __restrict__ b2 = buff + (size_t)(r + 2) * bstride;
      for (int col = 0; col < nx; col++) {
        int32_t v = ((int32_t)b2[col] + (1 << 6) + (128 << 7)) >> 7;
        o[col] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

/* reference: src/mc.c:352-378 */
static void blend_full(const uint8_t* const p[4], int log_x, int log_y,
                       uint8_t* __restrict__ out, int ostride) {
  int nx = 1 << log_x;
  int ny = 1 << log_y;
  int lb2 = log_x + log_y;
  int32_t rnd = 1 << (lb2 - 1);
  const uint8_t* __restrict__ q0 = p[0];
  const uint8_t* __restrict__ q1 = p[1];
  const uint8_t* __restrict__ q2 = p[2];
  const uint8_t* __restrict__ q3 = p[3];
  for (int j = 0; j < ny; j++) {
    uint8_t* __restrict__ o = out + j * ostride;
    const uint8_t* __restrict__ r0 = q0 + (j << log_x);
    const uint8_t* __restrict__ r1 = q1 + (j << log_x);
    const uint8_t* __restrict__ r2 = q2 + (j << log_x);
    const uint8_t* __restrict__ r3 = q3 + (j << log_x);
    for (int i = 0; i < nx; i++) {
      int32_t p0 = r0[i];
      int32_t p1 = r1[i];
      int32_t p2 = r2[i];
      int32_t p3 = r3[i];
      int32_t a = (p0 << log_x) + (p1 - p0) * i;
      int32_t b = (p3 << log_x) + (p2 - p3) * i;
      /* 32-bit exact: |a|, |b| < 2^15 and log_y <= 6. */
      o[i] = (uint8_t)(((a << log_y) + (b - a) * j + rnd) >> lb2);
    }
  }
}

/* reference: src/mc.c:1650-1750 */
static void blend_full_split(const uint8_t* const p[4], int oc, int s,
                             int log_x, int log_y,
                             uint8_t* __restrict__ out, int ostride) {
  int nx = 1 << log_x;
  int ny = 1 << log_y;
  int lb2p1 = log_x + log_y + 1;
  int64_t rnd = 1 << (lb2p1 - 1);
  int64_t s0[4], dsdi[4], dsdj[4], dd[4];
  int lb2 = log_x + log_y;
  s0[0] = (int64_t)2 << lb2; s0[1] = s0[2] = s0[3] = 0;
  dsdi[0] = -((int64_t)2 << log_x); dsdi[1] = (int64_t)2 << log_x;
  dsdi[2] = dsdi[3] = 0;
  dsdj[0] = -((int64_t)2 << log_y); dsdj[1] = dsdj[2] = 0;
  dsdj[3] = (int64_t)2 << log_y;
  dd[0] = 2; dd[1] = -2; dd[2] = 2; dd[3] = -2;
  if (!(s & 1)) {
    int k = (oc + 1) & 3;
    s0[k] >>= 1;   s0[oc] += s0[k];
    dsdi[k] >>= 1; dsdi[oc] += dsdi[k];
    dsdj[k] >>= 1; dsdj[oc] += dsdj[k];
    dd[k] >>= 1;   dd[oc] += dd[k];
  }
  if (!(s & 2)) {
    int k = (oc + 3) & 3;
    s0[k] >>= 1;   s0[oc] += s0[k];
    dsdi[k] >>= 1; dsdi[oc] += dsdi[k];
    dsdj[k] >>= 1; dsdj[oc] += dsdj[k];
    dd[k] >>= 1;   dd[oc] += dd[k];
  }
  /* 32-bit inner loop: |sw| < 2^15 and |p[k]-p0| <= 255 bound |acc| well
   * under 2^31, so this is bit-identical to the 64-bit form (and lets
   * the compiler vectorize the hot ME eval path). */
  int32_t s032[4], dsdi32[4], dsdj32[4], dd32[4];
  for (int k = 0; k < 4; k++) {
    s032[k] = (int32_t)s0[k];
    dsdi32[k] = (int32_t)dsdi[k];
    dsdj32[k] = (int32_t)dsdj[k];
    dd32[k] = (int32_t)dd[k];
  }
  int32_t rnd32 = (int32_t)rnd;
  const uint8_t* __restrict__ q0 = p[0];
  const uint8_t* __restrict__ q1 = p[1];
  const uint8_t* __restrict__ q2 = p[2];
  const uint8_t* __restrict__ q3 = p[3];
  for (int j = 0; j < ny; j++) {
    uint8_t* __restrict__ o = out + j * ostride;
    const uint8_t* __restrict__ r0 = q0 + (j << log_x);
    const uint8_t* __restrict__ r1 = q1 + (j << log_x);
    const uint8_t* __restrict__ r2 = q2 + (j << log_x);
    const uint8_t* __restrict__ r3 = q3 + (j << log_x);
    int32_t b1 = s032[1] + j * dsdj32[1];
    int32_t b2 = s032[2] + j * dsdj32[2];
    int32_t b3 = s032[3] + j * dsdj32[3];
    int32_t e1 = dsdi32[1] + j * dd32[1];
    int32_t e2 = dsdi32[2] + j * dd32[2];
    int32_t e3 = dsdi32[3] + j * dd32[3];
    for (int i = 0; i < nx; i++) {
      int32_t p0 = r0[i];
      int32_t acc = p0 << lb2p1;
      acc += ((int32_t)r1[i] - p0) * (b1 + i * e1);
      acc += ((int32_t)r2[i] - p0) * (b2 + i * e2);
      acc += ((int32_t)r3[i] - p0) * (b3 + i * e3);
      o[i] = (uint8_t)((acc + rnd32) >> lb2p1);
    }
  }
}

/* reference: src/state.c:628-672 */
static void pred_block_from_setup(const Ctx& c, int vx, int vy, int oc,
                                  int s, int log_mvb_sz) {
  const int* dxp = VERT_D + DX_OFF[oc][s];
  const int* dyp = VERT_D + DY_OFF[oc][s];
  if (c.fvx != INT_MIN) {
    bool refs_vertex = false;
    for (int k = 0; k < 4; k++) {
      if (vy + dyp[k] * (1 << log_mvb_sz) == c.fvy
          && vx + dxp[k] * (1 << log_mvb_sz) == c.fvx) {
        refs_vertex = true;
        break;
      }
    }
    if (!refs_vertex) return;
  }
  int log_x = log_mvb_sz + LOG_MVBSIZE_MIN - c.xdec;
  int log_y = log_mvb_sz + LOG_MVBSIZE_MIN - c.ydec;
  int x = vx << (LOG_MVBSIZE_MIN - c.xdec);
  int y = vy << (LOG_MVBSIZE_MIN - c.ydec);
  int nx = 1 << log_x;
  int ny = 1 << log_y;
  if (c.collect_only) {
    if (c.rects) {
      c.rects->push_back(x);
      c.rects->push_back(y);
      c.rects->push_back(nx);
      c.rects->push_back(ny);
    }
    return;
  }
  int mvx[4], mvy[4], srcs[4];
  uint8_t preds[4][64 * 64];
  const uint8_t* pp[4];
  for (int k = 0; k < 4; k++) {
    int gy = vy + dyp[k] * (1 << log_mvb_sz);
    int gx = vx + dxp[k] * (1 << log_mvb_sz);
    int mx, my, src;
    get_mv(c, gy, gx, &mx, &my, &src);
    mvx[k] = div_pow2_re(mx, c.xdec);
    mvy[k] = div_pow2_re(my, c.ydec);
    srcs[k] = src;
    int dup = -1;
    for (int k2 = 0; k2 < k; k2++) {
      if (srcs[k2] == src && mvx[k2] == mvx[k] && mvy[k2] == mvy[k]) {
        dup = k2;
        break;
      }
    }
    if (dup >= 0) {
      pp[k] = pp[dup];
      continue;
    }
    if (c.cache && !c.cache->tab.empty()) {
      PredCache& pc = *c.cache;
      /* Leaf origins are multiples of 8 and MVs are UMV-clamped, so the
       * packed key is unique: src:2 logx:3 logy:3 x>>3:11 y>>3:11
       * mvx:16 mvy:16 bits. */
      uint64_t key = (uint64_t)src
          | ((uint64_t)log_x << 2) | ((uint64_t)log_y << 5)
          | ((uint64_t)((uint32_t)(x >> 3) & 0x7FF) << 8)
          | ((uint64_t)((uint32_t)(y >> 3) & 0x7FF) << 19)
          | ((uint64_t)(uint16_t)(mvx[k] + 32768) << 30)
          | ((uint64_t)(uint16_t)(mvy[k] + 32768) << 46);
      size_t mask = ((size_t)1 << PredCache::kLogSlots) - 1;
      size_t h = (size_t)((key * 0x9E3779B97F4A7C15ull)
                          >> (64 - PredCache::kLogSlots));
      const uint8_t* hit = nullptr;
      for (;;) {
        PredCache::Ent& e = pc.tab[h];
        if (e.off == PredCache::kEmpty) break;
        if (e.key == key) {
          hit = pc.pool.data() + e.off;
          break;
        }
        h = (h + 1) & mask;
      }
      if (hit) {
        pp[k] = hit;
        continue;
      }
      size_t need = (size_t)ny * nx;
      if (pc.used + need <= pc.pool.size()) {
        uint8_t* buf = pc.pool.data() + pc.used;
        predict1fmv(c, src, y, x, mvx[k], mvy[k], ny, nx, buf, nx);
        pc.tab[h] = PredCache::Ent{key, (uint32_t)pc.used};
        pc.used += need;
        pp[k] = buf;
        continue;
      }
    }
    predict1fmv(c, src, y, x, mvx[k], mvy[k], ny, nx, preds[k], nx);
    pp[k] = preds[k];
  }
  uint8_t* dst = c.dst + (size_t)y * c.dstride + x;
  if (s == 3) {
    blend_full(pp, log_x, log_y, dst, c.dstride);
  } else {
    blend_full_split(pp, oc, s, log_x, log_y, dst, c.dstride);
  }
  if (c.rects) {
    c.rects->push_back(x);
    c.rects->push_back(y);
    c.rects->push_back(nx);
    c.rects->push_back(ny);
  }
}

/* reference: src/state.c:674-724 */
static void pred_block(const Ctx& c, int vx, int vy, int log_mvb_sz) {
  int half = (1 << log_mvb_sz) >> 1;
  if (log_mvb_sz > 0
      && c.valid[(vy + half) * (c.nh + 1) + vx + half]) {
    pred_block(c, vx, vy, log_mvb_sz - 1);
    pred_block(c, vx + half, vy, log_mvb_sz - 1);
    pred_block(c, vx, vy + half, log_mvb_sz - 1);
    pred_block(c, vx + half, vy + half, log_mvb_sz - 1);
  } else {
    int oc, s;
    if (log_mvb_sz < LOG_MVB_DELTA0) {
      int mask = (1 << (log_mvb_sz + 1)) - 1;
      oc = (vx & mask) ? 1 : 0;
      if (vy & mask) oc = 3 - oc;
      int s1vx = vx + (VERT_D[1 + ((oc + 1) & 3)] << log_mvb_sz);
      int s1vy = vy + (VERT_D[(oc + 1) & 3] << log_mvb_sz);
      int s3vx = vx + (VERT_D[1 + ((oc + 3) & 3)] << log_mvb_sz);
      int s3vy = vy + (VERT_D[(oc + 3) & 3] << log_mvb_sz);
      s = c.valid[s1vy * (c.nh + 1) + s1vx]
          | (c.valid[s3vy * (c.nh + 1) + s3vx] << 1);
    } else {
      oc = 0;
      s = 3;
    }
    pred_block_from_setup(c, vx, vy, oc, s, log_mvb_sz);
  }
}

/* Like pred_block, but only re-predicts leaf squares whose blend can
 * reference the vertex (fvx, fvy): the vertex-setup tables read corners
 * offset by [-1, +2] mvb units from the square origin, so a square at
 * (vx, vy) with size sz is influenced only when fvx/fvy lie within
 * [vx - sz, vx + 2*sz] x [vy - sz, vy + 2*sz].  Used by the encoder's
 * candidate refinement: the caller guarantees the destination already
 * holds the full prediction for the unchanged vertices, so skipping
 * uninfluenced leaves is exact. */
static void pred_block_filtered(const Ctx& c, int vx, int vy,
                                int log_mvb_sz, int fvx, int fvy) {
  int sz = 1 << log_mvb_sz;
  if (fvx < vx - sz || fvx > vx + 2 * sz
      || fvy < vy - sz || fvy > vy + 2 * sz) {
    return;
  }
  int half = sz >> 1;
  if (log_mvb_sz > 0
      && c.valid[(vy + half) * (c.nh + 1) + vx + half]) {
    pred_block_filtered(c, vx, vy, log_mvb_sz - 1, fvx, fvy);
    pred_block_filtered(c, vx + half, vy, log_mvb_sz - 1, fvx, fvy);
    pred_block_filtered(c, vx, vy + half, log_mvb_sz - 1, fvx, fvy);
    pred_block_filtered(c, vx + half, vy + half, log_mvb_sz - 1, fvx,
                        fvy);
  } else {
    pred_block(c, vx, vy, log_mvb_sz);
  }
}

}  /* namespace obmc */

extern "C" {

/* Predict one level-0 (64x64 luma) mesh block into dst; if cur != NULL,
 * also return the SAD of the prediction vs cur over the block clipped to
 * (w, h).  All pointers are raw addresses of contiguous uint8/int32
 * arrays. */
long long ec_obmc_pred_l0(
    const void* valid, const void* refidx, const void* mv, const void* mv1,
    int nh, int nv,
    const void* plane0, const void* plane1, const void* plane2,
    const void* plane3, int pstride, int pad, int xdec, int ydec,
    void* dst, int dstride, int vx, int vy,
    const void* cur, int cstride, int w, int h) {
  obmc::Ctx c;
  c.valid = (const uint8_t*)valid;
  c.refidx = (const uint8_t*)refidx;
  c.mv = (const int32_t*)mv;
  c.mv1 = (const int32_t*)mv1;
  c.nh = nh;
  c.nv = nv;
  c.planes[0] = (const uint8_t*)plane0;
  c.planes[1] = (const uint8_t*)plane1;
  c.planes[2] = (const uint8_t*)plane2;
  c.planes[3] = (const uint8_t*)plane3;
  c.pstride = pstride;
  c.pad = pad;
  c.xdec = xdec;
  c.ydec = ydec;
  c.dst = (uint8_t*)dst;
  c.dstride = dstride;
  obmc::pred_block(c, vx, vy, obmc::LOG_MVB_DELTA0);
  if (!cur) return 0;
  const uint8_t* cu = (const uint8_t*)cur;
  int x0 = vx << (obmc::LOG_MVBSIZE_MIN - xdec);
  int y0 = vy << (obmc::LOG_MVBSIZE_MIN - ydec);
  int n_x = 1 << (obmc::LOG_MVB_DELTA0 + obmc::LOG_MVBSIZE_MIN - xdec);
  int n_y = 1 << (obmc::LOG_MVB_DELTA0 + obmc::LOG_MVBSIZE_MIN - ydec);
  int ny = n_y < h - y0 ? n_y : h - y0;
  int nx = n_x < w - x0 ? n_x : w - x0;
  long long sad = 0;
  for (int r = 0; r < ny; r++) {
    const uint8_t* a = cu + (size_t)(y0 + r) * cstride + x0;
    const uint8_t* b = (const uint8_t*)dst + (size_t)(y0 + r) * dstride + x0;
    for (int col = 0; col < nx; col++) {
      int d = (int)a[col] - (int)b[col];
      sad += d < 0 ? -d : d;
    }
  }
  return sad;
}

}  /* extern "C" */

/* ---- Directional deringing filter ---------------------------------------
 * Native mirror of od_dering (reference: src/dering.c:54-350): direction
 * search by line-variance maximization, 7-tap conditional-replacement
 * filter along the direction, 4-tap orthogonal filter.  All filter
 * arithmetic int16 with wraparound, cost accumulation int32 with
 * wraparound, exactly as the reference and the Python model. */

namespace dering {

static inline int iabs(int v) { return v < 0 ? -v : v; }

constexpr int BORDER = 3;
constexpr int VERY_LARGE = 30000;

static const int DIV_TABLE[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
static const int THRESH_Q8[18] = {128, 134, 150, 168, 188, 210, 234, 262,
                                  292, 327, 365, 408, 455, 509, 569, 635,
                                  710, 768};
/* (dy, dx) tap offsets per direction (reference: src/dering.c:39-48). */
static const int DIR_OFF[8][3][2] = {
  {{-1, 1}, {-2, 2}, {-3, 3}}, {{0, 1}, {-1, 2}, {-1, 3}},
  {{0, 1}, {0, 2}, {0, 3}},    {{0, 1}, {1, 2}, {1, 3}},
  {{1, 1}, {2, 2}, {3, 3}},    {{1, 0}, {2, 1}, {3, 1}},
  {{1, 0}, {2, 0}, {3, 0}},    {{1, 0}, {2, -1}, {3, -1}}};

static void dir_find8(const int16_t* x, int stride, int coeff_shift,
                      int* best_dir_out, int* var_out) {
  // Row-vectorized accumulation of the 8 directional line sums
  // (reference od_dir_find8, src/dering.c:61-125; SIMD shape follows
  // the row-shift structure of the reference's own SSE4.1 port,
  // src/x86/sse2dering.c).  Partial sums of <= 8 pixels fit int32
  // comfortably; addition order is irrelevant, so the values are
  // bit-identical to the scalar double loop.
  typedef int32_t dv8 __attribute__((vector_size(32)));
  typedef int32_t dv4 __attribute__((vector_size(16)));
  int32_t p0[16] = {0}, p1[16] = {0}, p3[16] = {0}, p4[16] = {0},
          p5[16] = {0}, p7[16] = {0};
  int32_t p2[8], p6v[8];
  dv8 acc6 = (dv8){};
  auto addv8 = [](int32_t* dst, dv8 v) {
    dv8 t;
    memcpy(&t, dst, sizeof(t));
    t += v;
    memcpy(dst, &t, sizeof(t));
  };
  auto addv4 = [](int32_t* dst, dv4 v) {
    dv4 t;
    memcpy(&t, dst, sizeof(t));
    t += v;
    memcpy(dst, &t, sizeof(t));
  };
  for (int i = 0; i < 8; i++) {
    const int16_t* row = x + (size_t)i * stride;
    dv8 v = {row[0], row[1], row[2], row[3],
             row[4], row[5], row[6], row[7]};
    v >>= coeff_shift;
    dv8 vr = __builtin_shufflevector(v, v, 7, 6, 5, 4, 3, 2, 1, 0);
    dv4 pair = {v[0] + v[1], v[2] + v[3], v[4] + v[5], v[6] + v[7]};
    dv4 pairr = __builtin_shufflevector(pair, pair, 3, 2, 1, 0);
    addv8(p0 + i, v);             // partial[0][i + j]
    addv4(p1 + i, pair);          // partial[1][i + j/2]
    p2[i] = v[0] + v[1] + v[2] + v[3] + v[4] + v[5] + v[6] + v[7];
    addv4(p3 + i, pairr);         // partial[3][3 + i - j/2] = [i..i+3] rev
    addv8(p4 + i, vr);            // partial[4][7 + i - j] = [i..i+7] rev
    addv8(p5 + (3 - i / 2), v);   // partial[5][3 - i/2 + j]
    acc6 += v;                    // partial[6][j]
    addv8(p7 + (i / 2), v);       // partial[7][i/2 + j]
  }
  memcpy(p6v, &acc6, sizeof(p6v));
  int64_t partial[8][15];
  for (int i = 0; i < 15; i++) {
    partial[0][i] = p0[i];
    partial[1][i] = p1[i];
    partial[3][i] = p3[i];
    partial[4][i] = p4[i];
    partial[5][i] = p5[i];
    partial[7][i] = p7[i];
  }
  for (int i = 0; i < 8; i++) {
    partial[2][i] = p2[i];
    partial[6][i] = p6v[i];
  }
  int32_t cost[8];
  memset(cost, 0, sizeof(cost));
  for (int i = 0; i < 8; i++) {
    cost[2] += (int32_t)(partial[2][i] * partial[2][i]);
    cost[6] += (int32_t)(partial[6][i] * partial[6][i]);
  }
  cost[2] *= DIV_TABLE[8];
  cost[6] *= DIV_TABLE[8];
  for (int i = 0; i < 7; i++) {
    cost[0] += (int32_t)((partial[0][i] * partial[0][i]
                + partial[0][14 - i] * partial[0][14 - i])
               * DIV_TABLE[i + 1]);
    cost[4] += (int32_t)((partial[4][i] * partial[4][i]
                + partial[4][14 - i] * partial[4][14 - i])
               * DIV_TABLE[i + 1]);
  }
  cost[0] += (int32_t)(partial[0][7] * partial[0][7] * DIV_TABLE[8]);
  cost[4] += (int32_t)(partial[4][7] * partial[4][7] * DIV_TABLE[8]);
  for (int i = 1; i < 8; i += 2) {
    int32_t c = 0;
    for (int j = 0; j < 5; j++) {
      c += (int32_t)(partial[i][3 + j] * partial[i][3 + j]);
    }
    c *= DIV_TABLE[8];
    for (int j = 0; j < 3; j++) {
      c += (int32_t)((partial[i][j] * partial[i][j]
            + partial[i][10 - j] * partial[i][10 - j])
           * DIV_TABLE[2 * j + 2]);
    }
    cost[i] = c;
  }
  int32_t best_cost = 0;
  int best_dir = 0;
  for (int i = 0; i < 8; i++) {
    if (cost[i] > best_cost) {
      best_cost = cost[i];
      best_dir = i;
    }
  }
  *best_dir_out = best_dir;
  *var_out = (int)((best_cost - cost[(best_dir + 4) & 7]) >> 10);
}

// Vector form of the per-pixel filters: one row of the b x b block per
// iteration, GCC vector lanes.  The int16 wraparound of the scalar
// accumulators is preserved (lane ops wrap); the tap-keep comparisons
// are widened to int32 so the |p| == 32768 edge behaves exactly like
// the scalar iabs((int)p) (normative for garbage-stream parity).
#define FILTER_DIRECTION_VEC(B) \
static void filter_direction_vec_##B(const int16_t* in, int istride, \
                                     int threshold, int direction, \
                                     int16_t* out, int ostride) { \
  typedef int16_t vb __attribute__((vector_size(2 * B))); \
  typedef int32_t vw __attribute__((vector_size(4 * B))); \
  static const int taps[3] = {3, 2, 1}; \
  const vw thr32 = (vw){} + threshold; \
  for (int i = 0; i < B; i++) { \
    vb xx, acc = (vb){}; \
    __builtin_memcpy(&xx, in + i * istride, sizeof(vb)); \
    for (int k = 0; k < 3; k++) { \
      int dy = DIR_OFF[direction][k][0]; \
      int dx = DIR_OFF[direction][k][1]; \
      vb a, b2; \
      __builtin_memcpy(&a, in + (i + dy) * istride + dx, sizeof(vb)); \
      __builtin_memcpy(&b2, in + (i - dy) * istride - dx, sizeof(vb)); \
      vb p0 = a - xx, p1 = b2 - xx; \
      vw p0w = __builtin_convertvector(p0, vw); \
      vw p1w = __builtin_convertvector(p1, vw); \
      vw a0 = p0w < 0 ? -p0w : p0w; \
      vw a1 = p1w < 0 ? -p1w : p1w; \
      vb k0 = __builtin_convertvector(a0 < thr32, vb); \
      vb k1 = __builtin_convertvector(a1 < thr32, vb); \
      vb tap = (vb){} + (int16_t)taps[k]; \
      acc += tap * (p0 & k0); \
      acc += tap * (p1 & k1); \
    } \
    vw acc32 = __builtin_convertvector(acc, vw); \
    vb res = xx + __builtin_convertvector((acc32 + 8) >> 4, vb); \
    __builtin_memcpy(out + i * ostride, &res, sizeof(vb)); \
  } \
}
FILTER_DIRECTION_VEC(8)
FILTER_DIRECTION_VEC(4)

#define FILTER_ORTHOGONAL_VEC(B) \
static void filter_orthogonal_vec_##B(const int16_t* in, int istride, \
                                      const int16_t* x_orig, int xstride, \
                                      int threshold, int direction, \
                                      int16_t* out, int ostride) { \
  typedef int16_t vb __attribute__((vector_size(2 * B))); \
  typedef int32_t vw __attribute__((vector_size(4 * B))); \
  int offy, offx; \
  if (0 < direction && direction < 4) { \
    offy = 1; offx = 0; \
  } else { \
    offy = 0; offx = 1; \
  } \
  const vw thr32 = (vw){} + threshold; \
  const vw thr3 = (vw){} + threshold / 3; \
  for (int i = 0; i < B; i++) { \
    vb yy, xo; \
    __builtin_memcpy(&yy, in + i * istride, sizeof(vb)); \
    __builtin_memcpy(&xo, x_orig + i * xstride, sizeof(vb)); \
    vw yy32 = __builtin_convertvector(yy, vw); \
    vw xo32 = __builtin_convertvector(xo, vw); \
    vw dd = yy32 - xo32; \
    dd = dd < 0 ? -dd : dd; \
    vw at = thr3 + dd; \
    at = thr32 < at ? thr32 : at; \
    vb acc = (vb){}; \
    static const int mult[4] = {1, 2, -1, -2}; \
    for (int m = 0; m < 4; m++) { \
      int dy = offy * mult[m]; \
      int dx = offx * mult[m]; \
      vb nb; \
      __builtin_memcpy(&nb, in + (i + dy) * istride + dx, sizeof(vb)); \
      vb p = nb - yy; \
      vw pw = __builtin_convertvector(p, vw); \
      vw ap = pw < 0 ? -pw : pw; \
      vb keep = __builtin_convertvector(ap < at, vb); \
      acc += p & keep; \
    } \
    vw acc32 = __builtin_convertvector(acc, vw); \
    vb res = yy + __builtin_convertvector((3 * acc32 + 8) >> 4, vb); \
    __builtin_memcpy(out + i * ostride, &res, sizeof(vb)); \
  } \
}
FILTER_ORTHOGONAL_VEC(8)
FILTER_ORTHOGONAL_VEC(4)

static void filter_direction(const int16_t* in, int istride, int n,
                             int threshold, int direction,
                             int16_t* out, int ostride) {
  if (n == 8) {
    filter_direction_vec_8(in, istride, threshold, direction, out,
                           ostride);
    return;
  }
  if (n == 4) {
    filter_direction_vec_4(in, istride, threshold, direction, out,
                           ostride);
    return;
  }
  static const int taps[3] = {3, 2, 1};
  for (int i = 0; i < n; i++) {
    for (int j = 0; j < n; j++) {
      int16_t xx = in[i * istride + j];
      int16_t acc = 0;
      for (int k = 0; k < 3; k++) {
        int dy = DIR_OFF[direction][k][0];
        int dx = DIR_OFF[direction][k][1];
        int16_t p0 = (int16_t)(in[(i + dy) * istride + j + dx] - xx);
        int16_t p1 = (int16_t)(in[(i - dy) * istride + j - dx] - xx);
        if (iabs((int)p0) < threshold) acc = (int16_t)(acc + taps[k] * p0);
        if (iabs((int)p1) < threshold) acc = (int16_t)(acc + taps[k] * p1);
      }
      out[i * ostride + j] = (int16_t)(xx + (((int32_t)acc + 8) >> 4));
    }
  }
}

static void filter_orthogonal(const int16_t* in, int istride,
                              const int16_t* x_orig, int xstride, int n,
                              int threshold, int direction,
                              int16_t* out, int ostride) {
  if (n == 8) {
    filter_orthogonal_vec_8(in, istride, x_orig, xstride, threshold,
                            direction, out, ostride);
    return;
  }
  if (n == 4) {
    filter_orthogonal_vec_4(in, istride, x_orig, xstride, threshold,
                            direction, out, ostride);
    return;
  }
  int offy, offx;
  if (0 < direction && direction < 4) {
    offy = 1; offx = 0;
  } else {
    offy = 0; offx = 1;
  }
  for (int i = 0; i < n; i++) {
    for (int j = 0; j < n; j++) {
      int32_t yy = in[i * istride + j];
      int32_t at = threshold / 3
                   + iabs(yy - (int32_t)x_orig[i * xstride + j]);
      if (threshold < at) at = threshold;
      int16_t acc = 0;
      for (int m = 0; m < 4; m++) {
        static const int mult[4] = {1, 2, -1, -2};
        int dy = offy * mult[m];
        int dx = offx * mult[m];
        int16_t p = (int16_t)(in[(i + dy) * istride + j + dx] - yy);
        if (iabs((int)p) < at) acc = (int16_t)(acc + p);
      }
      out[i * ostride + j] = (int16_t)(yy + ((3 * (int32_t)acc + 8) >> 4));
    }
  }
}

}  /* namespace dering */

extern "C" {

/* Filter one deringing superblock for several candidate thresholds in
 * one call (the encoder's dering RDO): the bordered input copy, the
 * per-8x8 direction search and the skip mask are threshold-independent
 * and shared; only the final threshold scaling and the two filter
 * passes run per candidate.  Output-identical to nthr separate
 * ec_dering calls.  outs: int16 (nthr, n, ostride). */
void ec_dering_multi(const void* plane_, int ph, int pw, int sby,
                     int sbx, int xdec, int pli, const void* bskip_,
                     int skip_h, int skip_w, const int32_t* thresholds,
                     int nthr, int n, void* dirs_, int coeff_shift,
                     void* outs_, int ostride) {
  using namespace dering;
  const int16_t* plane = (const int16_t*)plane_;
  const uint8_t* bskip = (const uint8_t*)bskip_;
  int32_t* dirs = (int32_t*)dirs_;
  int16_t* outs = (int16_t*)outs_;
  int nhdr = pw >> (6 - xdec);
  int nvdr = ph >> (6 - xdec);
  int bsize = 3 - xdec;
  int nb = n >> bsize;
  const int istride = 64 + 2 * BORDER;
  int16_t inb0[(64 + 2 * BORDER) * (64 + 2 * BORDER)];
  for (int i = 0; i < (n + 2 * BORDER) * istride; i++)
    inb0[i] = VERY_LARGE;
  int y0 = sby << (6 - xdec);
  int x0 = sbx << (6 - xdec);
  int i_lo = sby != 0 ? -BORDER : 0;
  int i_hi = n + (sby != nvdr - 1 ? BORDER : 0);
  int j_lo = sbx != 0 ? -BORDER : 0;
  int j_hi = n + (sbx != nhdr - 1 ? BORDER : 0);
  for (int i = i_lo; i < i_hi; i++) {
    for (int j = j_lo; j < j_hi; j++) {
      inb0[(BORDER + i) * istride + BORDER + j] =
          plane[(size_t)(y0 + i) * pw + x0 + j];
    }
  }
  const int16_t* x_orig = plane + (size_t)y0 * pw + x0;
  // Threshold-independent per-block state: direction + the THRESH_Q8
  // scale index (or -1 for wrapped-negative variance / skip blocks and
  // -2 for chroma's unscaled threshold).
  int32_t tscale[8 * 8];
  if (pli == 0) {
    for (int by = 0; by < nb; by++) {
      for (int bx = 0; bx < nb; bx++) {
        int d, var;
        dir_find8(x_orig + (size_t)8 * by * pw + 8 * bx, pw, coeff_shift,
                  &d, &var);
        dirs[by * nb + bx] = d;
        int v1 = var >> 6;
        if (v1 > 32767) v1 = 32767;
        if (v1 < 0) {
          tscale[by * nb + bx] = -1;
        } else {
          tscale[by * nb + bx] =
              v1 > 0 ? 32 - __builtin_clz((unsigned)v1) : 0;
        }
      }
    }
  } else {
    for (int i = 0; i < nb * nb; i++) tscale[i] = -2;
  }
  (void)skip_h;
  for (int by = 0; by < nb; by++) {
    for (int bx = 0; bx < nb; bx++) {
      int xstart = 0, ystart = 0;
      int xend = 2 >> xdec, yend = 2 >> xdec;
      xstart -= sbx != 0;
      ystart -= sby != 0;
      xend += sbx != nhdr - 1;
      yend += sby != nvdr - 1;
      int skip = 1;
      for (int i = ystart; i < yend && skip; i++) {
        for (int j = xstart; j < xend; j++) {
          int yy = (sby << (4 - xdec)) + ((by << 1) >> xdec) + i;
          int xx = (sbx << (4 - xdec)) + ((bx << 1) >> xdec) + j;
          if (!bskip[(size_t)yy * skip_w + xx]) {
            skip = 0;
            break;
          }
        }
      }
      if (skip) tscale[by * nb + bx] = -1;
    }
  }
  int b = 1 << bsize;
  int16_t inb[(64 + 2 * BORDER) * (64 + 2 * BORDER)];
  int16_t tmp[64 * 64];
  int32_t thresh[8 * 8];
  for (int ti = 0; ti < nthr; ti++) {
    int threshold = thresholds[ti];
    int16_t* out = outs + (size_t)ti * n * ostride;
    for (int i = 0; i < nb * nb; i++) {
      if (tscale[i] == -1) thresh[i] = 0;
      else if (tscale[i] == -2) thresh[i] = threshold;
      else thresh[i] = (threshold * THRESH_Q8[tscale[i]] + 128) >> 8;
    }
    memcpy(inb, inb0, sizeof(inb0));
    for (int by = 0; by < nb; by++) {
      for (int bx = 0; bx < nb; bx++) {
        filter_direction(
            inb + (size_t)(BORDER + by * b) * istride + BORDER + bx * b,
            istride, b, thresh[by * nb + bx], dirs[by * nb + bx],
            tmp + (size_t)by * b * n + bx * b, n);
      }
    }
    for (int i = 0; i < n; i++) {
      for (int j = 0; j < n; j++) {
        inb[(BORDER + i) * istride + BORDER + j] = tmp[i * n + j];
      }
    }
    for (int by = 0; by < nb; by++) {
      for (int bx = 0; bx < nb; bx++) {
        filter_orthogonal(
            inb + (size_t)(BORDER + by * b) * istride + BORDER + bx * b,
            istride, x_orig + (size_t)by * b * pw + bx * b, pw, b,
            thresh[by * nb + bx], dirs[by * nb + bx],
            out + (size_t)by * b * ostride + bx * b, ostride);
      }
    }
  }
}

/* Filter one deringing superblock.  plane: full int16 plane (ph, pw);
 * dirs: int32 (nvb, nhb) buffer, written for pli==0 and read otherwise;
 * out: int16 (n, n) with stride ostride. */
void ec_dering(const void* plane_, int ph, int pw, int sby, int sbx,
               int xdec, int pli, const void* bskip_, int skip_h,
               int skip_w, int threshold, int n, void* dirs_,
               int coeff_shift, void* out_, int ostride) {
  using namespace dering;
  const int16_t* plane = (const int16_t*)plane_;
  const uint8_t* bskip = (const uint8_t*)bskip_;
  int32_t* dirs = (int32_t*)dirs_;
  int16_t* out = (int16_t*)out_;
  int nhdr = pw >> (6 - xdec);
  int nvdr = ph >> (6 - xdec);
  int bsize = 3 - xdec;
  int nb = n >> bsize;
  const int istride = 64 + 2 * BORDER;
  int16_t inb[(64 + 2 * BORDER) * (64 + 2 * BORDER)];
  for (int i = 0; i < (n + 2 * BORDER) * istride; i++) inb[i] = VERY_LARGE;
  int y0 = sby << (6 - xdec);
  int x0 = sbx << (6 - xdec);
  int i_lo = sby != 0 ? -BORDER : 0;
  int i_hi = n + (sby != nvdr - 1 ? BORDER : 0);
  int j_lo = sbx != 0 ? -BORDER : 0;
  int j_hi = n + (sbx != nhdr - 1 ? BORDER : 0);
  for (int i = i_lo; i < i_hi; i++) {
    for (int j = j_lo; j < j_hi; j++) {
      inb[(BORDER + i) * istride + BORDER + j] =
          plane[(size_t)(y0 + i) * pw + x0 + j];
    }
  }
  const int16_t* x_orig = plane + (size_t)y0 * pw + x0;
  int32_t thresh[8 * 8];
  if (pli == 0) {
    for (int by = 0; by < nb; by++) {
      for (int bx = 0; bx < nb; bx++) {
        int d, var;
        dir_find8(x_orig + (size_t)8 * by * pw + 8 * bx, pw, coeff_shift,
                  &d, &var);
        dirs[by * nb + bx] = d;
        int v1 = var >> 6;
        if (v1 > 32767) v1 = 32767;
        if (v1 < 0) {
          // Wrapped-negative variance (garbage streams): the reference
          // reads past its threshold table (OD_ILOG(v1) == 32, an
          // out-of-bounds upstream UB) and lands on a negative int16,
          // leaving the block unfiltered; emulate deterministically.
          thresh[by * nb + bx] = 0;
        } else {
          int ilog = v1 > 0 ? 32 - __builtin_clz((unsigned)v1) : 0;
          thresh[by * nb + bx] = (threshold * THRESH_Q8[ilog] + 128) >> 8;
        }
      }
    }
  } else {
    for (int i = 0; i < nb * nb; i++) thresh[i] = threshold;
  }
  (void)skip_h;
  for (int by = 0; by < nb; by++) {
    for (int bx = 0; bx < nb; bx++) {
      int xstart = 0, ystart = 0;
      int xend = 2 >> xdec, yend = 2 >> xdec;
      xstart -= sbx != 0;
      ystart -= sby != 0;
      xend += sbx != nhdr - 1;
      yend += sby != nvdr - 1;
      int skip = 1;
      for (int i = ystart; i < yend && skip; i++) {
        for (int j = xstart; j < xend; j++) {
          int yy = (sby << (4 - xdec)) + ((by << 1) >> xdec) + i;
          int xx = (sbx << (4 - xdec)) + ((bx << 1) >> xdec) + j;
          if (!bskip[(size_t)yy * skip_w + xx]) {
            skip = 0;
            break;
          }
        }
      }
      if (skip) thresh[by * nb + bx] = 0;
    }
  }
  int b = 1 << bsize;
  int16_t tmp[64 * 64];
  for (int by = 0; by < nb; by++) {
    for (int bx = 0; bx < nb; bx++) {
      filter_direction(
          inb + (size_t)(BORDER + by * b) * istride + BORDER + bx * b,
          istride, b, thresh[by * nb + bx], dirs[by * nb + bx],
          tmp + (size_t)by * b * n + bx * b, n);
    }
  }
  /* Second pass input: first-pass output with the same borders. */
  for (int i = 0; i < n; i++) {
    for (int j = 0; j < n; j++) {
      inb[(BORDER + i) * istride + BORDER + j] = tmp[i * n + j];
    }
  }
  for (int by = 0; by < nb; by++) {
    for (int bx = 0; bx < nb; bx++) {
      filter_orthogonal(
          inb + (size_t)(BORDER + by * b) * istride + BORDER + bx * b,
          istride, x_orig + (size_t)by * b * pw + bx * b, pw, b,
          thresh[by * nb + bx], dirs[by * nb + bx],
          out + (size_t)by * b * ostride + bx * b, ostride);
    }
  }
}

}  /* extern "C" */

// Reconstruction store: od_coeff_to_ref_buf (state.py
// coeff_to_ref_plane) as one vectorizable pass.  fpr selects the
// 12-bit uint16 reference layout; mode is the bitdepth_mode (lossless
// coefficients run at the input depth).
extern "C" void ec_coeff_to_ref(const int32_t* c, void* out, int64_t n,
                                int lossless, int fpr, int mode) {
  if (fpr) {
    int shift = lossless ? 4 - 2 * (mode - 1) : 0;
    uint16_t* o = (uint16_t*)out;
    for (int64_t i = 0; i < n; i++) {
      int32_t v = c[i] * (1 << shift) + (128 << 4);
      if (v < 0) v = 0;
      if (v > (1 << 12) - 1) v = (1 << 12) - 1;
      o[i] = (uint16_t)v;
    }
  } else {
    int shift = lossless ? 0 : 4;
    uint8_t* o = (uint8_t*)out;
    for (int64_t i = 0; i < n; i++) {
      int32_t v = ((c[i] + ((1 << shift) >> 1)) >> shift) + 128;
      if (v < 0) v = 0;
      if (v > 255) v = 255;
      o[i] = (uint8_t)v;
    }
  }
}

// Lightweight profiling counters (read via fc_get_prof).
extern "C" void fc_get_prof(double *out) {
  out[0] = g_prof_pvq; out[1] = g_prof_rate; out[2] = g_prof_snap;
  out[3] = g_prof_dct; out[4] = g_prof_dering; out[5] = g_prof_dist;
  out[6] = g_prof_filt;
  out[7] = g_prof_me_glob; out[8] = g_prof_me_full;
  out[9] = g_prof_me_mesh; out[10] = g_prof_me_refine;
  out[11] = g_prof_me_pred; out[12] = g_prof_me_sad;
  out[13] = g_prof_pvq_search; out[14] = g_prof_pvq_rate;
  out[15] = g_prof_blk; out[16] = g_prof_haardc; out[17] = g_prof_reorder;
  g_prof_blk = g_prof_haardc = g_prof_reorder = 0;
  g_prof_pvq_search = g_prof_pvq_rate = 0;
  g_prof_me_glob = g_prof_me_full = g_prof_me_mesh = g_prof_me_refine = 0;
  g_prof_me_pred = g_prof_me_sad = 0;
  g_prof_pvq = g_prof_rate = g_prof_snap = 0;
  g_prof_dct = g_prof_dering = g_prof_dist = g_prof_filt = 0;
}

// Native whole-frame coefficient encoder (fc_encode_frame et al.).
#include "frame_enc.inc"

// Test/benchmark entry for the RDO distortion metric (the SIMD form must
// stay bit-identical to daala_tpu/codec/dist.py compute_dist).
extern "C" double fc_compute_dist(const int32_t *x, int xstride,
                                  const int32_t *y, int ystride, int n,
                                  int use_activity_masking,
                                  int coded_quantizer, int flat_qm) {
  return fc::compute_dist(x, xstride, y, ystride, n, use_activity_masking,
                          coded_quantizer, flat_qm);
}

// Native motion-estimation engine (me_estimate et al.).
#include "me_enc.inc"

// Native whole-frame decoder (fd_decode_mvs / fc_decode_frame).
#include "frame_dec.inc"

// Native open-loop block-size splitter (bs_split_superblocks).
#include "bs_enc.inc"
