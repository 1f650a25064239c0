// The PVQ band search around its pulse search (models/pvqsearch.py
// band_search): band_prologue_kernel before csrc/pulse_search.cu's launch,
// band_epilogue_kernel after it, so that a band_search call is three
// launches with nothing read back to the host.
//
// Replaces the rest of band_search (daala_tpu/models/pvqsearch.py:562),
// which JAX runs in XLA, not a Pallas kernel.  The port's plain versions
// (ops/cuda/band_kernels.py band_prologue_plain, band_epilogue_plain) take
// about 550 launches a keyframe call and 1,350 an inter call.
//
// What bounds it.  Bytes: each row's n coefficients, reference
// coefficients and QM values come in once, and the pulse search's rows go
// out once each (inter: the reflected row that the 12 theta candidates
// search and the x16 row of the 2 noref candidates; keyframe: x16), with
// each candidate's fields; the epilogue reads each candidate's ok flag and
// the ok ones' pulses and fields once (only they can win: 12-35% of an
// inter call's candidates on the 1080p clip, all of a keyframe's) and
// writes the winner's.  Operations (chip_smoke.py band_work): the
// prologue's row is a long scalar chain of int64 fixed-point arithmetic
// (two gains, the reflection, glibc's atan2f, and each candidate's theta
// and k); the epilogue's is its candidates' split trees, two logs and up
// to four CDF reads for each node that codes, which the call's pulses
// decide.  A call has 10^3 to 10^4 rows.
//
// Where the time goes (measured on phase 3c's 1080p calls with builds that
// stopped after each stage, the occupancy API and ptxas; PERF.md section
// 6).  The first design's prologue (a warp a row, 4 blocks of 8 warps an SM)
// ran each row's scalar chain on all 32 lanes, so its time hardly moved with
// n (inter 25-36 us at n = 8 to 128): the same kernel at 8 lanes a row takes
// less than half as long at n = 8 to 32, the chain being issue-bound, and at
// n = 128 the gather, a table read and then the coefficients it points at,
// is most of what is left.  The first design's epilogue (a warp a candidate,
// 14 warps a block, 3 blocks an SM) walked every node, the logs on every
// lane whose node codes, 32 nodes at a time, then 14 warps waited at two
// barriers for one lane's choice (155 us at inter n = 128).  Its redesign
// first read a candidate's pulses when its pass came, and those loads were
// 38 of its 90 us at n = 128; staged for the whole task at once, they moved
// the wait to the traffic (49 of 72 us with 2 blocks an SM); only the ok
// candidates, the only ones that can win, are now read and searched: 43 us,
// and 40 with the registers it spilled at 64.  Few nodes code (about 40 a
// row at n = 128), so the two logs a node cost little; what remains is the
// prefix sums and the nodes' tests, a few hundred instructions a candidate,
// and at n <= 32 the fixed cost of a task (two loads one after the other,
// the sums, the decision).
//
// Design.
// - band_prologue_kernel<G>: a group of G = 8, 16 or 32 lanes a row, so a
//   warp runs the scalar chain of 32 / G rows at once (G from the call's
//   rows and n: the fewest lanes that still give 8 warps an SM, 16 or
//   more above 32 lanes a band).  The group gathers its row's
//   coefficients, reference coefficients and QM values into shared memory,
//   then runs csrc/band_row.cuh br::prologue_row with GroupLanes: its
//   integer sums in three fused butterflies within the group (the squares
//   and the reference's nonzero lanes; the gains' energies, the
//   correlation and the reference's largest lane; the reflection's energy
//   and projection), the gains' and compute_theta's divisions through a
//   double quotient corrected to the exact floor (br::floordiv_q), lane c
//   of the group candidate c (and c + G).
// - band_epilogue_kernel<NMAX>: a warp a task of one inter row (14
//   candidates) or 1 to 7 keyframe rows (2 each); the block stages the
//   split trees' coding nodes and the CDF tables in shared memory once,
//   while each warp reads its first task's fields.  The task's ok
//   candidates' pulses come into shared memory by cp.async, 16 bytes a
//   copy where n % 4 == 0, all at once.  For each ok candidate (2 or 4 at
//   once below 16 lanes), the warp forms the prefix sums of its
//   magnitudes and of the magnitudes times their lane, then tests its
//   nodes (at n = 128 first whether they hold pulses, then only those)
//   and appends the coding ones (br::node_term) in preorder to the warp's
//   list of terms by a ballot.  At a flush (the task's end, or a list
//   that could overflow) every lane computes one listed term's two logs
//   at a time (br::term_cost), then a lane a
//   candidate runs XLA's ordered sums over its terms (br::rate_chunks; 8
//   lanes a candidate at 16 to 32 nodes, br::lanes8_part then the
//   halving by shuffles and br::lanes8_rest).  A lane a candidate finishes
//   its cost, a lane a row decides (br::decide_row), and the warp writes
//   the winner's pulses.  No barrier after the tables' staging: a row
//   waits only on its own warp.
// Every float operation is the plain versions' through csrc/pulse_step.cuh
// and band_row.cuh, the arccos included (glibc's atan2f written out,
// br::atan2f_glibc), and the kernels are built without fast math: bit for
// bit with the plain versions on the card and on the CPU.
// band_acos_probe_kernel runs the prologue's arccos alone, for the checks
// that hold it to its plain version on every float32 in [-1, 1].

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "band_row.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_N = 128;  // the codec's widest band
constexpr int PRO_THREADS = 128;
constexpr int EPI_WARPS = 8;

// br::SerialLanes's loops over a group of G lanes of a warp (lane gl of
// it): lane gl takes j = gl, gl + G, ...; the sums' butterflies stay in
// the group.  Every group of a warp calls them alike.
template <int G>
struct GroupLanes {
  int gl;

  template <int K, typename F>
  __device__ __forceinline__ void sums(int n, F f, int64_t *s) const {
#pragma unroll
    for (int q = 0; q < K; q++) s[q] = 0;
    for (int j = gl; j < n; j += G) {
      int64_t v[K];
      f(j, v);
#pragma unroll
      for (int q = 0; q < K; q++) s[q] = br::add(s[q], v[q]);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < K; q++)
        s[q] = br::add(s[q],
                       (int64_t)__shfl_xor_sync(FULL, (long long)s[q], o));
  }
  template <int K, typename F, typename A>
  __device__ __forceinline__ int sums_argmax(int n, F f, A g,
                                             int64_t *s) const {
#pragma unroll
    for (int q = 0; q < K; q++) s[q] = 0;
    int64_t best = -1;
    int at = 0x7fffffff;
    for (int j = gl; j < n; j += G) {
      int64_t v[K];
      f(j, v);
#pragma unroll
      for (int q = 0; q < K; q++) s[q] = br::add(s[q], v[q]);
      const int64_t b = g(j);
      if (b > best) {
        best = b;
        at = j;
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < K; q++)
        s[q] = br::add(s[q],
                       (int64_t)__shfl_xor_sync(FULL, (long long)s[q], o));
      const int64_t ob = (int64_t)__shfl_xor_sync(FULL, (long long)best, o);
      const int oa = __shfl_xor_sync(FULL, at, o);
      if (ob > best || (ob == best && oa < at)) {
        best = ob;
        at = oa;
      }
    }
    return at;
  }
  template <typename F>
  __device__ __forceinline__ void each(int n, F f) const {
    for (int j = gl; j < n; j += G) f(j);
  }
  __device__ __forceinline__ bool leader() const { return gl == 0; }
};

// Rows past the call's last run that row again (their warp's butterflies
// need every lane) and write nothing; a warp past it returns.  Shared
// memory: the block's rows' gathered coefficients, reference
// coefficients and QM values, n int32 each.
template <int G>
__global__ void __launch_bounds__(PRO_THREADS) band_prologue_kernel(
    const int32_t *__restrict__ dflat, const int32_t *__restrict__ mdflat,
    long long dlen, const int32_t *__restrict__ base,
    const int32_t *__restrict__ tabsel, const int32_t *__restrict__ tab,
    const int32_t *__restrict__ qmtab, const int32_t *__restrict__ q0,
    const uint8_t *__restrict__ beta15, int m, int n, int keyframe, float lam,
    long long rt0, long long rt1, float *xs, uint8_t *lane_ok, int32_t *src,
    float *cf, int32_t *ci, float *rf) {
  extern __shared__ int32_t pro_smem[];
  constexpr int RPB = PRO_THREADS / G;  // rows a block
  const int rl = threadIdx.x / G, gl = threadIdx.x % G;
  const int64_t r_first = (int64_t)blockIdx.x * RPB;
  if (r_first + (threadIdx.x >> 5) * (32 / G) >= m) return;  // the warp
  const int64_t row = r_first + rl;
  const bool live = row < m;
  const int64_t r = live ? row : m - 1;
  int32_t *sx = pro_smem + rl * 3 * n, *sr = sx + n, *sq = sr + n;
  const int64_t t = tabsel[r], b0 = base[r];
#pragma unroll 4
  for (int j = gl; j < n; j += G) {
    const int64_t idx = b0 + tab[t * n + j];
    const bool inb = idx >= 0 && idx < dlen;
    sx[j] = inb ? dflat[idx] : 0;
    sr[j] = inb && !keyframe ? mdflat[idx] : 0;
    sq[j] = qmtab[t * n + j];
  }
  __syncwarp();
  const br::Out o{xs, lane_ok, src, cf, ci, rf, m, r, keyframe ? 2 : 14,
                  live};
  br::prologue_row(GroupLanes<G>{gl}, n, keyframe != 0, lam, sx, sr, sq,
                   q0[r], beta15[r] != 0, rt0, rt1, o);
}

__global__ void band_acos_probe_kernel(const float *__restrict__ c,
                                       float *__restrict__ out,
                                       int64_t count) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride)
    out[i] = br::acos_xla(c[i]);
}

// A warp's scratch in the epilogue's shared memory: its task's pulses,
// its list of terms, a pass's prefix sums and nodes that hold pulses, its
// candidates and rows.
template <int NMAX>
struct alignas(16) EpiWarp {
  static constexpr int CPP = 32 / (NMAX < 32 ? NMAX : 32);
  int32_t sy[br::EPI_CW][NMAX];  // by slot
  br::Term list[br::EPI_LCAP];
  int64_t cs[CPP][NMAX + 1], ws[CPP][NMAX + 1];
  uint8_t hold[NMAX];
  br::Cand cand[br::EPI_CW];
  int seg[br::EPI_CW + 1], slot[br::EPI_CW];  // by slot
  float rate[br::EPI_CW];
  int win[br::EPI_CW];
};

// The epilogue's dynamic shared memory: the two trees' coding nodes, the
// CDF tables (use_cdf), then EPI_WARPS warps' scratch.
struct EpiTables {
  int ni_th, ni_nr, k1n, spn;
  __host__ __device__ int table_bytes() const {
    return ((ni_th + ni_nr) * 16 + (k1n + spn) * 4 + 15) & ~15;
  }
};

// The epilogue kernel's body.  NMAX: the widest band of the
// instantiation.  Lane layout of a pass: a candidate takes LPC lanes, VPL
// pulses a lane, CPP candidates a pass; its nodes NIT rounds of LPC.  vec:
// y_c and y_out take 16- and 8-byte vectors (n % 4 == 0, aligned).
template <int NMAX>
__device__ __forceinline__ void epilogue_tasks(
    const br::EpiIn &a, const br::Node *__restrict__ nodes_th,
    const br::Node *__restrict__ nodes_nr, const EpiTables &tb, int rpw,
    int vec, int32_t *ints, int16_t *y_out, float *skip_diff) {
  constexpr int LPC = NMAX < 32 ? NMAX : 32;
  constexpr int VPL = NMAX / LPC < 4 ? NMAX / LPC : 4;
  constexpr int CPP = 32 / LPC;
  constexpr int NIT = (NMAX - 1 + LPC - 1) / LPC;
  static_assert(LPC * VPL >= NMAX, "a pass covers the widest band");
  extern __shared__ int4 epi_smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = a.C, n = a.n, CW = rpw * C;
  const int64_t m = a.m, tasks = (m + rpw - 1) / rpw;
  // Lane l < CW: candidate l's fields of the task, read a task ahead (the
  // first before the tables' staging); lane l < rpw: row l's skip and
  // initial distortions.
  br::CandIn in{};
  float skip_dist = 0.0f, dist0 = 0.0f;
  auto fields = [&](int64_t task) {
    const int64_t r0 = task * rpw, lrow = r0 + lane / C;
    if (task < tasks && lane < CW && lrow < m)
      in = br::load_cand(a, lrow, lane % C);
    if (task < tasks && lane < rpw && r0 + lane < m) {
      skip_dist = a.rf[m + r0 + lane];
      dist0 = a.rf[2 * m + r0 + lane];
    }
  };
  fields((int64_t)blockIdx.x * EPI_WARPS + w);
  br::Node *nth = (br::Node *)epi_smem, *nnr = nth + tb.ni_th;
  int32_t *k1s = (int32_t *)(nnr + tb.ni_nr), *sps = k1s + tb.k1n;
  for (int e = threadIdx.x; e < tb.ni_th; e += blockDim.x) nth[e] = nodes_th[e];
  for (int e = threadIdx.x; e < tb.ni_nr; e += blockDim.x) nnr[e] = nodes_nr[e];
  for (int e = threadIdx.x; e < tb.k1n; e += blockDim.x) k1s[e] = a.k1[e];
  for (int e = threadIdx.x; e < tb.spn; e += blockDim.x) sps[e] = a.sp[e];
  __syncthreads();
  EpiWarp<NMAX> &ws = ((EpiWarp<NMAX> *)((char *)epi_smem +
                                         tb.table_bytes()))[w];
  const int nn_th = 2 * (n - 1) - 1, nn_nr = 2 * n - 1;
  // Lanes a candidate in the sums: 8 where a tree of 16 to 32 nodes sums
  // in XLA's 8 lanes.
  const bool l8 = br::sums_in_lanes8(nn_th) || br::sums_in_lanes8(nn_nr);
  const int sub = lane / LPC, gl = lane % LPC;
  for (int64_t task = (int64_t)blockIdx.x * EPI_WARPS + w; task < tasks;
       task += (int64_t)gridDim.x * EPI_WARPS) {
    const int64_t r0 = task * rpw;
    // The ok candidates take the task's slots in order: only they can
    // win.
    const int lc = lane % C;
    const bool llive = lane < CW && r0 + lane / C < m;
    const unsigned okm = __ballot_sync(FULL, llive && in.ok != 0);
    const int nok = __popc(okm);
    if ((okm >> lane) & 1) ws.slot[__popc(okm & ((1u << lane) - 1u))] = lane;
    if (lane < br::EPI_CW) ws.rate[lane] = 0.0f;
    __syncwarp();
    // Their pulses into shared memory, every copy in flight at once.
    const int per = vec ? n / 4 : n;  // copies a candidate
    for (int t = lane; t < nok * per; t += 32) {
      const int s = t / per, q = t - s * per, wc = ws.slot[s];
      const int32_t *y = a.y_c + ((int64_t)(wc % C) * m + r0 + wc / C) * n;
      if (vec)
        __pipeline_memcpy_async(&ws.sy[s][4 * q], y + 4 * q, 16);
      else
        __pipeline_memcpy_async(&ws.sy[s][q], y + q, 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    if (a.use_cdf) {
      int count = 0, first = 0;
      auto flush = [&](int last) {
        for (int q = lane; q < count; q += 32)
          ws.list[q].a = br::term_cost(ws.list[q]);
        __syncwarp();
        auto span = [&](int s, int *b, int *e) {
          *b = ws.seg[s];
          *e = s + 1 < last ? ws.seg[s + 1] : count;
        };
        if (l8) {
          for (int s0 = first; s0 < last; s0 += 4) {
            const int s = s0 + (lane >> 3), i = lane & 7;
            const bool on = s < last;
            int b = 0, e = 0;
            if (on) span(s, &b, &e);
            const int NN = on ? br::cand_nn(a, ws.slot[s] % C) : 0;
            float p1 = 0.0f, p2 = 0.0f;
            if (on && br::sums_in_lanes8(NN))
              br::lanes8_part(ws.list, b, e, NN & ~7, i, &p1, &p2);
#pragma unroll
            for (int h = 4; h > 0; h >>= 1) {
              const float o1 = __shfl_down_sync(FULL, p1, h, 8);
              const float o2 = __shfl_down_sync(FULL, p2, h, 8);
              if (i < h) {
                p1 = ps_add(p1, o1);
                p2 = ps_add(p2, o2);
              }
            }
            if (on && i == 0)
              ws.rate[ws.slot[s]] =
                  br::sums_in_lanes8(NN)
                      ? br::lanes8_rest(ws.list, b, e, NN & ~7, p1, p2)
                      : br::rate_chunks(ws.list, b, e, NN);
          }
        } else {
          const int s = first + lane;
          if (s < last) {
            int b, e;
            span(s, &b, &e);
            ws.rate[ws.slot[s]] =
                br::rate_chunks(ws.list, b, e, br::cand_nn(a, ws.slot[s] % C));
          }
        }
        __syncwarp();
        count = 0;
        first = last;
      };
      for (int p0 = 0; p0 < nok; p0 += CPP) {
        if (count + br::epi_pass_max(NMAX) > br::EPI_LCAP) flush(p0);
        const int s = p0 + sub;
        const bool cl = s < nok;
        const int sl = cl ? s : 0, wc = ws.slot[sl], c = wc % C;
        const bool isnr = c >= C - 2;
        const int nt = isnr ? n : n - 1;
        // The pulses' magnitudes over the tree's lanes, then their prefix
        // sums and those of the magnitudes times their lane over the
        // candidate's lanes.
        int64_t v[VPL], u[VPL];
        const int j0 = gl * VPL;
        if (VPL == 4 && cl) {
          const int4 q = *(const int4 *)&ws.sy[sl][j0];
          v[0] = q.x;
          v[VPL > 1 ? 1 : 0] = q.y;
          v[VPL > 2 ? 2 : 0] = q.z;
          v[VPL > 3 ? 3 : 0] = q.w;
        } else {
#pragma unroll
          for (int q = 0; q < VPL; q++)
            v[q] = cl && j0 + q < n ? ws.sy[sl][j0 + q] : 0;
        }
        int64_t run = 0, wrun = 0;
#pragma unroll
        for (int q = 0; q < VPL; q++) {
          const int64_t mag = j0 + q < nt ? br::abs32(v[q]) : 0;
          v[q] = run = br::add(run, mag);
          u[q] = wrun = br::add(wrun, br::mul(mag, j0 + q));
        }
        int64_t inc = run, winc = wrun;
#pragma unroll
        for (int o = 1; o < LPC; o <<= 1) {
          const int64_t t =
              (int64_t)__shfl_up_sync(FULL, (long long)inc, o, LPC);
          const int64_t tw =
              (int64_t)__shfl_up_sync(FULL, (long long)winc, o, LPC);
          if (gl >= o) {
            inc = br::add(inc, t);
            winc = br::add(winc, tw);
          }
        }
        const int64_t excl = br::add(inc, -run), wexcl = br::add(winc, -wrun);
        int64_t *cs = ws.cs[sub], *wsum = ws.ws[sub];
        if (gl == 0) cs[0] = wsum[0] = 0;
#pragma unroll
        for (int q = 0; q < VPL; q++)
          if (j0 + q < NMAX) {
            cs[j0 + q + 1] = br::add(excl, v[q]);
            wsum[j0 + q + 1] = br::add(wexcl, u[q]);
          }
        __syncwarp();
        // The coding nodes, appended in preorder; none where the pass's
        // candidates hold no pulse.
        if (gl == 0 && cl) ws.seg[s] = count;
        if (!__any_sync(FULL, cl && cs[NMAX] != 0)) continue;
        const br::Node *nodes = isnr ? nnr : nth;
        const int ni = isnr ? tb.ni_nr : tb.ni_th;
        const unsigned below = (1u << lane) - 1u;
        if (NIT == 1) {
          br::Term t;
          const bool act = cl && gl < ni &&
                           br::node_term(nodes[gl], cs, wsum, k1s, a.last1,
                                         sps, a.w2, a.rows2, &t);
          const unsigned bal = __ballot_sync(FULL, act);
          if (gl == 0 && cl)
            ws.seg[s] = count + __popc(bal & ((1u << (sub * LPC)) - 1u));
          if (act) ws.list[count + __popc(bal & below)] = t;
          count += __popc(bal);
        } else {
          // One candidate a pass: first the nodes that hold pulses, in
          // preorder (a pulse lies in one node a level), then those of
          // them that code, 32 at a time.
          int hold = 0;
#pragma unroll
          for (int it = 0; it < NIT; it++) {
            const int idx = it * LPC + gl;
            bool h = false;
            if (cl && idx < ni) {
              const int w0 = nodes[idx].w0, b = (w0 >> 8) & 0xFF;
              h = cs[b + ((w0 >> 16) & 0xFF)] != cs[b];
            }
            const unsigned bal = __ballot_sync(FULL, h);
            if (h) ws.hold[hold + __popc(bal & below)] = (uint8_t)idx;
            hold += __popc(bal);
          }
          __syncwarp();
          for (int h0 = 0; h0 < hold; h0 += 32) {
            br::Term t;
            const bool act = h0 + lane < hold &&
                             br::node_term(nodes[ws.hold[h0 + lane]], cs,
                                           wsum, k1s, a.last1, sps, a.w2,
                                           a.rows2, &t);
            const unsigned bal = __ballot_sync(FULL, act);
            if (act) ws.list[count + __popc(bal & below)] = t;
            count += __popc(bal);
          }
        }
        __syncwarp();
      }
      flush(nok);
    } else {
      const int wc = ws.slot[lane < nok ? lane : 0] & 31;
      const int32_t k = __shfl_sync(FULL, in.k, wc);
      if (lane < nok) {
        const int32_t *y = ws.sy[lane];
        ws.rate[wc] = br::fast_rate([&](int j) { return (int64_t)y[j]; }, n,
                                    wc % C >= C - 2 ? n : n - 1, k);
      }
    }
    __syncwarp();
    if (llive) ws.cand[lane] = br::finish_cand(a, lc, in, ws.rate[lane]);
    __syncwarp();
    if (lane < rpw && r0 + lane < m)
      ws.win[lane] = br::decide_row(a, r0 + lane, ws.cand + lane * C,
                                    skip_dist, dist0, ints, skip_diff);
    fields(task + (int64_t)gridDim.x * EPI_WARPS);
    __syncwarp();
    // The rows' pulses: the winner's, or zeros.
    for (int rl = 0; rl < rpw && r0 + rl < m; rl++) {
      const int64_t row = r0 + rl;
      const int win = ws.win[rl];
      const int wc = rl * C + (win < 0 ? 0 : win);
      const int32_t *src = ws.sy[__popc(okm & ((1u << wc) - 1u))];
      int16_t *dst = y_out + row * n;
      if (vec) {
        for (int q = lane; q < n / 4; q += 32) {
          const int4 s =
              win >= 0 ? ((const int4 *)src)[q] : make_int4(0, 0, 0, 0);
          short4 d;
          d.x = (short)s.x;
          d.y = (short)s.y;
          d.z = (short)s.z;
          d.w = (short)s.w;
          ((short4 *)dst)[q] = d;
        }
      } else {
        for (int j = lane; j < n; j += 32)
          dst[j] = win >= 0 ? (int16_t)src[j] : 0;
      }
    }
    __syncwarp();
  }
}

// The kernel: at NMAX <= 32 it takes 64 registers and 4 blocks an SM; at
// NMAX = 128 shared memory holds 2 blocks an SM, so it may take 128
// registers (at 64 it spilled, and a bound of 4 blocks made the smaller
// ones spill).
template <int NMAX>
__global__ void __launch_bounds__(EPI_WARPS * 32) band_epilogue_kernel(
    br::EpiIn a, const br::Node *__restrict__ nodes_th,
    const br::Node *__restrict__ nodes_nr, EpiTables tb, int rpw, int vec,
    int32_t *ints, int16_t *y_out, float *skip_diff) {
  epilogue_tasks<NMAX>(a, nodes_th, nodes_nr, tb, rpw, vec, ints, y_out,
                       skip_diff);
}
template <>
__global__ void __launch_bounds__(EPI_WARPS * 32, 2) band_epilogue_kernel<128>(
    br::EpiIn a, const br::Node *__restrict__ nodes_th,
    const br::Node *__restrict__ nodes_nr, EpiTables tb, int rpw, int vec,
    int32_t *ints, int16_t *y_out, float *skip_diff) {
  epilogue_tasks<128>(a, nodes_th, nodes_nr, tb, rpw, vec, ints, y_out,
                      skip_diff);
}

// What the runtime answers the same way for as long as the process runs,
// asked once and kept: each device's SM count, and each kernel's blocks an
// SM at a launch's threads and shared memory on a device.
constexpr int MAX_DEVICES = 64;
constexpr int MAX_PLANS = 64;

// The current device and its SMs.
cudaError_t device_sms(int *dev, int *sms) {
  static std::mutex mu;
  static int count[MAX_DEVICES];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (*dev < MAX_DEVICES && count[*dev] > 0) {
    *sms = count[*dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err == cudaSuccess && *dev < MAX_DEVICES) count[*dev] = *sms;
  return err;
}

// out[0]: the current device's SMs; out[1]: the kernel's blocks an SM there
// at `threads` and `smem` bytes of dynamic shared memory.  Above 48 KB the
// kernel's limit is raised first, and only ever raised, so that every plan
// kept stays launchable.
template <typename K>
cudaError_t blocks_per_sm(K kernel, int threads, size_t smem, int *out) {
  struct Plan {
    const void *kernel;
    int dev, threads;
    size_t smem;
    int per_sm;
  };
  static std::mutex mu;
  static Plan plans[MAX_PLANS];
  static int nplans = 0;
  int dev = 0;
  cudaError_t err = device_sms(&dev, &out[0]);
  if (err != cudaSuccess) return err;
  const void *k = (const void *)kernel;
  std::lock_guard<std::mutex> lock(mu);
  size_t raised = 48 * 1024;
  for (int i = 0; i < nplans; i++) {
    const Plan &p = plans[i];
    if (p.kernel != k || p.dev != dev) continue;
    if (p.threads == threads && p.smem == smem) {
      out[1] = p.per_sm;
      return cudaSuccess;
    }
    if (p.smem > raised) raised = p.smem;
  }
  if (smem > raised)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess && nplans < MAX_PLANS)
    plans[nplans++] = Plan{k, dev, threads, smem, per_sm};
  out[1] = per_sm;
  return err;
}

template <int NMAX>
cudaError_t launch_epilogue(const br::EpiIn &a, const br::Node *th,
                            const br::Node *nr, const EpiTables &tb, int rpw,
                            int vec, int32_t *ints, int16_t *y,
                            float *skip_diff, cudaStream_t s) {
  const size_t smem = tb.table_bytes() + EPI_WARPS * sizeof(EpiWarp<NMAX>);
  int occ[2];
  cudaError_t err = blocks_per_sm(band_epilogue_kernel<NMAX>, EPI_WARPS * 32,
                                  smem, occ);
  if (err != cudaSuccess) return err;
  const int64_t tasks = (a.m + rpw - 1) / rpw;
  const int64_t blocks = (tasks + EPI_WARPS - 1) / EPI_WARPS;
  const int64_t full = (int64_t)occ[0] * (occ[1] > 0 ? occ[1] : 1);
  band_epilogue_kernel<NMAX>
      <<<(unsigned)(blocks < full ? blocks : full), EPI_WARPS * 32, smem, s>>>(
          a, th, nr, tb, rpw, vec, ints, y, skip_diff);
  return cudaGetLastError();
}

// The prologue's lanes a row: the fewest of 8 (up to 32 lanes a band), 16
// and 32 that still give the call 8 warps an SM (the scalar chain's issue
// shrinks with them, a lane's share of a wide band grows).
int prologue_g(int64_t m, int n, int sms) {
  const int64_t want = 8LL * sms;
  if (n <= 32 && m / 4 >= want) return 8;
  if (m / 2 >= want) return 16;
  return 32;
}

template <int G>
cudaError_t launch_prologue(cudaStream_t s, int m, int n, const void **p,
                            long long dlen, int keyframe, float lam,
                            long long rt0, long long rt1, void **out) {
  constexpr int RPB = PRO_THREADS / G;
  const size_t smem = (size_t)RPB * 3 * n * 4;
  band_prologue_kernel<G><<<(m + RPB - 1) / RPB, PRO_THREADS, smem, s>>>(
      (const int32_t *)p[0], (const int32_t *)p[1], dlen,
      (const int32_t *)p[2], (const int32_t *)p[3], (const int32_t *)p[4],
      (const int32_t *)p[5], (const int32_t *)p[6], (const uint8_t *)p[7], m,
      n, keyframe, lam, rt0, rt1, (float *)out[0], (uint8_t *)out[1],
      (int32_t *)out[2], (float *)out[3], (int32_t *)out[4], (float *)out[5]);
  return cudaGetLastError();
}

}  // namespace

// dflat, mdflat: int32 (dlen,); base, tabsel, q0: int32 (m,); tab, qmtab:
// int32 (T, n); beta15: bytes (m,).  Writes xs float32 (G m, n), lane_ok
// bytes (G m, n), src int32 (C m), cf float32 (5, C, m), ci int32 (6, C,
// m), rf float32 (3, m); G = 2, C = 14 (inter) or G = 1, C = 2
// (keyframe).  2 <= n <= 128, m >= 1.
extern "C" int band_prologue(const void *dflat, const void *mdflat,
                             long long dlen, const void *base,
                             const void *tabsel, const void *tab,
                             const void *qmtab, const void *q0,
                             const void *beta15, int m, int n, int keyframe,
                             float lam, long long rt0, long long rt1,
                             void *xs, void *lane_ok, void *src, void *cf,
                             void *ci, void *rf, void *stream) {
  if (m <= 0 || n <= 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  const cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  const void *p[8] = {dflat, mdflat, base, tabsel, tab, qmtab, q0, beta15};
  void *out[6] = {xs, lane_ok, src, cf, ci, rf};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (prologue_g(m, n, sms)) {
    case 8:
      return (int)launch_prologue<8>(s, m, n, p, dlen, keyframe, lam, rt0,
                                     rt1, out);
    case 16:
      return (int)launch_prologue<16>(s, m, n, p, dlen, keyframe, lam, rt0,
                                      rt1, out);
    default:
      return (int)launch_prologue<32>(s, m, n, p, dlen, keyframe, lam, rt0,
                                      rt1, out);
  }
}

// y_c int32 (C m, n), cos_dist float32 (C m), ok_p bytes (C m): the pulse
// search's result; cf, ci, rf: the prologue's.  nodes_th / nodes_nr: the
// coding nodes of the split trees of n - 1 and n lanes (int32 (n - 2, 4)
// and (n - 1, 4), band_kernels.py node_table); k1 (last index last1) and
// sp (rows2 x w2): the CDF tables, read when use_cdf.  Writes ints int32
// (m, 6), y int16 (m, n), skip_diff float32 (m).
extern "C" int band_epilogue(const void *y_c, const void *cos_dist,
                             const void *ok_p, const void *cf, const void *ci,
                             const void *rf, const void *nodes_th, int ni_th,
                             const void *nodes_nr, int ni_nr, const void *k1,
                             long long last1, const void *sp, int w2,
                             int rows2, int use_cdf, int m, int n, int C,
                             int keyframe, float lam, void *ints, void *y,
                             void *skip_diff, void *stream) {
  if (m <= 0 || n <= 1 || n > MAX_N || (C != 2 && C != 14) ||
      ni_th != n - 2 || ni_nr != n - 1 || (use_cdf && (last1 < 0 ||
                                                       w2 <= 0 || rows2 <= 0)))
    return (int)cudaErrorInvalidValue;
  br::EpiIn a;
  a.y_c = (const int32_t *)y_c;
  a.cos_dist = (const float *)cos_dist;
  a.ok_p = (const uint8_t *)ok_p;
  a.cf = (const float *)cf;
  a.ci = (const int32_t *)ci;
  a.rf = (const float *)rf;
  a.k1 = (const int32_t *)k1;
  a.sp = (const int32_t *)sp;
  a.last1 = last1;
  a.w2 = w2;
  a.rows2 = rows2;
  a.use_cdf = use_cdf != 0;
  a.keyframe = keyframe != 0;
  a.m = m;
  a.n = n;
  a.C = C;
  a.lam = lam;
  const EpiTables tb{ni_th, ni_nr, use_cdf ? (int)(last1 + 1) : 0,
                     use_cdf ? rows2 * w2 : 0};
  int dev = 0, sms = 0;
  const cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return (int)err;
  // Keyframe rows a warp: more than one only where the call has rows
  // for 32 warps an SM.
  int rpw = 1;
  if (C == 2) {
    const int64_t r = (int64_t)m / (32LL * sms);
    rpw = r < 1 ? 1 : (r > br::EPI_CW / C ? br::EPI_CW / C : (int)r);
  }
  const int vec = n % 4 == 0 && (uintptr_t)y_c % 16 == 0 &&
                  (uintptr_t)y % 8 == 0;
  const br::Node *th = (const br::Node *)nodes_th;
  const br::Node *nr = (const br::Node *)nodes_nr;
  int32_t *io = (int32_t *)ints;
  int16_t *yo = (int16_t *)y;
  float *sd = (float *)skip_diff;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (br::epi_nmax(n)) {
    case 8:
      return (int)launch_epilogue<8>(a, th, nr, tb, rpw, vec, io, yo, sd, s);
    case 16:
      return (int)launch_epilogue<16>(a, th, nr, tb, rpw, vec, io, yo, sd, s);
    case 32:
      return (int)launch_epilogue<32>(a, th, nr, tb, rpw, vec, io, yo, sd, s);
    default:
      return (int)launch_epilogue<128>(a, th, nr, tb, rpw, vec, io, yo, sd,
                                       s);
  }
}

// The prologue's arccos (br::acos_xla) of each of c's count float32
// values, into out.
extern "C" int band_acos_probe(const void *c, void *out, long long count,
                               void *stream) {
  if (count <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (count + 255) / 256;
  band_acos_probe_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                           (cudaStream_t)stream>>>(
      (const float *)c, (float *)out, (int64_t)count);
  return (int)cudaGetLastError();
}

// For the checks of the launch plan: blocks an SM of each kernel at the
// block size and shared memory it launches with, for calls of the codec's
// CDF tables (k1 12 x 16, split 98 x 8) at n = 8, 15, 32, 128: out[0..3]
// band_prologue_kernel<8, 16, 32> at n = 128 and n = 8 (two each, six),
// then band_epilogue_kernel<8, 16, 32, 128> (four).
extern "C" int band_occupancy(int *out) {
  int occ[2];
  const int ns[4] = {8, 15, 32, 128};
  cudaError_t err = cudaSuccess;
  const int pro_n[2] = {128, 8};
  for (int q = 0; q < 2 && err == cudaSuccess; q++) {
    err = blocks_per_sm(band_prologue_kernel<8>, PRO_THREADS,
                        (size_t)(PRO_THREADS / 8) * 3 * pro_n[q] * 4, occ);
    out[3 * q] = occ[1];
    if (err == cudaSuccess)
      err = blocks_per_sm(band_prologue_kernel<16>, PRO_THREADS,
                          (size_t)(PRO_THREADS / 16) * 3 * pro_n[q] * 4, occ);
    out[3 * q + 1] = occ[1];
    if (err == cudaSuccess)
      err = blocks_per_sm(band_prologue_kernel<32>, PRO_THREADS,
                          (size_t)(PRO_THREADS / 32) * 3 * pro_n[q] * 4, occ);
    out[3 * q + 2] = occ[1];
  }
  for (int q = 0; q < 4 && err == cudaSuccess; q++) {
    const EpiTables tb{ns[q] - 2, ns[q] - 1, 12 * 16, 98 * 8};
    const size_t base = tb.table_bytes();
    switch (q) {
      case 0:
        err = blocks_per_sm(band_epilogue_kernel<8>, EPI_WARPS * 32,
                            base + EPI_WARPS * sizeof(EpiWarp<8>), occ);
        break;
      case 1:
        err = blocks_per_sm(band_epilogue_kernel<16>, EPI_WARPS * 32,
                            base + EPI_WARPS * sizeof(EpiWarp<16>), occ);
        break;
      case 2:
        err = blocks_per_sm(band_epilogue_kernel<32>, EPI_WARPS * 32,
                            base + EPI_WARPS * sizeof(EpiWarp<32>), occ);
        break;
      default:
        err = blocks_per_sm(band_epilogue_kernel<128>, EPI_WARPS * 32,
                            base + EPI_WARPS * sizeof(EpiWarp<128>), occ);
    }
    out[6 + q] = occ[1];
  }
  return (int)err;
}
