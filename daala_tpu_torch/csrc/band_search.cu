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
// What bounds it: on bytes, each row's n coefficients and reference
// coefficients and its QM values come in once, and the pulse search's
// rows go out once each (inter: the reflected row that the 12 theta
// candidates search and the x16 row of the 2 noref candidates; keyframe:
// x16), with each candidate's fields; the epilogue reads each candidate's
// pulses once and writes the winner's.  A call has 10^3 to 10^4 rows, and
// each row's arithmetic is a few long integer chains (the gains, the
// reflection) and, in the epilogue, a split tree of about 2 n nodes a
// candidate with two logs a node.
//
// Design (a warp a row, or a candidate of a row, so that a call of a few
// thousand rows fills the card):
// - band_prologue_kernel: a warp a row, 8 rows a block.  The warp gathers
//   its row's coefficients, reference coefficients and QM values into
//   shared memory, then runs csrc/band_row.cuh br::prologue_row with
//   WarpLanes: the lane loops (the integer sums, which wrap and so come
//   out the same in any order, the first maximum, the rows written out)
//   spread over the lanes, lane c computes candidate c, and every lane runs
//   the row's scalar chain alike.
// - band_epilogue_kernel: a warp a (row, candidate), 14 warps a block (one
//   inter row or 7 keyframe rows), the blocks looping over the calls' rows.
//   The split trees' node tables are copied to shared memory once a block.
//   The warp scans its candidate's pulse magnitudes into prefix sums in
//   shared memory, then lane e takes node 32 q + e of chunk q (blocked
//   when one of its ancestors ends coding, read from the prefix sums) and
//   every lane adds the chunk's nonzero costs in XLA's order through
//   shuffles (a chain, or for 16 to 32 nodes 8 lanes halved, then the
//   rest).  After a barrier the row's first lane picks the winner and the
//   candidate whose pulses XLA keeps (br::epilogue_row), and the row's
//   warps copy those pulses.
// - band_epilogue_rows_kernel, for a call at n <= 32 with at least 128
//   candidates an SM (an inter frame's): a thread a (row, candidate),
//   which runs the row's small tree serially; a warp a candidate would
//   run each candidate's scalar code on 32 lanes, for a tree of 13 to 63
//   nodes.  The block stages its candidates' pulses and their prefix sums
//   in shared memory.
// Every float operation is the plain versions' through csrc/pulse_step.cuh
// and band_row.cuh, the arccos included (glibc's atan2f written out,
// br::atan2f_glibc), and the kernels are built without fast math: bit for
// bit with the plain versions on the card and on the CPU.
// band_acos_probe_kernel runs the prologue's arccos alone, for the checks
// that hold it to its plain version on every float32 in [-1, 1].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "band_row.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_N = 128;  // the codec's widest band
constexpr int PRO_WARPS = 8;   // prologue rows a block
constexpr int EPI_WARPS = 14;  // epilogue (row, candidate) pairs a block
constexpr int EPI_THREADS = 128;  // the same, a thread a pair

// br::SerialLanes's loops over a warp: lane l takes j = l, l + 32, ...
struct WarpLanes {
  int lane;

  template <typename F>
  __device__ __forceinline__ int64_t sum(int n, F f) const {
    int64_t s = 0;
    for (int j = lane; j < n; j += 32) s = br::add(s, f(j));
    for (int o = 16; o > 0; o >>= 1)
      s = br::add(s, (int64_t)__shfl_xor_sync(FULL, (long long)s, o));
    return s;
  }
  template <typename F>
  __device__ __forceinline__ bool any(int n, F f) const {
    bool a = false;
    for (int j = lane; j < n; j += 32) a = a || f(j);
    return __any_sync(FULL, a) != 0;
  }
  template <typename F>
  __device__ __forceinline__ int argmax(int n, F f) const {
    int64_t best = -1;
    int at = 0x7fffffff;
    for (int j = lane; j < n; j += 32) {
      const int64_t v = f(j);
      if (v > best) {
        best = v;
        at = j;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
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
    for (int j = lane; j < n; j += 32) f(j);
  }
  __device__ __forceinline__ bool leader() const { return lane == 0; }
  // Lane l scans elements [l per, (l + 1) per), per = ceil(n / 32) <= 4,
  // after the lanes before it.
  template <typename F>
  __device__ __forceinline__ void prefix(int n, F a, int64_t *cs) const {
    const int per = (n + 31) >> 5;
    const int j0 = lane * per;
    int64_t v[MAX_N / 32];
    int64_t c = 0;
#pragma unroll
    for (int q = 0; q < MAX_N / 32; q++) {
      const int j = j0 + q;
      v[q] = q < per && j < n ? a(j) : 0;
      c = br::add(c, v[q]);
    }
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t t = (int64_t)__shfl_up_sync(FULL, (long long)c, o);
      if (lane >= o) c = br::add(c, t);
    }
    int64_t e = (int64_t)__shfl_up_sync(FULL, (long long)c, 1);
    if (lane == 0) {
      e = 0;
      cs[0] = 0;
    }
#pragma unroll
    for (int q = 0; q < MAX_N / 32; q++) {
      const int j = j0 + q;
      if (q < per && j < n) {
        e = br::add(e, v[q]);
        cs[j + 1] = e;
      }
    }
    __syncwarp();
  }
  // Lane e computes f(e); every lane then adds them in order, skipping
  // the pairs of zeros: a sum from +0 is never -0, so adding a zero
  // leaves it as it is (a NaN is not a zero, and is added).
  template <typename F>
  __device__ __forceinline__ void chain(int span, F f, float *p1, float *p2) const {
    float c1 = 0.0f, c2 = 0.0f;
    if (lane < span) f(lane, &c1, &c2);
    float a = 0.0f, b = 0.0f;
    for (unsigned mk = __ballot_sync(FULL, c1 != 0.0f || c2 != 0.0f); mk;
         mk &= mk - 1) {
      const int e = __ffs(mk) - 1;
      a = ps_add(a, __shfl_sync(FULL, c1, e));
      b = ps_add(b, __shfl_sync(FULL, c2, e));
    }
    *p1 = a;
    *p2 = b;
  }
  // br::SerialLanes::lanes8 over a warp (span <= 32): lane e computes
  // f(e), lanes i < 8 sum their part, the parts are halved by shuffles, and
  // every lane adds the rest in order.
  template <typename F>
  __device__ __forceinline__ void lanes8(int span, F f, float *p1,
                                         float *p2) const {
    float c1 = 0.0f, c2 = 0.0f;
    if (lane < span) f(lane, &c1, &c2);
    const int body = span & ~7, i = lane & 7;
    float a = 0.0f, b = 0.0f;
    for (int e0 = 0; e0 < body; e0 += 8) {
      a = ps_add(a, __shfl_sync(FULL, c1, e0 + i));
      b = ps_add(b, __shfl_sync(FULL, c2, e0 + i));
    }
    for (int h = 4; h > 0; h >>= 1) {
      const float oa = __shfl_sync(FULL, a, i + h);
      const float ob = __shfl_sync(FULL, b, i + h);
      a = ps_add(a, oa);
      b = ps_add(b, ob);
    }
    a = __shfl_sync(FULL, a, 0);
    b = __shfl_sync(FULL, b, 0);
    for (int e = body; e < span; e++) {
      a = ps_add(a, __shfl_sync(FULL, c1, e));
      b = ps_add(b, __shfl_sync(FULL, c2, e));
    }
    *p1 = a;
    *p2 = b;
  }
};

__global__ void __launch_bounds__(PRO_WARPS * 32) band_prologue_kernel(
    const int32_t *__restrict__ dflat, const int32_t *__restrict__ mdflat,
    long long dlen, const int32_t *__restrict__ base,
    const int32_t *__restrict__ tabsel, const int32_t *__restrict__ tab,
    const int32_t *__restrict__ qmtab, const int32_t *__restrict__ q0,
    const uint8_t *__restrict__ beta15, int m, int n, int keyframe, float lam,
    long long rt0, long long rt1, float *xs, uint8_t *lane_ok, int32_t *src,
    float *cf, int32_t *ci, float *rf) {
  __shared__ int32_t sx[PRO_WARPS][MAX_N], sr[PRO_WARPS][MAX_N],
      sq[PRO_WARPS][MAX_N];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * PRO_WARPS + w;
  if (row >= m) return;  // the whole warp
  const int64_t t = tabsel[row];
  for (int j = lane; j < n; j += 32) {
    const int64_t idx = (int64_t)base[row] + tab[t * n + j];
    const bool inb = idx >= 0 && idx < dlen;
    sx[w][j] = inb ? dflat[idx] : 0;
    sr[w][j] = inb && !keyframe ? mdflat[idx] : 0;
    sq[w][j] = qmtab[t * n + j];
  }
  __syncwarp();
  const br::Out o{xs, lane_ok, src, cf, ci, rf, m, row, keyframe ? 2 : 14};
  br::prologue_row(WarpLanes{lane}, n, keyframe != 0, lam, sx[w], sr[w],
                   sq[w], q0[row], beta15[row] != 0, rt0, rt1, o);
}

__global__ void band_acos_probe_kernel(const float *__restrict__ c,
                                       float *__restrict__ out,
                                       int64_t count) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += stride)
    out[i] = br::acos_xla(c[i]);
}

// NMAX: the widest row of the instantiation.  3 blocks an SM: at most 40
// registers a thread (without the bound the kernel takes 56, and 2 blocks
// an SM leave its n = 128 inter calls a third slower).
template <int NMAX>
__global__ void __launch_bounds__(EPI_WARPS * 32, 3) band_epilogue_kernel(
    br::EpiIn a, const int32_t *__restrict__ nodes_th,
    const int32_t *__restrict__ nodes_nr, int32_t *ints, int16_t *y_out,
    float *skip_diff) {
  __shared__ br::Node nth[2 * NMAX - 1], nnr[2 * NMAX - 1];
  __shared__ int64_t cs[EPI_WARPS][NMAX + 1];
  __shared__ float s_cost[EPI_WARPS], s_cost_y[EPI_WARPS], s_kept[EPI_WARPS];
  __shared__ uint8_t s_ok[EPI_WARPS];
  __shared__ int s_win[EPI_WARPS];
  for (int e = threadIdx.x; e < a.nn_th * 6; e += blockDim.x)
    ((int32_t *)nth)[e] = nodes_th[e];
  for (int e = threadIdx.x; e < a.nn_nr * 6; e += blockDim.x)
    ((int32_t *)nnr)[e] = nodes_nr[e];
  __syncthreads();
  br::EpiIn s = a;
  s.nodes_th = nth;
  s.nodes_nr = nnr;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpb = EPI_WARPS / a.C;  // rows a block
  const int rb = w / a.C, c = w - rb * a.C;
  const int w0 = rb * a.C;  // the row's first warp
  const int64_t groups = (a.m + rpb - 1) / rpb;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t row = g * rpb + rb;
    const bool live = rb < rpb && row < a.m;
    if (live) {
      float cost, cost_y, kept;
      bool ok;
      const int32_t *y = a.y_c + ((int64_t)c * a.m + row) * a.n;
      br::epilogue_cand(WarpLanes{lane}, s, row, c,
                        [&](int j) { return (int64_t)y[j]; }, cs[w], &cost,
                        &cost_y, &kept, &ok);
      if (lane == 0) {
        s_cost[w] = cost;
        s_cost_y[w] = cost_y;
        s_kept[w] = kept;
        s_ok[w] = ok;
      }
    }
    __syncthreads();
    if (live && c == 0 && lane == 0)
      s_win[rb] = br::epilogue_row(
          s, row, [&](int q) { return s_cost[w0 + q]; },
          [&](int q) { return s_cost_y[w0 + q]; },
          [&](int q) { return s_kept[w0 + q]; },
          [&](int q) { return s_ok[w0 + q] != 0; }, ints, skip_diff);
    __syncthreads();
    if (live) {
      const int win = s_win[rb];
      for (int j = c * 32 + lane; j < a.n; j += a.C * 32)
        y_out[row * a.n + j] =
            win >= 0 ? (int16_t)a.y_c[((int64_t)win * a.m + row) * a.n + j]
                     : 0;
    }
  }
}

// A thread a (row, candidate), 128 threads and 128 / C rows a block, for
// calls of many candidates at n <= 32: the block stages its candidates'
// pulses in shared memory, each in the row of prefix sums that its thread
// then computes in place through br::SerialLanes (rows of NMAX + 1 int64:
// the threads of a warp, each on its own row, fall in distinct bank
// pairs).
template <int NMAX>
__global__ void __launch_bounds__(EPI_THREADS) band_epilogue_rows_kernel(
    br::EpiIn a, const int32_t *__restrict__ nodes_th,
    const int32_t *__restrict__ nodes_nr, int32_t *ints, int16_t *y_out,
    float *skip_diff) {
  constexpr int T = EPI_THREADS;
  __shared__ br::Node nth[2 * NMAX - 1], nnr[2 * NMAX - 1];
  __shared__ int64_t cs[T][NMAX + 1];
  __shared__ float s_cost[T], s_cost_y[T], s_kept[T];
  __shared__ uint8_t s_ok[T];
  __shared__ int s_win[T];
  for (int e = threadIdx.x; e < a.nn_th * 6; e += T)
    ((int32_t *)nth)[e] = nodes_th[e];
  for (int e = threadIdx.x; e < a.nn_nr * 6; e += T)
    ((int32_t *)nnr)[e] = nodes_nr[e];
  const int rpb = T / a.C;  // rows a block
  const int64_t r0 = (int64_t)blockIdx.x * rpb;
  // Candidate c of the block's rows is rpb n contiguous pulses of y_c;
  // thread rb C + c takes row rb's, pulse j at cs[rb C + c][j + 1].
  const int per_c = rpb * a.n;
  for (int e = threadIdx.x; e < a.C * per_c; e += T) {
    const int c = e / per_c, f = e - c * per_c;
    const int rb = f / a.n, j = f - rb * a.n;
    if (r0 + rb < a.m)
      cs[rb * a.C + c][j + 1] = a.y_c[((int64_t)c * a.m + r0) * a.n + f];
  }
  __syncthreads();
  br::EpiIn s = a;
  s.nodes_th = nth;
  s.nodes_nr = nnr;
  const int t = threadIdx.x;
  const int rb = t / a.C, c = t - rb * a.C;
  const int64_t row = r0 + rb;
  const bool live = rb < rpb && row < a.m;
  if (live) {
    bool ok;
    int64_t *ct = cs[t];
    br::epilogue_cand(br::SerialLanes(), s, row, c,
                      [&](int j) { return ct[j + 1]; }, ct, &s_cost[t],
                      &s_cost_y[t], &s_kept[t], &ok);
    s_ok[t] = ok;
  }
  __syncthreads();
  const int t0 = rb * a.C;  // the row's first thread
  if (live && c == 0)
    s_win[rb] = br::epilogue_row(
        s, row, [&](int q) { return s_cost[t0 + q]; },
        [&](int q) { return s_cost_y[t0 + q]; },
        [&](int q) { return s_kept[t0 + q]; },
        [&](int q) { return s_ok[t0 + q] != 0; }, ints, skip_diff);
  __syncthreads();
  if (!live) return;
  const int win = s_win[rb];
  for (int j = c; j < a.n; j += a.C)
    y_out[row * a.n + j] =
        win >= 0 ? (int16_t)a.y_c[((int64_t)win * a.m + row) * a.n + j] : 0;
}

template <int NMAX>
cudaError_t launch_epilogue_rows(const br::EpiIn &a, const int32_t *nodes_th,
                                 const int32_t *nodes_nr, int32_t *ints,
                                 int16_t *y, float *skip_diff,
                                 cudaStream_t s) {
  const int rpb = EPI_THREADS / a.C;
  band_epilogue_rows_kernel<NMAX>
      <<<(a.m + rpb - 1) / rpb, EPI_THREADS, 0, s>>>(a, nodes_th, nodes_nr,
                                                    ints, y, skip_diff);
  return cudaGetLastError();
}

template <int NMAX>
cudaError_t launch_epilogue(const br::EpiIn &a, const int32_t *nodes_th,
                            const int32_t *nodes_nr, int32_t *ints,
                            int16_t *y, float *skip_diff, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, band_epilogue_kernel<NMAX>, EPI_WARPS * 32, 0);
  if (err != cudaSuccess) return err;
  const int64_t groups = (a.m + EPI_WARPS / a.C - 1) / (EPI_WARPS / a.C);
  const int64_t full = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  band_epilogue_kernel<NMAX>
      <<<(unsigned)(groups < full ? groups : full), EPI_WARPS * 32, 0, s>>>(
          a, nodes_th, nodes_nr, ints, y, skip_diff);
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
  band_prologue_kernel<<<(m + PRO_WARPS - 1) / PRO_WARPS, PRO_WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t *)dflat, (const int32_t *)mdflat, dlen,
      (const int32_t *)base, (const int32_t *)tabsel, (const int32_t *)tab,
      (const int32_t *)qmtab, (const int32_t *)q0, (const uint8_t *)beta15,
      m, n, keyframe, lam, rt0, rt1, (float *)xs, (uint8_t *)lane_ok,
      (int32_t *)src, (float *)cf, (int32_t *)ci, (float *)rf);
  return (int)cudaGetLastError();
}

// y_c int32 (C m, n), cos_dist float32 (C m), ok_p bytes (C m): the pulse
// search's result; cf, ci, rf: the prologue's.  nodes_th / nodes_nr: the
// split trees of n - 1 and n lanes (int32 (NN, 6), band_kernels.py
// node_table); k1 (last index last1) and sp (rows2 x w2): the CDF tables,
// read when use_cdf.  Writes ints int32 (m, 6), y int16 (m, n), skip_diff
// float32 (m).
extern "C" int band_epilogue(const void *y_c, const void *cos_dist,
                             const void *ok_p, const void *cf, const void *ci,
                             const void *rf, const void *nodes_th, int nn_th,
                             const void *nodes_nr, int nn_nr, const void *k1,
                             long long last1, const void *sp, int w2,
                             int rows2, int use_cdf, int m, int n, int C,
                             int keyframe, float lam, void *ints, void *y,
                             void *skip_diff, void *stream) {
  if (m <= 0 || n <= 1 || n > MAX_N || (C != 2 && C != 14) ||
      nn_th > 2 * n - 1 || nn_nr > 2 * n - 1)
    return (int)cudaErrorInvalidValue;
  br::EpiIn a;
  a.y_c = (const int32_t *)y_c;
  a.cos_dist = (const float *)cos_dist;
  a.ok_p = (const uint8_t *)ok_p;
  a.cf = (const float *)cf;
  a.ci = (const int32_t *)ci;
  a.rf = (const float *)rf;
  a.nodes_th = nullptr;
  a.nodes_nr = nullptr;
  a.nn_th = nn_th;
  a.nn_nr = nn_nr;
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
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t *th = (const int32_t *)nodes_th, *nr = (const int32_t *)nodes_nr;
  int32_t *io = (int32_t *)ints;
  int16_t *yo = (int16_t *)y;
  float *sd = (float *)skip_diff;
  // A thread a candidate when the call has at least 4 warps of candidates
  // an SM and small trees; else a warp a candidate.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (n <= 32 && (int64_t)C * m >= 128LL * sms) {
    if (n <= 8) return (int)launch_epilogue_rows<8>(a, th, nr, io, yo, sd, s);
    if (n <= 16)
      return (int)launch_epilogue_rows<16>(a, th, nr, io, yo, sd, s);
    return (int)launch_epilogue_rows<32>(a, th, nr, io, yo, sd, s);
  }
  if (n <= 8) return (int)launch_epilogue<8>(a, th, nr, io, yo, sd, s);
  if (n <= 16) return (int)launch_epilogue<16>(a, th, nr, io, yo, sd, s);
  if (n <= 32) return (int)launch_epilogue<32>(a, th, nr, io, yo, sd, s);
  return (int)launch_epilogue<128>(a, th, nr, io, yo, sd, s);
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
