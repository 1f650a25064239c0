// Launch plan and blend weights of csrc/obmc_leaf.cu, in plain C++ so
// that the CPU tests compile this header with g++ and check the plan of
// every leaf size (tests/test_torch_obmc_plan.py).
#pragma once

#ifdef __CUDACC__
#define OBMC_HD __host__ __device__
#else
#define OBMC_HD
#endif

// One leaf size and sample width.  A thread owns one column of a leaf
// and `rows` consecutive output rows of it (a strip); `tpl` threads
// cover a leaf, `lpb` leaves share a block of `threads`.  Each leaf's 4
// corner windows ((ny + 5) rows of nx + 5 samples) lie in shared memory
// as they are in the planes, a row padded to `row_words` 32-bit words
// so that it starts where a `copy`-byte cp.async of the plane's row
// starts: the window row's first sample sits at byte
// (sx * itemsize) % copy of it.  Two stages of `lpb` leaves each form
// the ring.  Where leaves share a warp (tpl < 32, `params`), two
// buffers of the groups' copy parameters (8 bytes per leaf and corner)
// follow; then 16 bytes of tail, so that the last word reads of a
// stage's last row stay inside the allocation.  `min_blocks` is the
// blocks per SM that shared memory allows, at most 1024 threads' worth:
// the kernel's register cap (__launch_bounds__) keeps them resident.
// `wtab`: the block keeps the 64 (setup, corner) blend weights in a
// shared table (1 KB) instead of each thread evaluating its corner's
// weights per leaf; taken where the table costs no occupancy.
struct ObmcPlan {
  int rows, strips, tpl, lpb, threads;
  int copy, row_words, leaf_words, stage_bytes, smem_bytes, wtab;
  int params, min_blocks;
};

constexpr int kObmcThreads = 256;  // the most threads a block has
// Static shared memory: the tap tables (int32 and packed int8), and the
// weight table (16 x 4 int4) or its 4-entry stub.
constexpr int kObmcTapsSmem = 8 * 6 * 4 + 8 * 2 * 4;
OBMC_HD constexpr int obmc_static_smem(int wtab) {
  return kObmcTapsSmem + (wtab ? 16 : 1) * 4 * 16;
}
// What four blocks of a plan may take on an SM: 228 KB, less 1 KB a
// block that the hardware keeps.
constexpr int kObmcSmPerBlock = 228 * 1024 / 4 - 1024;
// Dynamic shared memory under which four blocks fit.
constexpr int kObmcSmemTarget = kObmcSmPerBlock - obmc_static_smem(0);

OBMC_HD constexpr ObmcPlan obmc_plan_with(int log_x, int log_y, int itemsize,
                                          int copy, int lpb) {
  const int nx = 1 << log_x, ny = 1 << log_y;
  const int rows = ny < 16 ? ny : 16;
  const int strips = ny / rows;
  const int tpl = nx * strips;
  const int row_bytes =
      (copy - 1 + (nx + 5) * itemsize + copy - 1) / copy * copy;
  const int row_words = row_bytes / 4;
  const int base = 4 * (ny + 5) * row_words;
  // Leaves that share a warp (tpl < 32) start an odd multiple of tpl
  // banks apart, so that the warp's lanes read distinct banks.  Padding
  // in multiples of 4 words keeps every window 16-byte aligned.
  int pad = 0;
  if (lpb > 1 && tpl < 32)
    while (((base + pad) % 32) % tpl || ((base + pad) % 32 / tpl) % 2 == 0)
      pad += 4;
  const int leaf_words = base + pad;
  const int stage_bytes = lpb * leaf_words * 4;
  const int params = tpl < 32;
  const int smem_bytes = 2 * stage_bytes + params * 2 * lpb * 4 * 8 + 16;
  const int wtab = smem_bytes + obmc_static_smem(1) <= kObmcSmPerBlock;
  const int by_smem =
      228 * 1024 / (smem_bytes + obmc_static_smem(wtab) + 1024);
  const int by_threads = 1024 / (lpb * tpl);
  return ObmcPlan{rows,        strips,     tpl,
                  lpb,         lpb * tpl,  copy,
                  row_words,   leaf_words, stage_bytes,
                  smem_bytes,  wtab,       params,
                  by_smem < by_threads ? by_smem : by_threads};
}

// The widest copy (16, 8 or 4 bytes: fewer copies) whose two stages of
// kObmcThreads threads fit kObmcSmemTarget, else 4 bytes; then as many
// leaves per block, down to one warp's worth, as still fit.
OBMC_HD constexpr ObmcPlan obmc_plan(int log_x, int log_y, int itemsize) {
  const int nx = 1 << log_x, ny = 1 << log_y;
  const int tpl = nx * (ny < 16 ? 1 : ny / 16);
  const int lpb_max = kObmcThreads / tpl;
  const int lpb_min = tpl < 32 ? 32 / tpl : 1;
  int copy = 16;
  while (copy > 4 &&
         obmc_plan_with(log_x, log_y, itemsize, copy, lpb_max).smem_bytes >
             kObmcSmemTarget)
    copy /= 2;
  int lpb = lpb_max;
  while (lpb > lpb_min &&
         obmc_plan_with(log_x, log_y, itemsize, copy, lpb).smem_bytes >
             kObmcSmemTarget)
    lpb /= 2;
  return obmc_plan_with(log_x, log_y, itemsize, copy, lpb);
}

// od_mc_setup_s_split (reference src/mc.c:1650-1698;
// daala_tpu_torch/codec/mc.py _setup_s_split): the merged blend weight
// w0 + i * wi + j * wj + i * j * wij of corner k (i the column, j the
// row) for outer corner oc and split mask s.  A clear bit of s halves
// corner oc + 1 (bit 0) or oc + 3 (bit 1) and adds the half to corner
// oc; every value halved is even, so the shifts are exact.  Written
// without arrays, so that a runtime k stays in registers.
OBMC_HD inline void obmc_corner(int k, int log_x, int log_y, int &w0, int &wi,
                                int &wj, int &wij) {
  w0 = k == 0 ? 2 << (log_x + log_y) : 0;
  wi = k == 0 ? -(2 << log_x) : k == 1 ? 2 << log_x : 0;
  wj = k == 0 ? -(2 << log_y) : k == 3 ? 2 << log_y : 0;
  wij = (k & 1) ? -2 : 2;
}

OBMC_HD inline void obmc_weight(int oc, int s, int k, int log_x, int log_y,
                                int &w0, int &wi, int &wj, int &wij) {
  obmc_corner(k, log_x, log_y, w0, wi, wj, wij);
  const int m1 = (oc + 1) & 3, m3 = (oc + 3) & 3;
  const bool half1 = !(s & 1), half3 = !(s & 2);
  if (k == oc) {
    int a, b, c, d;
    if (half1) {
      obmc_corner(m1, log_x, log_y, a, b, c, d);
      w0 += a >> 1, wi += b >> 1, wj += c >> 1, wij += d >> 1;
    }
    if (half3) {
      obmc_corner(m3, log_x, log_y, a, b, c, d);
      w0 += a >> 1, wi += b >> 1, wj += c >> 1, wij += d >> 1;
    }
  } else if ((k == m1 && half1) || (k == m3 && half3)) {
    w0 >>= 1, wi >>= 1, wj >>= 1, wij >>= 1;
  }
}
