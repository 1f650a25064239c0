// Launch plans of csrc/dct_frame.cu and csrc/lap_frame.cu, in plain C++
// so that the CPU tests compile this header with g++ and check the tiling
// of every plane shape the codec gives (tests/test_torch_frame_plan.py).
#pragma once

#ifdef __CUDACC__
#define FRAME_HD __host__ __device__
#else
#define FRAME_HD
#endif

// What an H100 SM offers a plan: 228 KB of shared memory (the hardware
// keeps 1 KB of it per block), 2048 threads, 32 blocks, 65,536 registers.
constexpr int kFrameSmemPerSm = 228 * 1024;
constexpr int kFrameSmemPerBlockReserved = 1024;
constexpr int kFrameThreadsPerSm = 2048;
constexpr int kFrameBlocksPerSm = 32;
constexpr int kFrameRegsPerSm = 65536;

FRAME_HD constexpr int frame_min(int a, int b) { return a < b ? a : b; }

// Blocks of `threads` threads, `smem` dynamic shared bytes and at most
// `regs` registers a thread that fit on one SM at once.
FRAME_HD constexpr int frame_resident(int threads, int smem, int regs) {
  return frame_min(
      frame_min(kFrameBlocksPerSm, kFrameThreadsPerSm / threads),
      frame_min(kFrameSmemPerSm / (smem + kFrameSmemPerBlockReserved),
                kFrameRegsPerSm / (threads * regs)));
}

// ---------------------------------------------------------------------
// dct_frame.  A unit is a strip of n rows by `wb` columns: wb / n tiles
// side by side, one thread per column, one block of wb threads per unit.
// The strip lies in shared memory as n rows of `pitch` = wb + 4 words
// (rows 16-byte aligned; pitch / 4 odd, so that the 16-byte row accesses
// of 8 neighbouring threads fall in 8 distinct bank groups) and is lifted
// in place.  `regs` is the budget each size's lifting needs without
// spills; __launch_bounds__ holds a thread to 65,536 / (threads x
// blocks_per_sm) registers, so that the planned blocks stay resident.
struct DctPlan {
  int n, wb, pitch, smem_bytes, regs, blocks_per_sm;
};

// The first pass reads the frame straight into registers (direct) for
// the forward transform and for the inverse at n <= 16; the inverse at
// n = 32 and 64 copies the strip in first (its tile rows, read straight,
// were slower).
FRAME_HD constexpr int dct_direct(int n, bool fwd) { return fwd || n <= 16; }

// Shapes that keep the first design (dct_tile_kernel: 128 threads, two
// buffers of n x (n + 1) words a tile, 4-byte copies), which the strip
// did not beat there: n = 4, and n = 8 on planes whose width is a
// multiple of 128.
constexpr int kDctTileThreads = 128;
FRAME_HD constexpr int dct_tile(int n, int w) {
  return n == 4 || (n == 8 && w % 128 == 0);
}

FRAME_HD constexpr int dct_regs(int n) {
  return n <= 8 ? 32 : n <= 16 ? 64 : n <= 32 ? 128 : 168;
}

FRAME_HD constexpr DctPlan dct_plan_for(int n, int wb) {
  const int pitch = wb + 4;
  const int smem = n * pitch * 4;
  return DctPlan{n,    wb,          pitch,
                 smem, dct_regs(n), frame_resident(wb, smem, dct_regs(n))};
}

// The strip width for a plane w columns wide: 64 at n = 64, else the
// widest of 128, 64 and 32 that divides w, so that no block hangs half
// idle over the right edge (32, with a ragged last strip, when none
// does).
FRAME_HD constexpr int dct_wb(int n, int w) {
  return n >= 64 ? 64 : w % 128 == 0 ? 128 : w % 64 == 0 ? 64 : 32;
}

// Units of an (h, w) plane; the grid holds one block per unit.
FRAME_HD constexpr int dct_units_x(int n, int w) {
  return (w + dct_wb(n, w) - 1) / dct_wb(n, w);
}
FRAME_HD constexpr int dct_units(int n, int h, int w) {
  return h / n * dct_units_x(n, w);
}

// ---------------------------------------------------------------------
// lap_frame, one launch.  A block owns an aligned tile of th x tw
// pixels (the last row and column of tiles ragged) and holds it in
// shared memory with a halo: 2 rows above and below, 4 columns left and
// right (2 would do; 4 keeps the copies' 16-byte alignment).  Tile
// edges lie on multiples of 4 and band starts k * sb - 2 on 2 modulo 4,
// so a band that touches the tile lies within the tile and its halo,
// and so does every 4 x 4 corner where a row band crosses a column band.
// Each block filters its bands in shared memory (a band that crosses a
// tile edge is filtered by both tiles, each storing its own half) and
// stores its tile: the plane is read once (and the halos from L2) and
// written once.
struct LapPlan {
  int th, tw, threads, pitch, rows, smem_bytes, tiles_y, tiles_x,
      blocks_per_sm;
};

constexpr int kLapThreads = 256;
constexpr int kLapRegs = 32;

FRAME_HD constexpr LapPlan lap_plan(int h, int w) {
  const int th = 32;
  const int tw = w >= 1024 ? 128 : 64;
  const int pitch = tw + 8, rows = th + 4;
  const int smem = rows * pitch * 4;
  return LapPlan{th,
                 tw,
                 kLapThreads,
                 pitch,
                 rows,
                 smem,
                 (h + th - 1) / th,
                 (w + tw - 1) / tw,
                 frame_resident(kLapThreads, smem, kLapRegs)};
}

// The interior edges k (1 <= k < nsb, band k * sb - 2 .. k * sb + 1)
// whose bands touch [a, b) along one axis: k_lo..k_hi, empty when
// k_lo > k_hi.  Two divisions per tile; none per pixel.
FRAME_HD inline void lap_edges(int a, int b, int sb, int nsb, int &k_lo,
                               int &k_hi) {
  // k * sb + 1 >= a  and  k * sb - 2 < b.
  k_lo = (a + sb - 2) / sb;
  if (k_lo < 1) k_lo = 1;
  k_hi = (b + 1) / sb;
  if (k_hi > nsb - 1) k_hi = nsb - 1;
}

// lap_edges for a tensor that holds rows (or columns) [o, o + size) of a
// plane of nsb superblocks (a tile of a sharded plane, with its halo):
// the edges whose bands touch [a, b) of the tensor, in the tensor's own
// coordinates, and whose whole band lies inside the tensor.  A band that
// the tensor holds only in part belongs to a neighbour.  With o = 0 and
// size the plane's, these are lap_edges' edges.
FRAME_HD inline int lap_floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}
FRAME_HD inline void lap_edges_at(int a, int b, int sb, int nsb, int o,
                                  int size, int &k_lo, int &k_hi) {
  lap_edges(a + o, b + o, sb, nsb, k_lo, k_hi);
  // k * sb - 2 >= o  and  k * sb + 2 <= o + size.
  const int lo = -lap_floor_div(-(o + 2), sb);
  const int hi = lap_floor_div(o + size - 2, sb);
  if (k_lo < lo) k_lo = lo;
  if (k_hi > hi) k_hi = hi;
}

