// GF(2^8) matrix x payload product for Hopper (sm_90a), batched, bitsliced.
//
//   Y[g, r, b] = XOR_j  M[g, r, j] (x) X[g, j, b]        ((x) = GF(256) multiply)
//
// with polynomial 0x11D and bit order LSB first (core/gf.py).
//
// Replaces the TPU kernel src/repro/kernels/gf_matmul.py::_gf_bitplane_kernel
// (launched by gf_matmul_pallas), which computes the product as the GF(2)
// matmul pack((bits(M) @ unpack(X)) & 1) on the MXU.  That int8 bitplane form
// was weighed for Hopper's tensor cores and not taken: it spends 64 int8 MACs
// on each GF multiply-add, about as much as one integer instruction per
// (row, coefficient, byte) on the CUDA cores, before unpacking the payload to
// bits, packing the parity back and padding 8R and 8K to the wgmma shapes.
//
// Bitsliced arithmetic.  A lane owns a 32-byte group of the payload, read as
// 8 words and bit-transposed (3 swap-move stages, 48 instructions) into 8
// plane words: plane i holds bit i of all 32 bytes.  In plane form x * 2 is a
// renaming of planes plus 3 XORs (plane 7 feeds planes 0, 2, 3 and 4), so the
// multiples x, 2x, .., 128x cost 21 XORs per input row, shared by every
// output row.  A coefficient c adds to its row's 8 accumulator planes the
// multiples its set bits select: its low nibble among x .. 8x, its high
// nibble among 16x .. 128x.  c is the same in every lane, so each nibble is
// one warp-uniform indirect branch (PTX brx.idx) into straight-line code in
// which LOP3 folds two multiples into each XOR: 8 instructions for a nibble
// of one or two bits, 16 for three or four, none for a zero nibble.  Masks
// (acc ^= mult & -bit) would spend 32 LOP3 per nibble whatever its bits.
//
// Work lists.  The block's prologue turns M into one list per (input row j,
// row warp): the nonzero coefficients of the warp's rows in column j.  A
// warp skips input row j outright when its list is empty (most of
// MSR(9,6,3)'s coefficients are zero) and otherwise runs down it.  The
// accumulators live in shared memory, lane-private (row r of a lane at
// accs + r * tile_bytes), so the case code is written once and not once per
// row: code kept per row overflowed the instruction cache.  A coefficient
// costs one 2 x 16-byte load and store of its row's planes.  At the end of an
// item's K input rows each row is transposed back and stored.
//
// Shared memory and copies.  The 16 warps of a block each own a 1 KB column
// slice, or, where R is too large for the accumulators of 16 slices, share
// a slice as row warps (up to 9 rows each; 16 row warps of 5-6 rows at the
// MSR(9,6,3) encode's R = 81), so each payload byte leaves device memory once
// per block at every R; a tile's passes (R > 144 only) follow each other and
// re-read it from L2.  A product too narrow for its tiles to fill the SMs
// takes more row warps than its rows need, for more and narrower tiles: a
// warp with no rows still copies and transposes.  The warps of a slice form a column group with its own
// 2-stage ring of payload rows, filled by 16-byte cp.async copies (zero-fill
// past B): chunk t + 1 is in flight while chunk t is computed, and a group
// waits only for itself (__syncwarp, or a named barrier when row warps share
// the slice and the copying thread has bit-transposed its groups in place).
// Risk: bank conflicts.  A lane reading its 32 bytes contiguously (16-byte
// loads at a 32-byte stride) would hit 2-way conflicts; a lane instead owns
// bytes [16 l, 16 l + 16) and [512 + 16 l, 528 + 16 l) of its slice, so each
// 16-byte shared load and store of a warp (ring, accumulators) and each
// global store covers 512 consecutive bytes, conflict-free and coalesced.
// Bytes are independent, so which bytes share a group does not change the
// product.
//
// What bounds it: integer issue, against (R + K) * B bytes.  Per input row
// and 32-byte group a lane spends about 124 instructions (48 to transpose,
// 21 to double) and about 24 plus the cases per nonzero coefficient.  At the
// small-K encodes (DRC(9,6,3), DRC(9,5,3), RS(9,6,3)) that work runs a little
// longer than the copies, which the ring overlaps with it; at the MSR(9,6,3)
// encode (R 81, K 162, 90% zeros) it is several times the byte time: the
// lists skip the zeros, and the 16 row warps' doublings remain.
//
// One kernel serves every shape: any R (passes over a tile only when no row
// warp count fits shared memory), any K, G batches on blockIdx.y, any B
// (narrow ones in narrower tiles; the ragged tail zero-filled and masked), and unaligned x or y (byte-wise copies
// in place of cp.async and of 16-byte stores).
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRowsPerWarp = 9;         // a row warp's output rows in one pass
constexpr int kRowsPerPass = kWarps * kMaxRowsPerWarp;
// a work list, in 16-bit words: [count | has_high << 8, entries (row << 8 | c)]
constexpr int kListWords = 1 + kMaxRowsPerWarp;
constexpr int kListStride = 2 * kListWords;  // bytes
constexpr int kSliceBytes = 1024;          // a warp's column slice: 32 lanes x 32 bytes
constexpr int kHalf = kSliceBytes / 2;     // a lane's second 16 bytes start here
constexpr int kStages = 2;
constexpr int kStageBytes = 64 * 1024;     // input rows x column tile, per stage at most
constexpr int kMaxSmem = 232448;

struct Geometry {
  int wr;               // row warps
  int wc;               // column warps: the tile is wc slices wide
  int tile_bytes;       // wc * kSliceBytes
  int rows_per_pass;    // ceil(R / passes)
  int passes;
  int chunk_rows;       // input rows per ring stage
  int chunks;           // ceil(K / chunk_rows)
  int ring_bytes;       // kStages * chunk_rows * tile_bytes
  int acc_bytes;        // rows_per_pass * tile_bytes
  int list_bytes;       // passes * K * wr * kListStride
  long long tiles;      // ceil(B / tile_bytes)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a's bits under mask << S trade places with b's bits under mask
template <int S>
__device__ __forceinline__ void swap_move(uint32_t& a, uint32_t& b, uint32_t mask) {
  const uint32_t a2 = (a & ~(mask << S)) | ((b << S) & (mask << S));
  b = ((a >> S) & mask) | (b & ~mask);
  a = a2;
}

// In every byte position, word i gets bit i of each word j at bit j: the
// 8 x 8 bit transpose.  It is its own inverse.
__device__ __forceinline__ void transpose8(uint32_t w[8]) {
  swap_move<1>(w[0], w[1], 0x55555555u);
  swap_move<1>(w[2], w[3], 0x55555555u);
  swap_move<1>(w[4], w[5], 0x55555555u);
  swap_move<1>(w[6], w[7], 0x55555555u);
  swap_move<2>(w[0], w[2], 0x33333333u);
  swap_move<2>(w[1], w[3], 0x33333333u);
  swap_move<2>(w[4], w[6], 0x33333333u);
  swap_move<2>(w[5], w[7], 0x33333333u);
  swap_move<4>(w[0], w[4], 0x0F0F0F0Fu);
  swap_move<4>(w[1], w[5], 0x0F0F0F0Fu);
  swap_move<4>(w[2], w[6], 0x0F0F0F0Fu);
  swap_move<4>(w[3], w[7], 0x0F0F0F0Fu);
}

// q = p * 2 mod 0x11D in plane form (q may not alias p)
__device__ __forceinline__ void double_planes(const uint32_t p[8], uint32_t q[8]) {
  q[0] = p[7];
  q[1] = p[0];
  q[2] = p[1] ^ p[7];
  q[3] = p[2] ^ p[7];
  q[4] = p[3] ^ p[7];
  q[5] = p[4];
  q[6] = p[5];
  q[7] = p[6];
}

// The nibble cases as PTX: plane i of the accumulator is operand %i, plane i
// of multiple b is %(8 + 8 b + i); LOP3 0x96 is a three-way XOR.
#define GF_X1(a, p) "xor.b32 %" #a ", %" #a ", %" #p ";\n"
#define GF_X2(a, p, q) "lop3.b32 %" #a ", %" #a ", %" #p ", %" #q ", 0x96;\n"
#define GF_N1(a, m0, m1, m2, m3) GF_X1(a, m0)
#define GF_N2(a, m0, m1, m2, m3) GF_X1(a, m1)
#define GF_N3(a, m0, m1, m2, m3) GF_X2(a, m0, m1)
#define GF_N4(a, m0, m1, m2, m3) GF_X1(a, m2)
#define GF_N5(a, m0, m1, m2, m3) GF_X2(a, m0, m2)
#define GF_N6(a, m0, m1, m2, m3) GF_X2(a, m1, m2)
#define GF_N7(a, m0, m1, m2, m3) GF_X2(a, m0, m1) GF_X1(a, m2)
#define GF_N8(a, m0, m1, m2, m3) GF_X1(a, m3)
#define GF_N9(a, m0, m1, m2, m3) GF_X2(a, m0, m3)
#define GF_N10(a, m0, m1, m2, m3) GF_X2(a, m1, m3)
#define GF_N11(a, m0, m1, m2, m3) GF_X2(a, m0, m1) GF_X1(a, m3)
#define GF_N12(a, m0, m1, m2, m3) GF_X2(a, m2, m3)
#define GF_N13(a, m0, m1, m2, m3) GF_X2(a, m0, m2) GF_X1(a, m3)
#define GF_N14(a, m0, m1, m2, m3) GF_X2(a, m1, m2) GF_X1(a, m3)
#define GF_N15(a, m0, m1, m2, m3) GF_X2(a, m0, m1) GF_X2(a, m2, m3)
#define GF_EXPAND(M, ...) M(__VA_ARGS__)
#define GF_PLANES(M)                                                          \
  GF_EXPAND(M, 0, 8, 16, 24, 32) GF_EXPAND(M, 1, 9, 17, 25, 33)               \
  GF_EXPAND(M, 2, 10, 18, 26, 34) GF_EXPAND(M, 3, 11, 19, 27, 35)             \
  GF_EXPAND(M, 4, 12, 20, 28, 36) GF_EXPAND(M, 5, 13, 21, 29, 37)             \
  GF_EXPAND(M, 6, 14, 22, 30, 38) GF_EXPAND(M, 7, 15, 23, 31, 39)
#define GF_CASE(N) "L" #N ":\n" GF_PLANES(GF_N##N) "bra.uni DONE;\n"
#define GF_M(b)                                                               \
  "r"(m[b][0]), "r"(m[b][1]), "r"(m[b][2]), "r"(m[b][3]),                     \
  "r"(m[b][4]), "r"(m[b][5]), "r"(m[b][6]), "r"(m[b][7])

// acc ^= the multiples m[b] selected by the set bits b of nibble n; n is
// the same in every lane (target 0 of the branch is the end)
__device__ __forceinline__ void select_nibble(uint32_t acc[8], const uint32_t m[4][8],
                                              uint32_t n) {
  asm volatile(
      "{\n"
      "ts: .branchtargets DONE, L1, L2, L3, L4, L5, L6, L7, L8, L9, L10, L11, L12, L13, L14,"
      " L15;\n"
      "brx.idx.uni %40, ts;\n"
      GF_CASE(1) GF_CASE(2) GF_CASE(3) GF_CASE(4) GF_CASE(5) GF_CASE(6) GF_CASE(7)
      GF_CASE(8) GF_CASE(9) GF_CASE(10) GF_CASE(11) GF_CASE(12) GF_CASE(13) GF_CASE(14)
      GF_CASE(15)
      "DONE:\n"
      "}\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7])
      : GF_M(0), GF_M(1), GF_M(2), GF_M(3), "r"(n));
}

// One work list: for each entry (row << 8 | c), the row's accumulator planes
// (this lane's 32 bytes at acc + row * tile_bytes, in shared memory, touched
// by no other lane) take c's low nibble's multiples among m[0..3] = x .. 8x
// and its high nibble's among m[4..7] = 16x .. 128x.
__device__ __forceinline__ void run_list(const uint16_t* list, int count, uint8_t* acc,
                                         int tile_bytes, const uint32_t m[8][8]) {
  for (int k = 0; k < count; ++k) {
    const uint32_t e = list[k];
    uint4* a = reinterpret_cast<uint4*>(acc + (e >> 8) * tile_bytes);
    const uint4 u = a[0];
    const uint4 w = a[kHalf / 16];
    uint32_t v[8] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
    select_nibble(v, m, e & 0x0Fu);
    select_nibble(v, m + 4, (e >> 4) & 0x0Fu);
    a[0] = make_uint4(v[0], v[1], v[2], v[3]);
    a[kHalf / 16] = make_uint4(v[4], v[5], v[6], v[7]);
  }
}

// 16 payload bytes at row[col..col+16) into w (zero past B), byte by byte
__device__ __forceinline__ void load16(const uint8_t* row, long long col, long long B,
                                      uint32_t w[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0u;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long c = col + 4 * q + t;
      word |= (c < B ? static_cast<uint32_t>(row[c]) : 0u) << (8 * t);
    }
    w[q] = word;
  }
}

__device__ __forceinline__ void store16(uint8_t* row, long long col, long long B,
                                        bool aligned, const uint32_t w[4]) {
  if (col >= B) return;
  if (aligned) {  // B % 16 == 0, so the whole 16 bytes lie inside
    *reinterpret_cast<uint4*>(row + col) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const long long c = col + 4 * q + t;
      if (c < B) row[c] = static_cast<uint8_t>(w[q] >> (8 * t));
    }
  }
}

// Where a thread is in its block's sequence of chunk steps: the block's
// items are blockIdx.x, blockIdx.x + gridDim.x, ..., item i being pass
// i % passes of column tile i / passes (so a tile's passes follow each other
// and re-read it from L2), each cut into `chunks` chunks of input rows.
struct Cursor {
  long long item;
  long long tile;
  int pass;
  int chunk;
  int stage;

  __device__ void place(const Geometry& geo) {
    tile = item / geo.passes;
    pass = static_cast<int>(item - tile * geo.passes);
  }
  __device__ void start(const Geometry& geo) {
    item = blockIdx.x;
    chunk = 0;
    stage = 0;
    place(geo);
  }
  __device__ void advance(const Geometry& geo) {
    stage = stage + 1 == kStages ? 0 : stage + 1;
    if (++chunk < geo.chunks) return;
    chunk = 0;
    item += gridDim.x;
    place(geo);
  }
};

// the output rows [lo, lo + n) of row warp wr in pass p
__device__ __forceinline__ void warp_rows(const Geometry& geo, int R, int p, int wr, int& lo,
                                          int& n) {
  const int pass_rows = min(geo.rows_per_pass, R - p * geo.rows_per_pass);
  lo = p * geo.rows_per_pass + wr * pass_rows / geo.wr;
  n = p * geo.rows_per_pass + (wr + 1) * pass_rows / geo.wr - lo;
}

__global__ void __launch_bounds__(kThreads, 1)
gf_bitsliced_kernel(const uint8_t* __restrict__ m, const uint8_t* __restrict__ x,
                    uint8_t* __restrict__ y, int R, int K, long long B, int aligned_flag,
                    Geometry geo) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wr = warp / geo.wc;  // row warps of one slice sit geo.wc warps apart
  const int wc = warp % geo.wc;
  // column group wc's ring, then [row of the pass][tile_bytes] accumulators,
  // then [pass][K][wr] work lists
  const int stage_bytes = geo.chunk_rows * kSliceBytes;
  uint8_t* ring = smem + wc * kStages * stage_bytes;
  uint8_t* accs = smem + geo.ring_bytes;
  const uint16_t* lists = reinterpret_cast<const uint16_t*>(accs + geo.acc_bytes);
  const bool aligned = aligned_flag != 0;

  const int g = blockIdx.y;
  const uint8_t* mg = m + static_cast<long long>(g) * R * K;
  const uint8_t* xg = x + static_cast<long long>(g) * K * B;
  uint8_t* yg = y + static_cast<long long>(g) * R * B;
  for (int e = threadIdx.x; e < geo.list_bytes / kListStride; e += kThreads) {
    const int w = e % geo.wr;
    const int j = (e / geo.wr) % K;
    const int p = e / (geo.wr * K);
    int lo, n;
    warp_rows(geo, R, p, w, lo, n);
    uint16_t* list = reinterpret_cast<uint16_t*>(accs + geo.acc_bytes) + e * kListWords;
    int count = 0, high = 0;
    for (int rr = 0; rr < n; ++rr) {
      const int c = mg[(lo + rr) * K + j];
      if (c) list[1 + count++] = static_cast<uint16_t>(rr << 8 | c);
      high |= c >> 4;
    }
    list[0] = static_cast<uint16_t>(count | (high ? 0x100 : 0));
  }
  for (int e = threadIdx.x; e < geo.acc_bytes / 16; e += kThreads) {
    reinterpret_cast<uint4*>(accs)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();  // lists, accumulators

  // The warps of one column slice (a column group) run their own pipeline
  // through their own ring: no block-wide barrier after this point.  With
  // several row warps on a slice, the group's threads each copy and, once
  // their own copies land, bit-transpose in place some of its 32-byte groups
  // (thread t of the group: groups t, t + 32 wr, ..), then meet at the
  // group's named barrier; a lone row warp transposes its lanes' bytes as it
  // reads them and meets only itself.
  const long long items = geo.tiles * geo.passes;
  const long long mine =
      blockIdx.x < items ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = mine * geo.chunks;
  const int group_threads = 32 * geo.wr;
  const int tid = wr * 32 + lane;  // within the column group
  const bool shared_planes = geo.wr > 1;
  auto group_sync = [&]() {
    if (shared_planes) {
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wc), "r"(group_threads) : "memory");
    } else {
      __syncwarp();
    }
  };

  Cursor prod;
  prod.start(geo);
  auto issue = [&](long long q) {
    if (q < steps) {
      const int j0 = prod.chunk * geo.chunk_rows;
      const int rows = min(geo.chunk_rows, K - j0);
      const long long col0 = prod.tile * geo.tile_bytes + wc * kSliceBytes;
      uint8_t* stage = ring + prod.stage * stage_bytes;
      for (int gi = tid; gi < rows * 32; gi += group_threads) {
        const int jj = gi >> 5;
        const uint8_t* src = xg + static_cast<long long>(j0 + jj) * B;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (gi & 31) * 16 + h * kHalf;
          const long long c = col0 + off;
          uint8_t* dst = stage + jj * kSliceBytes + off;
          if (aligned) {
            cp_async16(dst, c < B ? src + c : xg, c < B ? 16 : 0);
          } else {
            uint32_t w[4];
            load16(src, c, B, w);
            *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
      prod.advance(geo);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    issue(s);
    cp_async_commit();
  }

  Cursor cons;
  cons.start(geo);
  const int lane_off = wc * kSliceBytes + lane * 16;
  int rows_pass = -1, r_lo = 0, nrows = 0;
  uint8_t* acc = nullptr;
  for (long long q = 0; q < steps; ++q, cons.advance(geo)) {
    const long long col0 = cons.tile * geo.tile_bytes;
    const int j0 = cons.chunk * geo.chunk_rows;
    const int rows = min(geo.chunk_rows, K - j0);
    uint8_t* stage = ring + cons.stage * stage_bytes;
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk q landed
    for (int gi = tid; shared_planes && gi < rows * 32; gi += group_threads) {
      uint4* a = reinterpret_cast<uint4*>(stage + (gi >> 5) * kSliceBytes + (gi & 31) * 16);
      const uint4 u = a[0];
      const uint4 v = a[kHalf / 16];
      uint32_t w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
      transpose8(w);
      a[0] = make_uint4(w[0], w[1], w[2], w[3]);
      a[kHalf / 16] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    group_sync();  // chunk q is in place; the group is done with chunk q - 1
    issue(q + kStages - 1);
    cp_async_commit();
    if (cons.pass != rows_pass) {
      rows_pass = cons.pass;
      warp_rows(geo, R, rows_pass, wr, r_lo, nrows);
      acc = accs + (r_lo - rows_pass * geo.rows_per_pass) * geo.tile_bytes + lane_off;
    }
    const uint16_t* lbase = lists + ((cons.pass * K + j0) * geo.wr + wr) * kListWords;
    for (int jj = 0; jj < rows; ++jj) {
      const uint16_t* list = lbase + jj * geo.wr * kListWords;
      const uint32_t head = list[0];
      const int count = head & 0xFF;
      if (count == 0) continue;  // no row of this warp reads input row j
      uint32_t mult[8][8];
      const uint8_t* planes = stage + jj * kSliceBytes + lane * 16;
      const uint4 a = *reinterpret_cast<const uint4*>(planes);
      const uint4 b = *reinterpret_cast<const uint4*>(planes + kHalf);
      mult[0][0] = a.x; mult[0][1] = a.y; mult[0][2] = a.z; mult[0][3] = a.w;
      mult[0][4] = b.x; mult[0][5] = b.y; mult[0][6] = b.z; mult[0][7] = b.w;
      if (!shared_planes) transpose8(mult[0]);
      const int doubled = head >> 8 ? 7 : 3;  // 16x .. 128x only for high nibbles
#pragma unroll
      for (int i = 1; i < 8; ++i) {
        if (i <= doubled) double_planes(mult[i - 1], mult[i]);
      }
      run_list(list + 1, count, acc, geo.tile_bytes, mult);
    }

    if (cons.chunk == geo.chunks - 1) {  // the item's last input rows: store and reset
      const long long col = col0 + lane_off;
      for (int rr = 0; rr < nrows; ++rr) {
        uint4* a = reinterpret_cast<uint4*>(acc + rr * geo.tile_bytes);
        const uint4 u = a[0];
        const uint4 v = a[kHalf / 16];
        uint32_t w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
        transpose8(w);
        uint8_t* out = yg + static_cast<long long>(r_lo + rr) * B;
        store16(out, col, B, aligned, &w[0]);
        store16(out, col + kHalf, B, aligned, &w[4]);
        a[0] = make_uint4(0u, 0u, 0u, 0u);
        a[kHalf / 16] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  cp_async_wait<0>();
}

// Launch facts kept per device, so a launch makes no attribute or occupancy
// query after its device's first: the SM count (read once, when the
// shared-memory opt-in is also set, to the most any shape asks) and the
// blocks per SM of each dynamic shared-memory size.
std::mutex cache_mu;
std::map<int, int> cache_sms;
std::map<std::pair<int, long long>, int> cache_per_sm;

cudaError_t device_sms(int device, int& sms) {
  std::lock_guard<std::mutex> lock(cache_mu);
  auto hit = cache_sms.find(device);
  if (hit == cache_sms.end()) {
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(gf_bitsliced_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    }
    if (err != cudaSuccess) return err;
    hit = cache_sms.emplace(device, sms).first;
  }
  sms = hit->second;
  return cudaSuccess;
}

cudaError_t blocks_per_sm(int device, long long smem, int& per_sm) {
  std::lock_guard<std::mutex> lock(cache_mu);
  auto hit = cache_per_sm.find({device, smem});
  if (hit == cache_per_sm.end()) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gf_bitsliced_kernel, kThreads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    hit = cache_per_sm.emplace(std::make_pair(device, smem), per_sm > 0 ? per_sm : 1).first;
  }
  per_sm = hit->second;
  return cudaSuccess;
}

// Shared memory a geometry needs: accumulators (rows per pass x the tile),
// work lists and a ring of one-row stages at the least.
long long least_smem(const Geometry& geo, int K) {
  const long long tile = static_cast<long long>(kWarps / geo.wr) * kSliceBytes;
  return geo.rows_per_pass * tile + static_cast<long long>(geo.passes) * K * geo.wr * kListStride +
         kStages * tile;
}

// The block's geometry for a (G, R, K, B) product on `sms` SMs: the fewest
// row warps (a power of two, so they divide the block's warps) that fit,
// passes over the same tile only where no number of row warps holds R rows;
// then, for a narrow product whose tiles do not fill the SMs, more row
// warps (idle ones still copy and transpose) for more, narrower tiles.
// Returns false where no geometry fits.
bool make_geometry(int G, int R, int K, long long B, int sms, Geometry& geo) {
  auto fits = [&]() {
    return (geo.rows_per_pass + geo.wr - 1) / geo.wr <= kMaxRowsPerWarp &&
           least_smem(geo, K) <= kMaxSmem;
  };
  for (geo.passes = (R + kRowsPerPass - 1) / kRowsPerPass;; ++geo.passes) {
    geo.rows_per_pass = (R + geo.passes - 1) / geo.passes;
    geo.wr = 1;
    while (geo.wr <= kWarps && !fits()) geo.wr *= 2;
    if (geo.wr <= kWarps) break;
    if (geo.passes >= R) return false;
  }
  auto tiles = [&](int wr) {
    const long long tile = static_cast<long long>(kWarps / wr) * kSliceBytes;
    return (B + tile - 1) / tile;
  };
  while (geo.wr < kWarps && tiles(geo.wr) * G < sms) {
    geo.wr *= 2;
    if (!fits()) {
      geo.wr /= 2;
      break;
    }
  }
  geo.wc = kWarps / geo.wr;
  geo.tile_bytes = geo.wc * kSliceBytes;
  geo.acc_bytes = geo.rows_per_pass * geo.tile_bytes;
  const long long list_bytes = static_cast<long long>(geo.passes) * K * geo.wr * kListStride;
  const long long room = (kMaxSmem - geo.acc_bytes - list_bytes) / kStages;
  const long long stage = room < kStageBytes ? room : kStageBytes;
  const int per_stage = static_cast<int>(stage / geo.tile_bytes);
  geo.chunk_rows = per_stage < K ? per_stage : K;
  geo.chunks = (K + geo.chunk_rows - 1) / geo.chunk_rows;
  geo.ring_bytes = kStages * geo.chunk_rows * geo.tile_bytes;
  geo.list_bytes = static_cast<int>(list_bytes);
  geo.tiles = tiles(geo.wr);
  return true;
}

// Everything a launch decides on the host: the geometry, its dynamic shared
// memory, the blocks per SM it admits and the grid.  The launcher and the
// geometry query both call this, so what the checker is given is what runs;
// kernels/gf_matmul.py::gf_matmul_geometry models it with the device's SM
// count and blocks per SM as arguments.
struct Launch {
  Geometry geo;
  long long smem;
  int grid_x;
  int per_sm;
  int sms;
};

cudaError_t plan_launch(int G, int R, int K, long long B, Launch& l) {
  if (G <= 0 || R <= 0 || K <= 0 || B <= 0 || G > 65535) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = device_sms(device, l.sms);
  if (err != cudaSuccess) return err;
  if (!make_geometry(G, R, K, B, l.sms, l.geo)) return cudaErrorInvalidValue;
  l.smem = static_cast<long long>(l.geo.ring_bytes) + l.geo.acc_bytes + l.geo.list_bytes;
  err = blocks_per_sm(device, l.smem, l.per_sm);
  if (err != cudaSuccess) return err;
  const long long items = l.geo.tiles * l.geo.passes;
  const long long resident = static_cast<long long>(l.sms) * l.per_sm;
  // G batches on blockIdx.y share the resident blocks in one wave
  const long long want = resident / G > 0 ? resident / G : 1;
  l.grid_x = static_cast<int>(items < want ? items : want);
  return cudaSuccess;
}

}  // namespace

// m (G, R, K), x (G, K, B), y (G, R, B): contiguous uint8 device buffers.
// `aligned` != 0 promises B % 16 == 0 and 16-byte aligned x and y.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gf_matmul_launch(const void* m, const void* x, void* y, int G,
                                int R, int K, long long B, int aligned,
                                void* stream) {
  Launch l;
  const cudaError_t err = plan_launch(G, R, K, B, l);
  if (err != cudaSuccess) return static_cast<int>(err);
  gf_bitsliced_kernel<<<dim3(l.grid_x, G), kThreads, static_cast<size_t>(l.smem),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(m), static_cast<const uint8_t*>(x),
      static_cast<uint8_t*>(y), R, K, B, aligned, l.geo);
  return static_cast<int>(cudaGetLastError());
}

// The launch a (G, R, K, B) product would get on the current device, without
// launching: out = {wr, wc, tile_bytes, rows_per_pass, passes, chunk_rows,
// chunks, ring_bytes, acc_bytes, list_bytes, tiles, grid_x, per_sm,
// dynamic shared memory bytes, SM count}.  Returns 0 or the cudaError_t.
extern "C" int gf_matmul_geometry_query(int G, int R, int K, long long B, long long* out) {
  Launch l;
  const cudaError_t err = plan_launch(G, R, K, B, l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry& g = l.geo;
  const long long v[15] = {g.wr,       g.wc,         g.tile_bytes, g.rows_per_pass, g.passes,
                           g.chunk_rows, g.chunks,   g.ring_bytes, g.acc_bytes,     g.list_bytes,
                           g.tiles,    l.grid_x,     l.per_sm,     l.smem,          l.sms};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}
