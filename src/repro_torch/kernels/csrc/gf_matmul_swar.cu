// The first GF(2^8) kernel of the port (SWAR bitplane product), kept verbatim below as the
// baseline of `python -m repro_torch.kernels.gf_ablation`, which alone builds it.
// No wrapper on the path reaches it: the path's kernel is gf_matmul.cu.
//
// GF(2^8) matrix x payload product for Hopper (sm_90a), batched.
//
//   Y[g, r, b] = XOR_j  M[g, r, j] (x) X[g, j, b]        ((x) = GF(256) multiply)
//
// Replaces the TPU kernel src/repro/kernels/gf_matmul.py::_gf_bitplane_kernel
// (launched by gf_matmul_pallas).  That kernel computes the same product as the
// bitplane GF(2) matmul pack((bits(M) @ unpack(X)) & 1) on the MXU, with the
// whole bit-expanded (8R, 8K) matrix pinned in VMEM.  On Hopper that matrix does
// not fit one block's shared memory (MSR(9,6,3) encode: 648 x 1296 B = 840 KB;
// the shared memory limit is 227 KB), and int8 tensor cores would spend 64x the
// payload's bits on a product that is mostly zeros.
//
// Design: the GF(256) coefficients stay resident instead (R*K bytes, <= 40 KB on
// the main path), next to a 256 x 8 table of splat(c * 2^i) words (8 KB).  The
// bit-matrix column i of coefficient c is c * 2^i (core/gf.py::gf_mul_bitmatrix),
// so the bitplane product becomes, per 32-bit word of 4 payload bytes x:
//
//   plane_i = ((x >> i) & 0x01010101) * 0xFF        (0xFF in each byte whose bit i is set)
//   y      ^= plane_i & splat(c * 2^i)              for i = 0..7, accumulated over j
//
// which is one LOP3 per (row, coefficient, plane, word) once the planes are
// built.  Each thread owns a 16-byte strip of the byte axis (one coalesced
// 16-byte load per input row), keeps RT output rows in registers, and walks the
// K input rows; R is cut into passes of RT rows, and the passes of one strip run
// back to back so their re-reads of the strip hit L2.  The grid strides over the
// byte axis, blockIdx.y is the batch index g.
//
// What bounds it: per output byte the kernel does 8*K LOP3s over 4-byte words,
// about 2*R*K*B integer operations, against (R + K) * B bytes of traffic, so at
// the main path's shapes (R 9, K 18) it is bound by integer issue, not by memory.
//
// The ragged edge (B not a multiple of 16, or a row start that is not 16-byte
// aligned) takes the byte-wise load/store path with bounds checks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 16;       // payload bytes per thread per step
constexpr int kMaxRowsPerPass = 12;
constexpr int kTableBytes = 256 * 8 * 4;

__device__ __forceinline__ uint32_t xtime(uint32_t v) {
  // multiply one byte by 2 in GF(2^8) mod x^8+x^4+x^3+x^2+1 (0x11D)
  return ((v << 1) ^ ((v & 0x80u) ? 0x1Du : 0u)) & 0xFFu;
}

template <bool kAligned>
__device__ __forceinline__ void load_strip(const uint8_t* __restrict__ row,
                                           long long col, long long B,
                                           uint32_t w[4]) {
  if (kAligned) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + col));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long c = col + 4 * q + t;
        const uint32_t byte = c < B ? row[c] : 0u;
        word |= byte << (8 * t);
      }
      w[q] = word;
    }
  }
}

template <bool kAligned>
__device__ __forceinline__ void store_strip(uint8_t* __restrict__ row,
                                            long long col, long long B,
                                            const uint32_t w[4]) {
  if (kAligned) {
    *reinterpret_cast<uint4*>(row + col) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const long long c = col + 4 * q + t;
        if (c < B) row[c] = static_cast<uint8_t>(w[q] >> (8 * t));
      }
    }
  }
}

template <int RT, bool kAligned>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ m, const uint8_t* __restrict__ x,
                 uint8_t* __restrict__ y, int R, int K, long long B, int r_pad) {
  extern __shared__ uint32_t smem[];
  uint32_t* table = smem;                                          // [256][8] splat(c*2^i)
  uint8_t* coef = reinterpret_cast<uint8_t*>(smem + 256 * 8);      // [r_pad][K]

  const int g = blockIdx.y;
  const uint8_t* mg = m + static_cast<long long>(g) * R * K;
  const uint8_t* xg = x + static_cast<long long>(g) * K * B;
  uint8_t* yg = y + static_cast<long long>(g) * R * B;

  for (int e = threadIdx.x; e < 256 * 8; e += blockDim.x) {
    uint32_t v = static_cast<uint32_t>(e >> 3);
    for (int t = 0; t < (e & 7); ++t) v = xtime(v);
    table[e] = v * 0x01010101u;
  }
  for (int e = threadIdx.x; e < r_pad * K; e += blockDim.x) {
    coef[e] = e < R * K ? mg[e] : 0;  // rows past R multiply by zero
  }
  __syncthreads();

  const long long strips = (B + kStrip - 1) / kStrip;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       s < strips; s += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long col = s * kStrip;
    for (int r0 = 0; r0 < R; r0 += RT) {
      uint32_t acc[RT][4];
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        acc[rr][0] = acc[rr][1] = acc[rr][2] = acc[rr][3] = 0u;
      }
      for (int j = 0; j < K; ++j) {
        uint32_t w[4];
        load_strip<kAligned>(xg + static_cast<long long>(j) * B, col, B, w);
        uint32_t plane[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int q = 0; q < 4; ++q) plane[i][q] = ((w[q] >> i) & 0x01010101u) * 0xFFu;
        }
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          // the 8 words splat(c * 2^i) of this row's coefficient: two 16-byte
          // shared loads, the same address across the warp (a broadcast)
          const uint4* t = reinterpret_cast<const uint4*>(
              table + 8 * static_cast<uint32_t>(coef[(r0 + rr) * K + j]));
          const uint4 lo = t[0], hi = t[1];
          const uint32_t c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[rr][q] ^= plane[i][q] & c[i];
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        if (r0 + rr < R) {
          store_strip<kAligned>(yg + static_cast<long long>(r0 + rr) * B, col, B, acc[rr]);
        }
      }
    }
  }
}

template <int RT, bool kAligned>
cudaError_t launch(const uint8_t* m, const uint8_t* x, uint8_t* y, int G, int R,
                   int K, long long B, int grid_x, cudaStream_t stream) {
  const int r_pad = (R + RT - 1) / RT * RT;
  const size_t smem = kTableBytes + static_cast<size_t>(r_pad) * K;
  auto kernel = gf_matmul_kernel<RT, kAligned>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid_x, G), kThreads, smem, stream>>>(m, x, y, R, K, B, r_pad);
  return cudaGetLastError();
}

template <bool kAligned>
cudaError_t dispatch_rows(int rt, const uint8_t* m, const uint8_t* x, uint8_t* y,
                          int G, int R, int K, long long B, int grid_x,
                          cudaStream_t s) {
  switch (rt) {
    case 1: return launch<1, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 2: return launch<2, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 3: return launch<3, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 4: return launch<4, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 5: return launch<5, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 6: return launch<6, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 7: return launch<7, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 8: return launch<8, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 9: return launch<9, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 10: return launch<10, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 11: return launch<11, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    case 12: return launch<12, kAligned>(m, x, y, G, R, K, B, grid_x, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// m (G, R, K), x (G, K, B), y (G, R, B): contiguous uint8 device buffers.
// `aligned` != 0 promises B % 16 == 0 and 16-byte aligned base pointers.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gf_matmul_launch(const void* m, const void* x, void* y, int G,
                                int R, int K, long long B, int aligned,
                                void* stream) {
  if (G <= 0 || R <= 0 || K <= 0 || B <= 0 || G > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int passes = (R + kMaxRowsPerPass - 1) / kMaxRowsPerPass;
  const int rt = (R + passes - 1) / passes;  // even passes of <= 12 rows
  const long long strips = (B + kStrip - 1) / kStrip;
  const long long want = (strips + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16 / G > 0 ? 132LL * 16 / G : 1;  // ~16 blocks per SM in all
  const int grid_x = static_cast<int>(want < cap ? want : cap);
  const auto* mp = static_cast<const uint8_t*>(m);
  const auto* xp = static_cast<const uint8_t*>(x);
  auto* yp = static_cast<uint8_t*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      aligned ? dispatch_rows<true>(rt, mp, xp, yp, G, R, K, B, grid_x, s)
              : dispatch_rows<false>(rt, mp, xp, yp, G, R, K, B, grid_x, s);
  return static_cast<int>(err);
}
