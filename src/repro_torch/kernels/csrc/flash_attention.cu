// Flash-attention forward for Hopper (sm_90a): causal or bidirectional, GQA.
//
//   O[b, i, h, :] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,kh,:]) v[b,j,kh,:]
//   kh = h / (H / KVH),  causal: j <= i (positions from 0 for both q and k)
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention).  That kernel runs a grid (B*H, q blocks,
// kv blocks) whose kv axis is sequential on the TPU, carrying the running
// (max m, sum l, acc) in VMEM scratch from one grid step to the next.  CUDA
// blocks run in parallel and in no order, so here one thread block takes one
// (batch*head, 64-row q tile) and a loop inside the block walks the kv tiles,
// carrying (m, l, acc) in registers.  Tiles strictly above the causal diagonal
// are not visited; the diagonal tile masks row >= col.  q/k/v are read in the
// public (B, S, H, D) layout through strides: no transposed copy, and repeated
// K/V is never built.  The output is acc / max(l, 1e-30), as on the TPU.
//
// What bounds it: at the model's prefill shape (StarCoder2-3B: B 4, S 4096,
// H 24 over 2 KV heads, D 128, causal) the forward is about 4.1e11 FLOP against
// 218 MB of q, k, v and o, so it is bound by operations: about 0.42 ms at the
// data sheet's 989 TFLOP/s bf16 against about 0.07 ms at 3.35 TB/s (data-sheet
// figures, not measured).  What the design does about it: the (S, S) scores
// never leave the SM, both products of the bf16 path run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate), and causal tiles above the
// diagonal are skipped, which halves the work.  It is a simple kernel: one tile
// of K and V at a time, loaded synchronously, no wgmma, no TMA, no warp
// specialisation.
//
// Two type paths:
// * f32: f32 arithmetic throughout on the CUDA cores (FMA, no TF32).  q is
//   scaled before the product, as the TPU kernel does.  256 threads; thread
//   (row r, quarter q4) computes 16 scores of row r and owns D/4 columns of
//   the row's accumulator.  Tiles of 64 rows, shared-memory rows padded by one
//   float against bank conflicts: 113 KB at D = 128 (dynamic shared memory).
// * bf16: 4 warps, each owning 16 q rows.  S = Q K^T and O += P V run as
//   mma.sync m16n8k16; Q stays in registers as A fragments, K is read as the
//   B operand directly (its rows are the product's columns), V through
//   ldmatrix.trans.  Two differences from the TPU kernel, both within the
//   bf16 tolerance: the scale is applied to S in f32 after the product (the
//   TPU kernel scales q before it), and P is rounded to bf16 for the PV
//   product (the TPU kernel keeps it in f32).
//
// The ragged edge (Sq or Sk not a multiple of 64) is masked here: rows past Sq
// are computed on zeros and not stored, columns past Sk score -1e30 and their
// V rows are zero-filled.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockM = 64;  // q rows per block
constexpr int kBlockN = 64;  // kv rows per tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KVH;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  int causal;
  float scale;
};

// kv tiles a block of q rows [q0, q0 + kBlockM) visits: with a causal mask,
// none strictly above the diagonal of its last row.
__device__ __forceinline__ int kv_tiles(const Params& p, int q0) {
  int n = (p.Sk + kBlockN - 1) / kBlockN;
  if (p.causal) {
    const int last_row = min(q0 + kBlockM, p.Sq) - 1;
    n = min(n, last_row / kBlockN + 1);
  }
  return n;
}

// ----------------------------------------------------------------- f32 path
template <int D>
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int LD = D + 1;        // padded row of Q/K/V in shared memory
  constexpr int LP = kBlockN + 1;  // padded row of P
  constexpr int DV = D / 4;        // float4 per row
  extern __shared__ float smem_f[];
  float* Qs = smem_f;
  float* Ks = Qs + kBlockM * LD;
  float* Vs = Ks + kBlockN * LD;
  float* Ps = Vs + kBlockN * LD;

  const int tid = threadIdx.x;
  const int r = tid >> 2, q4 = tid & 3;
  const int q0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KVH);
  const float* qg = static_cast<const float*>(p.q) + b * p.qsb + h * p.qsh;
  const float* kg = static_cast<const float*>(p.k) + b * p.ksb + kh * p.ksh;
  const float* vg = static_cast<const float*>(p.v) + b * p.vsb + kh * p.vsh;

  for (int i = tid; i < kBlockM * DV; i += 256) {
    const int row = i / DV, c = (i % DV) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < p.Sq) x = *reinterpret_cast<const float4*>(qg + (q0 + row) * p.qss + c);
    float* dst = Qs + row * LD + c;
    dst[0] = x.x * p.scale; dst[1] = x.y * p.scale;
    dst[2] = x.z * p.scale; dst[3] = x.w * p.scale;
  }

  const int row = q0 + r;
  float m = kNegInf, l = 0.f;
  float acc[DV];
#pragma unroll
  for (int dd = 0; dd < DV; ++dd) acc[dd] = 0.f;

  const int nt = kv_tiles(p, q0);
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile's K/V/P are read
    for (int i = tid; i < kBlockN * DV; i += 256) {
      const int j = i / DV, c = (i % DV) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + j < p.Sk) {
        kx = *reinterpret_cast<const float4*>(kg + (k0 + j) * p.kss + c);
        vx = *reinterpret_cast<const float4*>(vg + (k0 + j) * p.vss + c);
      }
      float* kd = Ks + j * LD + c;
      float* vd = Vs + j * LD + c;
      kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
      vd[0] = vx.x; vd[1] = vx.y; vd[2] = vx.z; vd[3] = vx.w;
    }
    __syncthreads();

    float s[16];
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const int j = q4 + 4 * jj;
      const float* qr = Qs + r * LD;
      const float* kr = Ks + j * LD;
      float a = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
      const int col = k0 + j;
      if (col >= p.Sk || (p.causal && col > row)) a = kNegInf;
      s[jj] = a;
      mx = fmaxf(mx, a);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float pj = expf(s[jj] - m_new);
      Ps[r * LP + q4 + 4 * jj] = pj;
      sum += pj;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = m_new;
    __syncwarp();  // row r of P was written by the 4 lanes that read it
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) acc[dd] *= corr;
    for (int j = 0; j < kBlockN; ++j) {
      const float pj = Ps[r * LP + j];
      const float* vr = Vs + j * LD + q4;
#pragma unroll
      for (int dd = 0; dd < DV; ++dd) acc[dd] = fmaf(pj, vr[4 * dd], acc[dd]);
    }
  }

  if (row < p.Sq) {
    float* og = static_cast<float*>(p.o) + b * p.osb + row * p.oss + h * p.osh;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) og[q4 + 4 * dd] = acc[dd] / den;
  }
}

// ---------------------------------------------------------------- bf16 path
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies rows [r0, r0 + 64) of a (S, D) bf16 matrix with row stride `rs` into
// shared memory rows of LDS elements, zero-filling rows past `S`.
template <int D, int LDS>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst, const uint16_t* src,
                                               long long rs, int r0, int S, int tid) {
  constexpr int DV = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < 64 * DV; i += 128) {
    const int row = i / DV, c = (i % DV) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < S) x = *reinterpret_cast<const uint4*>(src + (r0 + row) * rs + c);
    *reinterpret_cast<uint4*>(dst + row * LDS + c) = x;
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  // rows padded by 8 elements (16 bytes): the 8 rows of a fragment load then
  // fall on distinct banks, and every row start stays 16-byte aligned
  constexpr int LDS = D + 8;
  constexpr int KS = D / 16;        // k-steps of Q K^T
  constexpr int NS = kBlockN / 8;   // n8 tiles of S
  constexpr int ND = D / 8;         // n8 tiles of O
  extern __shared__ __align__(16) uint16_t smem_h[];
  uint16_t* Qs = smem_h;
  uint16_t* Ks = Qs + kBlockM * LDS;
  uint16_t* Vs = Ks + kBlockN * LDS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * kBlockM;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int kh = h / (p.H / p.KVH);
  const uint16_t* qg = static_cast<const uint16_t*>(p.q) + b * p.qsb + h * p.qsh;
  const uint16_t* kg = static_cast<const uint16_t*>(p.k) + b * p.ksb + kh * p.ksh;
  const uint16_t* vg = static_cast<const uint16_t*>(p.v) + b * p.vsb + kh * p.vsh;

  load_tile_bf16<D, LDS>(Qs, qg, p.qss, q0, p.Sq, tid);
  __syncthreads();
  // this warp's 16 rows of Q as A fragments (row g and g + 8 of the warp)
  uint32_t qf[KS][4];
  {
    const uint16_t* base = Qs + (warp * 16 + g) * LDS + tg * 2;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][0] = ld32(base + kk * 16);
      qf[kk][1] = ld32(base + 8 * LDS + kk * 16);
      qf[kk][2] = ld32(base + kk * 16 + 8);
      qf[kk][3] = ld32(base + 8 * LDS + kk * 16 + 8);
    }
  }

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's partial sums
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  const int nt = kv_tiles(p, q0);
  for (int t = 0; t < nt; ++t) {
    const int k0 = t * kBlockN;
    __syncthreads();  // the previous tile's K/V are read
    load_tile_bf16<D, LDS>(Ks, kg, p.kss, k0, p.Sk, tid);
    load_tile_bf16<D, LDS>(Vs, vg, p.vss, k0, p.Sk, tid);
    __syncthreads();

    // S = Q K^T (16 x 64 per warp), f32
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const uint16_t* kb = Ks + (n * 8 + g) * LDS + tg * 2;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) mma_bf16(s[n], qf[kk], ld32(kb + kk * 16), ld32(kb + kk * 16 + 8));
    }
    // scale in f32, mask, running max of rows row0 / row1
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + tg * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        float x = s[n][e] * p.scale;
        if (col >= p.Sk || (p.causal && col > row)) x = kNegInf;
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = __expf(s[n][0] - mn0);
      s[n][1] = __expf(s[n][1] - mn0);
      s[n][2] = __expf(s[n][2] - mn1);
      s[n][3] = __expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= c0; oacc[n][1] *= c0;
      oacc[n][2] *= c1; oacc[n][3] *= c1;
    }
    // O += P V: the C fragments of S tiles 2t, 2t+1 are the A fragment of
    // k-step t once rounded to bf16
#pragma unroll
    for (int kt = 0; kt < kBlockN / 16; ++kt) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kt][0], s[2 * kt][1]), pack_bf16(s[2 * kt][2], s[2 * kt][3]),
          pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
      const uint16_t* vrow = Vs + (kt * 16 + (lane & 15)) * LDS;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(vrow + n * 8));
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(addr));
        mma_bf16(oacc[n], a, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  uint16_t* og = static_cast<uint16_t*>(p.o) + b * p.osb + h * p.osh + tg * 2;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (row0 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row0 * p.oss + n * 8) =
          pack_bf16(oacc[n][0] / d0, oacc[n][1] / d0);
    if (row1 < p.Sq)
      *reinterpret_cast<uint32_t*>(og + row1 * p.oss + n * 8) =
          pack_bf16(oacc[n][2] / d1, oacc[n][3] / d1);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t smem, const Params& p,
                   cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockM - 1) / kBlockM, p.B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 0) {
    const size_t smem = ((kBlockM + 2 * kBlockN) * (D + 1) + kBlockM * (kBlockN + 1)) * 4;
    return launch(flash_fwd_f32<D>, 256, smem, p, stream);
  }
  const size_t smem = (kBlockM + 2 * kBlockN) * (D + 8) * 2;
  return launch(flash_fwd_bf16<D>, 128, smem, p, stream);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  Strides are in elements; the head dim is
// contiguous and every row start is 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
    int KVH, int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int causal, int dtype, float scale,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      B * H > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{q, k, v, o, B, Sq, Sk, H, KVH, qsb, qss, qsh, ksb, kss, ksh,
                 vsb, vss, vsh, osb, oss, osh, causal, scale};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch<32>(dtype, p, s); break;
    case 64: err = dispatch<64>(dtype, p, s); break;
    case 128: err = dispatch<128>(dtype, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
