// Flash-attention forward for Hopper (sm_90a): causal or bidirectional, GQA.
//
//   O[b, i, h, :] = sum_j softmax_j(scale * q[b,i,h,:] . k[b,j,kh,:]) v[b,j,kh,:]
//   kh = h / (H / KVH),  causal: j <= i (positions from 0 for both q and k)
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (launched by flash_attention).  That kernel runs a grid (B*H, q blocks,
// kv blocks) whose kv axis is sequential on the TPU, carrying the running
// (max m, sum l, acc) in VMEM scratch from one grid step to the next.  CUDA
// blocks run in parallel and in no order, so here a block takes a whole
// (batch*head, q tile) and a loop inside it walks the kv tiles, carrying
// (m, l, acc) in registers.  Tiles strictly above the causal diagonal are not
// visited; only tiles that cross the diagonal or the ragged end of Sk pay for
// the mask.  q/k/v are read in the public (B, S, H, D) layout through their
// strides: no transposed copy, and repeated K/V is never built.  The output
// is acc / max(l, 1e-30), as on the TPU.
//
// What bounds it: at the model's prefill shape (StarCoder2-3B: B 4, S 4096,
// H 24 over 2 KV heads, D 128, causal) the forward is 4.12e11 FLOP against
// 218 MB of q, k, v and o, so it is bound by operations: 0.417 ms at the data
// sheet's 989 TFLOP/s bf16 against 0.065 ms at 3.35 TB/s.  What the bf16 path
// does about it, in FlashAttention-3's structure: keep the tensor cores fed
// and hide everything else behind them.
// * Persistent CTAs of three warpgroups, one per SM, each walking work items
//   (batch*head, 128-row q tile), longest causal tiles first so that the last
//   wave is short.  Warpgroup 0 is the producer: it gives its registers away
//   (setmaxnreg 24) and one of its threads issues every TMA load: Q, then K
//   and V tiles into a 2-stage ring in shared memory, K one kv tile ahead of
//   V, running on into the next item while the consumers finish this one.
//   Warpgroups 1 and 2 are the consumers (setmaxnreg 240), 64 q rows each.
// * mbarriers: full_k/full_v per stage (the producer's expect_tx plus the
//   TMA's byte count), empty_k/empty_v per stage (all 256 consumer threads
//   arrive: K once its QK^T has retired, V once its PV has), q_full/q_empty
//   for Q.  A consumer warpgroup with nothing to do on a tile or an item (all
//   its rows past Sq) still waits and arrives, so the ring never stalls.
// * Both products are wgmma with f32 accumulators in registers.  S = Q K^T is
//   m64n128k16 with both operands in shared memory, K-major, 128-byte
//   swizzled (64-byte at head dim 32) exactly as the TMA wrote them; at D 128
//   a tile is two 64-column boxes, since a swizzled box row is at most 128 B.
//   The online softmax runs on the accumulator fragment in the exp2 domain
//   (scale * log2(e) folded into one FMA), with quad shuffles for the row max
//   and a per-thread partial row sum.  P is rounded to bf16 in registers: the
//   accumulator layout of one wgmma is the register-A layout of the next, so
//   O += P V is m64n{D}k16 with A from registers and V read from shared
//   memory as an MN-major ("transposed") B operand.
// * Overlap: a warpgroup issues QK^T of kv tile t and PV of tile t - 1
//   together and runs the softmax of tile t while that PV is on the tensor
//   cores; and the two warpgroups take turns to issue (ping-pong, on named
//   barriers), so that one's softmax runs while the other's products do.
// * TMA fills rows past Sq or Sk with zeros, so loads need no bounds checks;
//   scores past Sk are masked in registers.
// * Epilogue: O / l rounded to bf16 is staged, swizzled, in an output tile of
//   its own and written by a TMA store, which clips rows past Sq, while the
//   producer already loads the next item.
// Two differences from the TPU kernel, both within the bf16 tolerance: the
// scale is applied to S in f32 after the product (the TPU kernel scales q
// before it), and P is rounded to bf16 for the PV product (the TPU kernel
// keeps it in f32).
//
// f32 path: f32 arithmetic throughout on the CUDA cores (FMA, no TF32), for
// the reference's f32 sweep; it is not on the serving path.  q is scaled
// before the product, as the TPU kernel does.  256 threads; thread (row r,
// quarter q4) computes 16 scores of row r and owns D/4 columns of the row's
// accumulator.  Tiles of 64 rows, shared-memory rows padded by one float
// against bank conflicts: 113 KB at D = 128 (dynamic shared memory).  Rows
// past Sq are computed on zeros and not stored, columns past Sk score -1e30
// and their V rows are zero-filled.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockM = 64;  // f32 path: q rows per block
constexpr int kBlockN = 64;  // f32 path: kv rows per tile

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

// kv tiles of `bn` rows that the q rows [q0, q0 + rows) visit: with a causal
// mask, none strictly above the diagonal of their last row.
__device__ __forceinline__ int kv_tiles(const Params& p, int q0, int rows, int bn) {
  int n = (p.Sk + bn - 1) / bn;
  if (p.causal) {
    const int last_row = min(q0 + rows, p.Sq) - 1;
    n = min(n, last_row / bn + 1);
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

  const int nt = kv_tiles(p, q0, kBlockM, kBlockN);
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

// ------------------------------------------------------- bf16 path (Hopper)
constexpr int kTileM = 128;  // q rows per work item, 64 per consumer warpgroup
constexpr int kTileN = 128;  // kv rows per ring stage
constexpr int kStages = 2;
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kConsumerThreads = 256;
// setmaxnreg: the producer gives registers to the consumers' accumulators
// (128 * 24 + 256 * 240 = 64,512 of the SM's 65,536)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Tiles {
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;  // bytes of one box row
  static constexpr int kBoxCols = kSwizzle / 2;              // head-dim columns per box
  static constexpr int kBoxes = D / kBoxCols;                // boxes across the head dim
  static constexpr int kQBytes = kTileM * D * 2;
  static constexpr int kKVBytes = kTileN * D * 2;  // one K or one V tile
  // Q, the staged output tile, then the K and V rings
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kStages * kKVBytes;
  // q_full, q_empty, then full_k, full_v, empty_k and empty_v of each stage;
  // +1024 to align
  static constexpr int kSmem = kBarOffset + 8 * (2 + 4 * kStages) + 1024;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all in 16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 x 128) = [S +] A (64 x 16, shared, K-major) * B (128 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
      "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
      "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The online softmax of one consumer thread's two rows (r0 = its row g of
// the warp's 16, r1 = g + 8), in the exp2 domain: m is the running max of
// scale * log2(e) * s, l this thread's partial sum of its 32 columns of P.
struct RowSoftmax {
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // Folds a (masked) S tile into (m, l), turns it into P = exp2(s * sl2 - m)
  // in place, and returns the factors exp2(m_old - m_new) for O's rows.
  template <int N>
  __device__ __forceinline__ void fold(float (&sc)[N], float sl2, float& c0, float& c1) {
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    // the four threads of a quad hold one row's columns
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // scale > 0, so scaling commutes with the max
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    c0 = exp2_approx(m0 - mn0);
    c1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      sc[4 * j] = exp2_approx(fmaf(sc[4 * j], sl2, -mn0));
      sc[4 * j + 1] = exp2_approx(fmaf(sc[4 * j + 1], sl2, -mn0));
      sc[4 * j + 2] = exp2_approx(fmaf(sc[4 * j + 2], sl2, -mn1));
      sc[4 * j + 3] = exp2_approx(fmaf(sc[4 * j + 3], sl2, -mn1));
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
  }

  // The whole row's sum, from the quad's partial sums.
  __device__ __forceinline__ float row_sum(float l) const {
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    return l + __shfl_xor_sync(0xffffffffu, l, 2);
  }
};

// Scores of the accumulator fragment at columns >= Sk, or above the causal
// diagonal, become kNegInf.  Element 4j + e is row (e < 2 ? r0 : r1),
// column k0 + 8j + 2tq + (e & 1).
template <int N>
__device__ __forceinline__ void mask_tile(float (&sc)[N], int k0, int r0, int r1, int tq, int sk,
                                          int causal) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + j * 8 + tq * 2 + (e & 1);
      const int row = e < 2 ? r0 : r1;
      if (col >= sk || (causal && col > row)) sc[4 * j + e] = kNegInf;
    }
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N], float c0, float c1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= c0;
    o[4 * j + 1] *= c0;
    o[4 * j + 2] *= c1;
    o[4 * j + 3] *= c1;
  }
}

// The accumulator fragments of columns [16kk, 16kk + 16) are the register A
// fragment of k-step kk once rounded to bf16.
template <int N>
__device__ __forceinline__ void to_a_fragments(uint32_t (&pa)[N / 8][4], const float (&sc)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

// Byte offset of (row, byte column) in a box of `Sw`-byte rows under the
// TMA's Sw-byte swizzle: the 16-byte chunk index is XORed with the row bits
// above the 128-byte line (CuTe's Swizzle<3,4,3> for 128 B, <2,4,3> for 64 B).
template <int Sw>
__device__ __forceinline__ uint32_t swizzled(int row, int byte_col) {
  const uint32_t off = row * Sw + byte_col;
  return off ^ (((off >> 7) & (Sw / 16 - 1)) << 4);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_hopper(__grid_constant__ const CUtensorMap tm_q,
                     __grid_constant__ const CUtensorMap tm_k,
                     __grid_constant__ const CUtensorMap tm_v,
                     __grid_constant__ const CUtensorMap tm_o, const Params p) {
  using T = Tiles<D>;
  constexpr int Sw = T::kSwizzle;
  constexpr int kSteps = D / 16;  // k-steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sO = sQ + T::kQBytes;  // the output tile, staged for its TMA store
  const uint32_t sK = sO + T::kQBytes;
  const uint32_t sV = sK + kStages * T::kKVBytes;
  const uint32_t q_full = sQ + T::kBarOffset;
  const uint32_t q_empty = q_full + 8;
  auto full_k = [&](int s) { return q_full + 8 * (2 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (2 + kStages + s); };
  auto empty_k = [&](int s) { return q_full + 8 * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return q_full + 8 * (2 + 3 * kStages + s); };

  // Persistent: each CTA walks the work items blockIdx.x, + gridDim.x, ...
  // Item w is q tile (m_tiles - 1 - w / (B*H)) of batch*head w % (B*H): the
  // longest causal tiles come first, so the last wave is short.
  const int bh_n = p.B * p.H;
  const int m_tiles = (p.Sq + kTileM - 1) / kTileM;
  const int n_work = bh_n * m_tiles;
  struct Work {
    int b, h, kh, q0, n_tiles;
  };
  auto work = [&](int w) {
    Work x;
    x.b = (w % bh_n) / p.H;
    x.h = (w % bh_n) % p.H;
    x.kh = x.h / (p.H / p.KVH);
    x.q0 = (m_tiles - 1 - w / bh_n) * kTileM;
    x.n_tiles = kv_tiles(p, x.q0, kTileM, kTileN);
    return x;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerThreads);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerThreads);
      mbar_init(empty_v(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load.  Per item: the first K
    // tile, Q once the consumers are done with the last item's Q, then K one
    // kv tile ahead of V, as the consumers need them: K1 V0, K2 V1, ...  The
    // kv tiles of an item come in descending order; the ring's load i (over
    // all items) waits for the release of load i - kStages of its stage.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 0) {
      int g = 0;  // kv tiles loaded by earlier items
      int it = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
        const Work x = work(w);
        auto load = [&](const CUtensorMap* map, uint32_t ring, bool is_k, int t) {
          const int i = g + t, s = i % kStages;
          const uint32_t full = is_k ? full_k(s) : full_v(s);
          if (i >= kStages) mbar_wait(is_k ? empty_k(s) : empty_v(s), (i / kStages - 1) & 1);
          mbar_expect_tx(full, T::kKVBytes);
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx)
            tma_load(ring + s * T::kKVBytes + bx * kTileN * Sw, map, full, bx * T::kBoxCols, x.kh,
                     (x.n_tiles - 1 - t) * kTileN, x.b);
        };
        load(&tm_k, sK, true, 0);
        if (it > 0) mbar_wait(q_empty, (it - 1) & 1);
        mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx)
            tma_load(sQ + bx * kTileM * Sw + half * 64 * Sw, &tm_q, q_full, bx * T::kBoxCols, x.h,
                     x.q0 + 64 * half, x.b);
        for (int t = 0; t < x.n_tiles; ++t) {
          if (t + 1 < x.n_tiles) load(&tm_k, sK, true, t + 1);
          load(&tm_v, sV, false, t);
        }
        g += x.n_tiles;
      }
    }
  } else {
    // ---- consumers: warpgroup c owns q rows [q0 + 64c, q0 + 64c + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
    const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)

    // K-major descriptors: 8-row groups 8 * Sw bytes apart; a k-step of 16
    // columns is 32 bytes inside a swizzled row, the next box past kBoxCols.
    const uint32_t sbo = 8 * Sw;
    auto desc_q = [&](int kk) {
      return smem_desc(sQ + (kk * 16 / T::kBoxCols) * kTileM * Sw + c * 64 * Sw +
                           (kk * 16 % T::kBoxCols) * 2,
                       16, sbo, T::kLayout);
    };
    auto desc_k = [&](int s, int kk) {
      return smem_desc(sK + s * T::kKVBytes + (kk * 16 / T::kBoxCols) * kTileN * Sw +
                           (kk * 16 % T::kBoxCols) * 2,
                       16, sbo, T::kLayout);
    };
    // MN-major V: a k-step is 16 kv rows; the next box of head-dim columns
    // (the leading byte offset) is kTileN rows on.
    auto desc_v = [&](int s, int kk) {
      return smem_desc(sV + s * T::kKVBytes + kk * 16 * Sw, kTileN * Sw, sbo, T::kLayout);
    };

    float o[D / 2];
    float sc[kTileN / 2];         // S of the newest tile, then its P in f32
    uint32_t pa[kTileN / 16][4];  // P of the tile before, as bf16 A fragments
    auto issue_qk = [&](int s) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) wgmma_ss_n128(sc, desc_q(kk), desc_k(s, kk), kk > 0);
      wgmma_commit();
    };
    auto issue_pv = [&](int s) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileN / 16; ++kk) wgmma_pv<D>(o, pa[kk], desc_v(s, kk));
      wgmma_commit();
    };
    // kv tiles a warpgroup whose rows start at rb needs; none where all its
    // rows lie past Sq
    auto tiles_of = [&](int rb) { return rb < p.Sq ? kv_tiles(p, rb, 64, kTileN) : 0; };

    int kv = 0;  // kv tiles of earlier items: the ring's position
    int it = 0;
    bool turns_begun = false;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++it) {
      const Work x = work(w);
      const int n_tiles = x.n_tiles;
      const int row_base = x.q0 + 64 * c;
      const int r0 = row_base + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
      const int n_mine = tiles_of(row_base);
      auto stage = [&](int t) { return (kv + t) % kStages; };
      auto parity = [&](int t) { return static_cast<uint32_t>(((kv + t) / kStages) & 1); };
      // Ping-pong: where both warpgroups walk the same tiles, they take turns
      // to issue their products (named barriers 3 and 4, 256 threads each), so
      // that one's softmax runs while the other's products use the tensor
      // cores.  Each has n_mine + 1 turns per item and the turns run on
      // across items; warpgroup 0 takes the very first, and warpgroup 1
      // passes none after its very last, which no one would take.  Items
      // without ping-pong (the second warpgroup past Sq) come first, as their
      // q tile is the last one.
      const bool pingpong = n_mine > 0 && tiles_of(x.q0 + 64 * (1 - c)) == n_mine;
      const bool last_item = w + static_cast<int>(gridDim.x) >= n_work;
      auto turn_wait = [&] {
        if (pingpong) asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
      };
      auto turn_pass = [&] {
        if (pingpong) asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
      };
      auto mask = [&](int k0) {
        if (k0 + kTileN > p.Sk || (p.causal && k0 + kTileN - 1 > row_base))
          mask_tile(sc, k0, r0, r1, tq, p.Sk, p.causal);
      };

      // Tiles come in descending order.  Those above this warpgroup's part
      // of the diagonal come first: the warpgroup only waits for them and
      // releases them, as the ring needs both warpgroups' arrivals.
      const int skip = n_tiles - n_mine;
      // Both warpgroups wait for every item's Q, so that each arrival on
      // q_empty falls in that item's phase; one with no rows reads no Q.
      mbar_wait(q_full, it & 1);
      if (n_mine == 0) mbar_arrive(q_empty);
      for (int t = 0; t < skip; ++t) {
        mbar_wait(full_k(stage(t)), parity(t));
        mbar_arrive(empty_k(stage(t)));
        mbar_wait(full_v(stage(t)), parity(t));
        mbar_arrive(empty_v(stage(t)));
      }
      if (n_mine > 0) {
        if (pingpong && c == 0 && !turns_begun)
          asm volatile("bar.arrive 3, 256;\n" ::: "memory");
        turns_begun = turns_begun || pingpong;
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        RowSoftmax sm;
        float c0, c1;
        mbar_wait(full_k(stage(skip)), parity(skip));
        turn_wait();
        issue_qk(stage(skip));
        turn_pass();
        wgmma_wait<0>();
        pin(sc);
        mbar_arrive(empty_k(stage(skip)));
        if (skip == n_tiles - 1) mbar_arrive(q_empty);  // the item's last QK^T
        mask((n_tiles - 1 - skip) * kTileN);
        sm.fold(sc, sl2, c0, c1);  // O is still 0: nothing to rescale
        to_a_fragments(pa, sc);
        // Steady state: S of tile t runs on the tensor cores beside PV of
        // tile t - 1, and the softmax of tile t overlaps that PV.
        for (int t = skip + 1; t < n_tiles; ++t) {
          mbar_wait(full_k(stage(t)), parity(t));
          turn_wait();
          issue_qk(stage(t));
          mbar_wait(full_v(stage(t - 1)), parity(t - 1));
          issue_pv(stage(t - 1));
          turn_pass();
          wgmma_wait<1>();  // S of tile t
          pin(sc);
          mbar_arrive(empty_k(stage(t)));
          if (t == n_tiles - 1) mbar_arrive(q_empty);
          mask((n_tiles - 1 - t) * kTileN);
          sm.fold(sc, sl2, c0, c1);
          wgmma_wait<0>();  // PV of tile t - 1
          pin(o);
          mbar_arrive(empty_v(stage(t - 1)));
          scale_rows(o, c0, c1);
          to_a_fragments(pa, sc);
        }
        mbar_wait(full_v(stage(n_tiles - 1)), parity(n_tiles - 1));
        turn_wait();
        issue_pv(stage(n_tiles - 1));
        if (c == 0 || !last_item) turn_pass();
        wgmma_wait<0>();
        pin(o);
        mbar_arrive(empty_v(stage(n_tiles - 1)));

        // O / l to bf16, staged in this warpgroup's rows of the output tile
        // in the layout the output's tensor map swizzles, once the last
        // item's store has read them; then one thread stores them by TMA,
        // which clips rows past Sq.
        const float inv0 = 1.f / fmaxf(sm.row_sum(sm.l0), 1e-30f);
        const float inv1 = 1.f / fmaxf(sm.row_sum(sm.l1), 1e-30f);
        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        const int lr0 = c * 64 + warp * 16 + g;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int col = j * 8 + tq * 2;
          uint8_t* box = smem + T::kQBytes + (col / T::kBoxCols) * kTileM * Sw;
          const int bc = (col % T::kBoxCols) * 2;
          *reinterpret_cast<uint32_t*>(box + swizzled<Sw>(lr0, bc)) =
              pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
          *reinterpret_cast<uint32_t*>(box + swizzled<Sw>(lr0 + 8, bc)) =
              pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
        if (tid == 0) {
#pragma unroll
          for (int bx = 0; bx < T::kBoxes; ++bx)
            tma_store(&tm_o, sO + bx * kTileM * Sw + c * 64 * Sw, bx * T::kBoxCols, x.h, row_base,
                      x.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      }
      kv += n_tiles;
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// A 4-d tensor map over a (B, S, heads, D) bf16 tensor, dims innermost first
// (D, heads, S, B) with its byte strides; a box is `rows` rows of S by
// kBoxCols of D, swizzled as the wgmma descriptors expect.
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int heads, int seq, int batch,
                     long long sh, long long ss, long long sb, int rows) {
  using T = Tiles<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::kBoxCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Where a launch's blocks go, decided on the host: the grid, the work items
// its blocks walk (bf16: item w, w + grid, ..; f32: one per block), the
// threads and the dynamic shared memory.  The launchers and the query both
// call this, so what the checker is given is what runs;
// kernels/flash_attention.py::flash_attention_work_geometry models it with
// the SM count as an argument.
struct WorkGeometry {
  long long grid_x, grid_y, items, threads, smem, sms;
};

template <int D>
cudaError_t work_geometry(int dtype, const Params& p, WorkGeometry& w) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    int sms;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    w.sms = sms;
  }
  if (err != cudaSuccess) return err;
  if (dtype == 1) {
    const long long n_work = static_cast<long long>(p.B) * p.H * ((p.Sq + kTileM - 1) / kTileM);
    if (n_work > 0x7fffffff) return cudaErrorInvalidValue;
    const long long sms = w.sms;
    // one CTA per SM (its shared memory admits no second), each walking items
    const int grid = static_cast<int>(n_work < sms ? n_work : sms);
    w = {grid, 1, n_work, kThreads, Tiles<D>::kSmem, sms};
    return cudaSuccess;
  }
  if (p.B * p.H > 65535) return cudaErrorInvalidValue;
  const long long m_blocks = (p.Sq + kBlockM - 1) / kBlockM;
  const long long smem = ((kBlockM + 2 * kBlockN) * (D + 1) + kBlockM * (kBlockN + 1)) * 4;
  w = {m_blocks, static_cast<long long>(p.B) * p.H, m_blocks * p.B * p.H, 256, smem, w.sms};
  return cudaSuccess;
}

template <int D>
cudaError_t launch_hopper(const Params& p, cudaStream_t stream) {
  WorkGeometry wg;
  cudaError_t err = work_geometry<D>(1, p, wg);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  if ((err = make_map<D>(&tq, p.q, p.H, p.Sq, p.B, p.qsh, p.qss, p.qsb, 64)) != cudaSuccess ||
      (err = make_map<D>(&tk, p.k, p.KVH, p.Sk, p.B, p.ksh, p.kss, p.ksb, kTileN)) != cudaSuccess ||
      (err = make_map<D>(&tv, p.v, p.KVH, p.Sk, p.B, p.vsh, p.vss, p.vsb, kTileN)) != cudaSuccess ||
      (err = make_map<D>(&to, p.o, p.H, p.Sq, p.B, p.osh, p.oss, p.osb, 64)) != cudaSuccess) {
    return err;
  }
  err = cudaFuncSetAttribute(flash_fwd_hopper<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wg.smem));
  if (err != cudaSuccess) return err;
  flash_fwd_hopper<D><<<static_cast<int>(wg.grid_x), kThreads, static_cast<size_t>(wg.smem),
                        stream>>>(tq, tk, tv, to, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 1) return launch_hopper<D>(p, stream);
  WorkGeometry wg;
  cudaError_t err = work_geometry<D>(0, p, wg);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wg.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(wg.grid_x), static_cast<unsigned>(wg.grid_y));
  flash_fwd_f32<D><<<grid, 256, static_cast<size_t>(wg.smem), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

template <int D>
void hopper_config(int* out) {
  using T = Tiles<D>;
  const int cfg[10] = {kTileM,        kTileN,        kStages,      kThreads,     T::kSmem,
                       kProducerRegs, kConsumerRegs, T::kSwizzle, T::kBoxCols, T::kBoxes};
  for (int i = 0; i < 10; ++i) out[i] = cfg[i];
}

// The bf16 kernel's geometry at head dim D: out = {q rows per CTA, kv rows
// per stage, stages, threads, dynamic shared memory bytes, producer and
// consumer registers, swizzle bytes, head-dim columns per TMA box, boxes
// across D}.  Returns 0, or an error for a D the kernel does not take.
extern "C" int flash_attention_hopper_config(int D, int* out) {
  switch (D) {
    case 32: hopper_config<32>(out); return 0;
    case 64: hopper_config<64>(out); return 0;
    case 128: hopper_config<128>(out); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch flash_attention_launch would make, without launching: out =
// {grid x, grid y, work items, threads, dynamic shared memory bytes, SM
// count}.  Returns 0, or the cudaError_t the launch would return for a shape
// it refuses.
extern "C" int flash_attention_work_geometry_query(int B, int Sq, int Sk, int H, int KVH, int D,
                                                   int dtype, long long* out) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{};
  p.B = B, p.Sq = Sq, p.Sk = Sk, p.H = H, p.KVH = KVH;
  WorkGeometry w;
  cudaError_t err;
  switch (D) {
    case 32: err = work_geometry<32>(dtype, p, w); break;
    case 64: err = work_geometry<64>(dtype, p, w); break;
    case 128: err = work_geometry<128>(dtype, p, w); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long v[6] = {w.grid_x, w.grid_y, w.items, w.threads, w.smem, w.sms};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// dtype: 0 = f32, 1 = bf16.  Strides are in elements; the head dim is
// contiguous and every row start is 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
    int KVH, int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss, long long vsh,
    long long osb, long long oss, long long osh, int causal, int dtype, float scale,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 ||
      (dtype != 0 && dtype != 1)) {
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
