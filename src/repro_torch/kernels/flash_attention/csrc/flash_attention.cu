// Flash-attention forward for Hopper (sm_90a), plain C entry point for ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_fwd (body _fwd_kernel)
// and computes the same function: O = softmax(Q·Kᵀ·scale + mask)·V with an
// online softmax (running max m, sum l and accumulator in fp32), causal and
// sliding-window masks, GQA by kv_head = h / groups (never materialising the
// repeated K/V), and block-level skipping of KV tiles that are entirely in the
// future or entirely before the window (kernel.py:54-60).
//
// What it adds over the TPU kernel:
//   * it reads the model layout [B, S, H, D] through strides, so the wrapper
//     needs no transposes (the reference's ops.py:36-44 transposes to
//     [B, H, S, D]); the head dim must be contiguous;
//   * ragged tails: rows and columns past Sq / Skv are masked here, so S need
//     not divide the tile (the Pallas kernel raises, kernel.py:115-117);
//   * a masked score contributes exactly 0 to l and acc, so a row with no
//     allowed key comes out as 0 (l clamped at 1e-37, as kernel.py:92), not NaN.
//
// Two kernels, chosen by the inputs' dtype (the only switch):
//
// bfloat16 — tensor cores (fwd_kernel_tc, the FlashAttention-2 shape).  One
// block of 4 warps per (batch, q-head, 64-row q-tile); each warp owns 16 q
// rows.  Q·Kᵀ and P·V are mma.sync.m16n8k16 bf16 products with fp32
// accumulation, their operands loaded from shared memory with ldmatrix
// (ldmatrix.trans for V).  The scores stay in registers: masked, scaled by
// scale·log2(e) and exponentiated with exp2f, then rounded to bf16 in
// registers, where the score accumulator's layout is already the A operand
// of P·V (no shared-memory round trip).  l sums the fp32 probabilities.  K/V
// tiles are double-buffered with 16-byte cp.async, so the next tile's load
// overlaps this tile's math; rows are padded by 16 bytes so ldmatrix hits
// distinct banks.  Head dims 8..256 (8 is zero-padded to the MMA's k of 16).
// Every row base must be 16-byte aligned (the wrapper refuses others).
// Up to D = 128 a warp keeps its Q fragments in registers for the whole KV
// loop.  At D = 256 (gemma3) the O accumulator alone is 16 x 256 fp32 a
// warp, 128 registers a lane, and Q's fragments would add 64 more: there Q
// stays in shared memory and each k-step of Q·Kᵀ reloads its fragment with
// ldmatrix (FlashAttention-2's layout for this head dim), so ptxas fits the
// kernel in 255 registers without spilling.  One 169 KB block an SM.
//
// float32 — CUDA cores (fwd_kernel, the first, scalar design, kept exact for the fp32
// card-vs-CPU checks: TF32 or bf16 operands would break their tolerance).
// One block of 256 threads per 64-row q-tile, products in fp32 from shared
// memory, P through shared memory.  Its shared memory grows with D: 213,760
// bytes at D = 256, under the 232,448 a block may opt in to.
//
// q-tiles are scheduled latest first, so the causally heaviest blocks start
// in the first wave: the bf16 kernel's grid puts the q-tile on its slowest
// axis, so every (batch, head) of the latest q-tile launches before any of
// the next (the fp32 kernel only reverses the q-tile axis, which is its
// fastest).  With causal tiles of 1 to 8 KV tiles, the longest block is the
// critical path, and starting it first cut the bf16 kernel's device time
// by about a quarter on an H100 (chip_smoke.py).  Two 16-row m-tiles a warp (FlashAttention-2's
// 128-row tiles) and 8-warp 128-row blocks were both slower at the serving
// shapes, so a warp owns 16 rows.
//
// What bounds it on an H100.  At the serving slice's shapes (B=4, S=512,
// Hq=15, Hkv=5, D=64, bf16, causal) the function moves ~10.5 MB (Q, K, V, O
// once each: ~3 us at 3.35 TB/s) and needs ~2.0 GFLOP in the causal triangle
// (~2 us at the 989 TFLOP/s bf16 tensor-core peak): bound by bytes, at a few
// microseconds, the order of one launch.  The tensor-core kernel does its
// products at the mma.sync rate and keeps every intermediate on chip, so
// what is left is latency: 480 blocks of 1-8 KV tiles each, three resident
// on each of the 132 SMs (141 registers a thread), the longest block walking
// 8 tiles one after another.  wgmma, TMA loads and warp
// specialisation are the next steps; chip_smoke.py reports the measured
// device time beside the bound and the library's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -2.0e38f;  // finite: no NaN from fully masked rows

struct Strides {
  long long b, s, h;  // in elements; the head dim has stride 1
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, int Sq, int Skv, int groups, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;   // padded rows: column walks hit distinct banks
  constexpr int PP = BK + 1;
  constexpr int CJ = (D + 15) / 16;  // accumulator columns per thread
  float* sQ = smem;           // [BQ][DP]
  float* sK = sQ + BQ * DP;   // [BK][DP]
  float* sV = sK + BK * DP;   // [BK][D]
  float* sP = sV + BK * D;    // [BQ][PP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / groups;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qr = q0 + r;
    sQ[r * DP + c] = qr < Sq ? to_f(qb[qr * qs.s + c]) : 0.f;
  }

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[i][c] = 0.f;
  }

  // The KV range this q-tile can see: tiles wholly in the future (causal) or
  // wholly before every row's window are skipped.
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int kv_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      const bool in = kr < Skv;
      sK[r * DP + c] = in ? to_f(kb[kr * ks.s + c]) : 0.f;
      sV[r * D + c] = in ? to_f(vb[kr * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      bool ok[4];
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const int diff = qr - kc;
        ok[j] = kc < Skv && (!causal || diff >= 0) && (window <= 0 || diff < window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * PP + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < D ? sV[kk * D + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      const int col = tx + 16 * c;
      if (col < D) ob[qr * os.s + col] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int Hq, int Hkv, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, int window, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * sizeof(float);
  // Above 48 KB of dynamic shared memory needs an opt-in, once per
  // instantiation and device (not per launch: it is a driver call).
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, Hq / Hkv, qs, ks, vs, os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int Sq,
               int Skv, int Hq, int Hkv, Strides qs, Strides ks, Strides vs, Strides os,
               float scale, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 256: return launch<T, 256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    default: return -2;  // unsupported head dim
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;                // q rows per block
constexpr int TC_BK = 64;                // kv rows per tile
constexpr int TC_THREADS = TC_BQ * 2;    // a warp per 16 q rows
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a·b for one 16x8x16 tile: a [16x16] row-major, b [16x8] column-major,
// bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded (to nearest) to a bf16 pair; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
struct TcShape {
  static constexpr int DK = D < 16 ? 16 : D;  // head dim padded to the MMA's k
  static constexpr int LD = DK + 8;           // row stride: an odd number of 16-byte units
  static constexpr int KSTEPS = DK / 16;      // k-steps of Q·Kᵀ
  static constexpr int NO = D / 8;            // 8-column blocks of O
  static constexpr bool Q_IN_REGS = D <= 128;  // else Q fragments reload from smem
  static constexpr int SMEM = (TC_BQ + 4 * TC_BK) * LD * static_cast<int>(sizeof(bf16));
};

// Rows [r0, r0 + 64) of one head into dst [64][LD] with 16-byte cp.async;
// rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long row_stride, int r0,
                                           int rows) {
  constexpr int CPR = D / 8;  // 16-byte copies a row
  for (int i = threadIdx.x; i < 64 * CPR; i += TC_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * TcShape<D>::LD + c, ok ? src + (r0 + r) * row_stride + c : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, int Sq, int Skv, int groups, Strides qs, Strides ks,
              Strides vs, Strides os, float scale_log2, int causal, int window) {
  using Sh = TcShape<D>;
  constexpr int LD = Sh::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sK = sQ + TC_BQ * LD;                     // [2][BK][LD]
  bf16* sV = sK + 2 * TC_BK * LD;                 // [2][BK][LD]

  // Blocks start in launch order, x fastest: every head and batch of the
  // latest (causally heaviest) q-tile first.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;
  const int kvh = h / groups;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;

  if (Sh::DK != D) {  // D = 8: the MMA's k is 16; columns D..15 stay zero
    for (int r = tid; r < TC_BQ + 4 * TC_BK; r += TC_THREADS)
#pragma unroll
      for (int c = D; c < Sh::DK; ++c) sQ[r * LD + c] = __float2bfloat16_rn(0.f);
  }

  // The KV range this q-tile can see: tiles wholly in the future (causal) or
  // wholly before every row's window are skipped.
  const int kv_end = causal ? min(Skv, q0 + TC_BQ) : Skv;
  const int kv_begin = window > 0 ? (max(0, q0 - window + 1) / TC_BK) * TC_BK : 0;
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + TC_BK - 1) / TC_BK : 0;

  stage_tile<D>(sQ, qb, qs.s, q0, Sq);
  cp_async_commit();
  if (ntiles > 0) {
    stage_tile<D>(sK, kb, ks.s, kv_begin, Skv);
    stage_tile<D>(sV, vb, vs.s, kv_begin, Skv);
  }
  cp_async_commit();

  // This thread's rows of the warp's 16: r and r + 8 (accumulator elements
  // 0,1 and 2,3); its columns in each 8-block: 2·(lane % 4) + {0, 1}.
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[Sh::NO][4];
#pragma unroll
  for (int n = 0; n < Sh::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  cp_async_wait<1>();  // Q has landed (K/V tile 0 may still be in flight)
  __syncthreads();
  const bf16* qrow = sQ + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  uint32_t qf[Sh::Q_IN_REGS ? Sh::KSTEPS : 1][4];
  if (Sh::Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < Sh::KSTEPS; ++kk) ldmatrix_x4(qf[Sh::Q_IN_REGS ? kk : 0], qrow + kk * 16);
  }

  const int wr_lo = q0 + warp * 16, wr_hi = wr_lo + 15;  // this warp's rows
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kv_begin + t * TC_BK;
    const int buf = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other buffer
      stage_tile<D>(sK + (buf ^ 1) * TC_BK * LD, kb, ks.s, k0 + TC_BK, Skv);
      stage_tile<D>(sV + (buf ^ 1) * TC_BK * LD, vb, vs.s, k0 + TC_BK, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + buf * TC_BK * LD;
    const bf16* cV = sV + buf * TC_BK * LD;

    // S = Q·Kᵀ for the warp's 16 rows and the tile's 64 columns.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Sh::KSTEPS; ++kk) {
      uint32_t(&qa)[4] = qf[Sh::Q_IN_REGS ? kk : 0];
      if (!Sh::Q_IN_REGS) ldmatrix_x4(qa, qrow + kk * 16);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, cK + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * n2], qa, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], qa, bk[2], bk[3]);
      }
    }

    // Mask (only where this warp's rows meet a tile edge), scale to log2 units.
    const bool need_mask = k0 + TC_BK > Skv || (causal && k0 + TC_BK - 1 > wr_lo) ||
                           (window > 0 && wr_hi - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (need_mask) {
          const int row = row0 + (e >> 1) * 8;
          const int col = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
          const int diff = row - col;
          const bool ok = col < Skv && (!causal || diff >= 0) && (window <= 0 || diff < window);
          x = ok ? x : -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share a row
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row with nothing allowed yet
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = mx[i];
    }

    // P = exp2(S - m): fp32 into l, bf16 into the A operand of P·V.
    uint32_t pf[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f(s[n][0] - base[0]), p1 = exp2f(s[n][1] - base[0]);
      const float p2 = exp2f(s[n][2] - base[1]), p3 = exp2f(s[n][3] - base[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int n = 0; n < Sh::NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P·V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* vrow = cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD;
#pragma unroll
      for (int n2 = 0; n2 < Sh::NO / 2; ++n2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + n2 * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * n2], pf[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * n2 + 1], pf[kk], bv[2], bv[3]);
      }
      if (Sh::NO % 2) {
        uint32_t bv[2];
        ldmatrix_x2_trans(bv, vrow + (Sh::NO - 1) * 8);
        mma_bf16(acc[Sh::NO - 1], pf[kk], bv[0], bv[1]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float denom = fmaxf(l[i], 1e-37f);
    const int row = row0 + i * 8;
    if (row >= Sq) continue;
#pragma unroll
    for (int n = 0; n < Sh::NO; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      *reinterpret_cast<uint32_t*>(ob + row * os.s + col) =
          pack_bf16(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    }
  }
}

// Every row base the kernel copies with 16-byte cp.async must be 16-byte
// aligned: the pointers, and the strides of every dimension longer than 1.
bool aligned16(const void* p, const Strides& st, int nb, int ns, int nh) {
  const long long e = static_cast<long long>(sizeof(bf16));
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (nb == 1 || st.b * e % 16 == 0) &&
         (ns == 1 || st.s * e % 16 == 0) && (nh == 1 || st.h * e % 16 == 0);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int Hq,
              int Hkv, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
              int window, cudaStream_t stream) {
  if (!aligned16(q, qs, B, Sq, Hq) || !aligned16(k, ks, B, Skv, Hkv) ||
      !aligned16(v, vs, B, Skv, Hkv) || !aligned16(o, os, B, Sq, Hq))
    return -3;
  constexpr int bytes = TcShape<D>::SMEM;
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fwd_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  dim3 grid(Hq, B, (Sq + TC_BQ - 1) / TC_BQ);
  fwd_kernel_tc<D><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Skv, Hq / Hkv, qs, ks, vs, os, scale * LOG2E, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(int D, const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
                int Hq, int Hkv, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                int causal, int window, cudaStream_t st) {
  switch (D) {
    case 8: return launch_tc<8>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 16: return launch_tc<16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 32: return launch_tc<32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 64: return launch_tc<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 128: return launch_tc<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    case 256: return launch_tc<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
    default: return -2;  // unsupported head dim
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
// Strides in elements, [B, S, H] order.  Returns 0, a cudaError_t from the
// launch, -1 (dtype), -2 (head dim) or -3 (a bf16 row base not 16-byte
// aligned).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                              int B, int Sq, int Skv, int Hq, int Hkv, int D, long long qsb,
                              long long qss, long long qsh, long long ksb, long long kss,
                              long long ksh, long long vsb, long long vss, long long vsh,
                              long long osb, long long oss, long long osh, float scale,
                              int causal, int window, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
  if (dtype == 1)
    return dispatch_tc(D, q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
  return -1;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
