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
//     allowed key comes out as 0 (l clamped at 1e-37, as kernel.py:92), not NaN;
//   * q_offset: row i of Q sits at position q_offset + i in the causal and
//     window masks, the contract of the reference's LM._attention
//     (src/repro/models/lm.py:396-410).  A rank that computes a block of query
//     rows under sequence parallelism attends at its place in the sequence
//     (Sq = 256 rows at offset 256 against Skv = 512 keys).
//
// The value head dim DV may differ from the key's D, as in the reference
// (v [B, Hkv, Skv, Dv], kernel.py:96-110): Q·Kᵀ runs over D, the V tile, the
// O accumulator and the output row over DV.  The source instantiates (d, d)
// for d in 8..256 and (192, 128), DeepSeek-V2's MLA prefill (q and k of nope
// 128 + rope 64, v of 128; the v the model hands over is the strided
// [nope | v] view of one up-projection, 256 bytes past its row start, read
// through its own tensor map).  Any other pair is refused.
//
// Three kernels.  The inputs' dtype, then (D, DV), pick one; nothing else
// does, and no kernel stands in for another on an error.
//
// bfloat16, D >= 64 — fwd_kernel_wgmma, the shape of FlashAttention-3, for
// every prefill of the main path ((64, 64), (128, 128), (256, 256) and
// (192, 128)).  A block of 384 threads in three warpgroups, one block an SM
// (shared memory allows no second), persistent:
//   * q-tiles.  A q-tile is 128 rows of one (batch, q-head).  The grid is
//     min(q-tiles, SMs) blocks; a block takes q-tile blockIdx.x, then the
//     next not yet taken from a counter in device memory (two ints a
//     stream, which the last block to finish sets back to 0; kernel.py
//     keeps one pair a stream, so launches on two streams never share
//     one).  The order: chunks of (batch, q-head) pairs whose K and V fill
//     about 24 MB (half the L2), q-head fastest, so a GQA group and a
//     head's q-tiles meet K and V in the L2; inside a chunk the latest
//     (causally heaviest) q-tiles first.  A block's next q-tile is loaded
//     while it finishes the last: its start-up (barriers, the first loads)
//     is paid once a block, not once a q-tile.
//   * warpgroup 0 produces.  It drops to 24 registers (setmaxnreg.dec) and
//     one thread issues every copy as a TMA box of a rank-4 (D, H, S, B)
//     tensor map over the model layout (the wrapper's byte strides; rows past
//     Sq or Skv arrive as zeros): a q-tile's Q once its consumers' last
//     Q·Kᵀ of the q-tile before is done (a full and an empty mbarrier), then
//     K and V tiles into a ring of WS_STAGES stages in shared memory,
//     128-byte swizzled, each stage with a full mbarrier (the copy's bytes,
//     complete_tx) and an empty one (one arrival from each consumer warp)
//     for K and for V apart, so the next K lands while this V is still read.
//     The ring runs on across q-tiles.  The maps are built on the host by
//     cuTensorMapEncodeTiled (taken from libcuda through the runtime: no
//     -lcuda) and passed as __grid_constant__ parameters.
//   * warpgroups 1 and 2 consume, at 240 registers (setmaxnreg.inc), 64 q
//     rows each (one wgmma M-tile).  S = Q·Kᵀ is wgmma.m64nBKk16 with Q and
//     K read from swizzled shared memory (K-major descriptors); P stays in
//     registers, where the score accumulator's layout is already the A
//     fragment of P·V, and O += P·V is the register-A wgmma with V's tile
//     read MN-major (the transpose bit: no shared-memory transpose).  The
//     fp32 accumulators stay in registers.
//   * overlap.  Inside a warpgroup, KV tile t's S = Q·Kᵀ and tile t-1's P·V
//     are issued together; wgmma.wait_group 1 waits for S alone, and tile t's
//     softmax runs while P·V is in flight.  Across the two warpgroups, named
//     barriers pass the turn to issue: one warpgroup's softmax runs while the
//     other's products occupy the tensor cores.  The KV loop has no
//     __syncthreads: every hand-off is an mbarrier or a named barrier.
//   * softmax.  Only a KV tile that meets an edge of some row's allowed
//     columns (Skv, the causal diagonal, the window's start) takes the
//     masked copy, which tests each column against its row's [lo, hi); the
//     others take a copy with no test.  (A per-element test on every tile,
//     even where it masks nothing, was the loop's largest cost: the
//     tensor cores waited on it.)  The exponent is one ex2.approx.ftz.
//   * tiles.  BK, the KV rows of a stage, by (D, DV) (REPRO_WGMMA_TILES):
//     128 up to D = 128 and at (192, 128); 64 at D = 256, where the O
//     accumulator alone is 64 x 256 fp32 a warpgroup, 128 registers a thread.
//     Shared memory: Q + 2 x (K + V) tiles, 80 KB at D = 64, 160 KB at 128,
//     192 KB at 256 and 208 KB at (192, 128).  ptxas: 0 spills at each (a
//     __trap() anywhere in the kernel keeps ptxas from giving the consumers
//     setmaxnreg's registers, and they spill).

// bfloat16, D <= 32 — fwd_kernel_tc, the FlashAttention-2 shape (no
// prefill of the main path has so small a head; the reduced configs of the
// tests do).  One block of 4 warps per (batch, q-head, 64-row q-tile); each
// warp owns 16 q rows; mma.sync.m16n8k16 from ldmatrix, K/V tiles
// double-buffered with 16-byte cp.async; D = 8 zero-padded to the MMA's k.
//
// Both bf16 kernels round alike: scores times scale·log2(e), the running max
// taken once a KV tile, P = exp2(s - m) rounded to bf16 before P·V while l
// sums the fp32 P, O rescaled by exp2(m_old - m_new) a tile and divided by
// max(l, 1e-37) once.  Only the tile (BK; 64 in fwd_kernel_tc) moves the
// rounding (and the exponent's approximation: exp2f there, ex2.approx.ftz
// here, which differ below the bf16 rounding of P), and
// tests/test_torch_flash_attention.py emulates each tile.  Every
// bf16 row base must be 16-byte aligned (cp.async, TMA; the wrapper refuses
// others).
//
// float32 — CUDA cores (fwd_kernel, the first, scalar design, kept exact for
// the fp32 card-vs-CPU checks: TF32 or bf16 operands would break their
// tolerance).  One block of 256 threads per 64-row q-tile, products in fp32
// from shared memory, P through shared memory.  Its shared memory grows with
// D and DV: 213,760 bytes at D = 256, 148,224 at (192, 128), under the
// 232,448 a block may opt in to.
//
// What bounds the bf16 kernel on an H100 (989 TFLOP/s bf16, 3.35 TB/s).
// Operations bound the long shapes: llama-vision's cross layer (B 4, 512 x
// 1600, 32:8 heads of 128) needs 53.7 GFLOP (54 us) against 59.8 MB (18
// us), whisper's encoder and cross layers likewise.  Bytes bound the causal
// 512 x 512 prefills, whose triangle is small beside Q, K, V and O: smollm
// (15:5 of 64) 10.5 MB (3.1 us) against 2.0 GFLOP (2.0 us), mixtral (48:8 of
// 128) 58.7 MB against 12.9 GFLOP, deepseek-v2 (128:128 of (192, 128)) 336
// MB (100 us) against 43.0 GFLOP.  What the design does about the faults of
// the Ampere-shaped kernel it replaces at these head dims:
//   1. mma.sync with every operand reloaded by ldmatrix at each k-step: both
//      products are wgmma, Q and K read by the tensor cores straight from
//      shared memory, P from registers;
//   2. softmax serialised with the products: the intra- and inter-warpgroup
//      overlap above;
//   3. a 2-stage cp.async ring issued by the same warps that compute, with
//      two __syncthreads a tile: one TMA thread, a full and an empty
//      mbarrier per stage, no block-wide barrier in the loop;
//   4. 64-row blocks and Q reloaded from shared memory at each k-step: 128
//      rows a q-tile, Q staged once and read by wgmma descriptors;
//   5. a K/V tile staged once per q-head: still so (a q-tile is one q-head;
//      packing a GQA group into a q-tile was not tried), but the q-tile
//      order keeps a chunk's K and V in the L2 (deepseek-v2's 128:128
//      heads: 0.204 ms with every head's four q-tiles 512 tiles apart,
//      0.167 ms in chunks).
// Device time a launch on an H100 80GB HBM3 at 700 W (timing.py, the
// profiler, 20 launches, B = 4; the mma.sync kernel it replaces and cuDNN in
// the same runs): smollm 15:5 of 64 0.0160 ms (mma.sync 0.0226, cuDNN
// 0.0133), mixtral 48:8
// of 128 0.0564 (0.1183, 0.0409), gemma3 16:8 of 256 0.0438 (0.0884,
// 0.0346), deepseek-v2 (192, 128) 0.1674 (0.3298, 0.1398), llama-vision
// cross 0.1146 (0.3448, 0.0975), whisper cross 0.0215 (0.0554, 0.0186);
// every shape in PERF.md section 6.

#include <cuda.h>
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

template <int D, int DV>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * DV + BQ * (BK + 1);
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, int Sq, int Skv, int groups, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, int window, int q_off) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;   // padded rows: column walks hit distinct banks
  constexpr int PP = BK + 1;
  constexpr int CJ = (DV + 15) / 16;  // accumulator columns per thread
  float* sQ = smem;           // [BQ][DP]
  float* sK = sQ + BQ * DP;   // [BK][DP]
  float* sV = sK + BK * DP;   // [BK][DV]
  float* sP = sV + BK * DV;   // [BQ][PP]

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
  const int kv_end = causal ? min(Skv, q_off + q0 + BQ) : Skv;
  const int kv_begin = window > 0 ? (max(0, q_off + q0 - window + 1) / BK) * BK : 0;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK/sV/sP reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kr = k0 + r;
      const bool in = kr < Skv;
      sK[r * DP + c] = in ? to_f(kb[kr * ks.s + c]) : 0.f;
      if constexpr (DV == D) sV[r * D + c] = in ? to_f(vb[kr * vs.s + c]) : 0.f;
    }
    if constexpr (DV != D) {
      for (int i = tid; i < BK * DV; i += THREADS) {
        const int r = i / DV, c = i % DV;
        const int kr = k0 + r;
        sV[r * DV + c] = kr < Skv ? to_f(vb[kr * vs.s + c]) : 0.f;
      }
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
        const int diff = q_off + qr - kc;
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
        const float vv = col < DV ? sV[kk * DV + col] : 0.f;
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
      if (col < DV) ob[qr * os.s + col] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int Hq, int Hkv, Strides qs, Strides ks, Strides vs, Strides os, float scale,
           int causal, int window, int q_off, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D, DV>() * sizeof(float);
  // Above 48 KB of dynamic shared memory needs an opt-in, once per
  // instantiation and device (not per launch: it is a driver call).
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fwd_kernel<T, D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  fwd_kernel<T, D, DV><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, Hq / Hkv, qs, ks, vs, os, scale, causal, window, q_off);
  return static_cast<int>(cudaGetLastError());
}

// The (D, DV) pairs the fp32 kernel is instantiated for (the bf16 kernels
// share them out: REPRO_MMA_PAIRS, REPRO_WGMMA_TILES); any other returns -2.
#define REPRO_FLASH_PAIRS(X) \
  X(8, 8) X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(256, 256) X(192, 128)

template <typename T>
int dispatch_d(int D, int DV, const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int Hq, int Hkv, Strides qs, Strides ks, Strides vs, Strides os,
               float scale, int causal, int window, int q_off, cudaStream_t st) {
#define REPRO_CASE(d, dv)                                                                   \
  if (D == d && DV == dv)                                                                   \
    return launch<T, d, dv>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, \
                            window, q_off, st);
  REPRO_FLASH_PAIRS(REPRO_CASE)
#undef REPRO_CASE
  return -2;  // unsupported (D, DV) pair
}

// ---------------------------------------------------------------------------
// bfloat16 at D <= 32: mma.sync tensor cores
// ---------------------------------------------------------------------------

// The (D, DV) pairs of the mma.sync kernel (its KV tile is TC_BK).
#define REPRO_MMA_PAIRS(X) X(8, 8) X(16, 16) X(32, 32)

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

template <int D, int DV>
struct TcShape {
  static constexpr int DK = D < 16 ? 16 : D;  // head dim padded to the MMA's k
  static constexpr int LD = DK + 8;           // Q and K row stride: an odd number of 16-byte units
  static constexpr int LDV = (DV < 16 ? 16 : DV) + 8;  // V row stride, likewise
  static constexpr int KSTEPS = DK / 16;      // k-steps of Q·Kᵀ
  static constexpr int NO = DV / 8;           // 8-column blocks of O
  static constexpr bool Q_IN_REGS = D <= 128;  // else Q fragments reload from smem
  static constexpr int SMEM =
      ((TC_BQ + 2 * TC_BK) * LD + 2 * TC_BK * LDV) * static_cast<int>(sizeof(bf16));
};

// Rows [r0, r0 + 64) of one head, COLS wide, into dst [64][LDS] with
// 16-byte cp.async; rows at or past `rows` are zero-filled.
template <int COLS, int LDS>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long row_stride, int r0,
                                           int rows) {
  constexpr int CPR = COLS / 8;  // 16-byte copies a row
  for (int i = threadIdx.x; i < 64 * CPR; i += TC_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r0 + r < rows;
    cp_async16(dst + r * LDS + c, ok ? src + (r0 + r) * row_stride + c : src, ok);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(TC_THREADS)
fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, int Sq, int Skv, int groups, Strides qs, Strides ks,
              Strides vs, Strides os, float scale_log2, int causal, int window, int q_off) {
  using Sh = TcShape<D, DV>;
  constexpr int LD = Sh::LD, LDV = Sh::LDV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sK = sQ + TC_BQ * LD;                     // [2][BK][LD]
  bf16* sV = sK + 2 * TC_BK * LD;                 // [2][BK][LDV]

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

  if (Sh::DK != D) {  // D = 8: the MMA's k is 16; columns D..15 of Q and K stay zero
    for (int r = tid; r < TC_BQ + 2 * TC_BK; r += TC_THREADS)
#pragma unroll
      for (int c = D; c < Sh::DK; ++c) sQ[r * LD + c] = __float2bfloat16_rn(0.f);
  }

  // The KV range this q-tile can see: tiles wholly in the future (causal) or
  // wholly before every row's window are skipped.
  const int kv_end = causal ? min(Skv, q_off + q0 + TC_BQ) : Skv;
  const int kv_begin = window > 0 ? (max(0, q_off + q0 - window + 1) / TC_BK) * TC_BK : 0;
  const int ntiles = kv_end > kv_begin ? (kv_end - kv_begin + TC_BK - 1) / TC_BK : 0;

  stage_tile<D, LD>(sQ, qb, qs.s, q0, Sq);
  cp_async_commit();
  if (ntiles > 0) {
    stage_tile<D, LD>(sK, kb, ks.s, kv_begin, Skv);
    stage_tile<DV, LDV>(sV, vb, vs.s, kv_begin, Skv);
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

  const int wr_lo = q_off + q0 + warp * 16, wr_hi = wr_lo + 15;  // this warp's positions
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = kv_begin + t * TC_BK;
    const int buf = t & 1;
    if (t + 1 < ntiles) {  // prefetch the next tile into the other buffer
      stage_tile<D, LD>(sK + (buf ^ 1) * TC_BK * LD, kb, ks.s, k0 + TC_BK, Skv);
      stage_tile<DV, LDV>(sV + (buf ^ 1) * TC_BK * LDV, vb, vs.s, k0 + TC_BK, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + buf * TC_BK * LD;
    const bf16* cV = sV + buf * TC_BK * LDV;

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
          const int row = q_off + row0 + (e >> 1) * 8;  // the row's position
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
      const bf16* vrow = cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV;
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

// ---------------------------------------------------------------------------
// bfloat16 at D >= 64: wgmma, TMA, a producer warpgroup and two consumers
// ---------------------------------------------------------------------------

constexpr int WS_BQ = 128;       // q rows per block: 64 for each consumer warpgroup
constexpr int WS_THREADS = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int WS_STAGES = 2;     // K and V ring depth
constexpr int WS_CHUNK = 64;     // columns of one 128-byte swizzled row
constexpr int WS_BAR_WG = 1;     // named barriers 1 and 2: the consumers' turns (0 is __syncthreads)
constexpr int WS_PRODUCER_REGS = 24;   // setmaxnreg: 24 + 2 x 240 = 3 x 168, the
constexpr int WS_CONSUMER_REGS = 240;  // registers a thread at 384 threads an SM

// The (D, DV) pairs of the wgmma kernel, with BK, the KV rows of a tile (a
// ring stage): the running max is taken once a tile, so BK is the only
// thing that moves the rounding (kernel.py's KV_TILE holds the same table).
#define REPRO_WGMMA_TILES(X) X(64, 64, 128) X(128, 128, 128) X(256, 256, 64) X(192, 128, 128)

template <int D, int DV, int BK>
struct WsShape {
  static_assert(D % WS_CHUNK == 0 && DV % WS_CHUNK == 0, "head dims of whole 64-column chunks");
  static_assert(BK % 16 == 0 && BK <= 128, "BK: a multiple of wgmma's k, one n <= 128 instruction");
  static constexpr int DC = D / WS_CHUNK;   // 64-column chunks of q and k
  static constexpr int VC = DV / WS_CHUNK;  // of v
  static constexpr int Q_BYTES = WS_BQ * D * 2;
  static constexpr int K_BYTES = BK * D * 2;
  static constexpr int V_BYTES = BK * DV * 2;
  // q full and empty; k and v full and empty a stage; the q-tile slot
  static constexpr int BARS = 2 + 4 * WS_STAGES + 1;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's 1024-byte atom
  static constexpr int SMEM = 1024 + Q_BYTES + WS_STAGES * (K_BYTES + V_BYTES) + BARS * 8;
};

// --- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Returns once the phase of parity `parity` has completed.  (No bounded
// wait with a trap: a trap anywhere in the kernel keeps ptxas from giving
// the consumers setmaxnreg's registers, and they spill.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// One box of a rank-4 (D, H, S, B) tensor map into shared memory; the bytes
// land on `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an asynchronous wgmma reads or writes, so the compiler
// moves no access of them across the wgmma's issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled operand:
// 14 bits of address / 16, the leading and stride byte offsets / 16, and
// layout type 1 (128B swizzle) in bits 62-63.  K-major (Q, K): SBO = 1024,
// the 8-row step; LBO unused.  MN-major (V): LBO = the step between
// 64-column chunks, SBO = 1024, the step between groups of 8 k-rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= a·b, m64nNk16, bf16 in, fp32 accumulator.  ss: a and b from shared
// memory, both K-major.  rs: a from registers (the m16n8k16 A fragment of
// each warp's 16 rows), b MN-major from shared memory (the transpose bit).

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

// S = Q·Kᵀ for a consumer's 64 rows and the tile's BK columns: D/16 k-steps,
// each advancing both descriptors 32 bytes inside a 128-byte swizzled row,
// then to the next 64-column chunk.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_addr, uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < D / WS_CHUNK; ++c)
#pragma unroll
    for (int kk = 0; kk < WS_CHUNK / 16; ++kk)
      wgmma_ss<BK>(s, sw128_desc(q_addr + c * WS_BQ * 128 + kk * 32, 16),
                   sw128_desc(k_addr + c * BK * 128 + kk * 32, 16), c + kk > 0);
  wgmma_commit();
}

// O += P·V: P from registers, V's tile MN-major (no transpose in shared
// memory); each k-step is 16 rows of V, 2048 bytes on.  DV = 256 is two
// n128 halves.
template <int DV, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], uint32_t (&p)[BK / 16][4],
                                         uint32_t v_addr) {
  constexpr int N = DV < 128 ? DV : 128;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int hf = 0; hf < DV / N; ++hf)
      wgmma_rs<N>(*reinterpret_cast<float(*)[N / 2]>(&o[hf * N / 2]), p[kk],
                  sw128_desc(v_addr + hf * (N / WS_CHUNK) * BK * 128 + kk * 2048, BK * 128));
  wgmma_commit();
}

// 2^x, the tensor-core kernels' exponent: one MUFU.EX2 (subnormal results
// flush to 0, below any p that moves l or O).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax on the scores in s (in place: s leaves holding
// the fp32 probabilities).  A thread holds rows r and r + 8 of its warp's 16
// (elements 4j + {0, 1} and 4j + {2, 3}), columns 8j + 2(lane % 4) + {0, 1}.
// Scores are scaled to base 2.  MASK (a tile that meets an edge of some row's
// allowed columns): a column outside [lo, hi) of its row, given relative to
// the thread's first column, is -inf and adds exactly 0.  The unmasked tiles
// take the MASK = false copy, with no per-element test.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const int (&lo)[2],
                                             const int (&hi)[2], float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (MASK) {
        const int c = j * 8 + (e & 1);
        x = c >= lo[e >> 1] && c < hi[e >> 1] ? x : -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // the 4 lanes of a quad share a row
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    base[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row with nothing allowed yet
    alpha[i] = exp2_ftz(m[i] - base[i]);
    m[i] = mx[i];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_ftz(s[4 * j + e] - base[e >> 1]);
      s[4 * j + e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
}

// The fp32 probabilities rounded to bf16, as the A fragments of P·V: k-step
// kk takes columns 16kk..16kk+15, the accumulator's blocks 2kk and 2kk + 1.
template <int BK>
__device__ __forceinline__ void to_a_fragments(const float (&s)[BK / 2], uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// The work of one q-tile: 128 rows of one (batch, q-head), the KV tiles
// they can see (those wholly in the future, causal, or wholly before every
// row's window are skipped).  Q-tiles are numbered in chunks of `chunk`
// (batch, q-head) pairs, q-head fastest (a GQA group together), chosen so a
// chunk's K and V stay in L2 while its q-tiles read them; inside a chunk the
// latest (causally heaviest) q-tiles come first.
struct WsTile {
  int h, b, q0, kvh, kv_begin, ntiles;
};

template <int BK>
__device__ __forceinline__ WsTile ws_tile(int i, int Hq, int B, int nqt, int chunk, int Skv,
                                          int groups, int causal, int window, int q_off) {
  const int c = i / (chunk * nqt), r = i % (chunk * nqt);
  const int in_chunk = min(chunk, Hq * B - c * chunk);
  const int hb = c * chunk + r % in_chunk;
  WsTile t;
  t.q0 = (nqt - 1 - r / in_chunk) * WS_BQ;
  t.h = hb % Hq;
  t.b = hb / Hq;
  t.kvh = t.h / groups;
  const int kv_end = causal ? min(Skv, q_off + t.q0 + WS_BQ) : Skv;
  t.kv_begin = window > 0 ? (max(0, q_off + t.q0 - window + 1) / BK) * BK : 0;
  t.ntiles = kv_end > t.kv_begin ? (kv_end - t.kv_begin + BK - 1) / BK : 0;
  return t;
}

template <int D, int DV, int BK>
__global__ void __launch_bounds__(WS_THREADS, 1)
fwd_kernel_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                 int* __restrict__ sched, int B, int Hq, int Sq, int Skv, int groups, int chunk,
                 Strides os, float scale_log2, int causal, int window, int q_off) {
  using Sh = WsShape<D, DV, BK>;
  extern __shared__ unsigned char ws_smem[];
  const uint32_t base = (smem_u32(ws_smem) + 1023) & ~1023u;
  const uint32_t sQ = base;                                 // [DC][BQ][64], swizzled
  const uint32_t sK = sQ + Sh::Q_BYTES;                     // [STAGES][DC][BK][64]
  const uint32_t sV = sK + WS_STAGES * Sh::K_BYTES;         // [STAGES][VC][BK][64]
  const uint32_t bars = sV + WS_STAGES * Sh::V_BYTES;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int st) { return bars + 8 * (2 + st); };
  auto k_empty = [&](int st) { return bars + 8 * (2 + WS_STAGES + st); };
  auto v_full = [&](int st) { return bars + 8 * (2 + 2 * WS_STAGES + st); };
  auto v_empty = [&](int st) { return bars + 8 * (2 + 3 * WS_STAGES + st); };
  volatile int* slot = reinterpret_cast<volatile int*>(
      ws_smem + (bars + 8 * (2 + 4 * WS_STAGES) - smem_u32(ws_smem)));  // the q-tile in hand

  // Persistent: a block per SM takes q-tile blockIdx.x, then the next one
  // not yet taken (sched[0] counts them), so the blocks share the q-tiles
  // out as they finish them, heaviest first.
  const int nqt = (Sq + WS_BQ - 1) / WS_BQ;
  const int total = nqt * Hq * B;
  auto tile = [&](int i) {
    return ws_tile<BK>(i, Hq, B, nqt, chunk, Skv, groups, causal, window, q_off);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // lane 0 of each consumer warp
    for (int st = 0; st < WS_STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 8);
      mbar_init(v_empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // The producer: one thread issues every load: a q-tile's Q once the
    // consumers' last Q·Kᵀ of the one before is done, and the ring's K and V
    // tiles as the consumers free them, on across q-tiles.
    setmaxnreg_dec<WS_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // ring tiles so far
      int i = blockIdx.x;
      for (int qi = 0;; ++qi) {
        // The q-tile goes to the consumers through `slot`, published by
        // q_full's arrival (-1: none left).
        mbar_wait(q_empty, (qi & 1) ^ 1);
        if (i >= total) {
          *slot = -1;
          mbar_arrive(q_full);
          break;
        }
        *slot = i;
        const int next = gridDim.x + atomicAdd(sched, 1);
        const WsTile tl = tile(i);
        mbar_expect_tx(q_full, Sh::Q_BYTES);
#pragma unroll
        for (int c = 0; c < Sh::DC; ++c)
          tma_load(sQ + c * WS_BQ * 128, &qmap, q_full, c * WS_CHUNK, tl.h, tl.q0, tl.b);
        for (int t = 0; t < tl.ntiles; ++t, ++it) {
          const int st = it % WS_STAGES, ph = (it / WS_STAGES) & 1;
          const int k0 = tl.kv_begin + t * BK;
          mbar_wait(k_empty(st), ph ^ 1);
          mbar_expect_tx(k_full(st), Sh::K_BYTES);
#pragma unroll
          for (int c = 0; c < Sh::DC; ++c)
            tma_load(sK + st * Sh::K_BYTES + c * BK * 128, &kmap, k_full(st), c * WS_CHUNK, tl.kvh,
                     k0, tl.b);
          mbar_wait(v_empty(st), ph ^ 1);
          mbar_expect_tx(v_full(st), Sh::V_BYTES);
#pragma unroll
          for (int c = 0; c < Sh::VC; ++c)
            tma_load(sV + st * Sh::V_BYTES + c * BK * 128, &vmap, v_full(st), c * WS_CHUNK, tl.kvh,
                     k0, tl.b);
        }
        i = next;
      }
      // The last block to finish leaves the counters at 0 for the next
      // launch on this stream (each stream has its own; kernel.py).
      __threadfence();
      if (atomicAdd(sched + 1, 1) == static_cast<int>(gridDim.x) - 1) {
        atomicExch(sched, 0);
        atomicExch(sched + 1, 0);
      }
    }
  } else {
    // The consumers: warpgroup w owns rows 64w..64w+63 of each q-tile.
    setmaxnreg_inc<WS_CONSUMER_REGS>();
    const int w = (threadIdx.x >> 7) - 1;
    const int lane = threadIdx.x & 31;
    const int wi = (threadIdx.x >> 5) & 3;  // warp in the warpgroup: rows 16wi..16wi+15
    const int my_turn = WS_BAR_WG + w, their_turn = WS_BAR_WG + 1 - w;
    const uint32_t q_addr = sQ + w * 64 * 128;
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    float acc[DV / 2];
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    uint32_t p[BK / 16][4];

    int it = 0;
    for (int qi = 0;; ++qi) {
      mbar_wait(q_full, qi & 1);
      const int i = *slot;
      if (i < 0) break;
      const WsTile tl = tile(i);
      const int row = tl.q0 + w * 64 + wi * 16 + (lane >> 2);  // this thread's rows: row, row + 8
#pragma unroll
      for (int r = 0; r < DV / 2; ++r) acc[r] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2] = {0.f, 0.f};
      // A tile is masked where it meets an edge of some row's columns: Skv,
      // the causal diagonal or the window's start.  Position pos of a row
      // sees the columns [lo, hi), here relative to this thread's first.
      auto softmax = [&](int k0) {
        const int pos = q_off + row, warp_lo = pos - (lane >> 2);  // the warp's rows: warp_lo + 0..15
        if (k0 + BK > Skv || (causal && k0 + BK - 1 > warp_lo) ||
            (window > 0 && warp_lo + 15 - k0 >= window)) {
          const int first = k0 + (lane & 3) * 2;
          int lo[2], hi[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            lo[r] = (window > 0 ? pos + 8 * r - window + 1 : 0) - first;
            hi[r] = (causal ? min(pos + 8 * r + 1, Skv) : Skv) - first;
          }
          softmax_tile<BK, true>(s, m, l, alpha, lo, hi, scale_log2);
        } else {
          const int none[2] = {0, 0};
          softmax_tile<BK, false>(s, m, l, alpha, none, none, scale_log2);
        }
      };

      if (tl.ntiles == 0) release(q_empty);
      if (tl.ntiles > 0) {
        // The two warpgroups take turns to issue their products (named
        // barriers), so one's softmax runs while the other's wgmmas do.
        // Warpgroup 0 goes first; each arrives on the other's barrier after
        // each of its issues (warpgroup 1 not after its last), so both
        // barriers end each q-tile balanced.
        if (w == 1) named_arrive(WS_BAR_WG, 256);
        int st = it % WS_STAGES;
        mbar_wait(k_full(st), (it / WS_STAGES) & 1);
        named_sync(my_turn, 256);
        issue_qk<D, BK>(s, q_addr, sK + st * Sh::K_BYTES);
        named_arrive(their_turn, 256);
        wgmma_wait<0>();
        fence_regs(s);
        release(k_empty(st));
        if (tl.ntiles == 1) release(q_empty);  // the q-tile's last Q·Kᵀ is done
        softmax(tl.kv_begin);
        to_a_fragments<BK>(s, p);

        for (int t = 1; t < tl.ntiles; ++t) {
          // Issue KV tile t's S = Q·Kᵀ, then tile t-1's O += P·V; wait for
          // S only, and run its softmax while P·V is in flight.
          const int pst = st;
          const int pph = (it / WS_STAGES) & 1;
          ++it;
          st = it % WS_STAGES;
          const int k0 = tl.kv_begin + t * BK;
          mbar_wait(k_full(st), (it / WS_STAGES) & 1);
          named_sync(my_turn, 256);
          issue_qk<D, BK>(s, q_addr, sK + st * Sh::K_BYTES);
          rescale(acc, alpha);
          mbar_wait(v_full(pst), pph);
          fence_regs(p);
          issue_pv<DV, BK>(acc, p, sV + pst * Sh::V_BYTES);
          named_arrive(their_turn, 256);
          wgmma_wait<1>();
          fence_regs(s);
          release(k_empty(st));
          if (t == tl.ntiles - 1) release(q_empty);
          softmax(k0);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(p);
          release(v_empty(pst));
          to_a_fragments<BK>(s, p);
        }

        rescale(acc, alpha);
        mbar_wait(v_full(st), (it / WS_STAGES) & 1);
        named_sync(my_turn, 256);
        fence_regs(p);
        issue_pv<DV, BK>(acc, p, sV + st * Sh::V_BYTES);
        if (w == 0) named_arrive(their_turn, 256);
        wgmma_wait<0>();
        fence_regs(acc);
        release(v_empty(st));
        ++it;
      }

      // The epilogue: O / l to the output rows (the producer is already
      // loading the next q-tile).
      bf16* ob = o + tl.b * os.b + tl.h * os.h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float denom = fmaxf(l[r], 1e-37f);
        if (row + r * 8 >= Sq) continue;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          const int col = j * 8 + (lane & 3) * 2;
          *reinterpret_cast<uint32_t*>(ob + (row + r * 8) * os.s + col) =
              pack_bf16(acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
        }
      }
    }
  }
}

// Every row base the kernels copy 16 bytes at a time (cp.async) or by TMA
// must be 16-byte aligned: the pointers, and the strides of every dimension
// longer than 1.
bool aligned16(const void* p, const Strides& st, int nb, int ns, int nh) {
  const long long e = static_cast<long long>(sizeof(bf16));
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (nb == 1 || st.b * e % 16 == 0) &&
         (ns == 1 || st.s * e % 16 == 0) && (nh == 1 || st.h * e % 16 == 0);
}

// cuTensorMapEncodeTiled, taken from libcuda through the runtime, so the
// library links no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f)
                                                                       : nullptr;
  }();
  return fn;
}

// A rank-4 map (cols, H, S, B) over a [B, S, H, cols] bf16 tensor with its
// element strides, whose box is 64 columns of `rows` rows of one head, 128B
// swizzled; rows past S read as zeros.  A dimension of extent 1 is given a
// stride that is never used but that cuTensorMapEncodeTiled accepts.
bool make_map(CUtensorMap* map, const void* p, int cols, int H, int S, int B, const Strides& st,
              int rows) {
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t sh = H > 1 ? st.h * e : cols * e;
  const cuuint64_t ss = S > 1 ? st.s * e : sh * H;
  const cuuint64_t sb = B > 1 ? st.b * e : ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {sh, ss, sb};
  const cuuint32_t box[4] = {WS_CHUNK, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
                        strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int* sched, int B, int Sq,
                 int Skv, int Hq, int Hkv, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal, int window, int q_off, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return -5;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, D, Hq, Sq, B, qs, WS_BQ) || !make_map(&kmap, k, D, Hkv, Skv, B, ks, BK) ||
      !make_map(&vmap, v, DV, Hkv, Skv, B, vs, BK))
    return -4;
  constexpr int bytes = WsShape<D, DV, BK>::SMEM;
  static int sms[64] = {};  // the device's SMs, once the opt-in is done
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(fwd_kernel_wgmma<D, DV, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = n;
  }
  // One block an SM (its shared memory allows no second), each taking
  // q-tiles until none is left.  A chunk of (batch, q-head) pairs holds
  // about 24 MB of K and V, half the L2.
  const int tiles = ((Sq + WS_BQ - 1) / WS_BQ) * Hq * B;
  const long long kv_bytes = static_cast<long long>(Skv) * (D + DV) * 2 / (Hq / Hkv);  // a q-head's share
  const int chunk = static_cast<int>(max(1LL, min(static_cast<long long>(Hq) * B, (24LL << 20) / max(1LL, kv_bytes))));
  fwd_kernel_wgmma<D, DV, BK><<<min(tiles, sms[dev]), WS_THREADS, bytes, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), sched, B, Hq, Sq, Skv, Hq / Hkv, chunk, os,
      scale * LOG2E, causal, window, q_off);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DV>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv, int Hq,
              int Hkv, Strides qs, Strides ks, Strides vs, Strides os, float scale, int causal,
              int window, int q_off, cudaStream_t stream) {
  constexpr int bytes = TcShape<D, DV>::SMEM;
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(fwd_kernel_tc<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  dim3 grid(Hq, B, (Sq + TC_BQ - 1) / TC_BQ);
  fwd_kernel_tc<D, DV><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Skv, Hq / Hkv, qs, ks, vs, os, scale * LOG2E, causal, window,
      q_off);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the wgmma kernel for its (D, DV) pairs, the mma.sync kernel for the
// small head dims; any other pair returns -2.
int dispatch_bf16(int D, int DV, const void* q, const void* k, const void* v, void* o, int* sched,
                  int B, int Sq, int Skv, int Hq, int Hkv, Strides qs, Strides ks, Strides vs,
                  Strides os, float scale, int causal, int window, int q_off, cudaStream_t st) {
  if (!aligned16(q, qs, B, Sq, Hq) || !aligned16(k, ks, B, Skv, Hkv) ||
      !aligned16(v, vs, B, Skv, Hkv) || !aligned16(o, os, B, Sq, Hq))
    return -3;
#define REPRO_CASE(d, dv, bk)                                                                   \
  if (D == d && DV == dv)                                                                       \
    return launch_wgmma<d, dv, bk>(q, k, v, o, sched, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, \
                                   causal, window, q_off, st);
  REPRO_WGMMA_TILES(REPRO_CASE)
#undef REPRO_CASE
#define REPRO_CASE(d, dv)                                                                   \
  if (D == d && DV == dv)                                                                   \
    return launch_tc<d, dv>(q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, \
                            window, q_off, st);
  REPRO_MMA_PAIRS(REPRO_CASE)
#undef REPRO_CASE
  return -2;  // unsupported (D, DV) pair
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernels).
// D is q's and k's head dim, Dv v's and o's.  Strides in elements, [B, S, H]
// order.  q_offset >= 0: row i of q is at position q_offset + i in the masks.
// sched: two ints on the device, zero before the first launch on a stream
// and left zero by each wgmma launch (its tile counter); launches that may
// run at once need their own.  Returns 0, a cudaError_t from the launch, -1
// (dtype), -2 (a (D, Dv) pair not instantiated), -3 (a bf16 row base not
// 16-byte aligned), -4 (cuTensorMapEncodeTiled refused a tensor map) or
// -5 (no cuTensorMapEncodeTiled in libcuda).
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* sched,
                              int dtype,
                              int B, int Sq, int Skv, int Hq, int Hkv, int D, int Dv, long long qsb,
                              long long qss, long long qsh, long long ksb, long long kss,
                              long long ksh, long long vsb, long long vss, long long vsh,
                              long long osb, long long oss, long long osh, float scale,
                              int causal, int window, int q_offset, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, Dv, q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal,
                             window, q_offset, st);
  if (dtype == 1)
    return dispatch_bf16(D, Dv, q, k, v, o, static_cast<int*>(sched), B, Sq, Skv, Hq, Hkv, qs, ks,
                         vs, os, scale, causal, window, q_offset, st);
  return -1;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
