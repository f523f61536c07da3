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
//   * a masked score contributes exactly 0 to l and acc (rather than exp(0)
//     while the running max is still -2e38), so a row with no allowed key
//     comes out as 0 (l clamped at 1e-37, as kernel.py:92), not NaN.
//
// Design.  One block of 256 threads per (batch, q-head, 64-row q-tile).  The
// block stages its Q tile once, then walks the 64-row K/V tiles its rows can
// see, staging each in shared memory as fp32.  A thread owns a 4x4 patch of
// the 64x64 score tile (rows ty+16i, columns tx+16j) and the matching rows of
// the output accumulator (columns tx+16c), both in registers; the 16 threads
// of one row are the lanes of one half-warp, so row max and row sum are warp
// shuffles.  P goes through shared memory for the P·V product.  Inputs are
// float32 or bfloat16; all arithmetic is fp32 and the output is rounded once
// to the input dtype.  q-tiles are scheduled latest first, so the causally
// heaviest blocks start in the first wave.
//
// What bounds it on an H100.  At the serving slice's shapes (B=4, S=512,
// Hq=15, Hkv=5, D=64, bf16, causal) the function moves ~10.5 MB (Q, K, V, O
// once each: ~3 us at 3.35 TB/s) and needs ~2.0 GFLOP (~2 us at the 989
// TFLOP/s bf16 tensor-core peak), so on paper it is bound by neither: a few
// microseconds, the order of one launch.  This first version does its
// products on the CUDA cores in fp32 from shared memory (about one shared
// load per two FMAs), so it is bound by shared-memory bandwidth and the fp32
// FMA rate, far above that bound.  Tensor cores (wgmma), TMA loads and warp
// specialisation are the work of a later change; chip_smoke.py reports the
// measured time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
    default: return -2;  // unsupported head dim
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements, [B, S, H] order.
// Returns 0, a cudaError_t from the launch, -1 (dtype) or -2 (head dim).
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
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, Hq, Hkv, qs, ks, vs, os, scale, causal, window, st);
  return -1;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
