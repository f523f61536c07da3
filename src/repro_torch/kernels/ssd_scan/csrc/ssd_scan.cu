// Mamba-2 SSD chunk scan for Hopper (sm_90a), plain C entry point for ctypes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::ssd_scan_fwd (body _ssd_kernel)
// and computes the same function, chunk by chunk with the same split.  For
// one (batch b, head h) and a chunk of Q rows, with da = dt·A, cum the
// inclusive cumsum of da over the chunk and total = cum[Q-1]:
//
//   intra:  y[i]  = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j
//   inter:  y[i] += exp(cum_i) C_i·h_prev          (h_prev [P, N] fp32)
//   update: h     = h_prev exp(total) + Σ_j exp(total - cum_j) dt_j x_j ⊗ B_j
//
// y is rounded once (to nearest) to x's dtype; the final h is returned in
// fp32.  exp(cum_i - cum_j) is only evaluated for j <= i (cum falls, so above
// the diagonal it would overflow), and never as exp(cum_i)·exp(-cum_j).
//
// What it adds over the TPU kernel:
//   * it reads the model layout through strides: x/y [B,S,H,P], dt [B,S,H],
//     B/C [B,S,G,N] with group g = h / (H/G) (the reference's jnp.repeat,
//     ops.py:30) — no host-side repeat of B/C to the heads (at G = 1 that
//     would move 24× their bytes) and no transposes; the last dim of x, B and
//     C must be contiguous;
//   * any chunk length Q that divides S (the model's choice halves 256 until
//     it divides, so S = 500 gives Q = 4): rows past Q in a 64-row sub-block
//     are masked.
//
// Design.  The TPU kernel runs the chunk axis of its grid in order on one
// core, carrying h in VMEM.  Here blocks run in parallel in no order, so one
// block of 256 threads owns one (b, h, 32-column tile of P) and loops over
// the chunks itself, carrying its [32, N] slice of h in shared memory (rows
// p of the state are independent: y[:, p] reads only h[p, :] and x[:, p]).
// At the serving shapes (B=4, H=24, P=64) that is 192 blocks on 132 SMs,
// two resident per SM.  Inside a chunk, 64-row sub-blocks: for each row
// block I, the inter term from h_prev, then for each column block J <= I
// the 64×64 tile S = C_I·B_Jᵀ (4×4 outputs a thread, N-long dot products
// from shared memory), masked and decayed in registers, staged, and
// multiplied into y by dt·x of J.  Then the state update from B and the
// decayed dt·x, 2×(N/16) outputs a thread in registers.  The chunk's cumsum
// is one warp's scan.  All arithmetic is fp32 on the CUDA cores.
//
// What bounds it on an H100.  At the serving shapes (B=4, S=512, H=24, P=64,
// G=1, N=128, Q=256, bf16 x/B/C) the function moves ~17 MB (x, y, B, C, dt
// once each, h_final in fp32: ~5 us at 3.35 TB/s) and needs ~4 GFLOP in its
// causal triangle (~4 us at the 989 TFLOP/s bf16 tensor-core peak).  This
// first version does its products on the CUDA cores in fp32 from shared
// memory, and each column tile recomputes the chunk's C·Bᵀ, so it is bound
// by the fp32 FMA rate and shared-memory bandwidth, far above that bound.
// C·Bᵀ depends only on the group, not the head: computing it once per group,
// tensor cores (wgmma) and TMA staging are the work of a later change;
// chip_smoke.py reports the measured time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 64;       // rows of a chunk sub-block
constexpr int TP = 32;        // columns of P per block
constexpr int THREADS = 256;  // 16 x 16
constexpr int MAX_SMEM = 232448;

struct Strides {
  long long b, s, h;  // in elements; the last dim has stride 1
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

__host__ __device__ constexpr int padded(int n) { return n | 1; }  // odd row stride: no bank conflicts

int smem_bytes(int N, int Q) {
  const int NP = padded(N);
  return (2 * BLK * NP + BLK * (BLK + 1) + BLK * TP + TP * NP + 2 * Q) * static_cast<int>(sizeof(float));
}

// Rows [r0, r0 + BLK) of the chunk starting at t0 into dst [BLK][NP] as fp32;
// rows past Q and columns past N are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, Strides st, int b, int gh,
                                          int t0, int r0, int Q, int N, int NP) {
  for (int idx = threadIdx.x; idx < BLK * N; idx += THREADS) {
    const int row = idx / N, n = idx - row * N;
    const int t = r0 + row;
    dst[row * NP + n] =
        t < Q ? to_f(src[b * st.b + static_cast<long long>(t0 + t) * st.s + gh * st.h + n]) : 0.f;
  }
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
           const T* __restrict__ bm, const T* __restrict__ cm, T* __restrict__ y,
           float* __restrict__ hout, int S, int H, int G, int P, int N, int Q, Strides xs,
           Strides dts, Strides bs, Strides cs, Strides ys) {
  extern __shared__ float smem[];
  const int NP = padded(N);
  float* sC = smem;                     // [BLK][NP]
  float* sB = sC + BLK * NP;            // [BLK][NP]
  float* sS = sB + BLK * NP;            // [BLK][BLK + 1]
  float* sX = sS + BLK * (BLK + 1);     // [BLK][TP]
  float* sH = sX + BLK * TP;            // [TP][NP]   h_prev of this column tile
  float* sCum = sH + TP * NP;           // [Q]
  float* sDt = sCum + Q;                // [Q]
  constexpr int SP = BLK + 1;
  constexpr int NC = NMAX / 16;

  const int p0 = blockIdx.x * TP;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const float A = a[h];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nblk = (Q + BLK - 1) / BLK;

  for (int i = tid; i < TP * NP; i += THREADS) sH[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    // ---- dt and the inclusive cumsum of dt·A over the chunk ------------
    for (int i = tid; i < Q; i += THREADS)
      sDt[i] = dt[b * dts.b + static_cast<long long>(t0 + i) * dts.s + h * dts.h];
    __syncthreads();
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int lo = tid * per, hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += sDt[i] * A;
        sCum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float before = incl - run;
      for (int i = lo; i < hi; ++i) sCum[i] += before;
    }
    __syncthreads();
    const float total = sCum[Q - 1];

    // ---- y, one 64-row block of the chunk at a time --------------------
    for (int I = 0; I < nblk; ++I) {
      const int r0 = I * BLK;
      load_rows(sC, cm, cs, b, g, t0, r0, Q, N, NP);
      __syncthreads();

      float acc[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = ty + 16 * r;
        float dot[2] = {0.f, 0.f};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float cv = sC[row * NP + n];
#pragma unroll
          for (int c = 0; c < 2; ++c) dot[c] = fmaf(cv, sH[(tx + 16 * c) * NP + n], dot[c]);
        }
        const float dec = r0 + row < Q ? expf(sCum[r0 + row]) : 0.f;
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[r][c] = dec * dot[c];
      }

      for (int J = 0; J <= I; ++J) {
        const int j0 = J * BLK;
        load_rows(sB, bm, bs, b, g, t0, j0, Q, N, NP);
        for (int idx = tid; idx < BLK * TP; idx += THREADS) {
          const int row = idx / TP, col = idx % TP;
          const int t = j0 + row, p = p0 + col;
          sX[idx] = t < Q && p < P
                        ? to_f(x[b * xs.b + static_cast<long long>(t0 + t) * xs.s + h * xs.h + p]) * sDt[t]
                        : 0.f;
        }
        __syncthreads();

        float s[4][4] = {};
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * NP + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * NP + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cv[r], bv[c], s[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gi = r0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int gj = j0 + tx + 16 * c;
            const float l = gi < Q && gj <= gi ? expf(sCum[gi] - sCum[gj]) : 0.f;
            sS[(ty + 16 * r) * SP + tx + 16 * c] = s[r][c] * l;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int j = 0; j < BLK; ++j) {
          float xv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) xv[c] = sX[j * TP + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float sv = sS[(ty + 16 * r) * SP + j];
#pragma unroll
            for (int c = 0; c < 2; ++c) acc[r][c] = fmaf(sv, xv[c], acc[r][c]);
          }
        }
        __syncthreads();
      }

      T* yb = y + b * ys.b + h * ys.h;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = r0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int p = p0 + tx + 16 * c;
          if (t < Q && p < P) yb[static_cast<long long>(t0 + t) * ys.s + p] = from_f<T>(acc[r][c]);
        }
      }
    }

    // ---- state update: h = h_prev exp(total) + (exp(total - cum) dt x)ᵀ B
    float hacc[2][NC] = {};
    for (int J = 0; J < nblk; ++J) {
      const int j0 = J * BLK;
      load_rows(sB, bm, bs, b, g, t0, j0, Q, N, NP);
      for (int idx = tid; idx < BLK * TP; idx += THREADS) {
        const int row = idx / TP, col = idx % TP;
        const int t = j0 + row, p = p0 + col;
        sX[idx] = t < Q && p < P
                      ? to_f(x[b * xs.b + static_cast<long long>(t0 + t) * xs.s + h * xs.h + p]) *
                            sDt[t] * expf(total - sCum[t])
                      : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < BLK; ++j) {
        const float xv0 = sX[j * TP + ty], xv1 = sX[j * TP + ty + 16];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tx + 16 * c;
          const float bv = n < N ? sB[j * NP + n] : 0.f;
          hacc[0][c] = fmaf(xv0, bv, hacc[0][c]);
          hacc[1][c] = fmaf(xv1, bv, hacc[1][c]);
        }
      }
      __syncthreads();
    }
    const float keep = expf(total);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int pp = ty + 16 * r, n = tx + 16 * c;
        if (n < N) sH[pp * NP + n] = sH[pp * NP + n] * keep + hacc[r][c];
      }
    __syncthreads();
  }

  float* hb = hout + (static_cast<long long>(b) * H + h) * P * N;
  for (int idx = tid; idx < TP * N; idx += THREADS) {
    const int pp = idx / N, n = idx - pp * N;
    if (p0 + pp < P) hb[static_cast<long long>(p0 + pp) * N + n] = sH[pp * NP + n];
  }
}

template <typename T, int NMAX>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm, void* y,
           void* hout, int B, int S, int H, int G, int P, int N, int Q, Strides xs, Strides dts,
           Strides bs, Strides cs, Strides ys, cudaStream_t stream) {
  const int bytes = smem_bytes(N, Q);
  if (bytes > MAX_SMEM) return -3;
  // Above 48 KB of dynamic shared memory needs an opt-in, per instantiation
  // and device; it is raised only when a launch needs more than before.
  static int opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > opted_in[dev]) {
    err = cudaFuncSetAttribute(ssd_kernel<T, NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = bytes;
  }
  dim3 grid((P + TP - 1) / TP, H, B);
  ssd_kernel<T, NMAX><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(hout), S, H, G, P, N, Q, xs, dts, bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
               void* y, void* hout, int B, int S, int H, int G, int P, int N, int Q, Strides xs,
               Strides dts, Strides bs, Strides cs, Strides ys, cudaStream_t st) {
  if (N <= 32) return launch<T, 32>(x, dt, a, bm, cm, y, hout, B, S, H, G, P, N, Q, xs, dts, bs, cs, ys, st);
  if (N <= 64) return launch<T, 64>(x, dt, a, bm, cm, y, hout, B, S, H, G, P, N, Q, xs, dts, bs, cs, ys, st);
  if (N <= 128) return launch<T, 128>(x, dt, a, bm, cm, y, hout, B, S, H, G, P, N, Q, xs, dts, bs, cs, ys, st);
  return -2;
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and a are float32,
// h_final is a contiguous float32 [B, H, P, N].  Strides in elements, in
// [B, S, H-or-G] order.  Returns 0, a cudaError_t from the launch, -1
// (dtype), -2 (shape: N > 128, Q not dividing S, G not dividing H) or -3
// (the chunk needs more shared memory than a block has).
int repro_ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                       const void* cm, void* y, void* h_final, int dtype, int B, int S, int H,
                       int G, int P, int N, int Q, long long xsb, long long xss, long long xsh,
                       long long dtsb, long long dtss, long long dtsh, long long bsb, long long bss,
                       long long bsh, long long csb, long long css, long long csh, long long ysb,
                       long long yss, long long ysh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || P <= 0 || N <= 0 || Q <= 0 || S % Q || H % G)
    return -2;
  const Strides xs{xsb, xss, xsh}, dts{dtsb, dtss, dtsh}, bs{bsb, bss, bsh}, cs{csb, css, csh},
      ys{ysb, yss, ysh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(x, dt, a, bm, cm, y, h_final, B, S, H, G, P, N, Q, xs, dts, bs, cs, ys, st);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, dt, a, bm, cm, y, h_final, B, S, H, G, P, N, Q, xs, dts, bs, cs, ys, st);
  return -1;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
