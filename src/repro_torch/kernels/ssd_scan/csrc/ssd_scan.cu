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
//     are masked (zero).
//
// The TPU kernel runs the chunk axis of its grid in order on one core,
// carrying h in VMEM.  Here blocks run in parallel in no order, so a block
// owns whole (b, h) rows of the state and loops over the chunks itself.  Two
// kernels, chosen by the dtype of x, B and C (the only switch):
//
// bfloat16 — tensor cores (ssd_kernel_tc).  One block of 8 warps per (b, h,
// 64 columns of P): at the serving shapes (P = 64) C·Bᵀ is computed once per
// head, 96 blocks on 132 SMs.  Each chunk's C, B and x rows are staged once
// with cp.async (16-byte copies where the rows allow, else 8 or 4).  The
// chunk's 64-row sub-blocks are split over the two warp groups (rows 0 and 3
// mod 4 to one, 1 and 2 to the other, which balances the causal triangle);
// each warp owns 16 rows of its sub-block.  All products are mma.sync
// m16n8k16 bf16 with fp32 accumulation, operands by ldmatrix:
//   * C·Bᵀ over the causal 64×64 sub-tiles (on the diagonal a warp stops at
//     its own last row); C and B are bf16 already, so it is exact up to the
//     fp32 sums;
//   * every other product has one exact bf16 operand (x, C or B) and one
//     fp32 operand, which is split in registers or shared memory into a
//     bf16 pair hi + lo (v ≈ hi + lo to ~2^-16 |v|) and multiplied twice.
//     A single bf16 rounding is not enough: rounding C·Bᵀ ⊙ L ⊙ dt once
//     puts y 2-3× outside its 5e-2 tolerance where |y| is small beside
//     terms of ~10 (tests/test_torch_ssd_scan.py emulates both), and the
//     state compounds its rounding across chunks (h_final is held to 5e-3).
//     So: (C·Bᵀ ⊙ exp(cum_i - cum_j) ⊙ dt_j) · x, split in registers as the
//     A operand; the inter term C · h_prevᵀ, h_prev split into two bf16
//     copies in shared memory; the update (exp(total - cum_j) dt_j x_j)ᵀ · B,
//     the first factor split in registers.  The state itself stays in fp32
//     registers, the update's accumulator: each warp holds 16 rows × 64
//     columns of h.
//
// float32 — CUDA cores (ssd_kernel, the first, scalar design, kept exact for the fp32
// card-vs-CPU checks: bf16 or TF32 operands would break their tolerance).
// One block of 256 threads per (b, h, 32 columns of P) carries its slice of
// h in shared memory; 64-row sub-blocks, 4×4 outputs a thread, the chunk's
// cumsum one warp's scan, all arithmetic fp32.
//
// What bounds it on an H100.  At the serving shapes (B=4, S=512, H=24, P=64,
// G=1, N=128, Q=256, bf16 x/B/C) the function moves ~17 MB (x, y, B, C, dt
// once each, h_final in fp32: ~5 us at 3.35 TB/s) and needs ~4 GFLOP in its
// causal triangle (~4 us at the 989 TFLOP/s bf16 tensor-core peak): bound by
// bytes.  The tensor-core kernel does ~19 M MAC per block and chunk (C·Bᵀ
// 5.2 M on the triangle's sub-tiles; its product with x 5.2 M, inter and
// update 4.2 M each, all three doubled by the hi + lo split) at the
// mma.sync rate of one SM, so it is bound by the per-SM tensor rate of 96
// busy SMs and by each chunk's staging, which is not yet overlapped with
// the math (216 KB of shared memory at chunk 256 leave no room for a second
// buffer).  Sharing C·Bᵀ
// across the heads of a group, TMA staging and wgmma are the next steps;
// chip_smoke.py reports the measured device time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_ROWS = 64;         // rows of a chunk sub-block
constexpr int TC_P = 64;            // columns of P per block
constexpr int TC_THREADS = 256;     // 8 warps: two groups of 4
constexpr int TC_LDP = TC_P + 8;    // row stride of the x tile: an odd number of 16-byte units
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `vec` bytes (16, 8 or 4) global -> shared, asynchronously.
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src, int vec) {
  const uint32_t d = smem_u32(dst);
  if (vec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else if (vec == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

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

// (f0, f1) as a bf16 pair hi plus the bf16 pair lo of what hi leaves out:
// f ≈ hi + lo to ~2^-16 |f|.
__device__ __forceinline__ void split_pair(float f0, float f1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(f0, f1);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = pack_bf16(f0 - __low2float(h2), f1 - __high2float(h2));
}

// The bf16 pair `packed` times (w0, w1), split as above.
__device__ __forceinline__ void scale_split(uint32_t packed, float w0, float w1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  split_pair(__low2float(v) * w0, __high2float(v) * w1, hi, lo);
}

// Rows [0, rows) × columns [0, cols) of a strided bf16 matrix into dst
// (row stride LD), `vec` bytes a copy.
template <int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long row_stride,
                                           int rows, int cols, int vec) {
  const int per = vec / 2;
  const int cpr = cols / per;
  for (int i = threadIdx.x; i < rows * cpr; i += TC_THREADS) {
    const int r = i / cpr, c = (i - r * cpr) * per;
    cp_async_vec(dst + r * LD + c, src + r * row_stride + c, vec);
  }
}

__host__ __device__ constexpr int round_rows(int Q) { return (Q + TC_ROWS - 1) / TC_ROWS * TC_ROWS; }

// bf16 tiles C, B [Qp][NMAX+8], x [Qp][TC_LDP], h_prev hi and lo
// [TC_P][NMAX+8]; fp32 cum, dt, exp(cum), the update's weights and cum·log2(e) [Qp].
__host__ __device__ constexpr int smem_bytes_tc(int nmax, int Q) {
  return (2 * round_rows(Q) * (nmax + 8) + round_rows(Q) * TC_LDP + 2 * TC_P * (nmax + 8)) * 2 +
         5 * round_rows(Q) * 4;
}

template <int NMAX>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_kernel_tc(const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ a,
              const bf16* __restrict__ bm, const bf16* __restrict__ cm, bf16* __restrict__ y,
              float* __restrict__ hout, int S, int H, int G, int P, int N, int Q, int vec,
              Strides xs, Strides dts, Strides bs, Strides cs, Strides ys) {
  constexpr int LDN = NMAX + 8;   // an odd number of 16-byte units: ldmatrix hits distinct banks
  constexpr int KN = NMAX / 16;   // k-steps over the state dim
  const int Qp = round_rows(Q);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);  // [Qp][LDN]
  bf16* sB = sC + Qp * LDN;                       // [Qp][LDN]
  bf16* sX = sB + Qp * LDN;                       // [Qp][TC_LDP]
  bf16* sHhi = sX + Qp * TC_LDP;                  // [TC_P][LDN]  h_prev rounded to bf16
  bf16* sHlo = sHhi + TC_P * LDN;                 // [TC_P][LDN]  h_prev - hi, rounded
  float* sCum = reinterpret_cast<float*>(sHlo + TC_P * LDN);  // [Qp]
  float* sDt = sCum + Qp;                         // [Qp]
  float* sEc = sDt + Qp;                          // [Qp] exp(cum_i); 0 past Q
  float* sW = sEc + Qp;                           // [Qp] dt_i exp(total - cum_i); 0 past Q
  float* sL2 = sW + Qp;                           // [Qp] cum_i · log2(e)

  const int p0 = blockIdx.x * TC_P;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int Pt = min(TC_P, P - p0);
  const float A = a[h];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nblk = Qp / TC_ROWS;

  // Zero everything once: rows past Q and columns past N or P are never
  // written again, so they stay zero operands.
  {
    uint4* p = reinterpret_cast<uint4*>(smem_raw);
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < smem_bytes_tc(NMAX, Q) / 16; i += TC_THREADS) p[i] = zero;
  }
  __syncthreads();

  // The state: this warp's 16 rows (of the block's P columns) × 64 columns of h.
  const int hp = 16 * (warp & 3), hn = 64 * (warp >> 2);
  const bool h_active = hp < Pt && hn < NMAX;
  float hs[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) hs[n][e] = 0.f;

  // The y side: this warp's group (row sub-blocks 0 and 3 mod 4, or 1 and 2)
  // and its 16 rows in each sub-block.
  const int wg = warp >> 2, wr = warp & 3;
  const int np16 = (Pt + 15) / 16;  // 16-column pairs of P in this tile

  const bf16* xb = x + b * xs.b + h * xs.h + p0;
  const bf16* bb = bm + b * bs.b + g * bs.h;
  const bf16* cb = cm + b * cs.b + g * cs.h;
  const float* dtb = dt + b * dts.b + h * dts.h;
  bf16* yb = y + b * ys.b + h * ys.h + p0;

  for (int t0 = 0; t0 < S; t0 += Q) {
    // ---- stage the chunk: C, B and x rows once each, dt --------------------
    stage_rows<LDN>(sC, cb + t0 * cs.s, cs.s, Q, N, vec);
    stage_rows<LDN>(sB, bb + t0 * bs.s, bs.s, Q, N, vec);
    stage_rows<TC_LDP>(sX, xb + t0 * xs.s, xs.s, Q, Pt, vec);
    cp_async_commit();
    for (int i = tid; i < Q; i += TC_THREADS) sDt[i] = dtb[static_cast<long long>(t0 + i) * dts.s];
    cp_async_wait_all();
    __syncthreads();

    // ---- the inclusive cumsum of dt·A: one warp's scan ---------------------
    if (warp == 0) {
      const int per = (Q + 31) / 32;
      const int lo = lane * per, hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += sDt[i] * A;
        sCum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float before = incl - run;
      for (int i = lo; i < hi; ++i) sCum[i] += before;
    }
    __syncthreads();
    const float total = sCum[Q - 1];
    for (int i = tid; i < Qp; i += TC_THREADS) {
      const bool in = i < Q;
      const float c = in ? sCum[i] : 0.f;
      sEc[i] = in ? expf(c) : 0.f;
      sW[i] = in ? sDt[i] * expf(total - c) : 0.f;
      sL2[i] = c * LOG2E;
    }
    // h_prev into shared memory as bf16 hi + lo, for the inter term.
    if (t0 > 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = hn + n * 8 + (lane & 3) * 2;
        if (col >= NMAX) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = hp + (lane >> 2) + i * 8;
          const float v0 = hs[n][2 * i], v1 = hs[n][2 * i + 1];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(sHhi + row * LDN + col) = h2;
          *reinterpret_cast<uint32_t*>(sHlo + row * LDN + col) =
              pack_bf16(v0 - __low2float(h2), v1 - __high2float(h2));
        }
      }
    }
    __syncthreads();

    // ---- y, one 16-row slice of a sub-block per warp -------------------------
    for (int I = 0; I < nblk; ++I) {
      const bool mine = ((I & 3) == 0 || (I & 3) == 3) == (wg == 0);
      const int r0 = I * TC_ROWS + wr * 16;  // this warp's first row of the chunk
      if (!mine || r0 >= Q) continue;
      uint32_t cf[KN][4];  // C rows r0..r0+15 as A operands
#pragma unroll
      for (int kk = 0; kk < KN; ++kk)
        ldmatrix_x4(cf[kk], sC + (r0 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8);
      float yacc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;

      // inter: exp(cum_i) · C_i·h_prevᵀ, h_prev = hi + lo (zero on the first chunk)
      const int ri0 = r0 + (lane >> 2), ri1 = ri0 + 8;
      if (t0 > 0) {
#pragma unroll
        for (int kk = 0; kk < KN; ++kk)
#pragma unroll
          for (int n2 = 0; n2 < 4; ++n2) {
            if (n2 >= np16) continue;
            const int off = (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDN + kk * 16 +
                            ((lane >> 3) & 1) * 8;
            uint32_t bh[4], bl[4];
            ldmatrix_x4(bh, sHhi + off);
            ldmatrix_x4(bl, sHlo + off);
            mma_bf16(yacc[2 * n2], cf[kk], bh[0], bh[1]);
            mma_bf16(yacc[2 * n2], cf[kk], bl[0], bl[1]);
            mma_bf16(yacc[2 * n2 + 1], cf[kk], bh[2], bh[3]);
            mma_bf16(yacc[2 * n2 + 1], cf[kk], bl[2], bl[3]);
          }
        const float e0 = sEc[ri0], e1 = sEc[ri1];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          yacc[n][0] *= e0;
          yacc[n][1] *= e0;
          yacc[n][2] *= e1;
          yacc[n][3] *= e1;
        }
      }

      // intra: for each sub-block J <= I, (C_I·B_Jᵀ ⊙ L ⊙ dt_J) · x_J, the first
      // factor split into bf16 hi + lo
      const float l0 = sL2[ri0], l1 = sL2[ri1];
      for (int J = 0; J <= I; ++J) {
        const int j0 = J * TC_ROWS;
        const bool diag = J == I;
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN; ++kk)
#pragma unroll
          for (int n2 = 0; n2 < 4; ++n2) {
            if (diag && n2 > wr) continue;  // wholly above this warp's rows
            uint32_t bk[4];
            ldmatrix_x4(bk, sB + (j0 + n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDN + kk * 16 +
                                ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * n2], cf[kk], bk[0], bk[1]);
            mma_bf16(s[2 * n2 + 1], cf[kk], bk[2], bk[3]);
          }
        uint32_t phi[4][4], plo[4][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int cj = j0 + n * 8 + (lane & 3) * 2;
          const float d0 = sDt[cj], d1 = sDt[cj + 1];
          const float c0 = sL2[cj], c1 = sL2[cj + 1];
          const float v0 = cj <= ri0 && ri0 < Q ? s[n][0] * exp2f(l0 - c0) * d0 : 0.f;
          const float v1 = cj + 1 <= ri0 && ri0 < Q ? s[n][1] * exp2f(l0 - c1) * d1 : 0.f;
          const float v2 = cj <= ri1 && ri1 < Q ? s[n][2] * exp2f(l1 - c0) * d0 : 0.f;
          const float v3 = cj + 1 <= ri1 && ri1 < Q ? s[n][3] * exp2f(l1 - c1) * d1 : 0.f;
          split_pair(v0, v1, phi[n >> 1][(n & 1) * 2], plo[n >> 1][(n & 1) * 2]);
          split_pair(v2, v3, phi[n >> 1][(n & 1) * 2 + 1], plo[n >> 1][(n & 1) * 2 + 1]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (diag && kk > wr) continue;
          const bf16* xrow = sX + (j0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LDP;
#pragma unroll
          for (int n2 = 0; n2 < 4; ++n2) {
            if (n2 >= np16) continue;
            uint32_t bx[4];
            ldmatrix_x4_trans(bx, xrow + n2 * 16 + (lane >> 4) * 8);
            mma_bf16(yacc[2 * n2], phi[kk], bx[0], bx[1]);
            mma_bf16(yacc[2 * n2], plo[kk], bx[0], bx[1]);
            mma_bf16(yacc[2 * n2 + 1], phi[kk], bx[2], bx[3]);
            mma_bf16(yacc[2 * n2 + 1], plo[kk], bx[2], bx[3]);
          }
        }
      }

#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + (lane & 3) * 2;
        if (col >= Pt) continue;
        if (ri0 < Q)
          *reinterpret_cast<uint32_t*>(yb + static_cast<long long>(t0 + ri0) * ys.s + col) =
              pack_bf16(yacc[n][0], yacc[n][1]);
        if (ri1 < Q)
          *reinterpret_cast<uint32_t*>(yb + static_cast<long long>(t0 + ri1) * ys.s + col) =
              pack_bf16(yacc[n][2], yacc[n][3]);
      }
    }

    // ---- state update: h = h_prev exp(total) + (w ⊙ x)ᵀ·B, w ⊙ x = hi + lo ---
    if (h_active) {
      const float keep = expf(total);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[n][e] *= keep;
      const int kq_end = (Q + 15) / 16;
      for (int kq = 0; kq < kq_end; ++kq) {
        uint32_t xa[4], ahi[4], alo[4];  // (x rows of this chunk)ᵀ: m = p, k = q
        ldmatrix_x4_trans(xa, sX + (kq * 16 + (lane & 7) + (lane >> 4) * 8) * TC_LDP + hp +
                                  ((lane >> 3) & 1) * 8);
        const int q = kq * 16 + (lane & 3) * 2;
        const float w0 = sW[q], w1 = sW[q + 1], w8 = sW[q + 8], w9 = sW[q + 9];
        scale_split(xa[0], w0, w1, ahi[0], alo[0]);
        scale_split(xa[1], w0, w1, ahi[1], alo[1]);
        scale_split(xa[2], w8, w9, ahi[2], alo[2]);
        scale_split(xa[3], w8, w9, ahi[3], alo[3]);
        const bf16* brow = sB + (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN;
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          if (hn + n2 * 16 >= NMAX) continue;
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, brow + hn + n2 * 16 + (lane >> 4) * 8);
          mma_bf16(hs[2 * n2], ahi, bq[0], bq[1]);
          mma_bf16(hs[2 * n2], alo, bq[0], bq[1]);
          mma_bf16(hs[2 * n2 + 1], ahi, bq[2], bq[3]);
          mma_bf16(hs[2 * n2 + 1], alo, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // every read of this chunk's tiles is done before the next loads
  }

  if (h_active) {
    float* hb = hout + (static_cast<long long>(b) * H + h) * P * N;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = hn + n * 8 + (lane & 3) * 2;
      if (col >= N) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = hp + (lane >> 2) + i * 8;
        if (row < Pt)
          *reinterpret_cast<float2*>(hb + static_cast<long long>(p0 + row) * N + col) =
              make_float2(hs[n][2 * i], hs[n][2 * i + 1]);
      }
    }
  }
}

// The widest copy (16, 8 or 4 bytes) that every row of a [B, S, H-or-G, n]
// bf16 operand allows: its pointer, the strides of every dimension longer
// than 1 and the row's bytes must all be multiples of it; 0 if none is.
int copy_bytes(const void* p, const Strides& st, int nb, int ns, int nh, int n) {
  const long long e = static_cast<long long>(sizeof(bf16));
  for (int vec = 16; vec >= 4; vec /= 2) {
    if (reinterpret_cast<uintptr_t>(p) % vec == 0 && (nb == 1 || st.b * e % vec == 0) &&
        (ns == 1 || st.s * e % vec == 0) && (nh == 1 || st.h * e % vec == 0) && n * e % vec == 0)
      return vec;
  }
  return 0;
}

template <int NMAX>
int launch_tc(const void* x, const void* dt, const void* a, const void* bm, const void* cm, void* y,
              void* hout, int B, int S, int H, int G, int P, int N, int Q, Strides xs,
              Strides dts, Strides bs, Strides cs, Strides ys, cudaStream_t stream) {
  int vec = copy_bytes(x, xs, B, S, H, P);
  const int vb = copy_bytes(bm, bs, B, S, G, N), vc = copy_bytes(cm, cs, B, S, G, N);
  vec = vb < vec ? vb : vec;
  vec = vc < vec ? vc : vec;
  if (vec == 0 || reinterpret_cast<uintptr_t>(y) % 4 || reinterpret_cast<uintptr_t>(hout) % 8)
    return -4;
  const int bytes = smem_bytes_tc(NMAX, Q);
  if (bytes > MAX_SMEM) return -3;
  static int opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (bytes > opted_in[dev]) {
    err = cudaFuncSetAttribute(ssd_kernel_tc<NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = bytes;
  }
  dim3 grid((P + TC_P - 1) / TC_P, H, B);
  ssd_kernel_tc<NMAX><<<grid, TC_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const bf16*>(bm), static_cast<const bf16*>(cm), static_cast<bf16*>(y),
      static_cast<float*>(hout), S, H, G, P, N, Q, vec, xs, dts, bs, cs, ys);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                void* y, void* hout, int B, int S, int H, int G, int P, int N, int Q, Strides xs,
                Strides dts, Strides bs, Strides cs, Strides ys, cudaStream_t st) {
  if (N <= 32) return launch_tc<32>(x, dt, a, bm, cm, y, hout, B, S, H, G, P, N, Q, xs, dts, bs, cs, ys, st);
  if (N <= 64) return launch_tc<64>(x, dt, a, bm, cm, y, hout, B, S, H, G, P, N, Q, xs, dts, bs, cs, ys, st);
  if (N <= 128) return launch_tc<128>(x, dt, a, bm, cm, y, hout, B, S, H, G, P, N, Q, xs, dts, bs, cs, ys, st);
  return -2;
}

}  // namespace

extern "C" {

// dtype (of x, B, C and y): 0 = float32 (CUDA-core kernel), 1 = bfloat16
// (tensor-core kernel); dt and a are float32, h_final is a contiguous
// float32 [B, H, P, N].  Strides in elements, in [B, S, H-or-G] order.
// Returns 0, a cudaError_t from the launch, -1 (dtype), -2 (shape: N > 128,
// Q not dividing S, G not dividing H), -3 (the chunk needs more shared
// memory than a block has) or -4 (bf16: a row of x, B or C not 4-byte
// aligned).
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
    return dispatch_tc(x, dt, a, bm, cm, y, h_final, B, S, H, G, P, N, Q, xs, dts, bs, cs, ys, st);
  return -1;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
