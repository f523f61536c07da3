// Block quantize and dequantize for Hopper (sm_90a), plain C entry points
// for ctypes.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/block_quant/kernel.py::quantize_blocks_pallas   (body _quantize_kernel)
//   src/repro/kernels/block_quant/kernel.py::dequantize_blocks_pallas (body _dequantize_kernel)
// and computes the format that the reference's codec writes, bit for bit
// (the checkpoint digests hash these bytes):
//
//   scale = absmax(row) * rcp      rcp = fl32(1 / fmax), passed by the caller:
//                                  the reference's jitted codec multiplies by
//                                  the rounded reciprocal (XLA folds the
//                                  division by a constant), so a correctly
//                                  rounded division would differ in the last
//                                  bit of some scales;
//   safe  = scale > 0 ? scale : 1
//   y     = min(max(x / safe, -fmax), fmax)     (correctly rounded division)
//   q     = (int8) rint(y)                      int8: rint rounds half to even, as jnp.round
//         = cvt.rn.satfinite(y)                 fp8 e4m3 / e5m2: round to nearest even
//   x'    = (float) q * scale                   dequantize: one fp32 multiply
//
// An all-zero row gets scale 0 and q = 0 (0 / 1 = 0).  NaN and inf follow
// the reference: the absmax keeps a NaN (fmaxf would drop it), so the row's
// scale is NaN and safe is 1; the clip lets a NaN through, and it is stored
// as int8 0 or an fp8 NaN code (e4m3 0x7f | sign, e5m2 0x7e | sign, the
// reference's bytes; the sign is whatever the card's arithmetic left).  An
// inf makes the scale inf, so x / inf is ±0 and inf / inf NaN.  Either way
// the row decodes to NaN.  The input is fp32 [nblocks, n] with no padding
// rows: the Pallas kernel's _ROWS = 32 padding is a TPU tiling fact, not
// part of the format.  The file is built without --use_fast_math, and the
// arithmetic uses the _rn intrinsics so the compiler can neither contract
// nor approximate it.
//
// What bounds it on an H100: bytes.  Quantize reads 4 bytes and writes 1 per
// element (+4 per row); dequantize reads 1 and writes 4.  At 3.35 TB/s a
// 19.7M-element moment shard (layers.blk.w_up under data=2,model=2) is ~29 us
// either way; the ~20 operations per element (a correctly rounded division
// among them) are far below the card's rate.  So the design is about bytes
// in flight: by Little's law the card needs ~20 KB of loads outstanding on
// each SM.
//
// Two variants, chosen by the caller from the shape and pointers alone
// (kernel.py::variant):
//
// vector — rows of n = 8k <= 1024 elements whose base pointers are 16-byte
// aligned (the codec's b256 moments, the main path).  A group of G lanes
// holds one row in registers as runs of 4 elements ("quads", one float4
// load each), lane l of the group taking quads l, l + G, ...: G = 8, 16, 32
// lanes of 2 quads for n <= 64, 128, 256, and 32 lanes of 4 or 8 quads up
// to n = 512 and 1024.  So every load and store instruction of a warp
// covers one contiguous span (512 bytes of fp32, 128 of codes at n = 256).
// The absmax is log2(G) xor shuffles inside the group: no shared memory, no
// __syncthreads, no second read of x.  Each lane packs a quad's 4 codes
// (__float2int_rn for int8, two paired __nv_cvt_float2_to_fp8x2 for fp8)
// into one 4-byte store.  Blocks of 8 warps walk the rows grid-stride over
// a grid sized to the card's resident blocks, and each group issues the
// loads of its next row before the math of this one (2 KB a warp in flight
// at n = 256).  Dequantize is the same layout: a 4-byte load of codes per
// quad, the row's scale once, paired fp8 -> half2 -> float2 conversions,
// __fmul_rn, one float4 streaming store per quad.  A first layout of 8
// contiguous elements a lane (two float4 at a 32-byte stride, one 8-byte
// code access) left each store instruction's sectors half written and was
// about a third slower for dequantize on an H100; quantize timed the same
// either way.
//
// general — any other n or alignment (n = 100, a view one element off, rows
// above 1024): one block of 256 threads per row, a strided absmax pass
// (warp shuffles, then across the 8 warps through shared memory), then a
// second strided pass, which the first left in L1/L2, that divides, clips,
// rounds and stores one byte per element; dequantize the same grid.  This
// is the first design, kept for the shapes the vector kernels do not take.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC_MAX_N = 1024;

enum QKind { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };

template <int K>
__host__ __device__ constexpr __nv_fp8_interpretation_t fp8_kind() {
  return K == kE4M3 ? __NV_E4M3 : __NV_E5M2;
}

// max that keeps a NaN from either side (fmaxf returns the other operand)
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// clip to ±fmax, letting a NaN through (fminf/fmaxf would turn it into -fmax)
__device__ __forceinline__ float clip_keep_nan(float y, float fmax) {
  return y != y ? y : fminf(fmaxf(y, -fmax), fmax);
}

// fp8 NaN code with the value's sign: the reference's bytes
template <int K>
__device__ __forceinline__ uint32_t fp8_nan(float y) {
  return ((__float_as_uint(y) >> 24) & 0x80u) | (K == kE4M3 ? 0x7fu : 0x7eu);
}

template <int K>
__device__ __forceinline__ uint8_t encode(float y) {
  if constexpr (K == kInt8) {
    return y != y ? 0 : static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(y)));
  } else {
    if (y != y) return static_cast<uint8_t>(fp8_nan<K>(y));
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, fp8_kind<K>());
  }
}

template <int K>
__device__ __forceinline__ float decode(uint8_t b) {
  if constexpr (K == kInt8) {
    return static_cast<float>(static_cast<int8_t>(b));
  } else {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(b, fp8_kind<K>());
    return __half2float(__half(h));  // every fp8 value is exact in half and in float
  }
}

// ------------------------------------------------------------------ general

template <int K>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                float* __restrict__ scales, int n, float fmax, float rcp) {
  const long long row = blockIdx.x;
  const float* xr = x + row * n;
  uint8_t* qr = q + row * n;

  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) m = max_keep_nan(m, fabsf(xr[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max_keep_nan(m, __shfl_xor_sync(0xffffffffu, m, off));

  __shared__ float warp_max[WARPS];
  __shared__ float row_scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < WARPS ? warp_max[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w = max_keep_nan(w, __shfl_xor_sync(0xffffffffu, w, off));
    if (threadIdx.x == 0) {
      const float s = __fmul_rn(w, rcp);
      row_scale = s;
      scales[row] = s;
    }
  }
  __syncthreads();

  const float scale = row_scale;
  const float safe = scale > 0.f ? scale : 1.f;  // NaN > 0 is false, as in the reference
  for (int i = threadIdx.x; i < n; i += THREADS) {
    qr[i] = encode<K>(clip_keep_nan(__fdiv_rn(xr[i], safe), fmax));
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scales,
                  float* __restrict__ out, int n) {
  const long long row = blockIdx.x;
  const float s = scales[row];
  const uint8_t* qr = q + row * n;
  float* orow = out + row * n;
  for (int i = threadIdx.x; i < n; i += THREADS) orow[i] = __fmul_rn(decode<K>(qr[i]), s);
}

// ------------------------------------------------------------------- vector

// A row of n = 8k elements: LANES lanes (8, 16 or 32; a power of two, so
// the xor shuffles stay inside the group), QUADS runs of 4 elements a lane.
// Lane `sub` owns quads sub + LANES * j, so each load and store instruction
// of the group covers one contiguous span of the row (512 bytes of fp32 or
// 128 of codes a warp at n = 256).
template <int LANES_, int QUADS_>
struct RowShape {
  static constexpr int LANES = LANES_;
  static constexpr int QUADS = QUADS_;
  static constexpr int ROWS_PER_WARP = 32 / LANES;
};

// First element of lane `sub`'s quad j in its row.
template <typename S>
__device__ __forceinline__ int quad_at(int sub, int j) {
  return (sub + S::LANES * j) * 4;
}

// The walk over rows: warp w of the grid starts at row w * ROWS_PER_WARP,
// its groups take the rows after it, and all of it strides by every warp
// of the grid.  The loop runs on `base`, the warp's first row, so every lane
// of a warp takes the same trips (each shuffles); a group whose row is past
// the end computes on zeros and stores nothing.
template <typename S>
struct RowWalk {
  long long base, step;
  int group, sub;
  __device__ __forceinline__ RowWalk() {
    const int lane = threadIdx.x & 31;
    const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    base = warp * S::ROWS_PER_WARP;
    step = (static_cast<long long>(gridDim.x) * blockDim.x >> 5) * S::ROWS_PER_WARP;
    group = lane / S::LANES;
    sub = lane % S::LANES;
  }
};

template <typename S>
__device__ __forceinline__ void load_row(const float* __restrict__ x, long long row,
                                         long long nblocks, int n, int sub,
                                         float4 (&v)[S::QUADS]) {
#pragma unroll
  for (int j = 0; j < S::QUADS; ++j) {
    const int e = quad_at<S>(sub, j);
    v[j] = row < nblocks && e < n ? *reinterpret_cast<const float4*>(x + row * n + e)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Four codes in one word, the first in the low byte (memory order).
template <int K>
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  if constexpr (K == kInt8) {
    return static_cast<uint32_t>(encode<K>(a)) | static_cast<uint32_t>(encode<K>(b)) << 8 |
           static_cast<uint32_t>(encode<K>(c)) << 16 | static_cast<uint32_t>(encode<K>(d)) << 24;
  } else {
    // the paired conversion puts its first value in the low byte; a NaN
    // code is then overwritten with the reference's
    const uint32_t lo = __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE, fp8_kind<K>());
    const uint32_t hi = __nv_cvt_float2_to_fp8x2(make_float2(c, d), __NV_SATFINITE, fp8_kind<K>());
    uint32_t w = lo | hi << 16;
    const float y[4] = {a, b, c, d};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (y[i] != y[i]) w = (w & ~(0xffu << (8 * i))) | fp8_nan<K>(y[i]) << (8 * i);
    }
    return w;
  }
}

template <int K, typename S>
__device__ __forceinline__ void quantize_row(const float4 (&v)[S::QUADS], long long row,
                                             long long nblocks, int n, int sub,
                                             uint8_t* __restrict__ q, float* __restrict__ scales,
                                             float fmax, float rcp) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < S::QUADS; ++j) {
    m = max_keep_nan(m, fabsf(v[j].x));
    m = max_keep_nan(m, fabsf(v[j].y));
    m = max_keep_nan(m, fabsf(v[j].z));
    m = max_keep_nan(m, fabsf(v[j].w));
  }
#pragma unroll
  for (int off = S::LANES / 2; off > 0; off >>= 1) {
    m = max_keep_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (row >= nblocks) return;
  const float scale = __fmul_rn(m, rcp);
  const float safe = scale > 0.f ? scale : 1.f;  // NaN > 0 is false, as in the reference
  if (sub == 0) scales[row] = scale;
#pragma unroll
  for (int j = 0; j < S::QUADS; ++j) {
    const int e = quad_at<S>(sub, j);
    if (e < n) {
      *reinterpret_cast<uint32_t*>(q + row * n + e) = pack4<K>(
          clip_keep_nan(__fdiv_rn(v[j].x, safe), fmax), clip_keep_nan(__fdiv_rn(v[j].y, safe), fmax),
          clip_keep_nan(__fdiv_rn(v[j].z, safe), fmax), clip_keep_nan(__fdiv_rn(v[j].w, safe), fmax));
    }
  }
}

template <int K, typename S>
__global__ void __launch_bounds__(THREADS)
quantize_vec_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                    float* __restrict__ scales, long long nblocks, int n, float fmax, float rcp) {
  const RowWalk<S> w;
  float4 cur[S::QUADS];
  load_row<S>(x, w.base + w.group, nblocks, n, w.sub, cur);
  for (long long base = w.base; base < nblocks; base += w.step) {
    const long long row = base + w.group;
    float4 nxt[S::QUADS];  // the next row's loads go out before this row's math
    load_row<S>(x, row + w.step, nblocks, n, w.sub, nxt);
    quantize_row<K, S>(cur, row, nblocks, n, w.sub, q, scales, fmax, rcp);
#pragma unroll
    for (int j = 0; j < S::QUADS; ++j) cur[j] = nxt[j];
  }
}

// Four floats of four codes (the low byte first), times the row's scale.
template <int K>
__device__ __forceinline__ float4 unpack4(uint32_t w, float s) {
  float4 f;
  if constexpr (K == kInt8) {
    f = make_float4(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                    static_cast<float>(static_cast<int8_t>((w >> 8) & 0xffu)),
                    static_cast<float>(static_cast<int8_t>((w >> 16) & 0xffu)),
                    static_cast<float>(static_cast<int8_t>(w >> 24)));
  } else {
    // fp8x2 -> half2 keeps the low byte in .x; every fp8 value is exact in
    // half and in float
    const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), fp8_kind<K>())));
    const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), fp8_kind<K>())));
    f = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return make_float4(__fmul_rn(f.x, s), __fmul_rn(f.y, s), __fmul_rn(f.z, s), __fmul_rn(f.w, s));
}

template <typename S>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ q,
                                           const float* __restrict__ scales, long long row,
                                           long long nblocks, int n, int sub,
                                           uint32_t (&v)[S::QUADS], float& s) {
  s = row < nblocks ? scales[row] : 0.f;
#pragma unroll
  for (int j = 0; j < S::QUADS; ++j) {
    const int e = quad_at<S>(sub, j);
    v[j] = row < nblocks && e < n ? *reinterpret_cast<const uint32_t*>(q + row * n + e) : 0u;
  }
}

// The fp32 output is written with streaming stores (__stcs: evict first),
// since nothing here reads it back.
template <int K, typename S>
__global__ void __launch_bounds__(THREADS)
dequantize_vec_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scales,
                      float* __restrict__ out, long long nblocks, int n) {
  const RowWalk<S> w;
  uint32_t cur[S::QUADS];
  float s;
  load_codes<S>(q, scales, w.base + w.group, nblocks, n, w.sub, cur, s);
  for (long long base = w.base; base < nblocks; base += w.step) {
    const long long row = base + w.group;
    uint32_t nxt[S::QUADS];
    float s_nxt;
    load_codes<S>(q, scales, row + w.step, nblocks, n, w.sub, nxt, s_nxt);
    if (row < nblocks) {
#pragma unroll
      for (int j = 0; j < S::QUADS; ++j) {
        const int e = quad_at<S>(w.sub, j);
        if (e < n) __stcs(reinterpret_cast<float4*>(out + row * n + e), unpack4<K>(cur[j], s));
      }
    }
#pragma unroll
    for (int j = 0; j < S::QUADS; ++j) cur[j] = nxt[j];
    s = s_nxt;
  }
}

int check_shape(long long nblocks, int n) {
  return (n <= 0 || nblocks < 0 || nblocks > 0x7fffffffLL) ? -2 : 0;
}

int check_vector(long long nblocks, int n, const void* a, const void* b) {
  if (n <= 0 || n % 8 != 0 || n > VEC_MAX_N || nblocks < 0) return -2;
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0) return -3;
  return 0;
}

// Blocks the card holds at once of one kernel (THREADS a block).
long long resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  return static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
}

// Blocks for `rows` rows at ROWS_PER_WARP a warp, at most as many as the
// card holds at once: the grid stride takes the rest.
template <typename S>
unsigned vector_grid(long long rows, long long resident) {
  const long long rows_per_block = static_cast<long long>(WARPS) * S::ROWS_PER_WARP;
  const long long need = (rows + rows_per_block - 1) / rows_per_block;
  return static_cast<unsigned>(need < resident ? need : resident);
}

template <int K, typename S>
void launch_quantize_vec(const float* x, uint8_t* q, float* scales, long long nblocks, int n,
                         float fmax, float rcp, cudaStream_t st) {
  static const long long resident =
      resident_blocks(reinterpret_cast<const void*>(quantize_vec_kernel<K, S>));
  quantize_vec_kernel<K, S><<<vector_grid<S>(nblocks, resident), THREADS, 0, st>>>(
      x, q, scales, nblocks, n, fmax, rcp);
}

template <int K, typename S>
void launch_dequantize_vec(const uint8_t* q, const float* scales, float* out, long long nblocks,
                           int n, cudaStream_t st) {
  static const long long resident =
      resident_blocks(reinterpret_cast<const void*>(dequantize_vec_kernel<K, S>));
  dequantize_vec_kernel<K, S><<<vector_grid<S>(nblocks, resident), THREADS, 0, st>>>(
      q, scales, out, nblocks, n);
}

// The row shape for n = 8k <= VEC_MAX_N: 8, 16 or 32 lanes of two quads up
// to n = 256, then 32 lanes of 4 or 8 quads.
template <int K>
void quantize_vec(const float* x, uint8_t* q, float* scales, long long nblocks, int n,
                  float fmax, float rcp, cudaStream_t st) {
  const int quads = n / 4;
  if (quads <= 16) launch_quantize_vec<K, RowShape<8, 2>>(x, q, scales, nblocks, n, fmax, rcp, st);
  else if (quads <= 32) launch_quantize_vec<K, RowShape<16, 2>>(x, q, scales, nblocks, n, fmax, rcp, st);
  else if (quads <= 64) launch_quantize_vec<K, RowShape<32, 2>>(x, q, scales, nblocks, n, fmax, rcp, st);
  else if (quads <= 128) launch_quantize_vec<K, RowShape<32, 4>>(x, q, scales, nblocks, n, fmax, rcp, st);
  else launch_quantize_vec<K, RowShape<32, 8>>(x, q, scales, nblocks, n, fmax, rcp, st);
}

template <int K>
void dequantize_vec(const uint8_t* q, const float* scales, float* out, long long nblocks, int n,
                    cudaStream_t st) {
  const int quads = n / 4;
  if (quads <= 16) launch_dequantize_vec<K, RowShape<8, 2>>(q, scales, out, nblocks, n, st);
  else if (quads <= 32) launch_dequantize_vec<K, RowShape<16, 2>>(q, scales, out, nblocks, n, st);
  else if (quads <= 64) launch_dequantize_vec<K, RowShape<32, 2>>(q, scales, out, nblocks, n, st);
  else if (quads <= 128) launch_dequantize_vec<K, RowShape<32, 4>>(q, scales, out, nblocks, n, st);
  else launch_dequantize_vec<K, RowShape<32, 8>>(q, scales, out, nblocks, n, st);
}

}  // namespace

extern "C" {

// qkind: 0 = int8, 1 = float8_e4m3fn, 2 = float8_e5m2.  x: fp32 [nblocks, n];
// q: one byte per element [nblocks, n]; scales: fp32 [nblocks].
// Returns 0, a cudaError_t from the launch, -1 (qkind) or -2 (shape).
// The general kernels: any n > 0, any alignment.
int repro_block_quantize(const float* x, void* q, float* scales, long long nblocks, int n,
                         int qkind, float fmax, float rcp, void* stream) {
  if (int bad = check_shape(nblocks, n)) return bad;
  if (nblocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* qb = static_cast<uint8_t*>(q);
  const dim3 grid(static_cast<unsigned>(nblocks));
  switch (qkind) {
    case kInt8: quantize_kernel<kInt8><<<grid, THREADS, 0, st>>>(x, qb, scales, n, fmax, rcp); break;
    case kE4M3: quantize_kernel<kE4M3><<<grid, THREADS, 0, st>>>(x, qb, scales, n, fmax, rcp); break;
    case kE5M2: quantize_kernel<kE5M2><<<grid, THREADS, 0, st>>>(x, qb, scales, n, fmax, rcp); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// out: fp32 [nblocks, n] (the padded tail of the last row included).
int repro_block_dequantize(const void* q, const float* scales, float* out, long long nblocks,
                           int n, int qkind, void* stream) {
  if (int bad = check_shape(nblocks, n)) return bad;
  if (nblocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  const dim3 grid(static_cast<unsigned>(nblocks));
  switch (qkind) {
    case kInt8: dequantize_kernel<kInt8><<<grid, THREADS, 0, st>>>(qb, scales, out, n); break;
    case kE4M3: dequantize_kernel<kE4M3><<<grid, THREADS, 0, st>>>(qb, scales, out, n); break;
    case kE5M2: dequantize_kernel<kE5M2><<<grid, THREADS, 0, st>>>(qb, scales, out, n); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// The vector kernels, the same arguments: n a multiple of 8 up to 1024, and
// x and q (quantize) or q and out (dequantize) 16-byte aligned; -2 (shape)
// or -3 (alignment) otherwise.
int repro_block_quantize_vec(const float* x, void* q, float* scales, long long nblocks, int n,
                             int qkind, float fmax, float rcp, void* stream) {
  if (int bad = check_vector(nblocks, n, x, q)) return bad;
  if (nblocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* qb = static_cast<uint8_t*>(q);
  switch (qkind) {
    case kInt8: quantize_vec<kInt8>(x, qb, scales, nblocks, n, fmax, rcp, st); break;
    case kE4M3: quantize_vec<kE4M3>(x, qb, scales, nblocks, n, fmax, rcp, st); break;
    case kE5M2: quantize_vec<kE5M2>(x, qb, scales, nblocks, n, fmax, rcp, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_block_dequantize_vec(const void* q, const float* scales, float* out,
                               long long nblocks, int n, int qkind, void* stream) {
  if (int bad = check_vector(nblocks, n, q, out)) return bad;
  if (nblocks == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* qb = static_cast<const uint8_t*>(q);
  switch (qkind) {
    case kInt8: dequantize_vec<kInt8>(qb, scales, out, nblocks, n, st); break;
    case kE4M3: dequantize_vec<kE4M3>(qb, scales, out, nblocks, n, st); break;
    case kE5M2: dequantize_vec<kE5M2>(qb, scales, out, nblocks, n, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
