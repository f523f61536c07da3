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
// An all-zero row gets scale 0 and q = 0 (0 / 1 = 0).  The input is fp32
// [nblocks, n] with no padding rows: the Pallas kernel's _ROWS = 32 padding
// is a TPU tiling fact, not part of the format.  Any n > 0 is taken.  The
// file is built without --use_fast_math, and the arithmetic uses the _rn
// intrinsics so the compiler can neither contract nor approximate it.
//
// Design.  One block of 256 threads per row of n (256 in the codec's
// default tag): a strided pass takes the row's absmax (a warp shuffle
// reduction, then one across the 8 warps through shared memory; max is exact
// in any order), then a second strided pass, which the first left in L1/L2,
// divides, clips, rounds and stores one byte per element.  Dequantize is
// the same grid: each thread converts its bytes and multiplies by the row's
// scale.
//
// What bounds it on an H100: bytes.  Quantize reads 4 bytes and writes 1 per
// element (+4 per row); dequantize reads 1 and writes 4.  At 3.35 TB/s a
// 19.7M-element moment shard (layers.blk.w_up under data=2,model=2) is ~29 us
// either way; the few operations per element are far below the card's rate.
// This first version issues 4-byte loads and 1-byte stores; wider vector
// accesses and several rows per block are the work of a later change.

#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

enum QKind { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };

template <int K>
__device__ __forceinline__ uint8_t encode(float y) {
  if constexpr (K == kInt8) {
    return static_cast<uint8_t>(static_cast<int8_t>(static_cast<int>(rintf(y))));
  } else {
    return __nv_cvt_float_to_fp8(y, __NV_SATFINITE, K == kE4M3 ? __NV_E4M3 : __NV_E5M2);
  }
}

template <int K>
__device__ __forceinline__ float decode(uint8_t b) {
  if constexpr (K == kInt8) {
    return static_cast<float>(static_cast<int8_t>(b));
  } else {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(b, K == kE4M3 ? __NV_E4M3 : __NV_E5M2);
    return __half2float(__half(h));  // every fp8 value is exact in half and in float
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                float* __restrict__ scales, int n, float fmax, float rcp) {
  const long long row = blockIdx.x;
  const float* xr = x + row * n;
  uint8_t* qr = q + row * n;

  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) m = fmaxf(m, fabsf(xr[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

  __shared__ float warp_max[WARPS];
  __shared__ float row_scale;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    float w = threadIdx.x < WARPS ? warp_max[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
    if (threadIdx.x == 0) {
      const float s = __fmul_rn(w, rcp);
      row_scale = s;
      scales[row] = s;
    }
  }
  __syncthreads();

  const float scale = row_scale;
  const float safe = scale > 0.f ? scale : 1.f;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const float y = fminf(fmaxf(__fdiv_rn(xr[i], safe), -fmax), fmax);
    qr[i] = encode<K>(y);
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

int check_shape(long long nblocks, int n) {
  return (n <= 0 || nblocks < 0 || nblocks > 0x7fffffffLL) ? -2 : 0;
}

}  // namespace

extern "C" {

// qkind: 0 = int8, 1 = float8_e4m3fn, 2 = float8_e5m2.  x: fp32 [nblocks, n];
// q: one byte per element [nblocks, n]; scales: fp32 [nblocks].
// Returns 0, a cudaError_t from the launch, -1 (qkind) or -2 (shape).
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

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
