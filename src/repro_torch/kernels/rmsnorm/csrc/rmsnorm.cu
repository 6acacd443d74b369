// Fused RMSNorm for sm_90a: out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas kernel of repro/kernels/rmsnorm/kernel.py (rmsnorm ->
// _rmsnorm_kernel), which loads a (block_n, D) tile into VMEM, reduces each
// row in fp32 and writes it back.  Here there is no sequential grid to carry
// a tile: each row is owned by a fixed group of threads of one block (the
// whole 256-thread block for D >= 1024, one warp for a shorter row, 8 rows
// to a block), which reads the row with 16-byte vector loads, sums the
// squares in fp32 (lane-strided loop, then a fixed shuffle tree and, for a
// block-wide row, one pass through shared memory), and writes the scaled
// row once in x's dtype.  The second read of the row, for the write pass,
// hits L1/L2: a row is at most 32 KB.  The reduction order is fixed, so two
// runs give the same bits.
//
// Bound: memory.  A call must read x (N*D elements) and scale (D) once and
// write N*D elements: (2*N*D + D)*sizeof(T) bytes, against 3*N*D
// fp32 operations, far below the card's operations-per-byte balance.
//
// Types: x, scale and out all bf16 or all float32, any D >= 1.
// x's rows may be strided (the last position of a prefill batch is read in
// place); out is contiguous.  Vector loads when D and x's row stride are
// multiples of 16 bytes and the pointers 16-byte aligned, scalar loads
// otherwise.  Launches on the caller's stream, allocates nothing, never
// synchronizes; the entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarp = 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ROWS rows per block; each row is owned by kBlock / ROWS threads.
template <typename T, int ROWS, bool VEC>
__global__ void __launch_bounds__(kBlock)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int64_t n_rows, int d, int64_t ld,
               float eps) {
  constexpr int kThreads = kBlock / ROWS;
  constexpr int kVec = 16 / sizeof(T);
  const int sub = threadIdx.x / kThreads;
  const int t = threadIdx.x % kThreads;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS + sub;
  const bool live = row < n_rows;
  const T* xr = x + row * ld;
  T* orow = out + row * d;

  float ss = 0.f;
  if (live) {
    if (VEC) {
      const int nv = d / kVec;
      for (int i = t; i < nv; i += kThreads) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr) + i);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float f = to_float(e[j]);
          ss += f * f;
        }
      }
    } else {
      for (int i = t; i < d; i += kThreads) {
        const float f = to_float(xr[i]);
        ss += f * f;
      }
    }
  }
  constexpr int kLanes = kThreads < kWarp ? kThreads : kWarp;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (kThreads > kWarp) {
    constexpr int kWarpsPerRow = kThreads / kWarp;
    __shared__ float partial[kBlock / kWarp];
    if (threadIdx.x % kWarp == 0) partial[threadIdx.x / kWarp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerRow; ++w) {
      ss += partial[sub * kWarpsPerRow + w];
    }
  }
  if (!live) return;

  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  if (VEC) {
    const int nv = d / kVec;
    for (int i = t; i < nv; i += kThreads) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xr) + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        o[j] = from_float<T>(to_float(e[j]) * r *
                             to_float(scale[i * kVec + j]));
      }
      reinterpret_cast<uint4*>(orow)[i] = packed;
    }
  } else {
    for (int i = t; i < d; i += kThreads) {
      orow[i] = from_float<T>(to_float(xr[i]) * r * to_float(scale[i]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int64_t n_rows,
           int64_t d, int64_t ld, float eps, cudaStream_t stream) {
  const bool vec = (d * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   (ld * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool wide = d >= 1024;
  const int rows = wide ? 1 : 8;
  const unsigned blocks = static_cast<unsigned>((n_rows + rows - 1) / rows);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
  const int di = static_cast<int>(d);
  if (wide && vec) {
    rmsnorm_kernel<T, 1, true><<<blocks, kBlock, 0, stream>>>(
        xp, sp, op, n_rows, di, ld, eps);
  } else if (wide) {
    rmsnorm_kernel<T, 1, false><<<blocks, kBlock, 0, stream>>>(
        xp, sp, op, n_rows, di, ld, eps);
  } else if (vec) {
    rmsnorm_kernel<T, 8, true><<<blocks, kBlock, 0, stream>>>(
        xp, sp, op, n_rows, di, ld, eps);
  } else {
    rmsnorm_kernel<T, 8, false><<<blocks, kBlock, 0, stream>>>(
        xp, sp, op, n_rows, di, ld, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (n_rows, d) with row stride ld (elements); out: (n_rows, d)
// contiguous; scale: (d,) of x's dtype.  dtype codes: 0 = float32,
// 1 = bfloat16.  n_rows >= 1, 1 <= d < 2^31, ld >= d.
int rmsnorm_forward(const void* x, const void* scale, void* out,
                    int64_t n_rows, int64_t d, int64_t ld, float eps,
                    int dtype, void* stream) {
  if (n_rows <= 0 || d <= 0 || d > INT32_MAX || ld < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, scale, out, n_rows, d, ld, eps, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, scale, out, n_rows, d, ld, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
