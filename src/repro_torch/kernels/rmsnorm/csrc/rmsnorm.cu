// Fused RMSNorm for sm_90a: out = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the Pallas kernel of repro/kernels/rmsnorm/kernel.py (rmsnorm ->
// _rmsnorm_kernel), which loads a (block_n, D) tile into VMEM, reduces each
// row in fp32 and writes it back.  Here there is no sequential grid to carry
// a tile: each row is owned by a fixed group of threads of one block.
//
// Bound: memory.  A call must read x (N*D elements) and scale (D) once and
// write N*D elements: (2*N*D + D)*sizeof(T) bytes, against 3*N*D fp32
// operations, far below the card's operations-per-byte balance.  So the
// design moves each byte once and keeps enough of them in flight:
//
// * register route (rmsnorm_row_kernel<T, V>): one row a block, D split
//   evenly over the block's threads, each holding V 16-byte vectors of the
//   row (neighbouring threads on neighbouring vectors).  A thread loads its
//   vectors of x and of scale once, into registers, sums the squares in
//   fp32, and after the block's reduction scales from those registers and
//   writes: the row is read once.  V comes from the wrapper's plan
//   (ops.plan), which picks it so that every thread holds the same number
//   of vectors and the block (D / V vectors) is whole warps.  At the serve
//   paths' widths a block holds 160-256 threads and an SM 8-12 rows, so
//   60-120 KB of loads are in flight on each SM.
// * loop route (rmsnorm_kernel<T, 1, VEC>): for a row wider than the
//   register route holds, or one whose rows or pointers are not 16-byte
//   aligned (scalar loads): the whole 256-thread block loops over the row
//   twice, summing squares, then writing; the second read hits L1/L2.
// * narrow route (rmsnorm_kernel<T, 8, VEC>): D < 1024, such as a per-head
//   q/k norm: one warp a row, 8 rows a block.
//
// The reduction order is fixed (each thread's vectors in order, a shuffle
// tree, then the warps' partial sums in order), so two runs give the same
// bits; there are no atomics.  Types: x, scale and out all bf16 or all
// float32, any D >= 1.  x's rows may be strided (the last position of a
// prefill batch is read in place); out is contiguous.  Launches on the
// caller's stream, allocates nothing, never synchronizes; the entry point
// makes the given device current for the launch only when it is not
// already, and returns cudaGetLastError() of its launch.  Its arguments
// are few (ops.LAUNCH_WORD packs the static ones into one word): at
// decode the host's work, ctypes' conversions included, is most of a
// call's time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarp = 32;
constexpr int kMaxRowThreads = 512;

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

// One row a block; blockDim.x (a multiple of 32) threads each hold V
// 16-byte vectors: thread t holds vectors t, t + blockDim.x, ...
template <typename T, int V>
__global__ void __launch_bounds__(kMaxRowThreads)
rmsnorm_row_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, int d, int64_t ld, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int t = threadIdx.x;
  const int stride = blockDim.x;
  const int64_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * ld);
  const uint4* sv = reinterpret_cast<const uint4*>(scale);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);

  uint4 xv[V], scv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) xv[i] = __ldg(xr + t + i * stride);
#pragma unroll
  for (int i = 0; i < V; ++i) scv[i] = __ldg(sv + t + i * stride);

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const T* e = reinterpret_cast<const T*>(&xv[i]);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = to_float(e[j]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  __shared__ float partial[kMaxRowThreads / kWarp];
  if (t % kWarp == 0) partial[t / kWarp] = ss;
  __syncthreads();
  const int warps = stride / kWarp;
  ss = 0.f;
  for (int w = 0; w < warps; ++w) ss += partial[w];

  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const T* e = reinterpret_cast<const T*>(&xv[i]);
    const T* sc = reinterpret_cast<const T*>(&scv[i]);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      o[j] = from_float<T>(to_float(e[j]) * r * to_float(sc[j]));
    }
    orow[t + i * stride] = packed;
  }
}

// ROWS rows per block; each row is owned by kBlock / ROWS threads, which
// loop over it twice (sum of squares, then the scaled write).
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

// Route codes, as ops.ROUTE_CODES (route 3 is refused).
constexpr int kRouteRegister = 0;
constexpr int kRouteLoop = 1;
constexpr int kRouteNarrow = 2;

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int64_t n_rows,
           int64_t d, int64_t ld, float eps, int route, int vecs,
           cudaStream_t stream) {
  constexpr int64_t kVec = 16 / sizeof(T);
  // vector loads of x and out (and, on the register route, of scale) need
  // 16-byte rows and pointers
  const bool vec = d % kVec == 0 && ld % kVec == 0 && aligned16(x) &&
                   aligned16(out);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
  const int di = static_cast<int>(d);
  if (route == kRouteRegister) {
    // the block: the row's vectors split evenly, vecs to a thread, in
    // whole warps within the launch bound
    const int64_t threads = vecs > 0 ? d / (vecs * kVec) : 0;
    if (!vec || !aligned16(scale) || threads * vecs * kVec != d ||
        threads <= 0 || threads % kWarp != 0 || threads > kMaxRowThreads ||
        n_rows > INT32_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const unsigned blocks = static_cast<unsigned>(n_rows);
    const unsigned block = static_cast<unsigned>(threads);
    switch (vecs) {
      case 1:
        rmsnorm_row_kernel<T, 1><<<blocks, block, 0, stream>>>(
            xp, sp, op, di, ld, eps);
        break;
      case 2:
        rmsnorm_row_kernel<T, 2><<<blocks, block, 0, stream>>>(
            xp, sp, op, di, ld, eps);
        break;
      case 4:
        rmsnorm_row_kernel<T, 4><<<blocks, block, 0, stream>>>(
            xp, sp, op, di, ld, eps);
        break;
      case 8:
        rmsnorm_row_kernel<T, 8><<<blocks, block, 0, stream>>>(
            xp, sp, op, di, ld, eps);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // the loop and narrow routes: a kBlock-thread block, vector loads where
  // the rows and pointers allow them
  if ((route != kRouteLoop && route != kRouteNarrow) || vecs != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = route == kRouteLoop ? 1 : 8;
  const unsigned blocks = static_cast<unsigned>((n_rows + rows - 1) / rows);
  if (route == kRouteLoop && vec) {
    rmsnorm_kernel<T, 1, true><<<blocks, kBlock, 0, stream>>>(
        xp, sp, op, n_rows, di, ld, eps);
  } else if (route == kRouteLoop) {
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
// contiguous; scale: (d,) of x's dtype.  n_rows >= 1, ld >= d.  word:
// the rest of the call, as ops.LAUNCH_WORD packs it, low bits first: the
// dtype (1 bit: 0 = float32, 1 = bfloat16), the route (2 bits, as
// ops.ROUTE_CODES), vecs (4 bits: on the register route the 16-byte
// vectors a thread holds, the block then d / (vecs * values a vector)
// threads; 0 on the other two), the CUDA device (8 bits; made current
// for the launch if it is not, and the previous one restored) and d
// (31 bits, >= 1).  n_rows, ld and word are integers in pointer-sized
// arguments, which ctypes converts faster than 64-bit integers
// (ops.LIBRARY).  A plan that does not fit the call (an uneven split,
// unaligned vectors) returns cudaErrorInvalidValue and launches nothing.
int rmsnorm_forward(const void* x, const void* scale, void* out,
                    const void* n_rows_arg, const void* ld_arg, float eps,
                    const void* word_arg, void* stream) {
  const int64_t n_rows = static_cast<int64_t>(
      reinterpret_cast<uintptr_t>(n_rows_arg));
  const int64_t ld = static_cast<int64_t>(reinterpret_cast<uintptr_t>(ld_arg));
  const uint64_t word = reinterpret_cast<uintptr_t>(word_arg);
  const int dtype = static_cast<int>(word & 1);
  const int route = static_cast<int>((word >> 1) & 3);
  const int vecs = static_cast<int>((word >> 3) & 15);
  const int device = static_cast<int>((word >> 7) & 255);
  const int64_t d = static_cast<int64_t>(word >> 15);
  if (n_rows <= 0 || d <= 0 || ld < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int previous = -1;
  cudaError_t e = cudaGetDevice(&previous);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (previous != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc =
      dtype == 0
          ? launch<float>(x, scale, out, n_rows, d, ld, eps, route, vecs, s)
          : launch<__nv_bfloat16>(x, scale, out, n_rows, d, ld, eps, route,
                                  vecs, s);
  if (previous != device) cudaSetDevice(previous);
  return rc;
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
