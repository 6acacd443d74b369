// The gradient of the fused RMSNorm for sm_90a.
//
// Forward (rmsnorm.cu): out = x * r * scale, r = rsqrt(mean(x^2) + eps), in
// fp32.  Backward, in fp32 throughout, with xh = x * r and g = dy * scale:
//   dx     = r * (g - xh * mean(g * xh))      (per row)
//   dscale = sum over rows of dy * xh         (per column)
//
// Replaces no Pallas kernel: the Pallas RMSNorm (repro/kernels/rmsnorm/
// kernel.py) has no custom_vjp, and the reference trains through jax.grad
// of its plain layer (repro/models/layers.py::rmsnorm).  The port's model
// runs the forward kernel on the card, so its gradient is a kernel too.
//
// Bound: memory.  A call must read x and dy (2 * N * D elements) and scale,
// and write dx (N * D) and dscale: about 3 * N * D * sizeof(T) bytes, against
// ~10 fp32 operations an element, far below the card's balance.
//
// Design, deterministic (no atomics; every sum in a fixed order):
// * rmsnorm_backward_kernel<T, ROWS, VEC, SMEM>: a block of 256 threads owns
//   rows_per_block consecutive rows (the wrapper picks it from N alone, so the
//   same shape gives the same grouping and the same bits on every card).
//   ROWS rows are in flight at once, each on 256 / ROWS threads: ROWS = 1 for
//   D >= 1024 (the model widths), 8 (a warp a row) for narrower rows such as a
//   per-head q/k norm.  A row takes two passes over its columns: the first
//   sums x^2 and g * x (a shuffle tree, then the warps' partials in order),
//   the second writes dx and adds dy * xh into the thread's own columns of a
//   per-row-slot accumulator.  A thread owns the same columns in every row,
//   so the accumulator needs no barrier; the second read of the row hits L1.
//   The accumulator lives in shared memory (ROWS * D floats, up to 48 KB) or,
//   for wider rows, in the block's row of the workspace (SMEM = false).  At
//   the end the block adds its row slots in order into its workspace row.
// * rmsnorm_backward_dscale_kernel<T>: a thread a column adds the blocks'
//   workspace rows in block order and rounds once to T.
// Vector loads (16 bytes a thread) where D, both row strides and every
// pointer allow (VEC), else scalar.  Launches on the caller's stream,
// allocates nothing (the wrapper passes the fp32 workspace), never
// synchronizes; the entry point returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarp = 32;
constexpr int64_t kSmemBytes = 48 * 1024;

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

template <typename T, int ROWS, bool VEC, bool SMEM>
__global__ void __launch_bounds__(kBlock)
rmsnorm_backward_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, int64_t n_rows, int d,
                        int64_t ld_x, int64_t ld_dy, int64_t rows_per_block,
                        float eps) {
  constexpr int kThreads = kBlock / ROWS;
  constexpr int kVec = VEC ? 16 / sizeof(T) : 1;
  constexpr int kLanes = kThreads < kWarp ? kThreads : kWarp;
  constexpr int kWarpsPerRow = kThreads > kWarp ? kThreads / kWarp : 1;
  extern __shared__ float smem[];
  __shared__ float red_ss[kBlock / kWarp];
  __shared__ float red_gx[kBlock / kWarp];

  const int sub = threadIdx.x / kThreads;
  const int t = threadIdx.x % kThreads;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  int64_t row_end = row0 + rows_per_block;
  if (row_end > n_rows) row_end = n_rows;
  float* acc = SMEM ? smem + static_cast<int64_t>(sub) * d
                    : partial + static_cast<int64_t>(blockIdx.x) * d;
  const int n_vec = d / kVec;

  for (int i = t; i < n_vec; i += kThreads) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[i * kVec + e] = 0.f;
  }

  for (int64_t base = row0; base < row_end; base += ROWS) {
    const int64_t row = base + sub;
    const bool live = row < row_end;
    const T* xr = x + row * ld_x;
    const T* dyr = dy + row * ld_dy;
    float ss = 0.f, gx = 0.f;
    if (live) {
      for (int i = t; i < n_vec; i += kThreads) {
        float xv[kVec], dv[kVec], sv[kVec];
        if (VEC) {
          const uint4 rx = __ldg(reinterpret_cast<const uint4*>(xr) + i);
          const uint4 rd = __ldg(reinterpret_cast<const uint4*>(dyr) + i);
          const uint4 rs = __ldg(reinterpret_cast<const uint4*>(scale) + i);
          const T* ex = reinterpret_cast<const T*>(&rx);
          const T* ed = reinterpret_cast<const T*>(&rd);
          const T* es = reinterpret_cast<const T*>(&rs);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            xv[e] = to_float(ex[e]);
            dv[e] = to_float(ed[e]);
            sv[e] = to_float(es[e]);
          }
        } else {
          xv[0] = to_float(xr[i]);
          dv[0] = to_float(dyr[i]);
          sv[0] = to_float(scale[i]);
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ss += xv[e] * xv[e];
          gx += dv[e] * sv[e] * xv[e];
        }
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    if (kThreads > kWarp) {
      if (threadIdx.x % kWarp == 0) {
        red_ss[threadIdx.x / kWarp] = ss;
        red_gx[threadIdx.x / kWarp] = gx;
      }
      __syncthreads();
      ss = 0.f;
      gx = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsPerRow; ++w) {
        ss += red_ss[sub * kWarpsPerRow + w];
        gx += red_gx[sub * kWarpsPerRow + w];
      }
      __syncthreads();  // the partials are rewritten by the next row
    }
    if (!live) continue;
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    const float m = r * gx / static_cast<float>(d);  // mean(g * xh)
    T* dxr = dx + row * static_cast<int64_t>(d);
    for (int i = t; i < n_vec; i += kThreads) {
      float xv[kVec], dv[kVec], sv[kVec];
      if (VEC) {
        const uint4 rx = __ldg(reinterpret_cast<const uint4*>(xr) + i);
        const uint4 rd = __ldg(reinterpret_cast<const uint4*>(dyr) + i);
        const uint4 rs = __ldg(reinterpret_cast<const uint4*>(scale) + i);
        const T* ex = reinterpret_cast<const T*>(&rx);
        const T* ed = reinterpret_cast<const T*>(&rd);
        const T* es = reinterpret_cast<const T*>(&rs);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          xv[e] = to_float(ex[e]);
          dv[e] = to_float(ed[e]);
          sv[e] = to_float(es[e]);
        }
      } else {
        xv[0] = to_float(xr[i]);
        dv[0] = to_float(dyr[i]);
        sv[0] = to_float(scale[i]);
      }
      uint4 packed;
      T* out = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = xv[e] * r;
        out[e] = from_float<T>(r * (dv[e] * sv[e] - xh * m));
        acc[i * kVec + e] += dv[e] * xh;
      }
      if (VEC) {
        reinterpret_cast<uint4*>(dxr)[i] = packed;
      } else {
        dxr[i] = out[0];
      }
    }
  }

  if (SMEM) {
    // the row slots' sums, in slot order, into the block's workspace row
    __syncthreads();
    float* out = partial + static_cast<int64_t>(blockIdx.x) * d;
    for (int j = threadIdx.x; j < d; j += kBlock) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) s += smem[static_cast<int64_t>(k) * d + j];
      out[j] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
rmsnorm_backward_dscale_kernel(const float* __restrict__ partial,
                               T* __restrict__ dscale, int blocks, int d) {
  const int j = blockIdx.x * kBlock + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<int64_t>(b) * d + j];
  dscale[j] = from_float<T>(s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int ROWS, bool VEC>
void launch_rows(const T* x, const T* sp, const T* dy, T* dx, float* partial,
                 int64_t n_rows, int d, int64_t ld_x, int64_t ld_dy,
                 int64_t rpb, float eps, unsigned blocks, cudaStream_t s) {
  // the accumulator in shared memory where it fits; several row slots
  // always fit (ROWS > 1 only for d < 1024), and only one row slot may
  // accumulate in the workspace row itself
  const int64_t smem = static_cast<int64_t>(ROWS) * d * sizeof(float);
  if constexpr (ROWS > 1) {
    rmsnorm_backward_kernel<T, ROWS, VEC, true>
        <<<blocks, kBlock, static_cast<size_t>(smem), s>>>(
            x, sp, dy, dx, partial, n_rows, d, ld_x, ld_dy, rpb, eps);
  } else if (smem <= kSmemBytes) {
    rmsnorm_backward_kernel<T, 1, VEC, true>
        <<<blocks, kBlock, static_cast<size_t>(smem), s>>>(
            x, sp, dy, dx, partial, n_rows, d, ld_x, ld_dy, rpb, eps);
  } else {
    rmsnorm_backward_kernel<T, 1, VEC, false><<<blocks, kBlock, 0, s>>>(
        x, sp, dy, dx, partial, n_rows, d, ld_x, ld_dy, rpb, eps);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* dy, void* dx,
           void* dscale, float* partial, int64_t n_rows, int64_t d,
           int64_t ld_x, int64_t ld_dy, int64_t rpb, float eps,
           cudaStream_t s) {
  constexpr int64_t kVec = 16 / sizeof(T);
  const int rows = d < 1024 ? 8 : 1;
  if (rpb <= 0 || rpb % rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks64 = (n_rows + rpb - 1) / rpb;
  if (blocks64 > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>(blocks64);
  const bool vec = d % kVec == 0 && ld_x % kVec == 0 && ld_dy % kVec == 0 &&
                   aligned16(x) && aligned16(dy) && aligned16(dx) &&
                   aligned16(scale);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const int di = static_cast<int>(d);
  if (rows == 8 && vec) {
    launch_rows<T, 8, true>(xp, sp, dyp, dxp, partial, n_rows, di, ld_x,
                            ld_dy, rpb, eps, blocks, s);
  } else if (rows == 8) {
    launch_rows<T, 8, false>(xp, sp, dyp, dxp, partial, n_rows, di, ld_x,
                             ld_dy, rpb, eps, blocks, s);
  } else if (vec) {
    launch_rows<T, 1, true>(xp, sp, dyp, dxp, partial, n_rows, di, ld_x,
                            ld_dy, rpb, eps, blocks, s);
  } else {
    launch_rows<T, 1, false>(xp, sp, dyp, dxp, partial, n_rows, di, ld_x,
                             ld_dy, rpb, eps, blocks, s);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned cols = static_cast<unsigned>((d + kBlock - 1) / kBlock);
  rmsnorm_backward_dscale_kernel<T><<<cols, kBlock, 0, s>>>(
      partial, static_cast<T*>(dscale), static_cast<int>(blocks), di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (n_rows, d) with row stride ld_x, dy: (n_rows, d) with row stride
// ld_dy (elements); dx: (n_rows, d) contiguous; scale and dscale: (d,).
// All of one dtype (0 = float32, 1 = bfloat16).  partial: an fp32
// workspace of ceil(n_rows / rows_per_block) * d values, the blocks' sums
// of dscale (rows_per_block a multiple of 8 where d < 1024).  n_rows,
// d >= 1, d < 2^31.  The device is made current for the launches if it is
// not, and the previous one restored.
int rmsnorm_backward(const void* x, const void* scale, const void* dy,
                     void* dx, void* dscale, void* partial, int64_t n_rows,
                     int64_t d, int64_t ld_x, int64_t ld_dy,
                     int64_t rows_per_block, float eps, int dtype,
                     int device, void* stream) {
  if (n_rows <= 0 || d <= 0 || d > INT32_MAX || ld_x < d || ld_dy < d ||
      partial == nullptr || (dtype != 0 && dtype != 1)) {
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
  float* ws = static_cast<float*>(partial);
  const int rc =
      dtype == 0
          ? launch<float>(x, scale, dy, dx, dscale, ws, n_rows, d, ld_x,
                          ld_dy, rows_per_block, eps, s)
          : launch<__nv_bfloat16>(x, scale, dy, dx, dscale, ws, n_rows, d,
                                  ld_x, ld_dy, rows_per_block, eps, s);
  if (previous != device) cudaSetDevice(previous);
  return rc;
}

const char* rmsnorm_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
