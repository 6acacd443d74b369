// Deterministic COO segment reductions in float64 for sm_90a.
//
// Replaces the Pallas kernels of repro/kernels/segment_fairshare/kernel.py
// (segment_sum -> _segment_sum_kernel, segment_min -> _segment_min_kernel).
// The Pallas kernels contract a one-hot (entries x segments) mask on the
// TPU's vector and matrix units; on Hopper that would read every entry once
// per segment tile.  Here the incidence is fixed for a whole solve, so the
// caller builds a plan once (ops.py::make_plan): a stable permutation that
// orders the entries by segment (omitted when the ids are already sorted),
// CSR offsets into that order, and G, the lanes a segment, a power of two
// from 1 to 32 sized to the mean segment length (ops.py::lanes_for).
//
// Each segment is reduced by a group of G lanes of one warp: lane l adds
// the segment's entries l, l + G, l + 2G, ... in order, from the identity;
// then a shuffle tree of width G (G/2 down to 1); lane 0 writes the result.
// The order of the operations is a function of G alone (not of the block
// or the grid), and ref.py::segment_sum_ordered_ref repeats it.  No
// atomics, so two runs give the same bits.  At G = 32 this is one warp a
// segment.  Where no segment is longer than G, the width-G tree gives the
// 32-lane tree's bits: the lanes it leaves out hold +0.0 (+inf for the
// min), which change nothing, since a lane's sum is never -0.0.
//
// Bound: memory.  Per call the kernel reads each value once (8 B), each
// permutation entry once (4 B), the offsets (4 B per segment) and writes
// the output (8 B per segment); it does one add or min per entry.  One
// warp a segment (G = 32) left 28 of 32 lanes idle on the sim's flow
// column (598,302 segments of at most 4 entries): 74,788 blocks in some 71
// waves of resident warps, each a chain of two dependent loads, 5 shuffle
// steps and a store.  With G = 4 the same column is 9,349 blocks, about 9
// waves.  The edge column (30 entries a segment) keeps G = 32.
//
// Launches on the caller's stream, allocates nothing, never synchronizes;
// each entry point makes the given device current for the launch only if
// it is not, and returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

struct SumOp {
  __device__ static double identity() { return 0.0; }
  __device__ static double apply(double a, double b) { return a + b; }
};

struct MinOp {
  __device__ static double identity() { return INFINITY; }
  __device__ static double apply(double a, double b) { return fmin(a, b); }
};

template <typename Op, int G>
__global__ void __launch_bounds__(kBlock)
segment_reduce_kernel(const double* __restrict__ values,
                      const int32_t* __restrict__ perm,
                      const int32_t* __restrict__ offsets,
                      int64_t num_segments, double* __restrict__ out) {
  const int64_t seg =
      (static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x) / G;
  const int lane = threadIdx.x % G;
  // a warp may hold groups before and past the last segment: every lane
  // stays for the full-mask shuffles, only the loads and the store are
  // predicated
  const bool live = seg < num_segments;
  double acc = Op::identity();
  if (live) {
    const int64_t hi = offsets[seg + 1];
    for (int64_t i = offsets[seg] + lane; i < hi; i += G) {
      acc = Op::apply(acc, values[perm != nullptr ? perm[i] : i]);
    }
  }
#pragma unroll
  for (int off = G / 2; off > 0; off /= 2) {
    acc = Op::apply(acc, __shfl_down_sync(0xffffffffu, acc, off, G));
  }
  if (live && lane == 0) out[seg] = acc;
}

// Launches the instance of `lanes` lanes a segment, trying G = 32, 16, ...,
// 1 in turn; a count with no instance launches nothing.
template <typename Op, int G = 32>
cudaError_t launch_lanes(int lanes, const void* values, const void* perm,
                         const void* offsets, int64_t num_segments, void* out,
                         cudaStream_t stream) {
  if (lanes == G) {
    const int64_t blocks = (num_segments * G + kBlock - 1) / kBlock;
    segment_reduce_kernel<Op, G>
        <<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
            static_cast<const double*>(values),
            static_cast<const int32_t*>(perm),
            static_cast<const int32_t*>(offsets), num_segments,
            static_cast<double*>(out));
    return cudaGetLastError();
  }
  if constexpr (G > 1) {
    return launch_lanes<Op, G / 2>(lanes, values, perm, offsets,
                                   num_segments, out, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename Op>
int launch(const void* values, const void* perm, const void* offsets,
           int64_t num_segments, int lanes, int device, void* out,
           void* stream) {
  if (num_segments <= 0) return static_cast<int>(cudaSuccess);
  // at most 2**31 - 1 segments (ops.make_plan), so the grid fits
  if (num_segments > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int previous = -1;
  cudaError_t e = cudaGetDevice(&previous);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (previous != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = launch_lanes<Op>(lanes, values, perm, offsets, num_segments, out,
                       static_cast<cudaStream_t>(stream));
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// out[s] = sum of values[perm[i]] for i in [offsets[s], offsets[s+1]),
// with `lanes` (1, 2, 4, 8, 16 or 32) lanes a segment; any other count
// returns cudaErrorInvalidValue and launches nothing.  perm may be null
// (identity: the entries are already in segment order).  `device` is the
// CUDA device of every pointer and of the stream.
int segment_sum_f64(const void* values, const void* perm, const void* offsets,
                    int64_t num_segments, int lanes, int device, void* out,
                    void* stream) {
  return launch<SumOp>(values, perm, offsets, num_segments, lanes, device,
                       out, stream);
}

// out[s] = min of the same entries; +inf for an empty segment.
int segment_min_f64(const void* values, const void* perm, const void* offsets,
                    int64_t num_segments, int lanes, int device, void* out,
                    void* stream) {
  return launch<MinOp>(values, perm, offsets, num_segments, lanes, device,
                       out, stream);
}

const char* segment_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
