// RG-LRU linear recurrence for sm_90a: y[b,t,w] = a[b,t,w] * y[b,t-1,w] +
// b[b,t,w] from y[b,-1,:] = h0 (zeros when h0 is null), float32 in and out,
// and h_last = y[:, S-1].
//
// Replaces the Pallas kernel of repro/kernels/rg_lru/kernel.py (lru_scan ->
// _lru_kernel).  That kernel walks a grid (B, W/bw, S/chunk) whose chunk
// axis is innermost and sequential, carries h in a VMEM scratch tile from
// one chunk to the next, and pads time with a = 1, b = 0 and width with
// zeros to whole blocks.  Blocks of a CUDA grid run in no order, so here a
// thread owns one (b, w) column for the whole sequence and keeps h in a
// register; it walks time itself.  Each warp takes 32 neighbouring columns
// and works alone: nothing is shared across warps, and there is no block
// barrier.  The ragged end of W is masked (columns past it are neither
// copied nor stored) and the ragged end of S too (a step past S is neither
// copied, run nor stored): no padded copies.
//
// Bound: bytes (a and b read once, y written once: 12 bytes per element;
// one multiply and one add per element is far below the float32 rate).
// The recurrence is serial in t, so a column's steps run one after the
// other, and what keeps memory busy is the requests in flight.  On the
// H100 a warp keeps only so many memory instructions in flight, whatever
// their width, and a 128-byte row of a warp's 32 columns is one request:
// with 4-byte moves (one row an instruction) the kernel takes 0.0772 ms at
// recurrentgemma-2b's prefill (4, 1024, 2560), the copies alone 0.0419 and
// the stores alone 0.0364; with 16-byte moves (4 rows an instruction)
// 0.0450, 0.0305 and 0.0258, against a byte bound of 0.0376 (device ms,
// tools/lru_scan_times.py --probe, an NVIDIA H100 80GB HBM3 at 700 W).
// So each warp moves its rows in 16-byte vectors, 4 rows an instruction:
//   - a ring of kStages slots of kSteps time steps of the warp's a and b
//     rows in shared memory, filled by cp.async (lane l copies row l / 8,
//     floats 4 (l % 8) to 4 (l % 8) + 3, of each group of 4 rows), keeps
//     kStages - 1 slots in flight while the warp runs the current one;
//   - each lane runs its own column's chain over the slot's steps and
//     writes y into a stage of rows in shared memory, which the warp then
//     stores with 16-byte vectors.
// Each lane waits for its own copies (cp.async.wait_group) and then the
// warp syncs (__syncwarp), so every lane's copies of the slot are in
// before any lane reads another's words.  Blocks are one warp (320 at
// recurrentgemma-2b's prefill), so every one of the 132 SMs holds
// columns.  Where W is not a multiple of 4 or a, b or y is not on 16
// bytes, the same kernel moves 4 bytes a lane, one row an instruction
// (the plan's vec 1).
//
// Rounding: each step is a float32 multiply, rounded, then an add, rounded
// (__fmul_rn / __fadd_rn keep the compiler from contracting them into an
// FMA), in time order from h0: what the plain PyTorch version computes, so
// the two agree bit for bit.
//
// Launches on the caller's stream, allocates nothing, never synchronizes;
// the entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the block and the ring (ops.THREADS, STAGES and STEPS): one warp a
// block, a ring of 4 slots of 16 time steps; the best of
// tools/lru_scan_times.py's sweep at recurrentgemma-2b's prefill (an
// NVIDIA H100 80GB HBM3 at 700 W), which builds copies of this file with
// other values
constexpr int kThreads = 32;
constexpr int kStages = 4;
constexpr int kSteps = 16;
// a block's shared memory: each warp's ring of a and b rows and its stage
// of y rows, float32 (18 KB)
constexpr int kShared = (kThreads / 32) * (2 * kStages + 1) * kSteps * 32 * 4;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kStages >= 2 && kSteps % 4 == 0, "whole 4-row groups");
static_assert(kShared <= 48 * 1024, "above 48 KB a block must opt in");

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int V>
__device__ __forceinline__ void copy(uint32_t dst, const float* src) {
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  // the memory clobber keeps the compiler from moving the ring's reads
  // above the wait
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kVec floats a lane in every copy and store: 4 (16 bytes; W a multiple
// of 4, a, b and y on 16 bytes) or 1
template <int kVec>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int seq, int64_t width) {
  using T = typename Vec<kVec>::T;
  // a warp's slot: kSteps rows of 32 floats of a, then of b; then the
  // warp's y stage, kSteps rows of 32
  constexpr int kSlot = 2 * kSteps * 32;
  constexpr int kWarpFloats = kStages * kSlot + kSteps * 32;
  // a copy or store instruction moves kRows rows: lane l takes row
  // l / kLanes of them, floats kVec * (l % kLanes) onward
  constexpr int kLanes = 32 / kVec;
  constexpr int kRows = kVec;
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kThreads + warp * 32;
  if (w0 >= width) return;   // the whole warp
  const int64_t bi = blockIdx.y;
  const int n_cols = width - w0 < 32 ? static_cast<int>(width - w0) : 32;

  // the chain: lane's own column
  const bool live = lane < n_cols;
  float h = live && h0 != nullptr ? h0[bi * width + w0 + lane] : 0.f;
  // the moves: this lane's row within an instruction's group and its
  // first float within the row
  const int mrow = lane / kLanes;
  const int mcol = kVec * (lane % kLanes);
  const bool mlive = mcol < n_cols;
  const int64_t row0 = bi * seq * width + w0 + mcol;   // (bi, 0, mcol)
  const float* const ga = a + row0;
  const float* const gb = b + row0;
  float* const gy = y + row0;

  float* const wring = ring + warp * kWarpFloats;
  float* const ystage = wring + kStages * kSlot;
  const uint32_t wring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(wring));
  const int n_stages = (seq + kSteps - 1) / kSteps;

  // copies stage `stage` (if there is one) into its slot and commits a
  // group either way, so group k always holds stage k
  auto issue = [&](int stage) {
    if (stage < n_stages && mlive) {
      const int t0 = stage * kSteps;
      const uint32_t dst =
          wring_s + 4u * static_cast<uint32_t>((stage % kStages) * kSlot +
                                               mrow * 32 + mcol);
#pragma unroll
      for (int r = 0; r < kSteps; r += kRows) {
        const int t = t0 + r + mrow;
        if (t < seq) {
          const uint32_t d = dst + 4u * static_cast<uint32_t>(r * 32);
          copy<kVec>(d, ga + t * width);
          copy<kVec>(d + 4u * kSteps * 32, gb + t * width);
        }
      }
    }
    commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int k = 0; k < n_stages; ++k) {
    wait_pending<kStages - 2>();   // this lane's copies of stage k are in
    __syncwarp();                  // and every other lane's
    // the slot refilled here was read in the last iteration, by every
    // lane before the sync above
    issue(k + kStages - 1);
    const float* s_a = wring + (k % kStages) * kSlot + lane;
    const int t0 = k * kSteps;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (t0 + i < seq) {
        h = __fadd_rn(__fmul_rn(s_a[i * 32], h), s_a[(kSteps + i) * 32]);
        ystage[i * 32 + lane] = h;
      }
    }
    __syncwarp();   // the stage's y rows are in
    if (mlive) {
#pragma unroll
      for (int r = 0; r < kSteps; r += kRows) {
        const int t = t0 + r + mrow;
        if (t < seq) {
          *reinterpret_cast<T*>(gy + t * width) =
              *reinterpret_cast<const T*>(ystage + (r + mrow) * 32 + mcol);
        }
      }
    }
    // the next stage's y rows are written after the sync at its top, when
    // every lane has read these
  }
  if (live) h_last[bi * width + w0 + lane] = h;
}

template <int kVec>
int launch(const float* a, const float* b, const float* h0, float* y,
           float* h_last, int64_t batch, int64_t seq, int64_t width,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((width + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  lru_scan_kernel<kVec><<<grid, kThreads, kShared, stream>>>(
      a, b, h0, y, h_last, static_cast<int>(seq), width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b, y (B, S, W) and h0, h_last (B, W), all float32, contiguous, on the
// device; h0 may be null (a zero initial state).  B, S and W (each >= 1, B
// at most 65,535) are integers in pointer-sized arguments, which ctypes
// converts faster than 64-bit integers (ops.LIBRARY).  word: the plan and
// the device, as ops.LAUNCH_WORD packs them, low bits first: floats a lane
// in each copy and store (3 bits: 4, where W is a multiple of 4 and a, b
// and y lie on 16 bytes, or 1) and the CUDA device (8 bits; made current
// for the launch if it is not, and the previous one restored).  A shape or
// a plan outside those returns cudaErrorInvalidValue and launches
// nothing.
int lru_scan_forward(const void* a, const void* b, const void* h0, void* y,
                     void* h_last, const void* batch_arg, const void* seq_arg,
                     const void* width_arg, const void* word_arg,
                     void* stream) {
  const int64_t batch =
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(batch_arg));
  const int64_t seq =
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(seq_arg));
  const int64_t width =
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(width_arg));
  const uint64_t word = reinterpret_cast<uintptr_t>(word_arg);
  const int vec = static_cast<int>(word & 7);
  const int device = static_cast<int>((word >> 3) & 255);
  if (batch <= 0 || seq <= 0 || width <= 0 || batch > 65535 ||
      seq > INT32_MAX / 2 || (width + kThreads - 1) / kThreads > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 4 ? (width % 4 != 0 ||
                  ((reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(y)) & 15) != 0)
               : vec != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int previous = -1;
  cudaError_t e = cudaGetDevice(&previous);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (previous != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  const auto* fh0 = static_cast<const float*>(h0);
  auto* fy = static_cast<float*>(y);
  auto* fh = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = vec == 4
                     ? launch<4>(fa, fb, fh0, fy, fh, batch, seq, width, s)
                     : launch<1>(fa, fb, fh0, fy, fh, batch, seq, width, s);
  if (previous != device) cudaSetDevice(previous);
  return rc;
}

const char* lru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
