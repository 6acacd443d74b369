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
// register; it walks time itself.  Neighbouring threads take neighbouring
// w, so every load and store of a warp is one 128-byte line.  The ragged
// end of W is masked (threads past it return) and the ragged end of S is
// masked inside the loop: no padded copies.
//
// Bound: bytes (a and b read once, y written once: 12 bytes per element;
// one multiply and one add per element is far below the float32 rate).
// The recurrence is serial in t, so a thread has one dependent chain; what
// keeps memory busy is the loads in flight.  Each thread issues the loads of
// the next kAhead steps (2 * kAhead independent loads) before it runs the
// current kAhead steps' dependent multiply-adds.  At recurrentgemma-2b's
// prefill shape (4, 1024, 2560) there are only B*W = 10,240 columns: 80
// blocks of 128 threads on 132 SMs, so the kernel is bound by the latency
// of those loads, not by the card's byte rate.  Splitting S into chunks
// (per-chunk products of a and partial states, a carry pass, a fix-up) is
// the next step.
//
// Rounding: each step is a float32 multiply, rounded, then an add, rounded
// (__fmul_rn / __fadd_rn keep the compiler from contracting them into an
// FMA), which is what the plain PyTorch version computes; the two agree bit
// for bit.
//
// Launches on the caller's stream, allocates nothing, never synchronizes;
// the entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 16;

__device__ __forceinline__ void load_steps(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int t0, int seq, int64_t width,
                                           float* va, float* vb) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int t = t0 + i;
    if (t < seq) {
      va[i] = __ldg(a + t * width);
      vb[i] = __ldg(b + t * width);
    } else {
      va[i] = 1.f;
      vb[i] = 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, int seq, int64_t width) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= width) return;
  const int64_t bi = blockIdx.y;
  const int64_t col = bi * seq * width + w;
  a += col;
  b += col;
  y += col;
  float h = h0 != nullptr ? h0[bi * width + w] : 0.f;

  float cur_a[kAhead], cur_b[kAhead];
  load_steps(a, b, 0, seq, width, cur_a, cur_b);
  for (int t0 = 0; t0 < seq; t0 += kAhead) {
    // the next steps' loads go out before this chunk's dependent chain
    float nxt_a[kAhead], nxt_b[kAhead];
    load_steps(a, b, t0 + kAhead, seq, width, nxt_a, nxt_b);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = t0 + i;
      if (t < seq) {
        h = __fadd_rn(__fmul_rn(cur_a[i], h), cur_b[i]);
        y[t * width] = h;
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      cur_a[i] = nxt_a[i];
      cur_b[i] = nxt_b[i];
    }
  }
  h_last[bi * width + w] = h;
}

}  // namespace

extern "C" {

// a, b, y (B, S, W) and h0, h_last (B, W), all float32, contiguous, on the
// device; h0 may be null (a zero initial state).  S >= 1.
int lru_scan_forward(const void* a, const void* b, const void* h0, void* y,
                     void* h_last, int64_t batch, int64_t seq, int64_t width,
                     void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0 || batch > 65535 ||
      seq > INT32_MAX / 2 || (width + kThreads - 1) / kThreads > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((width + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  lru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), static_cast<int>(seq), width);
  return static_cast<int>(cudaGetLastError());
}

const char* lru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
