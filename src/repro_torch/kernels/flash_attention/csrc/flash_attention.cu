// Flash attention (blockwise online softmax) for sm_90a, with the model's
// position mask.  Three routes behind one function:
//
//   flash_attention_kernel_tc      bf16 calls with more than one query
//                                  position (Sq > 1): every prefill and
//                                  window wave of the served models;
//                                  tensor cores.
//   flash_attention_kernel_decode  every decode call (Sq = 1), bf16 and
//   (+ _combine)                   float32: the cache split over blocks,
//                                  then the splits merged; CUDA cores.
//   flash_attention_kernel         float32 calls with Sq > 1; CUDA cores.
//
// The wrapper (ops.py, `_route`) chooses among the three entry points from
// the dtype and Sq alone.  The tc and CUDA-core routes also write each
// row's natural-log LSE (the log-sum-exp of its scaled, attended scores;
// -1e30 for a row that attends no key) where the caller passes a buffer,
// for the backward (flash_attention_backward.cu) to reuse: one store a row
// after the output, which stays bit for bit the same.  The decode route
// writes none.  The tensor-core and copy helpers live in mma_sync.cuh,
// shared with the backward.
//
// Replaces the Pallas kernel of repro/kernels/flash_attention/kernel.py
// (flash_attention -> _attn_kernel).  That kernel walks the kv blocks as
// the innermost, sequential grid axis and keeps the running max,
// denominator and accumulator in VMEM scratch between grid steps.  Blocks
// of a CUDA grid run in no order, so no kernel here copies that grid: one
// block owns a tile of query rows for its whole life and loops over the kv
// tiles itself, with the softmax state on chip (the decode kernel splits
// the kv tiles over blocks and merges their states in a second pass).
//
// Work split (tc and the CUDA-core kernel).  A block serves one (batch b,
// kv head kh) and BR consecutive rows of the flattened (query position s,
// group member g) index r = s * G + g, where query head kh * G + g reads
// kv head kh (GQA, and MQA with one kv head; no repeated K/V is
// materialised).  So every query head of a group shares each K/V tile the
// block stages; the decode kernel serves a group's heads the same way.
//
// Mask: attend key j from the query at position qp iff kv_pos[j] >= 0,
// kv_pos[j] <= qp when causal, and qp - kv_pos[j] < window when a window is
// set.  The Pallas kernel's right-aligned contiguous layout is the case
// kv_pos = arange(Skv), q_pos = Skv - Sq + arange(Sq).  A tile of BK = 64
// keys that no row of the block can attend is skipped whole.  A row that
// attends no key at all (the model never builds one) gives zeros here,
// where the reference's softmax over all -1e30 scores gives the mean of v.
//
// flash_attention_kernel_tc (bf16, Sq > 1).  Bound: operations, 4 * Dh
// FLOPs per attended (query head, key) pair against the bf16 tensor cores
// (989 TFLOP/s dense); prefill is far above the card's ~295 FLOP/byte
// ridge.  The design (FlashAttention-2's forward on mma.sync):
//   * 4 warps and BR = 64 rows per block, each warp a 16-row strip; the
//     kv tiles of 64 keys come through a two-stage cp.async.cg ring in
//     shared memory (the next live tile's copies are issued before the
//     current tile's math).  Empty slots (kv_pos < 0) and the ragged end
//     are zero-filled by the copy itself: a ring cache's empty slot may
//     hold any bits, and 0 * NaN is NaN even under a -inf score.
//   * S = Q K^T on mma.sync.m16n8k16 (bf16 in, fp32 sums): Q's A fragments
//     by ldmatrix.x4 from the Q tile (loaded once, rows padded by 8
//     elements so ldmatrix rows fall in distinct banks; read from shared
//     memory at every k-step rather than held, which keeps head dim 256
//     in registers), K's B fragments by ldmatrix (K is (key, d) row-major,
//     that is, the column-major B).
//   * Mask and online softmax in registers: a thread holds rows lane/4 and
//     lane/4 + 8 of its strip; scale * log2(e) is folded into S, exp2f;
//     the row max reduces over the quad; a tile that every row attends
//     whole skips the per-element mask.
//   * O += P V: P is rounded to bf16 in registers and used directly as the
//     A operand (the C fragments of two adjacent n-tiles are one A
//     fragment); V's B fragments by ldmatrix.trans; the fp32 accumulator
//     (16 x Dh per warp: Dh / 2 registers a thread, 128 at Dh = 256) is
//     rescaled by exp2(m_old - m_new) per row.  Output acc / l in bf16.
//   * The kv-tile liveness (any row attends; every row attends) is read
//     from kv_pos 2,048 keys at a time by each warp with warp votes, so
//     the ring can prefetch the next live tile without a block barrier.
//   * Causal calls launch the row tiles heaviest first.
//   Shared memory: Q (64, Dh + 8) and the ring 2 x 2 x (64, Dh + 8) bf16,
//   87.6 KB at Dh = 128 (two blocks per SM), 169.5 KB at Dh = 256 (one).
//   Not yet: wgmma, TMA, warp specialisation.
//
// flash_attention_kernel (float32, Sq > 1).  Bound: operations against
// the 67 TFLOP/s of the CUDA cores.  BR = 64 for long query runs (32 at
// Dh = 256, where 64 rows would hold a (64, 256) fp32 accumulator of 128
// registers a thread), 16 for short ones.
// Per kv tile of BK = 64 keys, 128 threads:
//   0. the tile's kv positions are read; a tile no row can attend is
//      skipped, its K/V never loaded;
//   1. K and V are staged in shared memory as fp32 (16-byte loads through
//      the caller's strides, so the ring cache's (B, cap, K, Dh) layout is
//      read in place); S = Q K^T * scale on CUDA cores, each thread a
//      (BR/16) x 8 micro-tile, masked to -inf;
//   2. online softmax per row: m_new = max(m, rowmax S), P = exp(S - m_new),
//      l = l * exp(m - m_new) + rowsum P;
//   3. acc = acc * exp(m - m_new) + P V, each thread a (BR/16) x (Dh/8)
//      micro-tile of the (BR, Dh) accumulator.
// It is exact in float32 (no TF32).
//
// flash_attention_kernel_decode (Sq = 1, bf16 and float32).  Bound: bytes,
// the attended keys' K and V read once: decode does about G operations a
// byte of cache (6-10 in the served models), far under the card's ~295
// FLOP/byte ridge.  One block for each (batch, kv head) walking the whole
// cache gave 1-32 blocks on 132 SMs, so the design (FlashDecoding's split
// KV) spreads the keys instead:
//   * grid (splits * ceil(G / ROWS), K, B): a block serves one (b, kh),
//     ROWS query heads of the group (8 for G <= 8, as the served dense and
//     MoE models' 8 and 6, else 16, as recurrentgemma-2b's 10) and one
//     contiguous split of ceil(Skv / splits) slots.  The wrapper chooses
//     splits (ops.decode_splits) for at least two blocks per SM where the
//     cache allows, each split whole 32-key tiles.
//   * 8 warps walk their split in tiles of 32 keys (a warp's lanes).  K
//     and V come through a two-stage cp.async.cg ring (16-byte copies
//     through the caller's strides, the ring cache read in place), issued
//     before the tile's kv positions are read: each warp reads them and
//     votes, so every warp holds the tile's mask with no barrier.  A key
//     the query does not attend (an empty slot, which may hold NaN, among
//     them) gets a -inf score and its V row is zeroed in shared memory, so
//     its bits never meet a multiply; a tile with none attended is skipped
//     whole.
//   * On CUDA cores in fp32: S = Q K^T with lane = key and each warp one
//     range of Dh for every row (the ranges' partial sums added in order);
//     the online softmax in log2 units, one warp a row; O += P V with a
//     thread 16 bytes of Dh for its rows, and where a block has more
//     threads than (row, 16 bytes) pairs, the keys dealt out over groups
//     whose accumulators are added in order at the end.  The loops run
//     over all ROWS rows, the zero rows past the group's end too: no
//     branch between the rows' independent sums.  Each split writes its
//     rows' (m, l, o) to a workspace that the wrapper allocates.
//   * flash_attention_kernel_decode_combine, a block per output row,
//     merges the row's splits in split order (M = max m_s, out = sum
//     2^(m_s - M) o_s / sum 2^(m_s - M) l_s): no float atomics, so the
//     same inputs give the same bits.  A split that attends nothing
//     carries l = 0 and adds nothing.
//   Shared memory: the ring 2 x 2 x (32, Dh + 16 B), Q (ROWS, Dh) fp32,
//   the partial scores and weights: 57 KB at bf16 Dh = 128 with 8 rows,
//   103 KB at Dh = 256 with 16.
//
// Types: bf16 (tc, decode) or float32 (decode, flash_attention_kernel)
// in, fp32 inside, output in q's dtype; Dh in {16, 32, 64, 128, 256}.  Every kernel launches on the caller's stream,
// allocates nothing and never synchronizes; each entry point returns
// cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 64;

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

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* q_pos;   // (Sq,)
  const int32_t* kv_pos;  // (Skv,), < 0 = empty slot
  // element strides: batch, sequence, head (the head dimension is
  // contiguous); q's and o's head stride steps over the flattened kh*G+g
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int sq, skv, g;
  int causal;
  int window;  // 0 = no window
  float scale;
  // each row's natural-log LSE, (B, K, Sq * G) fp32, or null: written by
  // the simt and tc routes when given (the backward's saved LSE)
  float* lse;
};

// 16 bytes of T from global memory, as kVec floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = to_float(e[i]);
}

template <int DH, int BR>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BR * (DH + 1) + kBK * (DH + 1) + kBK * DH +
                          BR * (kBK + 1) + 3 * BR) +
         sizeof(int) * (BR + kBK + 2);
}

// The dynamic shared memory a kernel may take beyond 48 KB is an attribute
// of the function on the current device: each launcher opts in once for
// each device, through its own `configured` flags.
constexpr int kMaxDevices = 64;

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool (&configured)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kMaxDevices && configured[device]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kMaxDevices) configured[device] = true;
  return 0;
}

template <typename T, int DH, int BR>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int QS = DH + 1;    // padded row strides (bank spread)
  constexpr int PS = kBK + 1;
  constexpr int RPT = BR / 16;  // rows per thread in the micro-tiles
  constexpr int CPT = kBK / 8;  // score columns per thread
  constexpr int DPT = DH / 8;   // output dims per thread
  constexpr int TPR = kThreads / BR;  // threads per row in the softmax

  extern __shared__ float smem[];
  float* q_s = smem;                 // (BR, QS)
  float* k_s = q_s + BR * QS;        // (BK, QS)
  float* v_s = k_s + kBK * QS;       // (BK, DH)
  float* p_s = v_s + kBK * DH;       // (BR, PS) scores, then weights
  float* m_s = p_s + BR * PS;        // (BR,) running max
  float* l_s = m_s + BR;             // (BR,) running denominator
  float* c_s = l_s + BR;             // (BR,) this tile's correction
  int* qpos_s = reinterpret_cast<int*>(c_s + BR);  // (BR,)
  int* kpos_s = qpos_s + BR;                       // (BK,)
  int* qrange_s = kpos_s + kBK;                    // min, max q position

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows = p.sq * p.g;
  const int row0 = blockIdx.x * BR;
  const int live_rows = min(BR, rows - row0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  // Q tile, row positions, softmax state
  for (int idx = tid; idx < BR * (DH / kVec); idx += kThreads) {
    const int r = idx / (DH / kVec);
    const int d = (idx % (DH / kVec)) * kVec;
    float val[kVec];
    if (r < live_rows) {
      const int fr = row0 + r;
      const int s = fr / p.g;
      const int h = kh * p.g + fr % p.g;
      load_vec<T>(q + b * p.q_sb + s * p.q_ss + h * p.q_sh + d, val);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) val[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) q_s[r * QS + d + i] = val[i];
  }
  for (int r = tid; r < BR; r += kThreads) {
    qpos_s[r] = p.q_pos[(row0 + (r < live_rows ? r : 0)) / p.g];
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = qpos_s[0], hi = qpos_s[0];
    for (int r = 1; r < live_rows; ++r) {
      lo = min(lo, qpos_s[r]);
      hi = max(hi, qpos_s[r]);
    }
    qrange_s[0] = lo;
    qrange_s[1] = hi;
  }
  __syncthreads();
  const int q_lo = qrange_s[0];
  const int q_hi = qrange_s[1];

  const int ty = tid / 8;  // micro-tile row group (16)
  const int tx = tid % 8;  // micro-tile column group (8)
  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < p.skv; kv0 += kBK) {
    // 0. positions of the tile; skip it if no row can attend any key
    bool any = false;
    if (tid < kBK) {
      const int j = kv0 + tid;
      const int kp = j < p.skv ? p.kv_pos[j] : -1;
      kpos_s[tid] = kp;
      any = kp >= 0 && (!p.causal || kp <= q_hi) &&
            (p.window <= 0 || q_lo - kp < p.window);
    }
    if (!__syncthreads_or(any)) continue;

    // 1. stage K and V (empty slots and the ragged end as zeros)
    for (int idx = tid; idx < kBK * (DH / kVec); idx += kThreads) {
      const int c = idx / (DH / kVec);
      const int d = (idx % (DH / kVec)) * kVec;
      float kf[kVec], vf[kVec];
      if (kpos_s[c] >= 0) {
        const int64_t j = kv0 + c;
        load_vec<T>(k + b * p.k_sb + j * p.k_ss + kh * p.k_sh + d, kf);
        load_vec<T>(v + b * p.v_sb + j * p.v_ss + kh * p.v_sh + d, vf);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        k_s[c * QS + d + i] = kf[i];
        v_s[c * DH + d + i] = vf[i];
      }
    }
    __syncthreads();

    // S = Q K^T * scale, masked
    {
      float s[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
      }
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        float qv[RPT], kv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ty * RPT + i) * QS + d];
#pragma unroll
        for (int j = 0; j < CPT; ++j) kv[j] = k_s[(tx + 8 * j) * QS + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty * RPT + i;
        const int qp = qpos_s[r];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + 8 * j;
          const int kp = kpos_s[c];
          const bool ok = kp >= 0 && (!p.causal || kp <= qp) &&
                          (p.window <= 0 || qp - kp < p.window);
          p_s[r * PS + c] = ok ? s[i][j] * p.scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // 2. online softmax, TPR consecutive lanes per row
    {
      const int r = tid / TPR;
      const int t = tid % TPR;
      const float m_old = m_s[r];
      const float l_old = l_s[r];
      float mx = -INFINITY;
      for (int c = t; c < kBK; c += TPR) mx = fmaxf(mx, p_s[r * PS + c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = t; c < kBK; c += TPR) {
        const float e =
            m_new == -INFINITY ? 0.f : expf(p_s[r * PS + c] - m_new);
        p_s[r * PS + c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      __syncwarp();
      if (t == 0) {
        const float corr = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        c_s[r] = corr;
        m_s[r] = m_new;
        l_s[r] = l_old * corr + sum;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = c_s[ty * RPT + i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[(ty * RPT + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = v_s[c * DH + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (p.lse != nullptr) {
    float* lse = p.lse + (static_cast<int64_t>(b) * gridDim.y + kh) * rows +
                 row0;
    for (int r = tid; r < live_rows; r += kThreads) {
      lse[r] = l_s[r] > 0.f ? m_s[r] + logf(l_s[r]) : kLseEmpty;
    }
  }
  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    if (r >= live_rows) continue;
    const int fr = row0 + r;
    const int s = fr / p.g;
    const int h = kh * p.g + fr % p.g;
    const float l = l_s[r];
    T* orow = o + b * p.o_sb + s * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      orow[tx + 8 * j] = from_float<T>(l > 0.f ? acc[i][j] / l : 0.f);
    }
  }
}

template <typename T, int DH, int BR>
int launch_tile(const Params& p, int batch, int kv_heads,
                cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH, BR>();
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(flash_attention_kernel<T, DH, BR>, bytes,
                             configured);
  if (err != 0) return err;
  const int rows = p.sq * p.g;
  const dim3 grid((rows + BR - 1) / BR, kv_heads, batch);
  flash_attention_kernel<T, DH, BR><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_dh(const Params& p, int batch, int kv_heads, cudaStream_t stream) {
  constexpr int kLongRows = DH >= 256 ? 32 : 64;
  if (p.sq * p.g >= 1024) {
    return launch_tile<T, DH, kLongRows>(p, batch, kv_heads, stream);
  }
  return launch_tile<T, DH, 16>(p, batch, kv_heads, stream);
}

template <typename T>
int launch(const Params& p, int batch, int kv_heads, int dh,
           cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_dh<T, 16>(p, batch, kv_heads, stream);
    case 32: return launch_dh<T, 32>(p, batch, kv_heads, stream);
    case 64: return launch_dh<T, 64>(p, batch, kv_heads, stream);
    case 128: return launch_dh<T, 128>(p, batch, kv_heads, stream);
    case 256: return launch_dh<T, 256>(p, batch, kv_heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// flash_attention_kernel_tc: bf16, Sq > 1, on the tensor cores.

using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;  // rows of the flattened (s, g) index a block

template <int DH>
struct TcShape {
  static constexpr int kStride = DH + 8;  // padded row, in elements
  static constexpr int kTile = kBK * kStride;
  // Q tile, then the ring's K and V tiles (2 stages each), then the
  // ring's kv positions
  static constexpr size_t kSmem =
      sizeof(bf16) * (kTcRows * kStride + 4 * kTile) + sizeof(int) * 2 * kBK;
};

__device__ __forceinline__ bool attends(int kp, int qp, const Params& p) {
  return kp >= 0 && (!p.causal || kp <= qp) &&
         (p.window <= 0 || qp - kp < p.window);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, DH >= 256 ? 1 : 2)
flash_attention_kernel_tc(const Params p) {
  using S = TcShape<DH>;
  constexpr int RS = S::kStride;
  constexpr int KSTEPS = DH / 16;  // k-steps of S = Q K^T
  constexpr int NT = kBK / 8;      // n-tiles of S (8 keys each)
  constexpr int DT = DH / 8;       // n-tiles of O (8 dims each)
  static_assert(DH % 16 == 0, "head dim");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // (64, RS)
  bf16* k_s = q_s + kTcRows * RS;                  // 2 x (64, RS)
  bf16* v_s = k_s + 2 * S::kTile;                  // 2 x (64, RS)
  int* kpos_s = reinterpret_cast<int*>(v_s + 2 * S::kTile);  // 2 x 64

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows = p.sq * p.g;
  // causal calls: the last row tiles attend the most keys; start them first
  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = tile * kTcRows;
  const int live_rows = min(kTcRows, rows - row0);
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  // the Q tile, once (rows past the end as zeros)
  for (int i = tid; i < kTcRows * (DH / 8); i += kThreads) {
    const int r = i / (DH / 8), d = (i % (DH / 8)) * 8;
    const bool ok = r < live_rows;
    const int fr = row0 + (ok ? r : 0);
    const int s = fr / p.g;
    const int h = kh * p.g + fr % p.g;
    cp_async16(q_s + r * RS + d,
               q + b * p.q_sb + s * p.q_ss + h * p.q_sh + d, ok);
  }

  // the positions of this thread's two rows, and the block's range
  const int r_lo = warp * 16 + lane / 4;
  const int qp0 = p.q_pos[(row0 + min(r_lo, live_rows - 1)) / p.g];
  const int qp1 = p.q_pos[(row0 + min(r_lo + 8, live_rows - 1)) / p.g];
  int q_lo, q_hi;
  {
    const int a = p.q_pos[(row0 + min(lane, live_rows - 1)) / p.g];
    const int c = p.q_pos[(row0 + min(lane + 32, live_rows - 1)) / p.g];
    q_lo = min(a, c);
    q_hi = max(a, c);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      q_lo = min(q_lo, __shfl_xor_sync(0xffffffffu, q_lo, off));
      q_hi = max(q_hi, __shfl_xor_sync(0xffffffffu, q_hi, off));
    }
  }

  // the next kv tile at or after t that some row attends (ntiles if none)
  const int ntiles = (p.skv + kBK - 1) / kBK;
  int chunk = -1;
  uint32_t live = 0u, full = 0u;
  auto next_live = [&](int t, bool& whole) {
    while (t < ntiles) {
      const int c = t / 32;
      if (c != chunk) {
        scan_kv_tiles<kBK>(p.kv_pos, p.skv, p.causal, p.window, c,
                           q_lo, q_hi, live, full);
        chunk = c;
      }
      const uint32_t rest = live >> (t % 32);
      if (rest) {
        t += __ffs(rest) - 1;
        whole = (full >> (t % 32)) & 1u;
        return t;
      }
      t = (c + 1) * 32;
    }
    return ntiles;
  };

  // K and V of tile t into ring slot `stage`, empty slots and the ragged
  // end zero-filled by the copy
  auto load_kv = [&](int stage, int t) {
    const int j0 = t * kBK;
    bf16* ks = k_s + stage * S::kTile;
    bf16* vs = v_s + stage * S::kTile;
    if (tid < kBK) {
      kpos_s[stage * kBK + tid] =
          j0 + tid < p.skv ? p.kv_pos[j0 + tid] : -1;
    }
    for (int i = tid; i < kBK * (DH / 8); i += kThreads) {
      const int c = i / (DH / 8), d = (i % (DH / 8)) * 8;
      const int64_t j = j0 + c;
      const bool ok = j < p.skv && __ldg(p.kv_pos + j) >= 0;
      cp_async16(ks + c * RS + d, ok ? k + j * p.k_ss + d : k, ok);
      cp_async16(vs + c * RS + d, ok ? v + j * p.v_ss + d : v, ok);
    }
  };

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float scale_log2 = p.scale * 1.4426950408889634f;

  bool cur_whole = false;
  int cur = next_live(0, cur_whole);
  if (cur < ntiles) load_kv(0, cur);
  cp_async_commit();  // with the Q tile
  int stage = 0;
  while (cur < ntiles) {
    bool nxt_whole = false;
    const int nxt = next_live(cur + 1, nxt_whole);
    if (nxt < ntiles) load_kv(stage ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copies just issued
    __syncthreads();

    const bf16* ks = k_s + stage * S::kTile;
    const bf16* vs = v_s + stage * S::kTile;
    const int* kp = kpos_s + stage * kBK;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (warp * 16 + lane % 16) * RS + kk * 16 +
                         (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * RS +
                           kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(sc[2 * np], a, r[0], r[1]);
        mma_bf16(sc[2 * np + 1], a, r[2], r[3]);
      }
    }

    // scale (in log2 units) and mask; this thread's keys are
    // 8n + 2 * (lane % 4) + {0, 1} of rows r_lo (e = 0, 1), r_lo + 8 (2, 3)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] *= scale_log2;
    }
    if (!cur_whole) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int2 kk2 =
            *reinterpret_cast<const int2*>(kp + n * 8 + 2 * (lane % 4));
        if (!attends(kk2.x, qp0, p)) sc[n][0] = -INFINITY;
        if (!attends(kk2.y, qp0, p)) sc[n][1] = -INFINITY;
        if (!attends(kk2.x, qp1, p)) sc[n][2] = -INFINITY;
        if (!attends(kk2.y, qp1, p)) sc[n][3] = -INFINITY;
      }
    }

    // online softmax: the row max over the quad, P = exp2(S - m)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[n][0], sc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with nothing attended so far keeps P = 0 and acc = 0
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float corr0 = exp2f(m0 - base0), corr1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = exp2f(sc[n][0] - base0);
      sc[n][1] = exp2f(sc[n][1] - base0);
      sc[n][2] = exp2f(sc[n][2] - base1);
      sc[n][3] = exp2f(sc[n][3] - base1);
      sum0 += sc[n][0] + sc[n][1];
      sum1 += sc[n][2] + sc[n][3];
    }
    // l is this thread's share of the row sum; the quad adds at the end
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // O += P V: P (bf16) is the A operand, 16 keys per k-step
#pragma unroll
    for (int t = 0; t < kBK / 16; ++t) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * t][0], sc[2 * t][1]);
      a[1] = pack_bf16(sc[2 * t][2], sc[2 * t][3]);
      a[2] = pack_bf16(sc[2 * t + 1][0], sc[2 * t + 1][1]);
      a[3] = pack_bf16(sc[2 * t + 1][2], sc[2 * t + 1][3]);
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (t * 16 + lane % 16) * RS + np * 16 +
                                 (lane / 16) * 8);
        mma_bf16(acc[2 * np], a, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // the slot is refilled in the next iteration
    cur = nxt;
    cur_whole = nxt_whole;
    stage ^= 1;
  }
  cp_async_wait<0>();

  // the quad's row sums, then acc / l in bf16 through o's strides
#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (p.lse != nullptr && lane % 4 == 0) {
    // m is in log2 units: LSE = (m + log2 l) ln 2
    float* lse = p.lse + (static_cast<int64_t>(b) * gridDim.y + kh) * rows +
                 row0;
    if (r_lo < live_rows) {
      lse[r_lo] = l0 > 0.f ? (m0 + log2f(l0)) * 0.6931471805599453f
                           : kLseEmpty;
    }
    if (r_lo + 8 < live_rows) {
      lse[r_lo + 8] = l1 > 0.f ? (m1 + log2f(l1)) * 0.6931471805599453f
                               : kLseEmpty;
    }
  }
  bf16* o = static_cast<bf16*>(p.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= live_rows) continue;
    const float l = half ? l1 : l0;
    const int fr = row0 + r;
    const int s = fr / p.g;
    const int h = kh * p.g + fr % p.g;
    bf16* orow = o + b * p.o_sb + s * p.o_ss + h * p.o_sh + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const float x = l > 0.f ? acc[n][2 * half] / l : 0.f;
      const float y = l > 0.f ? acc[n][2 * half + 1] / l : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(x, y);
    }
  }
}

template <int DH>
int launch_tc_dh(const Params& p, int batch, int kv_heads,
                 cudaStream_t stream) {
  constexpr size_t bytes = TcShape<DH>::kSmem;
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(flash_attention_kernel_tc<DH>, bytes,
                             configured);
  if (err != 0) return err;
  const int rows = p.sq * p.g;
  const dim3 grid((rows + kTcRows - 1) / kTcRows, kv_heads, batch);
  flash_attention_kernel_tc<DH><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_tc(const Params& p, int batch, int kv_heads, int dh,
              cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_tc_dh<16>(p, batch, kv_heads, stream);
    case 32: return launch_tc_dh<32>(p, batch, kv_heads, stream);
    case 64: return launch_tc_dh<64>(p, batch, kv_heads, stream);
    case 128: return launch_tc_dh<128>(p, batch, kv_heads, stream);
    case 256: return launch_tc_dh<256>(p, batch, kv_heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// flash_attention_kernel_decode (+ _combine): Sq = 1, bf16 or float32.

constexpr int kDecKeys = 32;  // keys of a tile: one a lane of a warp
constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;

// Query heads a block serves (ROWS below): 8 for a group of up to 8, else
// 16; a larger group takes ceil(G / 16) blocks for each split.
inline int decode_rows(int g) { return g <= 8 ? 8 : 16; }
inline int decode_groups(int g) {
  return (g + decode_rows(g) - 1) / decode_rows(g);
}

// A block serves ROWS (8 or 16) query heads of a group: the 6 or 8 of the
// served dense and MoE models in one block of 8, the 10 of
// recurrentgemma-2b in one of 16.
template <typename T, int DH, int ROWS>
struct DecShape {
  static constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes
  static constexpr int kStride = DH + kVec;    // row padded by 16 bytes
  static constexpr int kTile = kDecKeys * kStride;
  static constexpr int kTD = DH / kVec;  // threads across one row of V
  // S = Q K^T splits Dh into kDGroups ranges of 16-byte chunks, one a warp
  static constexpr int kDGroups = kTD < kDecWarps ? kTD : kDecWarps;
  // P V: kDecThreads / kTD groups of threads, each a set of rows; past
  // ROWS groups, the keys are dealt out over kKGroups of them
  static constexpr int kRG = kDecThreads / kTD;
  static constexpr int kKGroups = kRG > ROWS ? kRG / ROWS : 1;
  static constexpr int kRowStep = kRG / kKGroups;
  static constexpr int kRPT = ROWS / kRowStep;  // rows a thread in P V
  // the ring's K and V tiles (2 stages each), then Q (fp32), the partial
  // scores of each Dh range, the tile's weights, the rows' softmax state,
  // and the key groups' accumulators
  static constexpr size_t kSmem =
      sizeof(T) * 4 * kTile +
      sizeof(float) * (ROWS * DH + (kDGroups + 1) * ROWS * (kDecKeys + 1) +
                       3 * ROWS + (kKGroups > 1 ? kKGroups * ROWS * DH : 0));
};

// 16 bytes of T from shared memory, as kVec floats.
template <typename T>
__device__ __forceinline__ void load_smem_vec(const T* src, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = to_float(e[i]);
}

// First pass: block (x, kh, b) serves kv head kh of batch b, the query
// heads g0 .. g0 + ROWS - 1 of its group (g0 = ROWS * (x / splits)) and
// split x % splits of the cache slots, [s * chunk, (s + 1) * chunk) with
// chunk = ceil(Skv / splits).  It writes the split's running max m (log2
// units), denominator l and unnormalised output o of each row to the
// workspace: o (B, K, G, splits, Dh), then (m, l) (B, K, G, splits, 2),
// fp32.
template <typename T, int DH, int ROWS>
__global__ void __launch_bounds__(kDecThreads)
flash_attention_kernel_decode(const Params p, float* ws, int splits) {
  using S = DecShape<T, DH, ROWS>;
  constexpr int VEC = S::kVec;
  constexpr int RS = S::kStride;
  constexpr int PS = kDecKeys + 1;
  constexpr int TD = S::kTD;
  constexpr int ND = S::kDGroups;      // Dh ranges of S = Q K^T
  constexpr int NRW = kDecWarps / ND;  // row groups of S = Q K^T
  constexpr int SPW = ROWS / NRW;      // rows a warp in S = Q K^T
  constexpr int CPG = TD / ND;         // 16-byte chunks of a Dh range
  constexpr int KG = S::kKGroups;
  constexpr int RPT = S::kRPT;
  static_assert(TD <= kDecThreads && kDecThreads % TD == 0, "head dim");
  static_assert(kDecWarps % ND == 0 && TD % ND == 0, "head dim");
  static_assert(ROWS % NRW == 0 && ROWS % S::kRowStep == 0, "rows");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);  // 2 x (32, RS)
  T* v_s = k_s + 2 * S::kTile;              // 2 x (32, RS)
  float* q_s = reinterpret_cast<float*>(v_s + 2 * S::kTile);  // (ROWS, DH)
  float* sp_s = q_s + ROWS * DH;        // (ND, ROWS, PS) partial scores
  float* p_s = sp_s + ND * ROWS * PS;   // (ROWS, PS) weights
  float* m_s = p_s + ROWS * PS;  // (ROWS,) running max, log2 units
  float* l_s = m_s + ROWS;       // (ROWS,) running denominator
  float* c_s = l_s + ROWS;       // (ROWS,) this tile's correction
  float* red_s = c_s + ROWS;     // (KG, ROWS, DH) accumulators, KG > 1

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x % splits;
  const int g0 = (blockIdx.x / splits) * ROWS;
  const int rows = min(ROWS, p.g - g0);
  const int kh = blockIdx.y, b = blockIdx.z;
  const int chunk = (p.skv + splits - 1) / splits;
  const int j_begin = min(p.skv, split * chunk);
  const int j_end = min(p.skv, j_begin + chunk);
  const int ntiles = (j_end - j_begin + kDecKeys - 1) / kDecKeys;
  const int qp = __ldg(p.q_pos);
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  // K and V of tile t into ring slot `stage`, slots past the split's end
  // zero-filled by the copy.  Every slot of the split is copied, empty ones
  // too (they may hold NaN): the mask below keeps each key the query does
  // not attend out of every product.
  auto load_kv = [&](int stage, int t) {
    const int j0 = j_begin + t * kDecKeys;
    T* ks = k_s + stage * S::kTile;
    T* vs = v_s + stage * S::kTile;
    for (int i = tid; i < kDecKeys * TD; i += kDecThreads) {
      const int c = i / TD, d = (i % TD) * VEC;
      const int64_t j = j0 + c;
      const bool ok = j < j_end;
      cp_async16(ks + c * RS + d, ok ? k + j * p.k_ss + d : k, ok);
      cp_async16(vs + c * RS + d, ok ? v + j * p.v_ss + d : v, ok);
    }
  };

  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  // the group's query rows as fp32 (rows past the group's end as zeros)
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  for (int i = tid; i < ROWS * TD; i += kDecThreads) {
    const int r = i / TD, d = (i % TD) * VEC;
    float val[VEC];
    if (r < rows) {
      load_vec<T>(q + (kh * p.g + g0 + r) * p.q_sh + d, val);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) val[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) q_s[r * DH + d + e] = val[e];
  }
  // rows past the group's end keep P = 0 and a correction of 1, so the
  // loops below run over all ROWS rows without a branch
  for (int i = tid; i < ROWS * PS; i += kDecThreads) p_s[i] = 0.f;
  if (tid < ROWS) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    c_s[tid] = 1.f;
  }

  // P V: this thread's rows pr0 + kRowStep * i, dims [pd, pd + VEC) and
  // keys kg, kg + KG, ...
  const int pr0 = (tid / TD) % S::kRowStep, kg = (tid / TD) / S::kRowStep;
  const int pd = (tid % TD) * VEC;
  float acc[RPT][VEC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
  }
  const float scale_log2 = p.scale * 1.4426950408889634f;

  for (int t = 0, stage = 0; t < ntiles; ++t, stage ^= 1) {
    // the keys of tile t the query attends, as bits: each warp reads the
    // tile's 32 positions and votes, so every warp holds the same mask
    // with no barrier, while the tile's copies are in flight
    const int j = j_begin + t * kDecKeys + lane;
    const uint32_t mask = __ballot_sync(
        0xffffffffu, j < j_end && attends(__ldg(p.kv_pos + j), qp, p));
    if (t + 1 < ntiles) load_kv(stage ^ 1, t + 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copies just issued
    __syncthreads();
    if (mask == 0u) {  // nothing attended: the tile is skipped whole
      __syncthreads();
      continue;
    }
    const T* ks = k_s + stage * S::kTile;
    T* vs = v_s + stage * S::kTile;
    if (~mask != 0u) {
      // zero the V rows of the keys not attended (an empty slot may hold
      // NaN, and P = 0 must not meet it); the barrier after S = Q K^T
      // orders this before P V
      for (int i = tid; i < kDecKeys * TD; i += kDecThreads) {
        const int c = i / TD, d = (i % TD) * VEC;
        if (!((mask >> c) & 1u)) {
          *reinterpret_cast<uint4*>(vs + c * RS + d) = make_uint4(0, 0, 0, 0);
        }
      }
    }

    // partial S = Q K^T: lane = key, warp w the Dh range w % ND of rows
    // w / ND + NRW * i, every row (the zero rows past the group's end too:
    // no branch between the rows' independent sums)
    {
      const int dg = warp % ND, rw = warp / ND;
      float sc[SPW];
#pragma unroll
      for (int i = 0; i < SPW; ++i) sc[i] = 0.f;
      const T* krow = ks + lane * RS + dg * CPG * VEC;
      const float* qd = q_s + dg * CPG * VEC;
#pragma unroll
      for (int cc = 0; cc < CPG; ++cc) {
        float kf[VEC];
        load_smem_vec<T>(krow + cc * VEC, kf);
#pragma unroll
        for (int i = 0; i < SPW; ++i) {
          const float4* qr = reinterpret_cast<const float4*>(
              qd + (rw + NRW * i) * DH + cc * VEC);
#pragma unroll
          for (int e = 0; e < VEC / 4; ++e) {
            const float4 qv = qr[e];
            sc[i] = fmaf(qv.x, kf[4 * e], sc[i]);
            sc[i] = fmaf(qv.y, kf[4 * e + 1], sc[i]);
            sc[i] = fmaf(qv.z, kf[4 * e + 2], sc[i]);
            sc[i] = fmaf(qv.w, kf[4 * e + 3], sc[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        sp_s[(dg * ROWS + rw + NRW * i) * PS + lane] = sc[i];
      }
    }
    __syncthreads();

    // online softmax, one warp a row: S = the ranges' sum (in order) *
    // scale in log2 units, -inf where not attended; m_new = max(m,
    // rowmax S), P = exp2(S - m_new), l = l * exp2(m - m_new) + rowsum P
    for (int r = warp; r < rows; r += kDecWarps) {
      float x = 0.f;
#pragma unroll
      for (int dg = 0; dg < ND; ++dg) x += sp_s[(dg * ROWS + r) * PS + lane];
      x = ((mask >> lane) & 1u) ? x * scale_log2 : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // a row with nothing attended so far keeps P = 0 and acc = 0
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float e = exp2f(x - base);
      float sum = e;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      p_s[r * PS + lane] = e;
      if (lane == 0) {
        const float corr = exp2f(m_old - base);
        c_s[r] = corr;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over this thread's rows and keys
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = c_s[pr0 + S::kRowStep * i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] *= corr;
    }
#pragma unroll 8
    for (int c = kg; c < kDecKeys; c += KG) {
      float vf[VEC];
      load_smem_vec<T>(vs + c * RS + pd, vf);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float w = p_s[(pr0 + S::kRowStep * i) * PS + c];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(w, vf[e], acc[i][e]);
      }
    }
    __syncthreads();  // the slot is refilled in the next iteration
  }
  cp_async_wait<0>();

  // this split's (m, l, o) of each row; a split that attends nothing
  // writes m = -inf, l = 0, o = 0.  With KG key groups, their
  // accumulators are added in group order first.
  const int64_t entries =
      static_cast<int64_t>(gridDim.z) * gridDim.y * p.g * splits;
  const int64_t e0 =
      (static_cast<int64_t>(b * gridDim.y + kh) * p.g + g0) * splits + split;
  if constexpr (KG > 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red_s[(kg * ROWS + pr0) * DH + pd + e] = acc[0][e];
    }
    __syncthreads();
    for (int i = tid; i < rows * (DH / 4); i += kDecThreads) {
      const int r = i / (DH / 4), d = (i % (DH / 4)) * 4;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int gk = 0; gk < KG; ++gk) {
        const float4 part =
            *reinterpret_cast<const float4*>(red_s + (gk * ROWS + r) * DH + d);
        sum.x += part.x;
        sum.y += part.y;
        sum.z += part.z;
        sum.w += part.w;
      }
      *reinterpret_cast<float4*>(
          ws + (e0 + static_cast<int64_t>(r) * splits) * DH + d) = sum;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = pr0 + S::kRowStep * i;
      if (r >= rows) continue;
      float* dst = ws + (e0 + static_cast<int64_t>(r) * splits) * DH + pd;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        *reinterpret_cast<float4*>(dst + e) = make_float4(
            acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
      }
    }
  }
  if (tid < rows) {
    float* ml = ws + entries * DH + 2 * (e0 + static_cast<int64_t>(tid) *
                                                  splits);
    ml[0] = m_s[tid];
    ml[1] = l_s[tid];
  }
}

// Second pass: block (g, kh, b) merges the splits of one output row in
// split order, M = max m_s, out = sum 2^(m_s - M) o_s / sum 2^(m_s - M)
// l_s, in q's dtype, 0 for a row that attends no key.  Thread d < Dh owns
// dimension d; the weights 2^(m_s - M) are computed once, by warp 0, into
// shared memory (max(Dh, 32) threads).  Its only shared memory is the
// dynamic block of combine_smem_bytes(splits), which must stay within the
// 48 KB a launch takes without opting in: so at most kMaxDecodeSplits.
inline size_t combine_smem_bytes(int splits) {
  return sizeof(float) * (2 * static_cast<size_t>(splits) + 1);
}
constexpr int kMaxDecodeSplits =
    static_cast<int>((48 * 1024 / sizeof(float) - 1) / 2);

template <typename T>
__global__ void __launch_bounds__(256)
flash_attention_kernel_decode_combine(const Params p, const float* ws,
                                      int splits, int dh) {
  extern __shared__ float w_s[];  // (splits,) weights, l of each, the sum
  float* l_s = w_s + splits;
  float& den_s = l_s[splits];
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int64_t entries =
      static_cast<int64_t>(gridDim.z) * gridDim.y * p.g * splits;
  const int64_t e0 =
      (static_cast<int64_t>(b * gridDim.y + kh) * p.g + g) * splits;
  const float* ml = ws + entries * dh + 2 * e0;
  for (int s = tid; s < splits; s += blockDim.x) {
    w_s[s] = ml[2 * s];
    l_s[s] = ml[2 * s + 1];
  }
  __syncthreads();
  if (tid < 32) {
    float top = -INFINITY;
    for (int s = tid; s < splits; s += 32) top = fmaxf(top, w_s[s]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
    }
    for (int s = tid; s < splits; s += 32) {
      w_s[s] = top == -INFINITY ? 0.f : exp2f(w_s[s] - top);
    }
    __syncwarp();
    if (tid == 0) {
      float den = 0.f;
      for (int s = 0; s < splits; ++s) den = fmaf(w_s[s], l_s[s], den);
      den_s = den;
    }
  }
  __syncthreads();
  if (tid >= dh) return;
  const float* o = ws + e0 * dh + tid;
  float num = 0.f;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) {
    num = fmaf(w_s[s], o[static_cast<int64_t>(s) * dh], num);
  }
  const float den = den_s;
  T* out = static_cast<T*>(p.o) + b * p.o_sb + (kh * p.g + g) * p.o_sh + tid;
  *out = from_float<T>(den > 0.f ? num / den : 0.f);
}

template <typename T, int DH, int ROWS>
int launch_decode_rows(const Params& p, int batch, int kv_heads, float* ws,
                       int splits, cudaStream_t stream) {
  constexpr size_t bytes = DecShape<T, DH, ROWS>::kSmem;
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(flash_attention_kernel_decode<T, DH, ROWS>,
                             bytes, configured);
  if (err != 0) return err;
  const dim3 grid(splits * decode_groups(p.g), kv_heads, batch);
  flash_attention_kernel_decode<T, DH, ROWS>
      <<<grid, kDecThreads, bytes, stream>>>(p, ws, splits);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  const dim3 cgrid(p.g, kv_heads, batch);
  flash_attention_kernel_decode_combine<T>
      <<<cgrid, DH < 32 ? 32 : DH, combine_smem_bytes(splits), stream>>>(
          p, ws, splits, DH);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int launch_decode_dh(const Params& p, int batch, int kv_heads, float* ws,
                     int splits, cudaStream_t stream) {
  if (decode_rows(p.g) == 8) {
    return launch_decode_rows<T, DH, 8>(p, batch, kv_heads, ws, splits,
                                        stream);
  }
  return launch_decode_rows<T, DH, 16>(p, batch, kv_heads, ws, splits,
                                       stream);
}

template <typename T>
int launch_decode(const Params& p, int batch, int kv_heads, int dh,
                  float* ws, int splits, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_decode_dh<T, 16>(p, batch, kv_heads, ws, splits,
                                            stream);
    case 32: return launch_decode_dh<T, 32>(p, batch, kv_heads, ws, splits,
                                            stream);
    case 64: return launch_decode_dh<T, 64>(p, batch, kv_heads, ws, splits,
                                            stream);
    case 128: return launch_decode_dh<T, 128>(p, batch, kv_heads, ws, splits,
                                              stream);
    case 256: return launch_decode_dh<T, 256>(p, batch, kv_heads, ws, splits,
                                              stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The checked Params of one call from the entry points' arguments;
// cudaErrorInvalidValue for sizes the kernels do not take.
int make_params(const void* q, const void* k, const void* v, void* o,
                const void* q_pos, const void* kv_pos, const int64_t* dims,
                float scale, Params* p) {
  const int64_t batch = dims[0], sq = dims[1], skv = dims[2];
  const int64_t kv_heads = dims[3], g = dims[4];
  if (batch <= 0 || sq <= 0 || skv <= 0 || kv_heads <= 0 || g <= 0 ||
      batch > 65535 || kv_heads > 65535 || sq * g > INT32_MAX / 2 ||
      skv > INT32_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p->q = q;
  p->k = k;
  p->v = v;
  p->o = o;
  p->q_pos = static_cast<const int32_t*>(q_pos);
  p->kv_pos = static_cast<const int32_t*>(kv_pos);
  p->q_sb = dims[6];
  p->q_ss = dims[7];
  p->q_sh = dims[8];
  p->k_sb = dims[9];
  p->k_ss = dims[10];
  p->k_sh = dims[11];
  p->v_sb = dims[12];
  p->v_ss = dims[13];
  p->v_sh = dims[14];
  p->o_sb = dims[15];
  p->o_ss = dims[16];
  p->o_sh = dims[17];
  p->sq = static_cast<int>(sq);
  p->skv = static_cast<int>(skv);
  p->g = static_cast<int>(g);
  p->causal = static_cast<int>(dims[18]);
  p->window = static_cast<int>(dims[19]);
  p->scale = scale;
  p->lse = nullptr;
  return 0;
}

}  // namespace

extern "C" {

// Every entry point: q (B, Sq, K*G, Dh) and o through their strides, k and
// v (B, Skv, K, Dh) through theirs; q_pos (Sq,) and kv_pos (Skv,) int32 on
// the device.  dims (host memory, int64): B, Sq, Skv, K, G, Dh, then the
// (batch, sequence, head) element strides of q, k, v and o, then causal
// (0/1) and window (0 = none).  dtype code: 0 = float32, 1 = bfloat16 (q,
// k, v, o alike).  Every stride and pointer must be 16-byte aligned.

// The CUDA-core kernel (flash_attention_kernel), float32 with Sq > 1 only.
// lse: null, or B * K * Sq * G fp32 on the device for each row's LSE.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, const void* q_pos, const void* kv_pos,
                            const int64_t* dims, float scale, int dtype,
                            void* lse, void* stream) {
  if (dtype != 0 || dims[1] == 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  const int err = make_params(q, k, v, o, q_pos, kv_pos, dims, scale, &p);
  if (err != 0) return err;
  p.lse = static_cast<float*>(lse);
  return launch<float>(p, static_cast<int>(dims[0]),
                       static_cast<int>(dims[3]), static_cast<int>(dims[5]),
                       static_cast<cudaStream_t>(stream));
}

// The tensor-core kernel (flash_attention_kernel_tc), bfloat16 only.
// lse: null, or B * K * Sq * G fp32 on the device for each row's LSE.
int flash_attention_forward_tc(const void* q, const void* k, const void* v,
                               void* o, const void* q_pos,
                               const void* kv_pos, const int64_t* dims,
                               float scale, int dtype, void* lse,
                               void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  const int err = make_params(q, k, v, o, q_pos, kv_pos, dims, scale, &p);
  if (err != 0) return err;
  p.lse = static_cast<float*>(lse);
  return launch_tc(p, static_cast<int>(dims[0]), static_cast<int>(dims[3]),
                   static_cast<int>(dims[5]),
                   static_cast<cudaStream_t>(stream));
}

// The split-KV decode (flash_attention_kernel_decode, then its combine),
// float32 or bf16, Sq = 1 only.  workspace: B * K * G * splits * (Dh + 2)
// fp32 on the device; splits in [1, min(Skv, kMaxDecodeSplits)].
int flash_attention_forward_decode(const void* q, const void* k,
                                   const void* v, void* o, const void* q_pos,
                                   const void* kv_pos, const int64_t* dims,
                                   float scale, int dtype, void* workspace,
                                   int splits, void* stream) {
  Params p;
  const int err = make_params(q, k, v, o, q_pos, kv_pos, dims, scale, &p);
  if (err != 0) return err;
  const int64_t groups = decode_groups(static_cast<int>(dims[4]));
  if (dims[1] != 1 || splits < 1 || splits > dims[2] ||
      splits > kMaxDecodeSplits || splits * groups > INT32_MAX ||
      workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(dims[0]), kh = static_cast<int>(dims[3]);
  const int d = static_cast<int>(dims[5]);
  float* ws = static_cast<float*>(workspace);
  if (dtype == 0) return launch_decode<float>(p, b, kh, d, ws, splits, s);
  if (dtype == 1) {
    return launch_decode<__nv_bfloat16>(p, b, kh, d, ws, splits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
