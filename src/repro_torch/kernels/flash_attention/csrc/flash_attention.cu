// Flash attention (blockwise online softmax) for sm_90a, with the model's
// position mask.
//
// Replaces the Pallas kernel of repro/kernels/flash_attention/kernel.py
// (flash_attention -> _attn_kernel).  That kernel walks the kv blocks as
// the innermost, sequential grid axis and keeps the running max,
// denominator and accumulator in VMEM scratch between grid steps.  Blocks
// of a CUDA grid run in no order, so here one block owns a tile of query
// rows for its whole life and loops over the kv tiles itself, keeping the
// fp32 running max and denominator in shared memory and the fp32
// accumulator in registers.
//
// Work split.  A block serves one (batch b, kv head kh) and BR consecutive
// rows of the flattened (query position s, group member g) index
// r = s * G + g, where query head kh * G + g reads kv head kh (GQA, and MQA
// with one kv head; no repeated K/V is materialised).  So every query head
// of a group shares each K/V tile the block stages, and a decode step
// (Sq = 1) still fills a block with its G query heads.  BR = 64 for long
// query runs (32 at Dh = 256, where 64 rows would hold a (64, 256) fp32
// accumulator of 128 registers a thread), 16 for short ones (decode).
//
// Per kv tile of BK = 64 keys, 128 threads:
//   0. the tile's kv positions are read; if no row of the block can attend
//      any key of the tile (kv_pos < 0, after every query under the causal
//      mask, or out of every query's window) the tile is skipped whole, its
//      K/V never loaded;
//   1. K and V are staged in shared memory as fp32 (16-byte loads through
//      the caller's strides, so the ring cache's (B, cap, K, Dh) layout is
//      read in place); S = Q K^T * scale on CUDA cores, each thread a
//      (BR/16) x 8 micro-tile, masked to -inf;
//   2. online softmax per row: m_new = max(m, rowmax S), P = exp(S - m_new),
//      l = l * exp(m - m_new) + rowsum P;
//   3. acc = acc * exp(m - m_new) + P V, each thread a (BR/16) x (Dh/8)
//      micro-tile of the (BR, Dh) accumulator.
// The output is acc / l in q's dtype.  A row that attends no key at all
// (the model never builds one) gives zeros here, where the reference's
// softmax over all -1e30 scores gives the mean of v.
//
// Mask: attend key j from the query at position qp iff kv_pos[j] >= 0,
// kv_pos[j] <= qp when causal, and qp - kv_pos[j] < window when a window is
// set.  The Pallas kernel's right-aligned contiguous layout is the case
// kv_pos = arange(Skv), q_pos = Skv - Sq + arange(Sq).
//
// Bound: for prefill, operations (4 * B * H * Dh FLOPs per attended
// (query, key) pair, about half of Sq * Skv under the causal mask) against
// the card's tensor-core rate; for decode, bytes (the cache's K and V read
// once).  This first version runs on CUDA cores in fp32 and reaches neither:
// mma/wgmma tiles for prefill and a split over the keys for decode are the
// next steps.
//
// Types: bf16 or float32 in, fp32 inside, output in q's dtype; Dh in
// {16, 32, 64, 128, 256}.  Launches on the caller's stream, allocates nothing,
// never synchronizes; the entry point returns cudaGetLastError() of its
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DH, BR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
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

}  // namespace

extern "C" {

// q (B, Sq, K*G, Dh) and o through their strides, k and v (B, Skv, K, Dh)
// through theirs; q_pos (Sq,) and kv_pos (Skv,) int32 on the device.
// dims (host memory, int64): B, Sq, Skv, K, G, Dh, then the (batch,
// sequence, head) element strides of q, k, v and o, then causal (0/1) and
// window (0 = none).  dtype code: 0 = float32, 1 = bfloat16 (q, k, v, o
// alike).  Every stride and pointer must be 16-byte aligned.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, const void* q_pos, const void* kv_pos,
                            const int64_t* dims, float scale, int dtype,
                            void* stream) {
  const int64_t batch = dims[0], sq = dims[1], skv = dims[2];
  const int64_t kv_heads = dims[3], g = dims[4], dh = dims[5];
  if (batch <= 0 || sq <= 0 || skv <= 0 || kv_heads <= 0 || g <= 0 ||
      batch > 65535 || kv_heads > 65535 || sq * g > INT32_MAX / 2 ||
      skv > INT32_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_pos = static_cast<const int32_t*>(q_pos);
  p.kv_pos = static_cast<const int32_t*>(kv_pos);
  p.q_sb = dims[6];
  p.q_ss = dims[7];
  p.q_sh = dims[8];
  p.k_sb = dims[9];
  p.k_ss = dims[10];
  p.k_sh = dims[11];
  p.v_sb = dims[12];
  p.v_ss = dims[13];
  p.v_sh = dims[14];
  p.o_sb = dims[15];
  p.o_ss = dims[16];
  p.o_sh = dims[17];
  p.sq = static_cast<int>(sq);
  p.skv = static_cast<int>(skv);
  p.g = static_cast<int>(g);
  p.causal = static_cast<int>(dims[18]);
  p.window = static_cast<int>(dims[19]);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(batch), kh = static_cast<int>(kv_heads);
  const int d = static_cast<int>(dh);
  if (dtype == 0) return launch<float>(p, b, kh, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, b, kh, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
