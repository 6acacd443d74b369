// The gradient of the flash attention (flash_attention.cu) for sm_90a:
// FlashAttention-2's backward, in three launches, on CUDA cores in fp32.
//
// Replaces no Pallas kernel: the Pallas flash attention (repro/kernels/
// flash_attention/kernel.py) has no custom_vjp, and the reference trains
// through jax.grad of its plain attention (repro/models/layers.py::
// attention).  The port's model runs the forward kernels on the card, so
// their gradient is a kernel too.
//
// With s = q . k * scale over the attended keys (the forward's mask:
// kv_pos >= 0, kv_pos <= q_pos when causal, q_pos - kv_pos < window when a
// window is set), LSE_i the row's log-sum-exp, P = exp(s - LSE),
// D_i = sum_d dO_i,d * O_i,d and dS = P * (dO V^T - D):
//   dV = P^T dO,  dK = scale * dS^T Q,  dQ = scale * dS K.
//
//   1. attn_bwd_prepass: a block for each (b, kv head, 32 rows of the
//      flattened (query position, group member) index r = s * G + g, as
//      the forward kernels): recomputes each row's LSE in fp32 with an
//      online max and sum over the key tiles it attends, and D_i, into an
//      fp32 workspace.  The forward kernels stay as they are (storing the
//      LSE there is a later optimisation).
//   2. attn_bwd_dkdv: a block for each (b, kv head, tile of BK keys) holds
//      its K and V tiles and walks the query-row tiles that the mask lets
//      reach it, in row order (so the G query heads of the group in a
//      fixed order), accumulating dK and dV in registers.
//   3. attn_bwd_dq: a block for each (b, kv head, tile of BR rows) walks
//      the key tiles its rows attend, accumulating dQ in registers.
// No block writes what another block writes and every sum runs in a fixed
// order: no atomics, so the same inputs give the same bits.
//
// Bound: operations.  Five S x S x Dh products a call (causal: half the
// pairs) against the card's bf16 tensor-core peak (989 TFLOP/s dense);
// this first kernel runs them, and the S and dP recomputations of its
// three passes, on CUDA cores in fp32 (67 TFLOP/s), so it sits far above
// that bound.  The design keeps every operand in shared memory as fp32
// (rows padded by one float, so a warp's 16 column threads read 16 banks)
// and each thread a register micro-tile of 16 x 16 threads' strided rows
// and columns.  A tile of (rows, keys) that the mask leaves empty is
// skipped whole.  Keys of empty slots (kv_pos < 0) and rows past the end
// are zero-filled in shared memory, so their bits never meet a multiply.
// Not yet: mma.sync or wgmma tiles, the LSE saved by the forward.
//
// Types: q, k, v, o, dO bf16 or float32 (one dtype), fp32 inside, dq, dk,
// dv in that dtype; Dh in {16, 32, 64, 128, 256}.  Every kernel launches on
// the caller's stream, allocates nothing and never synchronizes; the entry
// point returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTy = 16;  // micro-tile thread rows
constexpr int kTx = 16;  // micro-tile thread columns
constexpr int kMaxDevices = 64;

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
  const void* o;
  const void* dout;
  void* dq;  // (B, Sq, K * G, Dh) contiguous
  void* dk;  // (B, Skv, K, Dh) contiguous
  void* dv;
  const int32_t* q_pos;   // (Sq,)
  const int32_t* kv_pos;  // (Skv,), < 0 = empty slot
  float* lse;             // (B, K, Sq * G)
  float* dsum;            // (B, K, Sq * G)
  // element strides: batch, sequence, head (the head dimension is
  // contiguous); q's, o's and dO's head stride steps over kh * G + g
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t d_sb, d_ss, d_sh;
  int sq, skv, g, kv_heads;
  int causal;
  int window;  // 0 = no window
  float scale;
};

__device__ __forceinline__ bool attends(int qp, int kp, const Params& p) {
  return kp >= 0 && (!p.causal || kp <= qp) &&
         (p.window <= 0 || qp - kp < p.window);
}

// 16 bytes of T from global memory, as kVec floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = to_float(e[i]);
}

// Rows row0 .. row0 + BR - 1 of the flattened (s, g) index of kv head kh
// into dst (BR, DH + 1) as fp32; rows at or past `live` as zeros.
template <typename T, int DH, int BR>
__device__ __forceinline__ void load_rows(const T* base, int64_t sb,
                                          int64_t ss, int64_t sh, int b,
                                          int kh, int g, int row0, int live,
                                          float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  for (int idx = threadIdx.x; idx < BR * (DH / kVec); idx += kThreads) {
    const int r = idx / (DH / kVec);
    const int d = (idx % (DH / kVec)) * kVec;
    float val[kVec];
    if (r < live) {
      const int fr = row0 + r;
      const int64_t s = fr / g;
      const int64_t h = kh * g + fr % g;
      load_vec<T>(base + b * sb + s * ss + h * sh + d, val);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) val[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * (DH + 1) + d + i] = val[i];
  }
}

// Keys k0 .. k0 + BK - 1 of kv head kh into dst (BK, DH + 1) as fp32; a key
// whose kpos_s is < 0 (an empty slot or past the end) as zeros.
template <typename T, int DH, int BK>
__device__ __forceinline__ void load_keys(const T* base, int64_t sb,
                                          int64_t ss, int64_t sh, int b,
                                          int kh, int k0, const int* kpos_s,
                                          float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  for (int idx = threadIdx.x; idx < BK * (DH / kVec); idx += kThreads) {
    const int c = idx / (DH / kVec);
    const int d = (idx % (DH / kVec)) * kVec;
    float val[kVec];
    if (kpos_s[c] >= 0) {
      const int64_t j = k0 + c;
      load_vec<T>(base + b * sb + j * ss + kh * sh + d, val);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) val[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[c * (DH + 1) + d + i] = val[i];
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over the (BR, BK)
// tile: a (BR, DH + 1) and b (BK, DH + 1) in shared memory.
template <int DH, int BR, int BK>
__device__ __forceinline__ void tile_nt(const float* a_s, const float* b_s,
                                        float (&acc)[BR / kTy][BK / kTx]) {
  constexpr int RI = BR / kTy;
  constexpr int CJ = BK / kTx;
  const int ty = threadIdx.x / kTx;
  const int tx = threadIdx.x % kTx;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float av[RI], bv[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) av[i] = a_s[(ty + kTy * i) * (DH + 1) + d];
#pragma unroll
    for (int j = 0; j < CJ; ++j) bv[j] = b_s[(tx + kTx * j) * (DH + 1) + d];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Whether any (row, key) pair of the tile is attended; every thread of the
// block takes part and gets the same answer.
template <int BR, int BK>
__device__ __forceinline__ bool tile_live(const int* qpos_s,
                                          const int* kpos_s, int live,
                                          const Params& p) {
  bool any = false;
  for (int idx = threadIdx.x; idx < BR * BK; idx += kThreads) {
    const int r = idx / BK;
    const int c = idx % BK;
    any = any || (r < live && attends(qpos_s[r], kpos_s[c], p));
  }
  return __syncthreads_or(any);
}

// The tile sizes: rows (BR) and keys (BK) of each kernel.
template <int DH>
struct Tiles {
  static constexpr int kPreRows = 32;
  static constexpr int kPreKeys = DH >= 256 ? 32 : 64;
  static constexpr int kKvRows = 32;
  static constexpr int kKvKeys = DH >= 256 ? 32 : 64;
  static constexpr int kQRows = DH >= 256 ? 32 : 64;
  static constexpr int kQKeys = 32;
};

template <int DH, int BR, int BK>
constexpr size_t prepass_smem() {
  return sizeof(float) * (BR * (DH + 1) + BK * (DH + 1) + BR * (BK + 1)) +
         sizeof(int) * (BR + BK);
}

template <int DH, int BR, int BK>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * BK * (DH + 1) + 2 * BR * (DH + 1) +
                          2 * BR * (BK + 1) + 2 * BR) +
         sizeof(int) * (BR + BK);
}

template <int DH, int BR, int BK>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BR * (DH + 1) + 2 * BK * (DH + 1) +
                          BR * (BK + 1) + 2 * BR) +
         sizeof(int) * (BR + BK);
}

// ---------------------------------------------------------------------------
// 1. LSE and D of every query row.

template <typename T, int DH, int BR, int BK>
__global__ void __launch_bounds__(kThreads) attn_bwd_prepass(const Params p) {
  constexpr int TPR = kThreads / BR;  // threads a row
  extern __shared__ float smem[];
  float* q_s = smem;                                   // (BR, DH + 1)
  float* k_s = q_s + BR * (DH + 1);                    // (BK, DH + 1)
  float* s_s = k_s + BK * (DH + 1);                    // (BR, BK + 1)
  int* qpos_s = reinterpret_cast<int*>(s_s + BR * (BK + 1));  // (BR,)
  int* kpos_s = qpos_s + BR;                                  // (BK,)

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows = p.sq * p.g;
  const int row0 = blockIdx.x * BR;
  const int live = min(BR, rows - row0);
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);

  load_rows<T, DH, BR>(q, p.q_sb, p.q_ss, p.q_sh, b, kh, p.g, row0, live,
                       q_s);
  for (int r = tid; r < BR; r += kThreads) {
    qpos_s[r] = r < live ? p.q_pos[(row0 + r) / p.g] : 0;
  }

  // D_i = sum_d dO . O, TPR consecutive lanes a row, added in a fixed tree
  const int r = tid / TPR;
  const int t = tid % TPR;
  const int64_t out_idx =
      (static_cast<int64_t>(b) * p.kv_heads + kh) * rows + row0 + r;
  {
    float acc = 0.f;
    if (r < live) {
      const int fr = row0 + r;
      const int64_t s = fr / p.g;
      const int64_t h = kh * p.g + fr % p.g;
      const T* orow = static_cast<const T*>(p.o) + b * p.o_sb + s * p.o_ss +
                      h * p.o_sh;
      const T* drow = static_cast<const T*>(p.dout) + b * p.d_sb +
                      s * p.d_ss + h * p.d_sh;
      for (int d = t; d < DH; d += TPR) {
        acc = fmaf(to_float(drow[d]), to_float(orow[d]), acc);
      }
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (t == 0 && r < live) p.dsum[out_idx] = acc;
  }

  float m_run = -INFINITY, l_run = 0.f;
  for (int k0 = 0; k0 < p.skv; k0 += BK) {
    for (int c = tid; c < BK; c += kThreads) {
      const int j = k0 + c;
      kpos_s[c] = j < p.skv ? p.kv_pos[j] : -1;
    }
    __syncthreads();
    if (!tile_live<BR, BK>(qpos_s, kpos_s, live, p)) continue;
    load_keys<T, DH, BK>(k, p.k_sb, p.k_ss, p.k_sh, b, kh, k0, kpos_s, k_s);
    __syncthreads();
    {
      float s[BR / kTy][BK / kTx];
      tile_nt<DH, BR, BK>(q_s, k_s, s);
      const int ty = tid / kTx;
      const int tx = tid % kTx;
#pragma unroll
      for (int i = 0; i < BR / kTy; ++i) {
        const int rr = ty + kTy * i;
#pragma unroll
        for (int j = 0; j < BK / kTx; ++j) {
          const int c = tx + kTx * j;
          const bool ok = rr < live && attends(qpos_s[rr], kpos_s[c], p);
          s_s[rr * (BK + 1) + c] = ok ? s[i][j] * p.scale : -INFINITY;
        }
      }
    }
    __syncthreads();
    float mx = -INFINITY;
    for (int c = t; c < BK; c += TPR) mx = fmaxf(mx, s_s[r * (BK + 1) + c]);
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    // every lane shuffles (another row of the warp may attend nothing)
    const float m_new = fmaxf(m_run, mx);
    const bool some = m_new != -INFINITY;
    float sum = 0.f;
    for (int c = t; c < BK; c += TPR) {
      sum += some ? expf(s_s[r * (BK + 1) + c] - m_new) : 0.f;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (some) {
      l_run = l_run * expf(m_run - m_new) + sum;
      m_run = m_new;
    }
    __syncthreads();  // s_s and kpos_s are rewritten by the next tile
  }
  if (t == 0 && r < live) {
    // a row that attends no key: +inf, so exp(s - LSE) is 0 for any s
    p.lse[out_idx] = m_run == -INFINITY ? INFINITY : m_run + logf(l_run);
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV of a tile of keys.

template <typename T, int DH, int BR, int BK>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(const Params p) {
  constexpr int RI = BR / kTy;   // score rows a thread
  constexpr int CJ = BK / kTx;   // score columns a thread
  constexpr int RK = BK / kTy;   // dK / dV key rows a thread
  constexpr int DJ = DH / kTx;   // dK / dV dims a thread
  extern __shared__ float smem[];
  float* k_s = smem;                       // (BK, DH + 1)
  float* v_s = k_s + BK * (DH + 1);        // (BK, DH + 1)
  float* q_s = v_s + BK * (DH + 1);        // (BR, DH + 1)
  float* do_s = q_s + BR * (DH + 1);       // (BR, DH + 1)
  float* p_s = do_s + BR * (DH + 1);       // (BR, BK + 1)
  float* ds_s = p_s + BR * (BK + 1);       // (BR, BK + 1)
  float* lse_s = ds_s + BR * (BK + 1);     // (BR,)
  float* dsum_s = lse_s + BR;              // (BR,)
  int* qpos_s = reinterpret_cast<int*>(dsum_s + BR);  // (BR,)
  int* kpos_s = qpos_s + BR;                          // (BK,)

  const int tid = threadIdx.x;
  const int ty = tid / kTx;
  const int tx = tid % kTx;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int rows = p.sq * p.g;
  const int64_t ws0 = (static_cast<int64_t>(b) * p.kv_heads + kh) * rows;

  for (int c = tid; c < BK; c += kThreads) {
    const int j = k0 + c;
    kpos_s[c] = j < p.skv ? p.kv_pos[j] : -1;
  }
  __syncthreads();
  load_keys<T, DH, BK>(static_cast<const T*>(p.k), p.k_sb, p.k_ss, p.k_sh, b,
                       kh, k0, kpos_s, k_s);
  load_keys<T, DH, BK>(static_cast<const T*>(p.v), p.v_sb, p.v_ss, p.v_sh, b,
                       kh, k0, kpos_s, v_s);

  float dk[RK][DJ], dv[RK][DJ];
#pragma unroll
  for (int i = 0; i < RK; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  }

  for (int row0 = 0; row0 < rows; row0 += BR) {
    const int live = min(BR, rows - row0);
    for (int r = tid; r < BR; r += kThreads) {
      qpos_s[r] = r < live ? p.q_pos[(row0 + r) / p.g] : 0;
      lse_s[r] = r < live ? p.lse[ws0 + row0 + r] : 0.f;
      dsum_s[r] = r < live ? p.dsum[ws0 + row0 + r] : 0.f;
    }
    __syncthreads();
    if (!tile_live<BR, BK>(qpos_s, kpos_s, live, p)) continue;
    load_rows<T, DH, BR>(static_cast<const T*>(p.q), p.q_sb, p.q_ss, p.q_sh,
                         b, kh, p.g, row0, live, q_s);
    load_rows<T, DH, BR>(static_cast<const T*>(p.dout), p.d_sb, p.d_ss,
                         p.d_sh, b, kh, p.g, row0, live, do_s);
    __syncthreads();
    {
      float s[RI][CJ], dp[RI][CJ];
      tile_nt<DH, BR, BK>(q_s, k_s, s);
      tile_nt<DH, BR, BK>(do_s, v_s, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + kTy * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + kTx * j;
          const bool ok = r < live && attends(qpos_s[r], kpos_s[c], p);
          const float pr = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
          p_s[r * (BK + 1) + c] = pr;
          ds_s[r * (BK + 1) + c] = pr * (dp[i][j] - dsum_s[r]);
        }
      }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the tile's rows in order
    for (int c = 0; c < live; ++c) {
      float pv[RK], dsv[RK], dov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pv[i] = p_s[c * (BK + 1) + ty + kTy * i];
        dsv[i] = ds_s[c * (BK + 1) + ty + kTy * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dov[j] = do_s[c * (DH + 1) + tx + kTx * j];
        qv[j] = q_s[c * (DH + 1) + tx + kTx * j];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv[i][j] = fmaf(pv[i], dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv[i], qv[j], dk[i][j]);
        }
      }
    }
    __syncthreads();  // the tile's buffers are rewritten by the next one
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty + kTy * i;
    if (key >= p.skv) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * p.skv + key) * p.kv_heads + kh) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_out[at + tx + kTx * j] = from_float<T>(dk[i][j] * p.scale);
      dv_out[at + tx + kTx * j] = from_float<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ of a tile of query rows.

template <typename T, int DH, int BR, int BK>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(const Params p) {
  constexpr int RI = BR / kTy;
  constexpr int CJ = BK / kTx;
  constexpr int DJ = DH / kTx;
  extern __shared__ float smem[];
  float* q_s = smem;                       // (BR, DH + 1)
  float* do_s = q_s + BR * (DH + 1);       // (BR, DH + 1)
  float* k_s = do_s + BR * (DH + 1);       // (BK, DH + 1)
  float* v_s = k_s + BK * (DH + 1);        // (BK, DH + 1)
  float* ds_s = v_s + BK * (DH + 1);       // (BR, BK + 1)
  float* lse_s = ds_s + BR * (BK + 1);     // (BR,)
  float* dsum_s = lse_s + BR;              // (BR,)
  int* qpos_s = reinterpret_cast<int*>(dsum_s + BR);  // (BR,)
  int* kpos_s = qpos_s + BR;                          // (BK,)

  const int tid = threadIdx.x;
  const int ty = tid / kTx;
  const int tx = tid % kTx;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows = p.sq * p.g;
  const int row0 = blockIdx.x * BR;
  const int live = min(BR, rows - row0);
  const int64_t ws0 = (static_cast<int64_t>(b) * p.kv_heads + kh) * rows;

  load_rows<T, DH, BR>(static_cast<const T*>(p.q), p.q_sb, p.q_ss, p.q_sh, b,
                       kh, p.g, row0, live, q_s);
  load_rows<T, DH, BR>(static_cast<const T*>(p.dout), p.d_sb, p.d_ss, p.d_sh,
                       b, kh, p.g, row0, live, do_s);
  for (int r = tid; r < BR; r += kThreads) {
    qpos_s[r] = r < live ? p.q_pos[(row0 + r) / p.g] : 0;
    lse_s[r] = r < live ? p.lse[ws0 + row0 + r] : 0.f;
    dsum_s[r] = r < live ? p.dsum[ws0 + row0 + r] : 0.f;
  }

  float dq[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < p.skv; k0 += BK) {
    for (int c = tid; c < BK; c += kThreads) {
      const int j = k0 + c;
      kpos_s[c] = j < p.skv ? p.kv_pos[j] : -1;
    }
    __syncthreads();
    if (!tile_live<BR, BK>(qpos_s, kpos_s, live, p)) continue;
    load_keys<T, DH, BK>(static_cast<const T*>(p.k), p.k_sb, p.k_ss, p.k_sh,
                         b, kh, k0, kpos_s, k_s);
    load_keys<T, DH, BK>(static_cast<const T*>(p.v), p.v_sb, p.v_ss, p.v_sh,
                         b, kh, k0, kpos_s, v_s);
    __syncthreads();
    {
      float s[RI][CJ], dp[RI][CJ];
      tile_nt<DH, BR, BK>(q_s, k_s, s);
      tile_nt<DH, BR, BK>(do_s, v_s, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + kTy * i;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + kTx * j;
          const bool ok = r < live && attends(qpos_s[r], kpos_s[c], p);
          const float pr = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
          ds_s[r * (BK + 1) + c] = pr * (dp[i][j] - dsum_s[r]);
        }
      }
    }
    __syncthreads();
    // dQ += dS K over the tile's keys in order
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = ds_s[(ty + kTy * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_s[c * (DH + 1) + tx + kTx * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = fmaf(dsv[i], kv[j], dq[i][j]);
      }
    }
    __syncthreads();  // the tile's buffers are rewritten by the next one
  }

  T* dq_out = static_cast<T*>(p.dq);
  const int heads = p.kv_heads * p.g;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + kTy * i;
    if (r >= live) continue;
    const int fr = row0 + r;
    const int64_t s = fr / p.g;
    const int64_t h = kh * p.g + fr % p.g;
    const int64_t at = ((static_cast<int64_t>(b) * p.sq + s) * heads + h) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dq_out[at + tx + kTx * j] = from_float<T>(dq[i][j] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// launches

// The dynamic shared memory a kernel may take beyond 48 KB is an attribute
// of the function on the current device: each launcher opts in once for
// each device, through its own `configured` flags.
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

template <typename T, int DH>
int launch_dh(const Params& p, int batch, cudaStream_t stream) {
  using Tl = Tiles<DH>;
  const int rows = p.sq * p.g;
  {
    constexpr int BR = Tl::kPreRows, BK = Tl::kPreKeys;
    constexpr size_t bytes = prepass_smem<DH, BR, BK>();
    static bool configured[kMaxDevices] = {};
    int err = allow_smem(attn_bwd_prepass<T, DH, BR, BK>, bytes, configured);
    if (err != 0) return err;
    const dim3 grid((rows + BR - 1) / BR, p.kv_heads, batch);
    attn_bwd_prepass<T, DH, BR, BK><<<grid, kThreads, bytes, stream>>>(p);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  {
    constexpr int BR = Tl::kKvRows, BK = Tl::kKvKeys;
    constexpr size_t bytes = dkdv_smem<DH, BR, BK>();
    static bool configured[kMaxDevices] = {};
    int err = allow_smem(attn_bwd_dkdv<T, DH, BR, BK>, bytes, configured);
    if (err != 0) return err;
    const dim3 grid((p.skv + BK - 1) / BK, p.kv_heads, batch);
    attn_bwd_dkdv<T, DH, BR, BK><<<grid, kThreads, bytes, stream>>>(p);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  {
    constexpr int BR = Tl::kQRows, BK = Tl::kQKeys;
    constexpr size_t bytes = dq_smem<DH, BR, BK>();
    static bool configured[kMaxDevices] = {};
    int err = allow_smem(attn_bwd_dq<T, DH, BR, BK>, bytes, configured);
    if (err != 0) return err;
    const dim3 grid((rows + BR - 1) / BR, p.kv_heads, batch);
    attn_bwd_dq<T, DH, BR, BK><<<grid, kThreads, bytes, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch(const Params& p, int batch, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_dh<T, 16>(p, batch, stream);
    case 32: return launch_dh<T, 32>(p, batch, stream);
    case 64: return launch_dh<T, 64>(p, batch, stream);
    case 128: return launch_dh<T, 128>(p, batch, stream);
    case 256: return launch_dh<T, 256>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, Sq, K*G, Dh), o and dO alike, through their strides; k and v
// (B, Skv, K, Dh) through theirs; dq (B, Sq, K*G, Dh) and dk, dv
// (B, Skv, K, Dh) contiguous; q_pos (Sq,) and kv_pos (Skv,) int32 on the
// device.  dims (host memory, int64): B, Sq, Skv, K, G, Dh, then the
// (batch, sequence, head) element strides of q, k, v, o and dO, then causal
// (0/1) and window (0 = none).  dtype code: 0 = float32, 1 = bfloat16 (all
// ten tensors but the positions alike).  workspace: 2 * B * K * Sq * G fp32
// on the device (the rows' LSE, then their D).  Every stride and pointer
// of the inputs must be 16-byte aligned.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, const void* q_pos,
                             const void* kv_pos, const int64_t* dims,
                             float scale, int dtype, void* workspace,
                             void* stream) {
  const int64_t batch = dims[0], sq = dims[1], skv = dims[2];
  const int64_t kv_heads = dims[3], g = dims[4], dh = dims[5];
  if (batch <= 0 || sq <= 0 || skv <= 0 || kv_heads <= 0 || g <= 0 ||
      batch > 65535 || kv_heads > 65535 || sq * g > INT32_MAX / 2 ||
      skv > INT32_MAX / 2 || workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_pos = static_cast<const int32_t*>(q_pos);
  p.kv_pos = static_cast<const int32_t*>(kv_pos);
  p.lse = static_cast<float*>(workspace);
  p.dsum = p.lse + batch * kv_heads * sq * g;
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
  p.d_sb = dims[18];
  p.d_ss = dims[19];
  p.d_sh = dims[20];
  p.sq = static_cast<int>(sq);
  p.skv = static_cast<int>(skv);
  p.g = static_cast<int>(g);
  p.kv_heads = static_cast<int>(kv_heads);
  p.causal = static_cast<int>(dims[21]);
  p.window = static_cast<int>(dims[22]);
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(batch), d = static_cast<int>(dh);
  if (dtype == 0) return launch<float>(p, b, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, b, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
