// The gradient of the flash attention (flash_attention.cu) for sm_90a:
// FlashAttention-2's backward.  Two routes behind one function each:
//
//   flash_attention_backward_tc  bf16: the products on the tensor cores
//                                (mma.sync.m16n8k16, bf16 in, fp32 sums).
//   flash_attention_backward     float32: on CUDA cores in fp32.
//
// The wrapper (ops.py, `_backward_route`) chooses from the dtype alone.
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
// Rows are the flattened (query position s, group member g) index
// r = s * G + g of one kv head, as in the forward kernels; each row's LSE
// and D live in (B, K, Sq * G) fp32 arrays.  The LSE is the one the forward
// saved (flash_attention.cu writes it when asked), so no pass recomputes
// it; the float32 route recomputes it where none is given.
//
// Bound: operations.  Five S x S x Dh products a call (S and dP recomputed,
// dV, dK, dQ; causal: half the pairs), 10 * Dh operations an attended
// (query head, key) pair, against the bf16 tensor cores (989 TFLOP/s dense;
// float32 outside them, 67 TFLOP/s).  At the yi-9b train cell (q (2, 4096,
// 4, 8, 128), causal) that is 687 GFLOP, 0.695 ms.
//
// The tc route (bf16), three launches:
//   1. attn_bwd_dsum: D of every row, a row on DH / 8 lanes with 16-byte
//      loads, a shuffle tree: one read of dO and O.
//   2. attn_bwd_dkdv_tc: a block for each (b, kv head, 64 keys), 4 warps,
//      each warp a 16-key strip whose dK and dV stay in fp32 registers.  K
//      and V are staged once; the row tiles that the mask lets reach the
//      keys come through a two-stage cp.async ring (Q, dO and the rows'
//      LSE, D and positions), in row order, so the G query heads of a group
//      add in a fixed order.  A tile's liveness comes from its rows'
//      position range against the block's key range (each warp scans 32
//      tiles at once, a lane a tile, with warp votes: no barrier).  With the
//      keys as the m dimension, S^T = K Q^T and dP^T = V dO^T land in the
//      accumulator layout that the next mma takes as its A operand (the
//      forward's trick for P V): P^T = exp2(S^T scale log2(e) - LSE log2(e))
//      and dS^T = P^T (dP^T - D) are rounded to bf16 in registers, and
//      dV += P^T dO, dK += dS^T Q take dO's and Q's B fragments by
//      ldmatrix.trans.  Causal calls start with the first key tiles, which
//      the most rows attend.
//   3. attn_bwd_dq_tc: a block for each (b, kv head, 64 rows), 4 warps of
//      16 rows, walks the key tiles its rows attend through a two-stage
//      cp.async ring of K and V (the forward's scan and ring): S = Q K^T,
//      dP = dO V^T, P and dS in registers, dQ += dS K (K's B fragments by
//      ldmatrix.trans).  So dQ's pass recomputes S and dP: seven products
//      a call, not five, and no atomics.  Causal calls launch the last row
//      tiles, the heaviest, first.
//   Head dim 256: smaller tiles.  The ring steps 32 rows (dK/dV) and 32 keys
//   (dQ), and a 16-key strip's dK and dV together (256 fp32 registers a
//   thread) do not fit, so the dK/dV pass runs twice, for dV (S^T, dV) and
//   for dK (S^T, dP^T, dK): 8 products a call.
//   Masks and empty slots: a tile that every row attends whole skips the
//   per-element mask; elsewhere P = 0 where not attended, and rows past the
//   end get LSE = +inf, so P = 0 there too.  Empty slots (kv_pos < 0), the
//   ragged end and rows past the end are zero-filled by the copies
//   themselves: a ring cache's empty slot may hold NaN, and 0 * NaN is NaN.
//   Precision: P and dS are rounded to bf16 as the A operands (as
//   FlashAttention-2 does); every sum is fp32.
//   Shared memory at Dh 128: dK/dV 104 KB, dQ 104 KB (two blocks an SM);
//   at Dh 256: 135 KB each (one).
//   What holds it back now: mma.sync issues from every warp with no
//   producer/consumer split, so the ldmatrix loads of Q, dO, K and V share
//   the warps' issue slots with the products; the dQ pass's recomputation of
//   S and dP (two of seven products); 4-warp blocks, two an SM.  Not yet:
//   wgmma, TMA, warp specialisation.
//
// The float32 route, on CUDA cores in fp32: attn_bwd_dsum (D), where no
// LSE is given attn_bwd_prepass (each row's LSE, by an online max and sum
// over the key tiles it attends), attn_bwd_dkdv (a block for each (b, kv
// head, tile of keys) walks the row tiles that reach it, in row order) and
// attn_bwd_dq (a block for each (b, kv head, tile of rows) walks its key
// tiles).  Operands staged
// in shared memory as fp32 (rows padded by one float), each thread a
// register micro-tile of 16 x 16 threads' strided rows and columns; empty
// tiles skipped whole, empty slots and rows past the end zero-filled.
//
// No block writes what another block writes and every sum runs in a fixed
// order: no atomics, so the same inputs give the same bits.  Types: q, k,
// v, o, dO bf16 (tc) or float32, fp32 inside, dq, dk, dv in that dtype; Dh
// in {16, 32, 64, 128, 256}.  Every kernel launches on the caller's
// stream, allocates nothing and never synchronizes; each entry point
// returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace {

constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
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
  float* lse;             // (B, K, Sq * G): the forward's, or the pre-pass's
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

// 16 bytes of T from global memory, as 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = to_float(e[i]);
}

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

// ---------------------------------------------------------------------------
// D of every row (both routes).

constexpr int kDsumThreads = 256;

// Row i of the (B, K, Sq * G) index on TPR consecutive lanes, each of
// DH / (VEC * TPR) 16-byte vectors of dO and O, added in a fixed tree.
template <typename T, int DH>
__global__ void __launch_bounds__(kDsumThreads)
attn_bwd_dsum(const Params p, int64_t total) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TPR = DH / VEC < 32 ? DH / VEC : 32;
  constexpr int PER = DH / (VEC * TPR);
  const int64_t rows = static_cast<int64_t>(p.sq) * p.g;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * (kDsumThreads / TPR) +
                    threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  float acc = 0.f;
  if (i < total) {
    const int64_t bk = i / rows, r = i % rows;
    const int64_t b = bk / p.kv_heads, kh = bk % p.kv_heads;
    const int64_t s = r / p.g, h = kh * p.g + r % p.g;
    const T* orow =
        static_cast<const T*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh;
    const T* drow = static_cast<const T*>(p.dout) + b * p.d_sb + s * p.d_ss +
                    h * p.d_sh;
#pragma unroll
    for (int c = 0; c < PER; ++c) {
      const int d = (c * TPR + t) * VEC;
      float ov[VEC], dv[VEC];
      load_vec<T>(orow + d, ov);
      load_vec<T>(drow + d, dv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = fmaf(dv[e], ov[e], acc);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (t == 0 && i < total) p.dsum[i] = acc;
}

template <typename T, int DH>
int launch_dsum(const Params& p, int batch, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TPR = DH / VEC < 32 ? DH / VEC : 32;
  constexpr int kRowsPerBlock = kDsumThreads / TPR;
  const int64_t total =
      static_cast<int64_t>(batch) * p.kv_heads * p.sq * p.g;
  const int64_t blocks = (total + kRowsPerBlock - 1) / kRowsPerBlock;
  attn_bwd_dsum<T, DH><<<static_cast<unsigned>(blocks), kDsumThreads, 0,
                         stream>>>(p, total);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tc route (bf16): dK/dV and dQ on the tensor cores.

constexpr int kTcThreads = 128;  // 4 warps
constexpr int kTcKeys = 64;      // keys of a dK/dV block: a 16-key strip a warp
constexpr int kTcRows = 64;      // rows of a dQ block: a 16-row strip a warp

// what a dK/dV launch accumulates
constexpr int kDv = 1;
constexpr int kDk = 2;

template <int DH, int BR>
struct DkdvShape {
  static constexpr int kStride = DH + 8;  // padded row, in elements
  static constexpr int kRowTile = BR * kStride;
  // K and V of the block's keys, the ring's Q and dO tiles (2 stages each),
  // then each stage's rows' LSE (log2 units), D and positions, then the
  // keys' positions
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kTcKeys * kStride + 4 * kRowTile) +
      2 * BR * (2 * sizeof(float) + sizeof(int)) + sizeof(int) * kTcKeys;
};

template <int DH, int BR, int PARTS>
__global__ void __launch_bounds__(kTcThreads, DH >= 256 ? 1 : 2)
attn_bwd_dkdv_tc(const Params p) {
  using S = DkdvShape<DH, BR>;
  constexpr int RS = S::kStride;
  constexpr int KSTEPS = DH / 16;  // k-steps of S^T = K Q^T, dP^T = V dO^T
  constexpr int NT = BR / 8;       // n-tiles of S^T (8 rows each)
  constexpr int DT = DH / 8;       // n-tiles of dK and dV (8 dims each)
  constexpr bool kWantDv = (PARTS & kDv) != 0;
  constexpr bool kWantDk = (PARTS & kDk) != 0;
  static_assert(DH % 16 == 0 && BR % 16 == 0, "tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // (64, RS)
  bf16* v_s = k_s + kTcKeys * RS;                  // (64, RS)
  bf16* q_s = v_s + kTcKeys * RS;                  // 2 x (BR, RS)
  bf16* do_s = q_s + 2 * S::kRowTile;              // 2 x (BR, RS)
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * S::kRowTile);  // 2 x BR
  float* dsum_s = lse_s + 2 * BR;                                   // 2 x BR
  int* qpos_s = reinterpret_cast<int*>(dsum_s + 2 * BR);            // 2 x BR
  int* kpos_s = qpos_s + 2 * BR;                                    // 64

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int k0 = blockIdx.x * kTcKeys;
  const int rows = p.sq * p.g;
  const int64_t ws0 = (static_cast<int64_t>(b) * p.kv_heads + kh) * rows;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.d_sb;

  // the block's keys: their positions (-1 empty or past the end), range and
  // whether all are filled slots, in every warp alike
  int k_lo = INT32_MAX, k_hi = INT32_MIN;
  bool every_key = true;
#pragma unroll
  for (int c = lane; c < kTcKeys; c += 32) {
    const int j = k0 + c;
    const int kp = j < p.skv ? __ldg(p.kv_pos + j) : -1;
    if (kp >= 0) {
      k_lo = min(k_lo, kp);
      k_hi = max(k_hi, kp);
    } else {
      every_key = false;
    }
    if (warp == 0) kpos_s[c] = kp;
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    k_lo = min(k_lo, __shfl_xor_sync(0xffffffffu, k_lo, off));
    k_hi = max(k_hi, __shfl_xor_sync(0xffffffffu, k_hi, off));
  }
  every_key = __all_sync(0xffffffffu, every_key);
  const bool some_key = k_lo <= k_hi;

  // K (and V for dK) once, empty slots and the ragged end zero-filled
  for (int i = tid; i < kTcKeys * (DH / 8); i += kTcThreads) {
    const int c = i / (DH / 8), d = (i % (DH / 8)) * 8;
    const int64_t j = k0 + c;
    const bool ok = j < p.skv && __ldg(p.kv_pos + j) >= 0;
    cp_async16(k_s + c * RS + d, ok ? k + j * p.k_ss + d : k, ok);
    if (kWantDk) cp_async16(v_s + c * RS + d, ok ? v + j * p.v_ss + d : v, ok);
  }

  // Flags of the row tiles 32c .. 32c + 31, a lane a tile: `live` if the
  // tile's position range can attend the block's key range, `full` if
  // every row attends every key (so the per-element mask is skipped).
  // Ranges only over-state the pairs, so a tile flagged dead has none.
  const int ntiles = (rows + BR - 1) / BR;
  int chunk = -1;
  uint32_t live = 0u, full = 0u;
  auto scan = [&](int c) {
    const int t = c * 32 + lane;
    bool lv = false, fl = false;
    if (t < ntiles && some_key) {
      const int r_end = min(rows, (t + 1) * BR) - 1;
      int q_lo = INT32_MAX, q_hi = INT32_MIN;
      for (int s = t * BR / p.g; s <= r_end / p.g; ++s) {
        const int qp = __ldg(p.q_pos + s);
        q_lo = min(q_lo, qp);
        q_hi = max(q_hi, qp);
      }
      lv = (!p.causal || q_hi >= k_lo) &&
           (p.window <= 0 || q_lo - k_hi < p.window);
      fl = every_key && (!p.causal || q_lo >= k_hi) &&
           (p.window <= 0 || q_hi - k_lo < p.window);
    }
    live = __ballot_sync(0xffffffffu, lv);
    full = __ballot_sync(0xffffffffu, fl);
  };
  // the next row tile at or after t that reaches the keys (ntiles if none)
  auto next_live = [&](int t, bool& whole) {
    while (t < ntiles) {
      const int c = t / 32;
      if (c != chunk) {
        scan(c);
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

  // Q and dO of row tile t into ring slot `stage` (rows past the end
  // zero-filled by the copy), and the rows' LSE in log2 units (+inf past
  // the end, so P = 0 there), D and positions
  auto load_rows = [&](int stage, int t) {
    const int r0 = t * BR;
    bf16* qs = q_s + stage * S::kRowTile;
    bf16* ds = do_s + stage * S::kRowTile;
    for (int i = tid; i < BR * (DH / 8); i += kTcThreads) {
      const int r = i / (DH / 8), d = (i % (DH / 8)) * 8;
      const bool ok = r0 + r < rows;
      const int fr = ok ? r0 + r : 0;
      const int64_t s = fr / p.g;
      const int64_t h = kh * p.g + fr % p.g;
      cp_async16(qs + r * RS + d, q + s * p.q_ss + h * p.q_sh + d, ok);
      cp_async16(ds + r * RS + d, dout + s * p.d_ss + h * p.d_sh + d, ok);
    }
    for (int r = tid; r < BR; r += kTcThreads) {
      const bool ok = r0 + r < rows;
      lse_s[stage * BR + r] = ok ? p.lse[ws0 + r0 + r] * kLog2e : INFINITY;
      dsum_s[stage * BR + r] = ok && kWantDk ? p.dsum[ws0 + r0 + r] : 0.f;
      qpos_s[stage * BR + r] = __ldg(p.q_pos + (ok ? r0 + r : r0) / p.g);
    }
  };

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;
  // this thread's keys in the accumulators: strip rows lane / 4 (e = 0, 1)
  // and lane / 4 + 8 (e = 2, 3); its rows 8n + 2 * (lane % 4) + {0, 1}
  const int key0 = warp * 16 + lane / 4;

  bool cur_whole = false;
  int cur = next_live(0, cur_whole);
  if (cur < ntiles) load_rows(0, cur);
  cp_async_commit();  // with K and V
  int stage = 0;
  while (cur < ntiles) {
    bool nxt_whole = false;
    const int nxt = next_live(cur + 1, nxt_whole);
    if (nxt < ntiles) load_rows(stage ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copies just issued
    __syncthreads();

    const bf16* qs = q_s + stage * S::kRowTile;
    const bf16* ds = do_s + stage * S::kRowTile;
    const float* ls = lse_s + stage * BR;
    const float* dd = dsum_s + stage * BR;
    const int* qp = qpos_s + stage * BR;

    // S^T = K Q^T: this warp's 16 keys x the tile's BR rows
    float st[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, k_s + (warp * 16 + lane % 16) * RS + kk * 16 +
                         (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, qs + (np * 16 + lane % 8 + (lane / 16) * 8) * RS +
                           kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(st[2 * np], a, r[0], r[1]);
        mma_bf16(st[2 * np + 1], a, r[2], r[3]);
      }
    }

    // P^T = exp2(S^T scale log2(e) - LSE2), 0 where not attended
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(ls + n * 8 + 2 * (lane % 4));
      st[n][0] = exp2f(fmaf(st[n][0], scale_log2, -l2.x));
      st[n][1] = exp2f(fmaf(st[n][1], scale_log2, -l2.y));
      st[n][2] = exp2f(fmaf(st[n][2], scale_log2, -l2.x));
      st[n][3] = exp2f(fmaf(st[n][3], scale_log2, -l2.y));
    }
    if (!cur_whole) {
      const int kp0 = kpos_s[key0], kp1 = kpos_s[key0 + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int2 qq =
            *reinterpret_cast<const int2*>(qp + n * 8 + 2 * (lane % 4));
        if (!attends(qq.x, kp0, p)) st[n][0] = 0.f;
        if (!attends(qq.y, kp0, p)) st[n][1] = 0.f;
        if (!attends(qq.x, kp1, p)) st[n][2] = 0.f;
        if (!attends(qq.y, kp1, p)) st[n][3] = 0.f;
      }
    }

    if constexpr (kWantDv) {
      // dV += P^T dO: P^T (bf16) is the A operand, 16 rows a k-step
#pragma unroll
      for (int t = 0; t < BR / 16; ++t) {
        uint32_t a[4];
        a[0] = pack_bf16(st[2 * t][0], st[2 * t][1]);
        a[1] = pack_bf16(st[2 * t][2], st[2 * t][3]);
        a[2] = pack_bf16(st[2 * t + 1][0], st[2 * t + 1][1]);
        a[3] = pack_bf16(st[2 * t + 1][2], st[2 * t + 1][3]);
#pragma unroll
        for (int np = 0; np < DT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, ds + (t * 16 + lane % 16) * RS + np * 16 +
                                   (lane / 16) * 8);
          mma_bf16(dv[2 * np], a, r[0], r[1]);
          mma_bf16(dv[2 * np + 1], a, r[2], r[3]);
        }
      }
    }

    if constexpr (kWantDk) {
      // dP^T = V dO^T, then dS^T = P^T (dP^T - D) in its place
      float dpt[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, v_s + (warp * 16 + lane % 16) * RS + kk * 16 +
                           (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, ds + (np * 16 + lane % 8 + (lane / 16) * 8) * RS +
                             kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(dpt[2 * np], a, r[0], r[1]);
          mma_bf16(dpt[2 * np + 1], a, r[2], r[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(dd + n * 8 + 2 * (lane % 4));
        dpt[n][0] = st[n][0] * (dpt[n][0] - d2.x);
        dpt[n][1] = st[n][1] * (dpt[n][1] - d2.y);
        dpt[n][2] = st[n][2] * (dpt[n][2] - d2.x);
        dpt[n][3] = st[n][3] * (dpt[n][3] - d2.y);
      }
      // dK += dS^T Q
#pragma unroll
      for (int t = 0; t < BR / 16; ++t) {
        uint32_t a[4];
        a[0] = pack_bf16(dpt[2 * t][0], dpt[2 * t][1]);
        a[1] = pack_bf16(dpt[2 * t][2], dpt[2 * t][3]);
        a[2] = pack_bf16(dpt[2 * t + 1][0], dpt[2 * t + 1][1]);
        a[3] = pack_bf16(dpt[2 * t + 1][2], dpt[2 * t + 1][3]);
#pragma unroll
        for (int np = 0; np < DT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, qs + (t * 16 + lane % 16) * RS + np * 16 +
                                   (lane / 16) * 8);
          mma_bf16(dk[2 * np], a, r[0], r[1]);
          mma_bf16(dk[2 * np + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // the slot is refilled in the next iteration
    cur = nxt;
    cur_whole = nxt_whole;
    stage ^= 1;
  }
  cp_async_wait<0>();

  // dK * scale and dV in bf16: keys key0 and key0 + 8, dims 8n + 2(lane % 4)
  bf16* dk_out = static_cast<bf16*>(p.dk);
  bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + key0 + 8 * half;
    if (key >= p.skv) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * p.skv + key) * p.kv_heads + kh) * DH +
        2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      if constexpr (kWantDk) {
        *reinterpret_cast<__nv_bfloat162*>(dk_out + at + n * 8) =
            __floats2bfloat162_rn(dk[n][2 * half] * p.scale,
                                  dk[n][2 * half + 1] * p.scale);
      }
      if constexpr (kWantDv) {
        *reinterpret_cast<__nv_bfloat162*>(dv_out + at + n * 8) =
            __floats2bfloat162_rn(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
}

template <int DH, int BK>
struct DqShape {
  static constexpr int kStride = DH + 8;  // padded row, in elements
  static constexpr int kTile = BK * kStride;
  // Q and dO tiles, then the ring's K and V tiles (2 stages each), then
  // the ring's kv positions
  static constexpr size_t kSmem =
      sizeof(bf16) * (2 * kTcRows * kStride + 4 * kTile) +
      sizeof(int) * 2 * BK;
};

template <int DH, int BK>
__global__ void __launch_bounds__(kTcThreads, DH >= 256 ? 1 : 2)
attn_bwd_dq_tc(const Params p) {
  using S = DqShape<DH, BK>;
  constexpr int RS = S::kStride;
  constexpr int KSTEPS = DH / 16;  // k-steps of S = Q K^T and dP = dO V^T
  constexpr int NT = BK / 8;       // n-tiles of S (8 keys each)
  constexpr int DT = DH / 8;       // n-tiles of dQ (8 dims each)
  static_assert(DH % 16 == 0 && BK % 16 == 0, "tile");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // (64, RS)
  bf16* do_s = q_s + kTcRows * RS;                 // (64, RS)
  bf16* k_s = do_s + kTcRows * RS;                 // 2 x (BK, RS)
  bf16* v_s = k_s + 2 * S::kTile;                  // 2 x (BK, RS)
  int* kpos_s = reinterpret_cast<int*>(v_s + 2 * S::kTile);  // 2 x BK

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int rows = p.sq * p.g;
  // causal calls: the last row tiles attend the most keys; start them first
  const int tile = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int row0 = tile * kTcRows;
  const int live_rows = min(kTcRows, rows - row0);
  const int64_t ws0 = (static_cast<int64_t>(b) * p.kv_heads + kh) * rows;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* dout = static_cast<const bf16*>(p.dout) + b * p.d_sb;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + kh * p.v_sh;

  // the Q and dO tiles, once (rows past the end as zeros)
  for (int i = tid; i < kTcRows * (DH / 8); i += kTcThreads) {
    const int r = i / (DH / 8), d = (i % (DH / 8)) * 8;
    const bool ok = r < live_rows;
    const int fr = row0 + (ok ? r : 0);
    const int64_t s = fr / p.g;
    const int64_t h = kh * p.g + fr % p.g;
    cp_async16(q_s + r * RS + d, q + s * p.q_ss + h * p.q_sh + d, ok);
    cp_async16(do_s + r * RS + d, dout + s * p.d_ss + h * p.d_sh + d, ok);
  }

  // this thread's two rows: positions, LSE in log2 units (+inf past the
  // end, so P = 0 there) and D; the block's position range
  const int r_lo = warp * 16 + lane / 4;
  const int qp0 = __ldg(p.q_pos + (row0 + min(r_lo, live_rows - 1)) / p.g);
  const int qp1 =
      __ldg(p.q_pos + (row0 + min(r_lo + 8, live_rows - 1)) / p.g);
  const bool ok0 = r_lo < live_rows, ok1 = r_lo + 8 < live_rows;
  const float l2_0 = ok0 ? p.lse[ws0 + row0 + r_lo] * kLog2e : INFINITY;
  const float l2_1 = ok1 ? p.lse[ws0 + row0 + r_lo + 8] * kLog2e : INFINITY;
  const float d0 = ok0 ? p.dsum[ws0 + row0 + r_lo] : 0.f;
  const float d1 = ok1 ? p.dsum[ws0 + row0 + r_lo + 8] : 0.f;
  int q_lo, q_hi;
  {
    const int a = __ldg(p.q_pos + (row0 + min(lane, live_rows - 1)) / p.g);
    const int c =
        __ldg(p.q_pos + (row0 + min(lane + 32, live_rows - 1)) / p.g);
    q_lo = min(a, c);
    q_hi = max(a, c);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      q_lo = min(q_lo, __shfl_xor_sync(0xffffffffu, q_lo, off));
      q_hi = max(q_hi, __shfl_xor_sync(0xffffffffu, q_hi, off));
    }
  }

  // the next kv tile at or after t that some row attends (ntiles if none)
  const int ntiles = (p.skv + BK - 1) / BK;
  int chunk = -1;
  uint32_t live = 0u, full = 0u;
  auto next_live = [&](int t, bool& whole) {
    while (t < ntiles) {
      const int c = t / 32;
      if (c != chunk) {
        scan_kv_tiles<BK>(p.kv_pos, p.skv, p.causal, p.window, c, q_lo, q_hi,
                          live, full);
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
    const int j0 = t * BK;
    bf16* ks = k_s + stage * S::kTile;
    bf16* vs = v_s + stage * S::kTile;
    for (int c = tid; c < BK; c += kTcThreads) {
      kpos_s[stage * BK + c] = j0 + c < p.skv ? __ldg(p.kv_pos + j0 + c) : -1;
    }
    for (int i = tid; i < BK * (DH / 8); i += kTcThreads) {
      const int c = i / (DH / 8), d = (i % (DH / 8)) * 8;
      const int64_t j = j0 + c;
      const bool ok = j < p.skv && __ldg(p.kv_pos + j) >= 0;
      cp_async16(ks + c * RS + d, ok ? k + j * p.k_ss + d : k, ok);
      cp_async16(vs + c * RS + d, ok ? v + j * p.v_ss + d : v, ok);
    }
  };

  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;

  bool cur_whole = false;
  int cur = next_live(0, cur_whole);
  if (cur < ntiles) load_kv(0, cur);
  cp_async_commit();  // with the Q and dO tiles
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
    const int* kp = kpos_s + stage * BK;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows and BK keys
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4], ad[4];
      ldmatrix_x4(a, q_s + (warp * 16 + lane % 16) * RS + kk * 16 +
                         (lane / 16) * 8);
      ldmatrix_x4(ad, do_s + (warp * 16 + lane % 16) * RS + kk * 16 +
                          (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int at = (np * 16 + lane % 8 + (lane / 16) * 8) * RS +
                       kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, ks + at);
        mma_bf16(sc[2 * np], a, r[0], r[1]);
        mma_bf16(sc[2 * np + 1], a, r[2], r[3]);
        ldmatrix_x4(r, vs + at);
        mma_bf16(dp[2 * np], ad, r[0], r[1]);
        mma_bf16(dp[2 * np + 1], ad, r[2], r[3]);
      }
    }

    // P = exp2(S scale log2(e) - LSE2), 0 where not attended; this thread's
    // keys are 8n + 2 * (lane % 4) + {0, 1} of rows r_lo (e = 0, 1) and
    // r_lo + 8 (e = 2, 3); then dS = P (dP - D) in dP's place
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = exp2f(fmaf(sc[n][0], scale_log2, -l2_0));
      sc[n][1] = exp2f(fmaf(sc[n][1], scale_log2, -l2_0));
      sc[n][2] = exp2f(fmaf(sc[n][2], scale_log2, -l2_1));
      sc[n][3] = exp2f(fmaf(sc[n][3], scale_log2, -l2_1));
    }
    if (!cur_whole) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int2 kk2 =
            *reinterpret_cast<const int2*>(kp + n * 8 + 2 * (lane % 4));
        if (!attends(qp0, kk2.x, p)) sc[n][0] = 0.f;
        if (!attends(qp0, kk2.y, p)) sc[n][1] = 0.f;
        if (!attends(qp1, kk2.x, p)) sc[n][2] = 0.f;
        if (!attends(qp1, kk2.y, p)) sc[n][3] = 0.f;
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      dp[n][0] = sc[n][0] * (dp[n][0] - d0);
      dp[n][1] = sc[n][1] * (dp[n][1] - d0);
      dp[n][2] = sc[n][2] * (dp[n][2] - d1);
      dp[n][3] = sc[n][3] * (dp[n][3] - d1);
    }

    // dQ += dS K: dS (bf16) is the A operand, 16 keys a k-step
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      uint32_t a[4];
      a[0] = pack_bf16(dp[2 * t][0], dp[2 * t][1]);
      a[1] = pack_bf16(dp[2 * t][2], dp[2 * t][3]);
      a[2] = pack_bf16(dp[2 * t + 1][0], dp[2 * t + 1][1]);
      a[3] = pack_bf16(dp[2 * t + 1][2], dp[2 * t + 1][3]);
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ks + (t * 16 + lane % 16) * RS + np * 16 +
                                 (lane / 16) * 8);
        mma_bf16(dq[2 * np], a, r[0], r[1]);
        mma_bf16(dq[2 * np + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // the slot is refilled in the next iteration
    cur = nxt;
    cur_whole = nxt_whole;
    stage ^= 1;
  }
  cp_async_wait<0>();

  // dQ * scale in bf16 into dq's contiguous (B, Sq, K * G, Dh)
  bf16* dq_out = static_cast<bf16*>(p.dq);
  const int heads = p.kv_heads * p.g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= live_rows) continue;
    const int fr = row0 + r;
    const int64_t s = fr / p.g;
    const int64_t h = kh * p.g + fr % p.g;
    bf16* out = dq_out + ((static_cast<int64_t>(b) * p.sq + s) * heads + h) *
                             DH + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) = __floats2bfloat162_rn(
          dq[n][2 * half] * p.scale, dq[n][2 * half + 1] * p.scale);
    }
  }
}

template <int DH, int BR, int PARTS>
int launch_dkdv_tc(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t bytes = DkdvShape<DH, BR>::kSmem;
  static bool configured[kMaxDevices] = {};
  const int err =
      allow_smem(attn_bwd_dkdv_tc<DH, BR, PARTS>, bytes, configured);
  if (err != 0) return err;
  const dim3 grid((p.skv + kTcKeys - 1) / kTcKeys, p.kv_heads, batch);
  attn_bwd_dkdv_tc<DH, BR, PARTS><<<grid, kTcThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH, int BK>
int launch_dq_tc(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t bytes = DqShape<DH, BK>::kSmem;
  static bool configured[kMaxDevices] = {};
  const int err = allow_smem(attn_bwd_dq_tc<DH, BK>, bytes, configured);
  if (err != 0) return err;
  const dim3 grid((p.sq * p.g + kTcRows - 1) / kTcRows, p.kv_heads, batch);
  attn_bwd_dq_tc<DH, BK><<<grid, kTcThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// D, then dK and dV, then dQ.  Head dim 256 steps 32 rows and 32 keys, and
// takes dV and dK in two launches (their accumulators together would not
// fit a thread's registers).
template <int DH>
int launch_tc_dh(const Params& p, int batch, cudaStream_t stream) {
  constexpr bool kWide = DH >= 256;
  constexpr int BR = kWide ? 32 : 64;
  constexpr int BK = kWide ? 32 : 64;
  int err = launch_dsum<bf16, DH>(p, batch, stream);
  if (err != 0) return err;
  if constexpr (kWide) {
    err = launch_dkdv_tc<DH, BR, kDv>(p, batch, stream);
    if (err != 0) return err;
    err = launch_dkdv_tc<DH, BR, kDk>(p, batch, stream);
  } else {
    err = launch_dkdv_tc<DH, BR, kDv | kDk>(p, batch, stream);
  }
  if (err != 0) return err;
  return launch_dq_tc<DH, BK>(p, batch, stream);
}

int launch_tc(const Params& p, int batch, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_tc_dh<16>(p, batch, stream);
    case 32: return launch_tc_dh<32>(p, batch, stream);
    case 64: return launch_tc_dh<64>(p, batch, stream);
    case 128: return launch_tc_dh<128>(p, batch, stream);
    case 256: return launch_tc_dh<256>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The float32 route, on CUDA cores.

constexpr int kThreads = 256;
constexpr int kTy = 16;  // micro-tile thread rows
constexpr int kTx = 16;  // micro-tile thread columns

// Rows row0 .. row0 + BR - 1 of the flattened (s, g) index of kv head kh
// into dst (BR, DH + 1); rows at or past `live` as zeros.
template <int DH, int BR>
__device__ __forceinline__ void load_rows(const float* base, int64_t sb,
                                          int64_t ss, int64_t sh, int b,
                                          int kh, int g, int row0, int live,
                                          float* dst) {
  for (int idx = threadIdx.x; idx < BR * (DH / 4); idx += kThreads) {
    const int r = idx / (DH / 4);
    const int d = (idx % (DH / 4)) * 4;
    float val[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < live) {
      const int fr = row0 + r;
      const int64_t s = fr / g;
      const int64_t h = kh * g + fr % g;
      load_vec<float>(base + b * sb + s * ss + h * sh + d, val);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[r * (DH + 1) + d + i] = val[i];
  }
}

// Keys k0 .. k0 + BK - 1 of kv head kh into dst (BK, DH + 1); a key whose
// kpos_s is < 0 (an empty slot or past the end) as zeros.
template <int DH, int BK>
__device__ __forceinline__ void load_keys(const float* base, int64_t sb,
                                          int64_t ss, int64_t sh, int b,
                                          int kh, int k0, const int* kpos_s,
                                          float* dst) {
  for (int idx = threadIdx.x; idx < BK * (DH / 4); idx += kThreads) {
    const int c = idx / (DH / 4);
    const int d = (idx % (DH / 4)) * 4;
    float val[4] = {0.f, 0.f, 0.f, 0.f};
    if (kpos_s[c] >= 0) {
      const int64_t j = k0 + c;
      load_vec<float>(base + b * sb + j * ss + kh * sh + d, val);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[c * (DH + 1) + d + i] = val[i];
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

// 1. The LSE of every query row, where none is given.
template <int DH, int BR, int BK>
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
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);

  load_rows<DH, BR>(q, p.q_sb, p.q_ss, p.q_sh, b, kh, p.g, row0, live, q_s);
  for (int r = tid; r < BR; r += kThreads) {
    qpos_s[r] = r < live ? p.q_pos[(row0 + r) / p.g] : 0;
  }

  // the online max and sum of row r on TPR consecutive lanes
  const int r = tid / TPR;
  const int t = tid % TPR;
  float m_run = -INFINITY, l_run = 0.f;
  for (int k0 = 0; k0 < p.skv; k0 += BK) {
    for (int c = tid; c < BK; c += kThreads) {
      const int j = k0 + c;
      kpos_s[c] = j < p.skv ? p.kv_pos[j] : -1;
    }
    __syncthreads();
    if (!tile_live<BR, BK>(qpos_s, kpos_s, live, p)) continue;
    load_keys<DH, BK>(k, p.k_sb, p.k_ss, p.k_sh, b, kh, k0, kpos_s, k_s);
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
    p.lse[(static_cast<int64_t>(b) * p.kv_heads + kh) * rows + row0 + r] =
        m_run == -INFINITY ? kLseEmpty : m_run + logf(l_run);
  }
}

// 2. dK and dV of a tile of keys.
template <int DH, int BR, int BK>
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
  load_keys<DH, BK>(static_cast<const float*>(p.k), p.k_sb, p.k_ss, p.k_sh,
                    b, kh, k0, kpos_s, k_s);
  load_keys<DH, BK>(static_cast<const float*>(p.v), p.v_sb, p.v_ss, p.v_sh,
                    b, kh, k0, kpos_s, v_s);

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
    load_rows<DH, BR>(static_cast<const float*>(p.q), p.q_sb, p.q_ss, p.q_sh,
                      b, kh, p.g, row0, live, q_s);
    load_rows<DH, BR>(static_cast<const float*>(p.dout), p.d_sb, p.d_ss,
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

  float* dk_out = static_cast<float*>(p.dk);
  float* dv_out = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = k0 + ty + kTy * i;
    if (key >= p.skv) continue;
    const int64_t at =
        ((static_cast<int64_t>(b) * p.skv + key) * p.kv_heads + kh) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_out[at + tx + kTx * j] = dk[i][j] * p.scale;
      dv_out[at + tx + kTx * j] = dv[i][j];
    }
  }
}

// 3. dQ of a tile of query rows.
template <int DH, int BR, int BK>
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

  load_rows<DH, BR>(static_cast<const float*>(p.q), p.q_sb, p.q_ss, p.q_sh, b,
                    kh, p.g, row0, live, q_s);
  load_rows<DH, BR>(static_cast<const float*>(p.dout), p.d_sb, p.d_ss,
                    p.d_sh, b, kh, p.g, row0, live, do_s);
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
    load_keys<DH, BK>(static_cast<const float*>(p.k), p.k_sb, p.k_ss, p.k_sh,
                      b, kh, k0, kpos_s, k_s);
    load_keys<DH, BK>(static_cast<const float*>(p.v), p.v_sb, p.v_ss, p.v_sh,
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

  float* dq_out = static_cast<float*>(p.dq);
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
      dq_out[at + tx + kTx * j] = dq[i][j] * p.scale;
    }
  }
}

template <typename Kernel>
int launch_simt_kernel(Kernel kernel, size_t bytes,
                       bool (&configured)[kMaxDevices], dim3 grid,
                       const Params& p, cudaStream_t stream) {
  const int err = allow_smem(kernel, bytes, configured);
  if (err != 0) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// D, the LSE where none is given, then dK and dV, then dQ.
template <int DH>
int launch_simt_dh(const Params& p, int batch, bool have_lse,
                   cudaStream_t stream) {
  using Tl = Tiles<DH>;
  const int rows = p.sq * p.g;
  int err = launch_dsum<float, DH>(p, batch, stream);
  if (err != 0) return err;
  if (!have_lse) {
    constexpr int BR = Tl::kPreRows, BK = Tl::kPreKeys;
    static bool configured[kMaxDevices] = {};
    err = launch_simt_kernel(attn_bwd_prepass<DH, BR, BK>,
                             prepass_smem<DH, BR, BK>(), configured,
                             dim3((rows + BR - 1) / BR, p.kv_heads, batch),
                             p, stream);
    if (err != 0) return err;
  }
  {
    constexpr int BR = Tl::kKvRows, BK = Tl::kKvKeys;
    static bool configured[kMaxDevices] = {};
    err = launch_simt_kernel(attn_bwd_dkdv<DH, BR, BK>,
                             dkdv_smem<DH, BR, BK>(), configured,
                             dim3((p.skv + BK - 1) / BK, p.kv_heads, batch),
                             p, stream);
  }
  if (err != 0) return err;
  constexpr int BR = Tl::kQRows, BK = Tl::kQKeys;
  static bool configured[kMaxDevices] = {};
  return launch_simt_kernel(attn_bwd_dq<DH, BR, BK>, dq_smem<DH, BR, BK>(),
                            configured,
                            dim3((rows + BR - 1) / BR, p.kv_heads, batch), p,
                            stream);
}

int launch_simt(const Params& p, int batch, int dh, bool have_lse,
                cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_simt_dh<16>(p, batch, have_lse, stream);
    case 32: return launch_simt_dh<32>(p, batch, have_lse, stream);
    case 64: return launch_simt_dh<64>(p, batch, have_lse, stream);
    case 128: return launch_simt_dh<128>(p, batch, have_lse, stream);
    case 256: return launch_simt_dh<256>(p, batch, have_lse, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The checked Params of one call from the entry points' arguments;
// cudaErrorInvalidValue for sizes the kernels do not take.  The workspace
// holds each row's D, then (where no LSE is given) its LSE.
int make_params(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv,
                const void* q_pos, const void* kv_pos, const int64_t* dims,
                float scale, void* lse, void* workspace, Params* p) {
  const int64_t batch = dims[0], sq = dims[1], skv = dims[2];
  const int64_t kv_heads = dims[3], g = dims[4];
  if (batch <= 0 || sq <= 0 || skv <= 0 || kv_heads <= 0 || g <= 0 ||
      batch > 65535 || kv_heads > 65535 || sq * g > INT32_MAX / 2 ||
      skv > INT32_MAX / 2 || workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p->q = q;
  p->k = k;
  p->v = v;
  p->o = o;
  p->dout = dout;
  p->dq = dq;
  p->dk = dk;
  p->dv = dv;
  p->q_pos = static_cast<const int32_t*>(q_pos);
  p->kv_pos = static_cast<const int32_t*>(kv_pos);
  p->dsum = static_cast<float*>(workspace);
  p->lse = lse != nullptr ? static_cast<float*>(lse)
                          : p->dsum + batch * kv_heads * sq * g;
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
  p->d_sb = dims[18];
  p->d_ss = dims[19];
  p->d_sh = dims[20];
  p->sq = static_cast<int>(sq);
  p->skv = static_cast<int>(skv);
  p->g = static_cast<int>(g);
  p->kv_heads = static_cast<int>(kv_heads);
  p->causal = static_cast<int>(dims[21]);
  p->window = static_cast<int>(dims[22]);
  p->scale = scale;
  return 0;
}

}  // namespace

extern "C" {

// Both entry points: q (B, Sq, K*G, Dh), o and dO alike, through their
// strides; k and v (B, Skv, K, Dh) through theirs; dq (B, Sq, K*G, Dh) and
// dk, dv (B, Skv, K, Dh) contiguous; q_pos (Sq,) and kv_pos (Skv,) int32 on
// the device.  dims (host memory, int64): B, Sq, Skv, K, G, Dh, then the
// (batch, sequence, head) element strides of q, k, v, o and dO, then causal
// (0/1) and window (0 = none).  dtype code: 0 = float32, 1 = bfloat16 (all
// ten tensors but the positions alike).  lse: the forward's (B, K, Sq * G)
// fp32 LSE on the device, or null.  workspace: B * K * Sq * G fp32 on the
// device for the rows' D, twice that where lse is null (then their LSE).
// Every stride and pointer of the inputs must be 16-byte aligned.

// The CUDA-core route, float32 only; without lse its pre-pass computes it.
int flash_attention_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, void* dq,
                             void* dk, void* dv, const void* q_pos,
                             const void* kv_pos, const int64_t* dims,
                             float scale, int dtype, void* lse,
                             void* workspace, void* stream) {
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  const int err = make_params(q, k, v, o, dout, dq, dk, dv, q_pos, kv_pos,
                              dims, scale, lse, workspace, &p);
  if (err != 0) return err;
  return launch_simt(p, static_cast<int>(dims[0]), static_cast<int>(dims[5]),
                     lse != nullptr, static_cast<cudaStream_t>(stream));
}

// The tensor-core route, bfloat16 only, with the forward's LSE.
int flash_attention_backward_tc(const void* q, const void* k, const void* v,
                                const void* o, const void* dout, void* dq,
                                void* dk, void* dv, const void* q_pos,
                                const void* kv_pos, const int64_t* dims,
                                float scale, int dtype, void* lse,
                                void* workspace, void* stream) {
  if (dtype != 1 || lse == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  const int err = make_params(q, k, v, o, dout, dq, dk, dv, q_pos, kv_pos,
                              dims, scale, lse, workspace, &p);
  if (err != 0) return err;
  return launch_tc(p, static_cast<int>(dims[0]), static_cast<int>(dims[5]),
                   static_cast<cudaStream_t>(stream));
}

const char* flash_attention_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
