// Grouped (per-expert) matrix products for sm_90a: the MoE expert FFN over
// capacity buffers, and the MegaBlocks-style ragged variant.
//
// Replaces the Pallas kernels of repro/kernels/grouped_matmul/kernel.py:
//
// * grouped_matmul (-> _gmm_kernel): out[e] = x[e] @ w[e] for x (E, M, K),
//   w (E, K, N), fp32 accumulation, the result in x's dtype.  The Pallas
//   grid walks K as its innermost, sequential axis and carries the fp32
//   accumulator tile in VMEM between grid steps.  CUDA blocks run in no
//   order, so here one block owns a BM x BN output tile of one expert for
//   its whole life and loops over K itself, the accumulator in registers.
// * ragged_grouped_matmul (-> _ragged_kernel): x (T, K) rows sorted by
//   group, group_sizes (E,).  Rows are cut into ownership blocks of
//   block_m rows; a block is owned by the group of its first row
//   (#{ends <= first row}, clipped to E - 1); its rows are multiplied by
//   the owner's weights, and rows outside the owner's [start, start + size)
//   are written as 0.  The Pallas kernel reads that block -> group table
//   by scalar prefetch; here every block derives its own entry from
//   group_sizes on the device (E sizes read, no host round trip), and
//   block_m stays the ownership granularity whatever tile the kernel uses
//   (an ownership block is covered by whole CUDA row tiles).
//
// Three routes, chosen by the caller (ops._route) from the dtype and the
// rows of a tile (M, or block_m for the ragged variant), both variants
// alike.  No route falls back to another.
//
// * wgmma (bf16, more than 64 rows: every prefill and window wave).
//   Bound by operations (2 * M * K * N per expert against the tensor
//   cores' 989 TFLOP/s).  What reaches that rate on Hopper is wgmma fed
//   by TMA, so gmm_wgmma_kernel is warp-specialised: a 128 x 256 output
//   tile, one producer warp (its warpgroup gives up registers with
//   setmaxnreg) that keeps a 4-stage ring of 128 x 64 x tiles and 64 x 256
//   w tiles filled by TMA, with a "full" and an "empty" mbarrier per
//   stage; two consumer warpgroups (232 registers each thread) that each
//   run wgmma.m64n256k16 on their 64-row half, A and B read from shared
//   memory through descriptors, one k tile's products in flight while
//   the next is issued.  Both maps use the 128-byte swizzle.  w is (K, N)
//   row-major, so B is N-major (the descriptor's transpose bit); a
//   swizzled box is at most 64 bf16 wide, so the 256-wide w tile arrives
//   as four 64 x 64 boxes 8 KB apart, and the descriptor's leading byte
//   offset steps between them.  Expert edges are the maps' business:
//   x is mapped as (K, M, E) and w as (N, K, E) (x as (K, T) for the
//   ragged variant, w at the block owner's index), so a tile past M, T,
//   N or K reads TMA's zero fill and never the next expert's rows.  The
//   epilogue stores fp32 -> bf16 pairs from registers, predicated on the
//   tile's rows: a ragged tile reaches into the next ownership block
//   when block_m is not a multiple of 128, so a whole-tile store would
//   overwrite that block's output; its foreign rows are loaded, and
//   written as 0.  Not done yet: a persistent grid, clusters with TMA
//   multicast, a TMA-store epilogue.
// * mma (bf16, at most 64 rows: every decode step).  Bound by bytes
//   (every expert's weights read once for 2 rows).  gmm_bf16_kernel<Decode>:
//   mma.sync.m16n8k16 on 16 x 128 tiles with a 64-deep K tile, 4 warps,
//   operands staged by cp.async (16-byte copies, zero-filled past the
//   edges) in a 4-stage ring, fragments read with ldmatrix (.trans for
//   w); the deep K tile keeps more of the weights in flight.  78,848
//   bytes of shared memory a block leave room for 2 blocks an SM, 264
//   slots on 132 SMs; mixtral's decode down (N 6,144) has 48 column tiles
//   of 8 experts, 384 blocks that each walk all 256 K tiles: 1.45 waves,
//   the second one half empty.  So the caller may split K (ops.splits_for:
//   S in 1, 2, 4, 8, the least that fills 90 % of the waves' slots; 1
//   wherever the grid already does): blockIdx.z then carries the split
//   as well as the expert, each block walks ktiles / S K tiles and
//   stores its fp32 tile to its split's plane of a workspace (S planes of
//   the output's shape), and gmm_splitk_reduce_kernel adds the planes in
//   split order and rounds once.  At S = 1 the kernel walks every K tile
//   and rounds in its own epilogue, as before the split existed.
// * f32: FFMA on CUDA cores (never TF32), 64 x 64 tiles of 4 x 4 per
//   thread, in the same loop order.
//
// bf16 products are exact in fp32 and summed in fp32 in a fixed order (a
// split K's partial sums too, added in split order by one thread an
// element; no atomics, no counters), so every call gives the same bits.
// bf16 needs K and N multiples of 8 and 16-byte aligned pointers (TMA's
// strides, cp.async's and the epilogue's vectors); the entry point
// refuses other inputs.
//
// Launches on the caller's stream (both kernels of a split, in order),
// allocates nothing (the caller passes the split's workspace), never
// synchronizes; makes the given device current only if it is not; the
// entry point returns the first error of its launches, or one of its own
// when a tensor map cannot be encoded.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is
                   // looked up at run time (encoder()), libcuda is not
                   // linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

using bf16 = __nv_bfloat16;

struct Params {
  const void* x;
  const void* w;
  void* out;
  const int32_t* group_sizes;  // (E,), ragged only
  int64_t m;                   // rows of each expert, or T (ragged)
  int64_t k, n;
  int experts;
  int ragged;
  int64_t block_m;             // ragged: rows of an ownership block
  int tiles_per_block;         // ragged: CUDA row tiles per ownership block
  int splits;                  // mma: K splits (1: no workspace)
  float* ws;                   // mma, splits > 1: (splits, out's shape)
};

// One block's share: rows [row0, row0 + rows) of x and out (within the
// expert for the grouped product), of which rows [lo, hi) of the tile are
// products and the rest zeros; element offsets of its operands, and the
// tensor-map coordinates of its first row and of its weights' expert.
struct Tile {
  int rows, lo, hi;
  int64_t a_off, b_off, c_off;
  int row0, expert;
};

// z: the block's expert (grouped; blockIdx.z but for a split K)
template <int BM>
__device__ __forceinline__ Tile make_tile(const Params& p, int64_t z) {
  Tile t;
  if (!p.ragged) {
    const int64_t e = z;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
    t.rows = static_cast<int>(min(static_cast<int64_t>(BM), p.m - row0));
    t.lo = 0;
    t.hi = t.rows;
    t.a_off = (e * p.m + row0) * p.k;
    t.b_off = e * p.k * p.n;
    t.c_off = (e * p.m + row0) * p.n;
    t.row0 = static_cast<int>(row0);
    t.expert = static_cast<int>(e);
    return t;
  }
  const int64_t first = static_cast<int64_t>(blockIdx.x / p.tiles_per_block)
                        * p.block_m;
  const int64_t row0 =
      first + static_cast<int64_t>(blockIdx.x % p.tiles_per_block) * BM;
  const int64_t end = min(min(first + p.block_m, p.m), row0 + BM);
  t.rows = static_cast<int>(max(end - row0, static_cast<int64_t>(0)));
  // the block -> group table entry: groups that end at or before the
  // ownership block's first row, clipped to E - 1
  int owner = 0;
  int64_t run = 0;
  for (int e = 0; e < p.experts; ++e) {
    run += p.group_sizes[e];
    owner += run <= first;
  }
  owner = min(owner, p.experts - 1);
  int64_t start = 0;
  for (int e = 0; e < owner; ++e) start += p.group_sizes[e];
  const int64_t stop = start + p.group_sizes[owner];
  const int64_t rows = t.rows;
  t.lo = static_cast<int>(min(max(start - row0, int64_t{0}), rows));
  t.hi = static_cast<int>(min(max(stop - row0, int64_t{0}), rows));
  t.hi = max(t.hi, t.lo);
  t.a_off = row0 * p.k;
  t.b_off = static_cast<int64_t>(owner) * p.k * p.n;
  t.c_off = row0 * p.n;
  t.row0 = static_cast<int>(row0);
  t.expert = owner;
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES>
struct Bf16Config {
  static constexpr int kBM = BM, kBN = BN, kBK = BK;
  static constexpr int kWarpsM = WARPS_M, kWarpsN = WARPS_N;
  static constexpr int kStages = STAGES;
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kAStride = BK + 8;  // padded: ldmatrix rows hit
  static constexpr int kBStride = BN + 8;  // distinct banks
  static constexpr size_t kSmem =
      sizeof(bf16) * STAGES * (BM * kAStride + BK * kBStride);
};

using Decode = Bf16Config<16, 128, 64, 1, 4, 4>;

template <class C>
__global__ void __launch_bounds__(C::kThreads)
gmm_bf16_kernel(const Params p) {
  constexpr int BM = C::kBM, BN = C::kBN, BK = C::kBK;
  constexpr int WTM = BM / C::kWarpsM, WTN = BN / C::kWarpsN;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  constexpr int AS = C::kAStride, BS = C::kBStride, STAGES = C::kStages;
  static_assert(NI % 2 == 0 && BK % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * BM * AS;

  // blockIdx.z: split * (experts, 1 when ragged) + expert
  const int ez = p.ragged ? 1 : p.experts;
  const int split = static_cast<int>(blockIdx.z) / ez;
  const Tile t = make_tile<BM>(p, blockIdx.z - split * ez);
  if (t.rows <= 0) return;
  const bf16* a = static_cast<const bf16*>(p.x) + t.a_off;
  const bf16* b = static_cast<const bf16*>(p.w) + t.b_off;
  bf16* c = static_cast<bf16*>(p.out) + t.c_off;
  const int64_t K = p.k, N = p.n;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  // this split's K tiles: [kt0, kt0 + ktiles) (splits divides the count)
  const int ktiles = static_cast<int>((K + BK - 1) / BK) / p.splits;
  const int kt0 = split * ktiles;
  // a split's fp32 partial tile goes to its plane of the workspace
  float* part = nullptr;
  if (p.splits > 1) {
    const int64_t plane = (p.ragged ? p.m : p.experts * p.m) * N;
    part = p.ws + split * plane + t.c_off;
  }

  auto load_stage = [&](int stage, int kt) {
    const int64_t k0 = static_cast<int64_t>(kt) * BK;
    bf16* as = As + stage * BM * AS;
    bf16* bs = Bs + stage * BK * BS;
    for (int i = threadIdx.x; i < BM * BK / 8; i += C::kThreads) {
      const int r = i / (BK / 8), cc = (i % (BK / 8)) * 8;
      const bool ok = r >= t.lo && r < t.hi && k0 + cc < K;
      cp_async16(as + r * AS + cc, ok ? a + r * K + k0 + cc : a, ok);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += C::kThreads) {
      const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + cc < N;
      cp_async16(bs + r * BS + cc, ok ? b + (k0 + r) * N + n0 + cc : b, ok);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the slot every warp finished reading in the last iteration
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, kt0 + next);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * BM * AS;
    const bf16* bs = Bs + (kt % STAGES) * BK * BS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = wm * WTM + i * 16 + (lane % 16);
        ldmatrix_x4(af[i], as + row * AS + kk + (lane / 16) * 8);
      }
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, bs + (kk + lane % 16) * BS + wn * WTN + j * 16 + (lane / 16) * 8);
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: rows outside [lo, hi) are written as 0, so a split's
  // partials of such a row are 0 and so is their sum
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int64_t col = n0 + wn * WTN + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * WTM + i * 16 + lane / 4 + half * 8;
        if (r >= t.rows || col >= N) continue;
        const bool keep = r >= t.lo && r < t.hi;
        const float v0 = keep ? acc[i][j][2 * half] : 0.f;
        const float v1 = keep ? acc[i][j][2 * half + 1] : 0.f;
        // N % 8 == 0: the pair lies inside the row
        if (part != nullptr) {
          *reinterpret_cast<float2*>(part + r * N + col) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(c + r * N + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// The split K's second pass: out[i] = ws[0][i] + ws[1][i] + ... +
// ws[splits - 1][i], added in that order in fp32 and rounded to bf16
// once; `count` (the output's elements) is a multiple of 4 (N % 8 == 0),
// and each thread takes 4 elements, 16-byte loads and an 8-byte store.
// Bound by bytes: splits * 4 + 2 bytes an element, 0.88 MB at mixtral's
// decode down (S = 2), a few microseconds.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
gmm_splitk_reduce_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                         int64_t count, int splits) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x) * 4;
  if (i >= count) return;
  float4 acc = *reinterpret_cast<const float4*>(ws + i);
  for (int s = 1; s < splits; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(ws + s * count + i);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + i) = packed;
}

// ---- the wgmma route -------------------------------------------------------

namespace wg {
constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kThreads = 384;  // the producer's warpgroup, two consumers
constexpr int kBoxN = 64;      // 128 bytes of bf16: the swizzle's width
constexpr uint32_t kABytes = kBM * kBK * 2;        // 16 KB
constexpr uint32_t kBoxBytes = kBK * kBoxN * 2;    // 8 KB
constexpr uint32_t kStageBytes = kABytes + kBN / kBoxN * kBoxBytes;
// 1 KB to align the ring (the swizzle's pattern repeats every 1,024
// bytes, and the descriptors assume tiles that start on it), the ring,
// then a full and an empty barrier per stage
constexpr size_t kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
}  // namespace wg

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// spin until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | uint64_t{1} << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are written by asynchronous wgmma: no other
// instruction may be moved across a fence or wait that orders them
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define GMM_ACC8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256 fp32, the warpgroup's fragment) += A (64 x 16, K-major)
// * B (16 x 256, N-major: transpose bit set)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : GMM_ACC8(0), GMM_ACC8(8), GMM_ACC8(16), GMM_ACC8(24), GMM_ACC8(32),
        GMM_ACC8(40), GMM_ACC8(48), GMM_ACC8(56), GMM_ACC8(64),
        GMM_ACC8(72), GMM_ACC8(80), GMM_ACC8(88), GMM_ACC8(96),
        GMM_ACC8(104), GMM_ACC8(112), GMM_ACC8(120)
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

#undef GMM_ACC8

// x_map: (K, M, E) for the grouped product, (K, T) for the ragged one;
// w_map: (N, K, E).  Boxes of 64 x 128 (x) and 64 x 64 (w), innermost
// first, 128-byte swizzle, zero fill out of bounds.
__global__ void __launch_bounds__(wg::kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 const Params p) {
  using namespace wg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = make_tile<kBM>(p, blockIdx.z);
  if (t.rows <= 0) return;
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx, then the bytes
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ktiles = static_cast<int>((p.k + kBK - 1) / kBK);
  const int n0 = static_cast<int>(blockIdx.y) * kBN;

  if (threadIdx.x < 128) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // w boxes wholly past N are not loaded: the columns they would
      // feed are not stored
      const int boxes = min(kBN / kBoxN,
                            static_cast<int>((p.n - n0 + kBoxN - 1) / kBoxN));
      const uint32_t bytes = kABytes + boxes * kBoxBytes;
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty(s), ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), bytes);
        const uint32_t a = ring + s * kStageBytes, b = a + kABytes;
        const int k0 = kt * kBK;
        if (p.ragged) {
          tma_load_2d(a, &x_map, full(s), k0, t.row0);
        } else {
          tma_load_3d(a, &x_map, full(s), k0, t.row0, t.expert);
        }
        for (int i = 0; i < boxes; ++i) {
          tma_load_3d(b + i * kBoxBytes, &w_map, full(s), n0 + i * kBoxN,
                      k0, t.expert);
        }
      }
    }
  } else {
    // consumers: warpgroup cw multiplies rows [64 cw, 64 cw + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full(s), (kt / kStages) & 1);
      // A: 64 rows of 128 bytes, 8-row groups 1,024 bytes apart, a k16
      // step 32 bytes along the row; B: 16 rows of each 64-wide box per
      // step (2,048 bytes), 8-row groups 1,024 bytes apart, boxes (the
      // leading dimension) kBoxBytes apart
      const uint32_t a = ring + s * kStageBytes + cw * 64 * 128;
      const uint32_t b = ring + s * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_m64n256k16(acc, smem_desc(a + kk * 32, 16, 1024),
                         smem_desc(b + kk * 2048, kBoxBytes, 1024));
      }
      wgmma_commit();
      // the previous k tile's products are done: its stage may be refilled
      wgmma_wait<1>();
      if (kt > 0 && threadIdx.x % 128 == 0) {
        mbar_arrive(empty((kt - 1) % kStages));
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue: thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and
    // columns 8 j + 2 (l % 4) (+ 1) of its 64 x 256 fragment; rows past
    // the tile are not written, rows outside [lo, hi) are written as 0
    const int wt = threadIdx.x % 128, warp = wt / 32, lane = wt % 32;
    bf16* c = static_cast<bf16*>(p.out) + t.c_off;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int64_t col = n0 + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = cw * 64 + warp * 16 + lane / 4 + h * 8;
        if (r >= t.rows || col >= p.n) continue;
        const bool keep = r >= t.lo && r < t.hi;
        const float v0 = keep ? acc[4 * j + 2 * h] : 0.f;
        const float v1 = keep ? acc[4 * j + 2 * h + 1] : 0.f;
        // N % 8 == 0: the pair lies inside the row
        *reinterpret_cast<__nv_bfloat162*>(c + r * p.n + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

constexpr int kF32BM = 64, kF32BN = 64, kF32BK = 16, kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
gmm_f32_kernel(const Params p) {
  __shared__ __align__(16) float As[kF32BK][kF32BM + 4];
  __shared__ __align__(16) float Bs[kF32BK][kF32BN + 4];
  const Tile t = make_tile<kF32BM>(p, blockIdx.z);
  if (t.rows <= 0) return;
  const float* a = static_cast<const float*>(p.x) + t.a_off;
  const float* b = static_cast<const float*>(p.w) + t.b_off;
  float* c = static_cast<float*>(p.out) + t.c_off;
  const int64_t K = p.k, N = p.n;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kF32BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4] = {};
  for (int64_t k0 = 0; k0 < K; k0 += kF32BK) {
    for (int i = threadIdx.x; i < kF32BM * kF32BK; i += kF32Threads) {
      const int r = i / kF32BK, kk = i % kF32BK;
      const bool ok = r >= t.lo && r < t.hi && k0 + kk < K;
      As[kk][r] = ok ? a[r * K + k0 + kk] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32BK * kF32BN; i += kF32Threads) {
      const int r = i / kF32BN, cc = i % kF32BN;
      const bool ok = k0 + r < K && n0 + cc < N;
      Bs[r][cc] = ok ? b[(k0 + r) * N + n0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= t.rows) continue;
    const bool keep = r >= t.lo && r < t.hi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = n0 + tx * 4 + j;
      if (col < N) c[r * N + col] = keep ? acc[i][j] : 0.f;
    }
  }
}

// grid: row tiles (x), column tiles (y), experts (z; 1 when ragged)
// times the K splits
dim3 grid_for(const Params& p, int bm, int bn) {
  const int64_t row_tiles =
      p.ragged ? ((p.m + p.block_m - 1) / p.block_m) * p.tiles_per_block
               : (p.m + bm - 1) / bm;
  return dim3(static_cast<unsigned>(row_tiles),
              static_cast<unsigned>((p.n + bn - 1) / bn),
              static_cast<unsigned>((p.ragged ? 1 : p.experts) * p.splits));
}

// the dynamic shared memory limit is an attribute of the function on the
// current device: set once for each device
constexpr int kMaxDevices = 64;

template <int Route>
int configure(const void* kernel, size_t smem) {
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !configured[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) configured[device] = true;
  }
  return 0;
}

// the route codes of the entry point, ops.ROUTE_CODES
constexpr int kRouteF32 = 0, kRouteMma = 1, kRouteWgmma = 2;

int launch_mma(Params p, cudaStream_t stream) {
  using C = Decode;
  const int err = configure<kRouteMma>(
      reinterpret_cast<const void*>(gmm_bf16_kernel<C>), C::kSmem);
  if (err != 0) return err;
  p.tiles_per_block = static_cast<int>((p.block_m + C::kBM - 1) / C::kBM);
  gmm_bf16_kernel<C>
      <<<grid_for(p, C::kBM, C::kBN), C::kThreads, C::kSmem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  const int64_t count = (p.ragged ? p.m : p.experts * p.m) * p.n;
  const int64_t blocks = (count / 4 + kReduceThreads - 1) / kReduceThreads;
  gmm_splitk_reduce_kernel<<<static_cast<unsigned>(blocks), kReduceThreads,
                             0, stream>>>(p.ws, static_cast<bf16*>(p.out),
                                          count, p.splits);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled's failures are returned as kEncodeError plus its
// CUresult, which no cudaError_t reaches
constexpr int kEncodeError = 1 << 20;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// a bf16 tensor map of `rank` dims (innermost first, contiguous), boxes
// of `box`, 128-byte swizzle, zero fill out of bounds
int encode(CUtensorMap* map, const void* base, int rank,
           const cuuint64_t* dims, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  cuuint64_t strides[2];  // bytes, of dims 1.. (dim 0's is the element)
  strides[0] = dims[0] * 2;
  strides[1] = strides[0] * dims[1];
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, static_cast<cuuint32_t>(rank),
      const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

int launch_wgmma(Params p, cudaStream_t stream) {
  using namespace wg;
  int err = configure<kRouteWgmma>(
      reinterpret_cast<const void*>(gmm_wgmma_kernel), kSmem);
  if (err != 0) return err;
  CUtensorMap x_map, w_map;
  const cuuint32_t x_box[3] = {kBK, kBM, 1};
  if (p.ragged) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.k),
                                static_cast<cuuint64_t>(p.m)};
    err = encode(&x_map, p.x, 2, dims, x_box);
  } else {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(p.k),
                                static_cast<cuuint64_t>(p.m),
                                static_cast<cuuint64_t>(p.experts)};
    err = encode(&x_map, p.x, 3, dims, x_box);
  }
  if (err != 0) return err;
  const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(p.n),
                                static_cast<cuuint64_t>(p.k),
                                static_cast<cuuint64_t>(p.experts)};
  const cuuint32_t w_box[3] = {kBoxN, kBK, 1};
  err = encode(&w_map, p.w, 3, w_dims, w_box);
  if (err != 0) return err;
  p.tiles_per_block = static_cast<int>((p.block_m + kBM - 1) / kBM);
  gmm_wgmma_kernel<<<grid_for(p, kBM, kBN), kThreads, kSmem, stream>>>(
      x_map, w_map, p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

int launch(Params p, int route, cudaStream_t s) {
  if (route == kRouteF32) {
    p.tiles_per_block =
        static_cast<int>((p.block_m + kF32BM - 1) / kF32BM);
    gmm_f32_kernel<<<grid_for(p, kF32BM, kF32BN), kF32Threads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (route == kRouteMma) return launch_mma(p, s);
  return launch_wgmma(p, s);
}

}  // namespace

extern "C" {

// x, w, out: contiguous.  dims (host memory, int64): ragged (0/1),
// experts E, rows (M per expert, or T), K, N, block_m (ragged: the
// ownership block, already min(block_m, T)), splits S.  grouped: x (E, M,
// K), w (E, K, N), out (E, M, N).  ragged: x (T, K), w (E, K, N), out (T,
// N), group_sizes (E,) int32 on the device.  route: 0 = f32 (float32), 1 =
// mma, 2 = wgmma (both bfloat16: x, w and out alike; K and N multiples of
// 8, pointers 16-byte aligned).  S is 1, or (mma only) 2, 4 or 8 dividing
// ceil(K / 64), with workspace (S, out's shape) float32, 16-byte aligned;
// workspace is not read at S = 1.  `device` is the CUDA device of every
// pointer and of the stream.
int grouped_matmul_forward(const void* x, const void* w, void* out,
                           const void* group_sizes, void* workspace,
                           const int64_t* dims, int route, int device,
                           void* stream) {
  Params p;
  p.x = x;
  p.w = w;
  p.out = out;
  p.group_sizes = static_cast<const int32_t*>(group_sizes);
  p.ragged = static_cast<int>(dims[0]);
  p.experts = static_cast<int>(dims[1]);
  p.m = dims[2];
  p.k = dims[3];
  p.n = dims[4];
  p.block_m = p.ragged ? dims[5] : 0;
  p.tiles_per_block = 1;
  p.splits = static_cast<int>(dims[6]);
  p.ws = static_cast<float*>(workspace);
  const int64_t ktiles = (p.k + Decode::kBK - 1) / Decode::kBK;
  const bool split_ok =
      p.splits == 1 ||
      ((p.splits == 2 || p.splits == 4 || p.splits == 8) &&
       route == kRouteMma && ktiles % p.splits == 0 &&
       workspace != nullptr && aligned16(workspace));
  if (p.experts <= 0 || p.m <= 0 || p.k <= 0 || p.n <= 0 || !split_ok ||
      (p.ragged && (p.block_m <= 0 || group_sizes == nullptr)) ||
      (p.ragged ? p.splits : p.experts * static_cast<int64_t>(p.splits))
          > 65535 ||
      (p.n + 15) / 16 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route != kRouteF32 &&
      ((route != kRouteMma && route != kRouteWgmma) || p.k % 8 != 0 ||
       p.n % 8 != 0 || !aligned16(x) || !aligned16(w) || !aligned16(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // tensor-map coordinates are 32-bit
  if (route == kRouteWgmma &&
      (p.m > INT32_MAX || p.k > INT32_MAX || p.n > INT32_MAX)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int previous = -1;
  cudaError_t e = cudaGetDevice(&previous);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (previous != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rc = launch(p, route, static_cast<cudaStream_t>(stream));
  if (previous != device) cudaSetDevice(previous);
  return rc;
}

// blocks of a route's kernel that fit on one SM (its dynamic shared
// memory limit set as for a launch), from the occupancy calculator
int grouped_matmul_occupancy(int route, int* blocks_per_sm) {
  int err = 0;
  if (route == kRouteF32) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, gmm_f32_kernel, kF32Threads, 0));
  }
  if (route == kRouteMma) {
    err = configure<kRouteMma>(
        reinterpret_cast<const void*>(gmm_bf16_kernel<Decode>),
        Decode::kSmem);
    if (err != 0) return err;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, gmm_bf16_kernel<Decode>, Decode::kThreads,
        Decode::kSmem));
  }
  if (route == kRouteWgmma) {
    err = configure<kRouteWgmma>(
        reinterpret_cast<const void*>(gmm_wgmma_kernel), wg::kSmem);
    if (err != 0) return err;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, gmm_wgmma_kernel, wg::kThreads, wg::kSmem));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* grouped_matmul_error_string(int code) {
  if (code >= kEncodeError) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed, CUresult %d",
             code - kEncodeError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
