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
// bf16: tensor-core mma.sync.m16n8k16 (bf16 x bf16 products are exact in
// fp32, the sums fp32), operands staged through shared memory by cp.async
// (16-byte copies, zero-filled past the edges) in a ring of STAGES tiles,
// fragments read with ldmatrix (.trans for w, which is (K, N) row-major as
// the reference stores it).  Two tile shapes: 128 x 128 x 32 with 8 warps
// for prefill-sized M, and 16 x 128 x 64 with 4 warps for decode (M = 2:
// the time is the weights' bytes, and the deeper K tile keeps more of them
// in flight).  K and N must be multiples of 8 and the pointers 16-byte
// aligned (every staging copy and output pair is a vector); the entry point
// refuses other inputs.
//
// float32: FFMA on CUDA cores (never TF32), 64 x 64 tiles of 4 x 4 per
// thread, in the same loop order.
//
// Bound: prefill is operations (2 * M * K * N per expert against the
// tensor cores); decode is bytes (every expert's weights read once for
// 2 rows).  This first version is simple: mma.sync rather than wgmma, no
// TMA, no warp specialisation, no persistent scheduling.
//
// Launches on the caller's stream, allocates nothing, never synchronizes;
// the entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
};

// One block's share: rows [row0, row0 + rows) of x and out (within the
// expert for the grouped product), of which rows [lo, hi) of the tile are
// products and the rest zeros; element offsets of its operands.
struct Tile {
  int rows, lo, hi;
  int64_t a_off, b_off, c_off;
};

template <int BM>
__device__ __forceinline__ Tile make_tile(const Params& p) {
  Tile t;
  if (!p.ragged) {
    const int64_t e = blockIdx.z;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
    t.rows = static_cast<int>(min(static_cast<int64_t>(BM), p.m - row0));
    t.lo = 0;
    t.hi = t.rows;
    t.a_off = (e * p.m + row0) * p.k;
    t.b_off = e * p.k * p.n;
    t.c_off = (e * p.m + row0) * p.n;
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

using Prefill = Bf16Config<128, 128, 32, 2, 4, 3>;
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

  const Tile t = make_tile<BM>(p);
  if (t.rows <= 0) return;
  const bf16* a = static_cast<const bf16*>(p.x) + t.a_off;
  const bf16* b = static_cast<const bf16*>(p.w) + t.b_off;
  bf16* c = static_cast<bf16*>(p.out) + t.c_off;
  const int64_t K = p.k, N = p.n;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int ktiles = static_cast<int>((K + BK - 1) / BK);

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
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // refill the slot every warp finished reading in the last iteration
    const int next = kt + STAGES - 1;
    if (next < ktiles) load_stage(next % STAGES, next);
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

  // epilogue: rows outside [lo, hi) are written as 0
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
        *reinterpret_cast<__nv_bfloat162*>(c + r * N + col) =
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
  const Tile t = make_tile<kF32BM>(p);
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
dim3 grid_for(const Params& p, int bm, int bn) {
  const int64_t row_tiles =
      p.ragged ? ((p.m + p.block_m - 1) / p.block_m) * p.tiles_per_block
               : (p.m + bm - 1) / bm;
  return dim3(static_cast<unsigned>(row_tiles),
              static_cast<unsigned>((p.n + bn - 1) / bn),
              p.ragged ? 1u : static_cast<unsigned>(p.experts));
}

// the dynamic shared memory limit is an attribute of the function on the
// current device: set once for each device
constexpr int kMaxDevices = 64;

template <class C>
int launch_bf16(Params p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !configured[device]) {
    err = cudaFuncSetAttribute(gmm_bf16_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) configured[device] = true;
  }
  p.tiles_per_block = static_cast<int>((p.block_m + C::kBM - 1) / C::kBM);
  gmm_bf16_kernel<C>
      <<<grid_for(p, C::kBM, C::kBN), C::kThreads, C::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

extern "C" {

// x, w, out: contiguous.  dims (host memory, int64): ragged (0/1),
// experts E, rows (M per expert, or T), K, N, block_m (ragged: the
// ownership block, already min(block_m, T)).  grouped: x (E, M, K),
// w (E, K, N), out (E, M, N).  ragged: x (T, K), w (E, K, N), out (T, N),
// group_sizes (E,) int32 on the device.  dtype code: 0 = float32,
// 1 = bfloat16 (x, w and out alike; K and N multiples of 8, pointers
// 16-byte aligned).
int grouped_matmul_forward(const void* x, const void* w, void* out,
                           const void* group_sizes, const int64_t* dims,
                           int dtype, void* stream) {
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
  if (p.experts <= 0 || p.m <= 0 || p.k <= 0 || p.n <= 0 ||
      (p.ragged && (p.block_m <= 0 || group_sizes == nullptr)) ||
      (!p.ragged && p.experts > 65535) || (p.n + 15) / 16 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    p.tiles_per_block =
        static_cast<int>((p.block_m + kF32BM - 1) / kF32BM);
    gmm_f32_kernel<<<grid_for(p, kF32BM, kF32BN), kF32Threads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1 || p.k % 8 != 0 || p.n % 8 != 0 || !aligned16(x) ||
      !aligned16(w) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tile_rows = p.ragged ? p.block_m : p.m;
  if (tile_rows <= 64) return launch_bf16<Decode>(p, s);
  return launch_bf16<Prefill>(p, s);
}

const char* grouped_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
