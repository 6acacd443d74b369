// Tensor-core and copy helpers shared by the attention kernels
// (flash_attention.cu's tensor-core forward and flash_attention_backward.cu's
// tensor-core backward), for sm_90a: cp.async copies into shared memory,
// ldmatrix fragment loads, the bf16 mma.sync.m16n8k16 product, the scan
// of a row block's live kv tiles, and the LSE the forward saves for the
// backward of a row that attends no key.
//
// Fragments of mma.sync.m16n8k16 (lane = threadIdx.x % 32):
//   A (16 x 16, row-major), 4 registers of two bf16: rows lane / 4 (a0, a2)
//     and lane / 4 + 8 (a1, a3), columns 2 * (lane % 4) + {0, 1} (a0, a1)
//     and 8 more (a2, a3);
//   B (16 x 8, column-major), 2 registers: column lane / 4, rows
//     2 * (lane % 4) + {0, 1} (b0) and 8 more (b1);
//   C (16 x 8, fp32), 4 floats: row lane / 4 (c0, c1) and lane / 4 + 8
//     (c2, c3), columns 2 * (lane % 4) + {0, 1}.
// So the C fragments of two adjacent 8-column tiles, rounded to bf16 in
// pairs, are the A fragment of their 16 columns: a product's result feeds
// the next product without leaving registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// the LSE of a row that attends no key (ref.py's NEG_INF): the backward's
// P = exp(s - LSE) of it is 0 through the mask
constexpr float kLseEmpty = -1e30f;

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
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Flags of the 32 kv tiles of KEYS keys (32 or 64) that start at key
// c * 32 * KEYS, bit t for tile 32c + t: `live` if some query in
// [q_lo, q_hi] attends one of its keys, `full` if every such query attends
// all of them (every key a filled slot: kv_pos >= 0).  Computed by each
// warp alone (coalesced reads of kv_pos, warp votes), so every warp of the
// block holds the same flags with no barrier.
template <int KEYS>
__device__ __forceinline__ void scan_kv_tiles(const int32_t* kv_pos, int skv,
                                              int causal, int window, int c,
                                              int q_lo, int q_hi,
                                              uint32_t& live,
                                              uint32_t& full) {
  static_assert(KEYS == 32 || KEYS == 64, "kv tile");
  const int lane = threadIdx.x % 32;
  const int base = c * 32 * KEYS;
  live = 0u;
  full = ~0u;
#pragma unroll 8
  for (int i = 0; i < KEYS; ++i) {
    const int j = base + i * 32 + lane;
    const int kp = j < skv ? __ldg(kv_pos + j) : -1;
    const bool any = kp >= 0 && (!causal || kp <= q_hi) &&
                     (window <= 0 || q_lo - kp < window);
    const bool all = kp >= 0 && (!causal || kp <= q_lo) &&
                     (window <= 0 || q_hi - kp < window);
    const uint32_t bit = 1u << (i / (KEYS / 32));  // KEYS / 32 steps a tile
    if (__any_sync(0xffffffffu, any)) live |= bit;
    if (!__all_sync(0xffffffffu, all)) full &= ~bit;
  }
}

}  // namespace
