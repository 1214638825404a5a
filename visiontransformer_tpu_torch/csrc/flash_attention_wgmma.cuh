// Warpgroup-product (wgmma) pieces of the flash-attention kernels at
// d = 64 (flash_attention_fwd.cu, flash_attention_bwd_dq.cu,
// flash_attention_bwd_dkv.cu): 64 x 64 bf16 tiles in 128-byte swizzled shared
// memory filled by cp.async, their matrix descriptors, and the
// wgmma.mma_async forms the kernels use. A tile is 64 rows of 128 bytes;
// read as a K-major operand its rows are the operand's M or N index, read
// MN-major (the descriptor's transpose bit) its rows are the K index, so one
// copy of K (or Q, dO) serves both S = Q K^T and dQ += dS K. The tuning
// sweeps' kernels 6-9 (flash_variant_wgmma.cuh) use the same tiles and
// descriptors, and the wider forms at the end.
#pragma once

#include "flash_attention_common.cuh"

namespace vt_flash {
namespace wg {

constexpr int kTile = 64;                  // rows per tile, and d
constexpr int kThreads = 128;              // one warpgroup
constexpr int kStages = 3;                 // tiles in the ring
constexpr int kTileBytes = kTile * 64 * 2; // 8192

// Start the copies of rows row0 .. row0 + 63 of a matrix with row stride
// `stride` into a 128-byte swizzled tile (1024-byte aligned): the 16-byte
// chunk c of row r lives at chunk c ^ (r & 7); rows >= n are zero-filled.
// Called by every thread of a block of kBlockThreads.
template <int kBlockThreads = kThreads>
__device__ __forceinline__ void stage_sw128(unsigned char* dst, const bf16* src,
                                            long long stride, int row0, int n) {
  for (int idx = threadIdx.x; idx < kTile * 8; idx += kBlockThreads) {
    const int r = idx >> 3, c = idx & 7;
    const int row = row0 + r;
    const int from = row < n ? row : n - 1;
    cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4),
               src + from * stride + c * 8, row < n ? 16 : 0);
  }
}

// Matrix descriptor of a tile: start address, leading offset 16 B (unused
// at one swizzle atom per row), stride 1024 B between groups of 8 rows,
// 128-byte swizzle. Advancing the operand's K index by 16 adds 2 (32 bytes)
// to a K-major reading and 128 (16 rows) to an MN-major one.
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses to an accumulator across the
// asynchronous products that write it.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments: they stay in place until this point.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define VT_WG_D32(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define VT_WG_DLIST                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// D (64 x 64, fp32, the mma.sync C layout per warp and 8-column tile)
// (+)= A (registers, 64 x 16: each warp its 16 rows as an mma.sync A
// fragment) * B (descriptor); kTransB: B is MN-major in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VT_WG_DLIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : VT_WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(kTransB));
}

// D (+)= A (descriptor, K-major) * B (descriptor, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VT_WG_DLIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : VT_WG_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// ------------------------------------------ widths of the sweep kernels
// The tuning-sweep kernels (flash_variant_wgmma.cuh) take S = Q K^T at
// n = 32, 64 and 128 keys and O^T = V^T P^T with A MN-major.
#define VT_WG_D16(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define VT_WG_DLIST16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define VT_WG_D64(d)                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),           \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),           \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),           \
  "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),           \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),           \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
  "+f"(d[62]), "+f"(d[63])
#define VT_WG_DLIST64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// D (64 x kN, fp32, kN / 2 registers: 8-column group j in d[4j .. 4j + 3]
// as in the 64-wide forms) (+)= A (descriptor) * B (descriptor, K-major);
// kTransA: A is MN-major in shared memory.
template <int kN, int kTransA = 0>
__device__ __forceinline__ void wgmma_ss_n(float (&d)[kN / 2],
                                           uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  if constexpr (kN == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " VT_WG_DLIST16
        ", %16, %17, p, 1, 1, %19, 0;\n}\n"
        : VT_WG_D16(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA));
  } else if constexpr (kN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VT_WG_DLIST
        ", %32, %33, p, 1, 1, %35, 0;\n}\n"
        : VT_WG_D32(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA));
  } else {
    static_assert(kN == 128, "wgmma_ss_n: n is 32, 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " VT_WG_DLIST64
        ", %64, %65, p, 1, 1, %67, 0;\n}\n"
        : VT_WG_D64(d)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA));
  }
}

// fence_regs for accumulators and A fragments of any width.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int kN, int kM>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[kN][kM]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int j = 0; j < kM; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

}  // namespace wg
}  // namespace vt_flash
