// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_fwd.cu: K4, K3; flash_bwd.cu: K5a, K5b): cp.async copies into shared
// memory, ldmatrix loads of mma fragments, the m16n8k16 bf16 mma with
// fp32 accumulators, and the split of fp32 operands into bf16 parts.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (lane = 4 * gid + tig): A (16 x 16) a0 = (gid, 2 tig + {0, 1}),
// a1 = (gid + 8, ...), a2 = (gid, 8 + 2 tig + {0, 1}), a3 = (gid + 8, 8 +
// ...); B (16 x 8, k x n) b0 = (2 tig + {0, 1}, gid), b1 = (8 + 2 tig +
// {0, 1}, gid); C (16 x 8) c0, c1 = (gid, 2 tig + {0, 1}), c2, c3 =
// (gid + 8, 2 tig + {0, 1}). So the accumulators of two neighbouring
// 8-column tiles are, value for value, the A fragment of a product whose
// k axis is those 16 columns: scores become probabilities in registers
// and feed the next product without a shared-memory round trip.
//
// Tiles in shared memory hold bf16 rows padded by 8 elements (16 bytes):
// the eight 16-byte rows an ldmatrix phase reads then fall in eight
// different bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace skt_mma {

constexpr int kPad = 8;                       // bf16 elements of row padding
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !pred.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-filled when !pred.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// Rows row0 .. row0 + rows - 1 of an operand (row stride `rstride`
// elements, D contiguous bf16 each) into a tile with row stride SD, by
// the block's NT threads, 16 bytes a copy; rows at or past `limit` are
// zero-filled and never read.
template <int D, int SD, int NT, typename T>
__device__ __forceinline__ void cp_async_rows(T* dst, const T* src,
                                              long long rstride, int row0,
                                              int rows, int limit) {
  constexpr int kChunks = D * (int)sizeof(T) / 16;   // per row
  constexpr int kPer = 16 / (int)sizeof(T);          // elements per chunk
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += NT) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * kPer;
    const bool ok = row0 + r < limit;
    cp_async_16(dst + r * SD + c, ok ? src + (row0 + r) * rstride + c : src,
                ok);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8 i .. 8 i + 7 give the row addresses
// of matrix i, and register i receives matrix i's fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (B operands whose k axis
// runs along the rows in shared memory).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores (bf16 operands, fp32 accumulators).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + O(2^-17 |x|): the bf16 rounding of x and of what it
// leaves. Two mma over hi and lo keep an fp32 operand (probabilities,
// score gradients) at close to fp32 precision.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// x = hi + mid + lo + O(2^-26 |x|): three bf16 parts, for a product whose
// fp32 result is rounded to bf16 right after (K4's output), where the
// O(2^-17) of two parts moves the value across more bf16 rounding
// boundaries than fp32 sums in another order do.
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  mid = *reinterpret_cast<uint32_t*>(&m);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// The A fragments of a 16 x 16 block whose values are the accumulators
// c0 (columns 0-7) and c1 (columns 8-15) of two 16 x 8 tiles, split in
// three bf16 parts.
__device__ __forceinline__ void acc_to_a_split3(const float (&c0)[4],
                                                const float (&c1)[4],
                                                uint32_t (&hi)[4],
                                                uint32_t (&mid)[4],
                                                uint32_t (&lo)[4]) {
  split3_bf16(c0[0], c0[1], hi[0], mid[0], lo[0]);
  split3_bf16(c0[2], c0[3], hi[1], mid[1], lo[1]);
  split3_bf16(c1[0], c1[1], hi[2], mid[2], lo[2]);
  split3_bf16(c1[2], c1[3], hi[3], mid[3], lo[3]);
}

// The A fragments (hi and lo) of a 16 x 16 block whose values are the
// accumulators c0 (columns 0-7) and c1 (columns 8-15) of two 16 x 8 tiles.
__device__ __forceinline__ void acc_to_a_split(const float (&c0)[4],
                                               const float (&c1)[4],
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// Row address a lane gives ldmatrix_x4 for the A fragment of the 16 x 16
// block at (row0, col0) of a row-major tile with row stride `sd`.
template <typename T>
__device__ __forceinline__ const T* a_frag_addr(const T* tile, int sd,
                                                int row0, int col0, int lane) {
  return tile + (row0 + (lane & 15)) * sd + col0 + ((lane >> 4) << 3);
}

// Row address for ldmatrix_x4 of the B fragments of two 8-wide n tiles
// (rows n0 .. n0 + 15 of the tile are the n axis, its columns k0 .. k0 +
// 15 the k axis): registers {0, 1} are tile n0, {2, 3} tile n0 + 8.
template <typename T>
__device__ __forceinline__ const T* b_frag_addr(const T* tile, int sd, int n0,
                                                int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * sd + k0 +
         (((lane >> 3) & 1) << 3);
}

// Row address for ldmatrix_x4_trans of the B fragments of two 8-wide n
// tiles when the tile's rows k0 .. k0 + 15 are the k axis and its columns
// n0 .. n0 + 15 the n axis: registers {0, 1} are tile n0, {2, 3} n0 + 8.
template <typename T>
__device__ __forceinline__ const T* bt_frag_addr(const T* tile, int sd, int k0,
                                                 int n0, int lane) {
  return tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * sd + n0 +
         ((lane >> 4) << 3);
}

}  // namespace skt_mma
