// K4 and K3: the flash-attention forward for NVIDIA Hopper (sm_90a).
//
// K4 (`skt_flash_fwd`) replaces the TPU kernel `_fwd_kernel` (:44) behind
// `_fwd` (:108) in skypilot_tpu/ops/flash_attention.py: the
// FlashAttention-2 forward, causal or full, returning the output in q's
// dtype and the logsumexp in fp32 [b, hq, sq].
// K3 (`skt_flash_fwd_chunk`) replaces `_fwd_chunk_kernel` (:159) behind
// `_fwd_chunk` (:234): a prefill CHUNK of sq rows against a per-row cache
// prefix. kv row j < split is cache row j, valid iff j < cache_len[b];
// kv row j >= split is chunk row j - split, valid iff j - split <= q
// (the q row's chunk-local index). The cache and the chunk are two
// operands, so the reference's [cache; chunk] concatenation is never
// copied.
//
// What each computes, per batch row b, query head h (GQA: kv head
// h / (hq / hkv), no repeat) and query row i:
//   s_j = (q_i . k_j) * scale, or -0.7 * FLT_MAX where row j is masked;
//   online softmax over kv tiles: m, l = sum exp(s - m), acc = sum p v;
//   out_i = acc / l_safe, lse_i = m + log(l_safe), l_safe = l or 1 if 0.
// Inputs are read in the model layout [b, s, h, d] through element
// strides; the last axis must be contiguous.
//
// What bounds it: at the served prefill shapes (sq 256, d 128) device
// bytes (q, k, v read once, out written once) and the operations are
// close; at sq 2048 the operations (4 * d flops per valid (q, k) pair),
// which belong on the tensor cores (989 TFLOP/s bf16).
//
// Two kernel bodies for each, chosen by the operands' dtype in
// `dispatch`: bf16 runs the tensor-core body, fp32 the CUDA-core one. No
// bf16 call reaches the CUDA-core body.
//
// bf16 K4 and K3 (`flash_fwd_kernel_tc<D, kChunk>`, tensor cores): one
// block per (q tile of BQ = 64 rows, q head, batch row); warp w owns q
// rows 16 (w % 4) .. + 15 and CW output columns: all of them at d 64 and
// 128 (4 warps); at d 256 two warps split the columns (8 warps, each
// recomputing its row group's scores), so no warp holds more than 64
// output accumulator floats (128 left K3 at d 256 past 255 registers).
// The Q tile is copied to shared memory once and, for d <= 128, kept as
// mma A fragments in registers for the whole kv loop (d 256 reloads them
// with ldmatrix). K/V tiles of BK rows (64; 32 at d 256) are
// double-buffered in padded shared memory with cp.async, so tile j + 1
// loads while tile j computes. S = Q K^T is mma.sync m16n8k16 (bf16 in,
// fp32 accumulators); the online softmax runs on the accumulators (row
// max and sum over the 4 lanes of a quad with shuffles); P feeds P V
// straight from registers as the A operand, V through ldmatrix.trans.
// P is fp32: it is split into three bf16 parts, each multiplied (three
// mma), so the output keeps the reference's fp32 precision up to
// O(2^-26) before its bf16 rounding, at 2x the minimal tensor-core work.
// (Two parts leave O(2^-17) of p, which moved outputs across bf16
// rounding boundaries of the plain version's bf16 output: a one-ulp
// flip at |out| 1.14, d 256.) Causal tiles above the block's diagonal
// are never loaded; only tiles that cross the diagonal or the ragged kv
// end are masked, and a warp whose rows all lie above a tile skips it.
// K3 (kChunk) is the same body with a second kv walk in front: the
// row's valid cache rows [0, min(cache_len[b], split)) of the cache
// operands, in tiles from cache row 0 (rows past cache_len zero-filled,
// never read: a slot cache holds stale rows there; only the tile that
// crosses cache_len is masked, and tiles wholly past it are not walked),
// then the chunk operands' rows in tiles from chunk row 0, causal against
// the chunk-local q rows exactly as K4's walk is. No tile straddles
// split, so each tile has one source and one mask rule; K3 writes no
// logsumexp.
//
// fp32 K4 and K3 (`flash_fwd_kernel`, CUDA cores): one block of 128
// threads per (q tile of BQ rows, q head, batch row); BQ = 64 (d 64,
// 128) or 32 (d 256). The block walks the kv tiles of BK = 64 rows
// itself (the TPU's sequential kv grid axis), skipping tiles that hold
// no valid row: above the causal diagonal (K4), and cache tiles at or
// past cache_len[b] that do not reach the chunk (K3). Q, then K, then V
// tiles are staged in shared memory as fp32 (16-byte global loads; rows
// that are out of range or masked cache rows are zero-filled, never
// loaded). Thread (rg, cg), rg = tid / 8, cg = tid % 8, owns rows
// rg * R .. rg * R + R - 1 (R = BQ / 16) and columns cg + 8 j of both
// the score tile and the output tile, so m and l live in registers and
// row reductions are 8-lane shuffles. Padded shared-memory strides keep
// the tile reads free of bank conflicts. It runs fp32 operands only
// (the fp32 parity checks hold it to 1e-5, which bf16 mma operands could
// not). Not done yet: TMA/wgmma, and a split of K3's cache walk across
// blocks (at the long shape its grid is 128 blocks, under one wave).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using skt_flash::kMaskValue;
using skt_flash::store_float;

constexpr int kThreads = 128;
constexpr int kBK = 64;                       // kv rows per tile

struct Args {
  const void* q;
  const void* k;            // K4: all kv rows; K3: the cache rows
  const void* v;
  const void* k2;           // K3: the chunk rows (null for K4)
  const void* v2;
  const int32_t* cache_len; // K3: [b] valid cache rows
  void* out;
  float* lse;               // K4: [b, hq, sq] (null for K3)
  int b, hq, hkv, sq;
  int skv;                  // K4: kv rows; K3: split (cache rows)
  int causal;
  float scale;
  // element strides (batch, seq, head) of q, k, v, k2, v2, out
  long long st[6][3];
};

template <typename T, int D, int SSTR, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int rows,
                                           RowPtr row_ptr) {
  skt_flash::stage_rows<T, D, SSTR, kThreads>(dst, rows, row_ptr);
}

template <int D>
struct Shape {
  static constexpr int BQ = D >= 256 ? 32 : 64;  // q rows per block
  static constexpr int R = BQ / 16;              // q rows per thread
  static constexpr int QSTR = D + 1;             // padded strides (floats)
  static constexpr int KSTR = D + 1;
  static constexpr int PSTR = kBK + 1;
  static constexpr int kSmemFloats = BQ * QSTR + kBK * KSTR + BQ * PSTR;
};

template <typename T, int D, bool kChunk>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  using S = Shape<D>;
  constexpr int BQ = S::BQ, R = S::R;
  constexpr int CO = D / 8;            // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][QSTR]
  float* kvs = qs + BQ * S::QSTR;      // [kBK][KSTR]: K, then V
  float* ps = kvs + kBK * S::KSTR;     // [BQ][PSTR]

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int rg = threadIdx.x / 8;
  const int cg = threadIdx.x % 8;
  const int q_end = min(q_start + BQ, a.sq);      // exclusive
  const int split = a.skv;                        // K3: cache rows
  const int cl = kChunk ? a.cache_len[bi] : 0;
  const int kv_rows = kChunk ? split + a.sq : a.skv;

  const T* q = static_cast<const T*>(a.q);
  stage_rows<T, D, S::QSTR>(qs, BQ, [&](int r) -> const T* {
    const int qi = q_start + r;
    if (qi >= a.sq) return nullptr;
    return q + bi * a.st[0][0] + qi * a.st[0][1] + h * a.st[0][2];
  });

  // Row pointer of kv row j (K when which == 0, V when 1), or null when
  // the row is out of range or a masked cache row.
  auto kv_row = [&](int which, int j) -> const T* {
    if (j >= kv_rows) return nullptr;
    if (kChunk && j >= split) {
      const T* base = static_cast<const T*>(which ? a.v2 : a.k2);
      const long long* st = a.st[which ? 4 : 3];
      return base + bi * st[0] + (j - split) * st[1] + kvh * st[2];
    }
    if (kChunk && j >= cl) return nullptr;
    const T* base = static_cast<const T*>(which ? a.v : a.k);
    const long long* st = a.st[which ? 2 : 1];
    return base + bi * st[0] + j * st[1] + kvh * st[2];
  };

  float m[R], l[R], acc[R][CO];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[i][j] = 0.f;
  }

  // kv tiles that can hold a valid row for this q tile: below
  // q_end (K4 causal), all (K4 full), or below split + q_end (K3).
  const int k_stop = kChunk ? split + q_end
                            : (a.causal ? min(q_end, a.skv) : a.skv);
  for (int k_start = 0; k_start < k_stop; k_start += kBK) {
    if (kChunk && !((k_start < split && k_start < cl) ||
                    k_start + kBK > split))
      continue;                        // cache tile past cache_len
    __syncthreads();                   // previous tile's V and P reads done
    stage_rows<T, D, S::KSTR>(kvs, kBK,
                              [&](int r) { return kv_row(0, k_start + r); });
    __syncthreads();

    float s[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[R], kv[8];
#pragma unroll
      for (int i = 0; i < R; ++i) qv[i] = qs[(rg * R + i) * S::QSTR + dd];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = kvs[(cg + 8 * j) * S::KSTR + dd];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qi = q_start + rg * R + i;        // chunk-local q index
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k_start + cg + 8 * j;
        bool valid;
        if (kChunk) {
          valid = kj < split ? kj < cl : (kj - split <= qi && kj < kv_rows);
        } else {
          valid = kj < a.skv && (!a.causal || kj <= qi);
        }
        s[i][j] = valid ? s[i][j] * a.scale : kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(rg * R + i) * S::PSTR + cg + 8 * j] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CO; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                   // K reads done, P written
    stage_rows<T, D, S::KSTR>(kvs, kBK,
                              [&](int r) { return kv_row(1, k_start + r); });
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pv[i] = ps[(rg * R + i) * S::PSTR + kk];
#pragma unroll
      for (int j = 0; j < CO; ++j) {
        const float vv = kvs[kk * S::KSTR + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q_start + rg * R + i;
    if (qi >= a.sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* o = out + bi * a.st[5][0] + qi * a.st[5][1] + h * a.st[5][2];
#pragma unroll
    for (int j = 0; j < CO; ++j) store_float(acc[i][j] / l_safe, o + cg + 8 * j);
    if (!kChunk && cg == 0)
      a.lse[((long long)bi * a.hq + h) * a.sq + qi] = m[i] + logf(l_safe);
  }
}

// ----------------------------------------------------------- bf16 K4, K3
template <int D>
struct TcShape {
  static constexpr int BQ = 64;                   // q rows per block
  static constexpr int BK = D >= 256 ? 32 : 64;   // kv rows per tile
  static constexpr int CW = D >= 256 ? 128 : D;   // output columns per warp
  static constexpr int kColWarps = D / CW;        // warps along head_dim
  static constexpr int kThreads = 32 * (BQ / 16) * kColWarps;
  static constexpr int SD = D + skt_mma::kPad;    // shared row stride
  static constexpr bool kQRegs = D <= 128;        // Q fragments in registers
  static constexpr int kSmemElems = BQ * SD + 4 * BK * SD;  // Q, 2 x (K, V)
};

template <int D, bool kChunk>
__global__ void __launch_bounds__(TcShape<D>::kThreads)
flash_fwd_kernel_tc(const Args a) {
  using S = TcShape<D>;
  using bf16 = __nv_bfloat16;
  constexpr int BQ = S::BQ, BK = S::BK, SD = S::SD, NTHR = S::kThreads;
  constexpr int KC = D / 16;           // k chunks of the head dim
  constexpr int NT = BK / 8;           // 8-column tiles of S
  constexpr int NO = S::CW / 8;        // 8-column tiles of the warp's output
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);   // [BQ][SD]
  bf16* ks = qs + BQ * SD;                        // [2][BK][SD]
  bf16* vs = ks + 2 * BK * SD;                    // [2][BK][SD]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp % (BQ / 16);     // the warp's 16 q rows
  const int col0 = (warp / (BQ / 16)) * S::CW;    // its output columns
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int q_end = min(q_start + BQ, a.sq);
  const int w_row0 = q_start + wr * 16;           // the warp's first q row
  const bf16* qg = static_cast<const bf16*>(a.q) + bi * a.st[0][0] +
                   h * a.st[0][2];
  // The causal walk: K4's kv rows (operands 1, 2), or K3's chunk rows
  // (operands 3, 4), whose indices are the chunk-local q indices.
  constexpr int KO = kChunk ? 3 : 1, VO = kChunk ? 4 : 2;
  const bf16* kg = static_cast<const bf16*>(kChunk ? a.k2 : a.k) +
                   bi * a.st[KO][0] + kvh * a.st[KO][2];
  const bf16* vg = static_cast<const bf16*>(kChunk ? a.v2 : a.v) +
                   bi * a.st[VO][0] + kvh * a.st[VO][2];
  const int kv_rows = kChunk ? a.sq : a.skv;
  // K3 walks the row's valid cache rows first, [0, min(cache_len[b],
  // split)) of operands 1, 2; the rows past them are zero-filled, never
  // read, and tiles wholly past them are not walked. The two walks start
  // at their own row 0, so no tile straddles split.
  const int cache_rows = kChunk ? max(0, min(a.cache_len[bi], a.skv)) : 0;
  const bf16* kcache = static_cast<const bf16*>(a.k) + bi * a.st[1][0] +
                       kvh * a.st[1][2];
  const bf16* vcache = static_cast<const bf16*>(a.v) + bi * a.st[2][0] +
                       kvh * a.st[2][2];
  const int n_cache = (cache_rows + BK - 1) / BK;

  auto load_rows = [](bf16* dst, const bf16* src, long long rstride,
                      int row0, int rows, int limit) {
    skt_mma::cp_async_rows<D, SD, NTHR>(dst, src, rstride, row0, rows,
                                        limit);
  };
  // K and V of walk tile t into buffer buf.
  auto load_tile = [&](int t, int buf) {
    bf16* kd = ks + buf * BK * SD;
    bf16* vd = vs + buf * BK * SD;
    if (t < n_cache) {
      load_rows(kd, kcache, a.st[1][1], t * BK, BK, cache_rows);
      load_rows(vd, vcache, a.st[2][1], t * BK, BK, cache_rows);
    } else {
      load_rows(kd, kg, a.st[KO][1], (t - n_cache) * BK, BK, kv_rows);
      load_rows(vd, vg, a.st[VO][1], (t - n_cache) * BK, BK, kv_rows);
    }
  };

  const int k_stop = a.causal ? min(q_end, kv_rows) : kv_rows;
  const int n_tiles = n_cache + (k_stop + BK - 1) / BK;
  load_rows(qs, qg, a.st[0][1], q_start, BQ, a.sq);
  if (n_tiles > 0) load_tile(0, 0);
  skt_mma::cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // Running max (log2 units, of rows gid and gid + 8) and this lane's
  // share of the running sums (summed over the quad at the end).
  float m2[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  uint32_t qf[S::kQRegs ? KC : 1][4];
  const float sl2 = a.scale * skt_mma::kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const bool cache_tile = t < n_cache;
    // The tile's first row in its operand, and the rows valid there.
    const int k_start = (cache_tile ? t : t - n_cache) * BK;
    const int limit = cache_tile ? cache_rows : kv_rows;
    const bool causal = a.causal && !cache_tile;
    if (t + 1 < n_tiles) load_tile(t + 1, buf ^ 1);  // during this tile
    skt_mma::cp_async_commit();
    skt_mma::cp_async_wait<1>();
    __syncthreads();
    if constexpr (S::kQRegs) {
      if (t == 0) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          skt_mma::ldmatrix_x4(
              qf[kc], skt_mma::a_frag_addr(qs, SD, wr * 16, kc * 16, lane));
      }
    }
    // A warp whose rows all lie above this tile (causal) skips it.
    const bool live = !causal || k_start <= w_row0 + 15;
    if (live) {
      const bf16* kt = ks + buf * BK * SD;
      const bf16* vt = vs + buf * BK * SD;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t af[4];
        if constexpr (S::kQRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x) af[x] = qf[kc][x];
        } else {
          skt_mma::ldmatrix_x4(
              af, skt_mma::a_frag_addr(qs, SD, wr * 16, kc * 16, lane));
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bfr[4];
          skt_mma::ldmatrix_x4(
              bfr, skt_mma::b_frag_addr(kt, SD, np * 16, kc * 16, lane));
          skt_mma::mma_16816(s[2 * np], af, bfr[0], bfr[1]);
          skt_mma::mma_16816(s[2 * np + 1], af, bfr[2], bfr[3]);
        }
      }
      // Scores in log2 units; masked pairs are -inf (their p is exactly
      // 0, as exp(DEFAULT_MASK_VALUE - m) is in the reference).
      const bool masked = k_start + BK > limit ||
                          (causal && k_start + BK - 1 > w_row0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * sl2;
          if (masked) {
            const int kj = k_start + n * 8 + 2 * tig + (e & 1);
            const int qi = w_row0 + gid + 8 * (e >> 1);
            if (kj >= limit || (causal && kj > qi)) x = -INFINITY;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m2[r], mx[r]);
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2f(m2[r] - base[r]);
        m2[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - base[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += P V, P split into three bf16 parts.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t p3[3][4];
        skt_mma::acc_to_a_split3(s[2 * kk], s[2 * kk + 1], p3[0], p3[1],
                                 p3[2]);
#pragma unroll
        for (int dp = 0; dp < S::CW / 16; ++dp) {
          uint32_t bfr[4];
          skt_mma::ldmatrix_x4_trans(
              bfr,
              skt_mma::bt_frag_addr(vt, SD, kk * 16, col0 + dp * 16, lane));
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            skt_mma::mma_16816(o[2 * dp], p3[part], bfr[0], bfr[1]);
            skt_mma::mma_16816(o[2 * dp + 1], p3[part], bfr[2], bfr[3]);
          }
        }
      }
    }
    __syncthreads();                   // buf is refilled two tiles on
  }
  skt_mma::cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = w_row0 + gid + 8 * r;
    if (qi >= a.sq) continue;
    const float l_safe = lr == 0.f ? 1.f : lr;
    const float inv = 1.f / l_safe;
    bf16* orow = out + bi * a.st[5][0] + qi * a.st[5][1] + h * a.st[5][2];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + col0 + n * 8 + 2 * tig) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (!kChunk && tig == 0 && col0 == 0) {
      const float m = m2[r] == -INFINITY ? kMaskValue : m2[r] * skt_mma::kLn2;
      a.lse[((long long)bi * a.hq + h) * a.sq + qi] = m + logf(l_safe);
    }
  }
}

template <int D, bool kChunk>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  using S = TcShape<D>;
  const size_t smem = (size_t)S::kSmemElems * sizeof(__nv_bfloat16);
  auto kernel = flash_fwd_kernel_tc<D, kChunk>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.sq + S::BQ - 1) / S::BQ, a.hq, a.b);
  kernel<<<grid, S::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------ fp32 K4, K3 (CUDA cores)
template <typename T, int D, bool kChunk>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using S = Shape<D>;
  const size_t smem = (size_t)S::kSmemFloats * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D, kChunk>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.sq + S::BQ - 1) / S::BQ, a.hq, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kChunk>
cudaError_t dispatch(const Args& a, int d, int dtype, cudaStream_t s) {
  if (a.b == 0 || a.sq == 0) return cudaSuccess;
  if (dtype == 0) {                    // bf16 K4, K3: the tensor-core body
    switch (d) {
      case 64: return launch_tc<64, kChunk>(a, s);
      case 128: return launch_tc<128, kChunk>(a, s);
      case 256: return launch_tc<256, kChunk>(a, s);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 64: return launch<float, 64, kChunk>(a, s);
      case 128: return launch<float, 128, kChunk>(a, s);
      case 256: return launch<float, 256, kChunk>(a, s);
    }
  }
  return cudaErrorInvalidValue;
}

void fill_strides(Args& a, const long long* strides, int n_operands) {
  for (int o = 0; o < 6; ++o)
    for (int x = 0; x < 3; ++x)
      a.st[o][x] = o < n_operands ? strides[o * 3 + x] : 0;
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32 (q, k, v and out alike). strides: 18 element
// strides (batch, seq, head) of q, k, v, (unused k2, v2), out. lse is
// [b, hq, sq] fp32. Returns the CUDA error of the launch (0 = success).
int skt_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  float* lse, const long long* strides, int b, int hq,
                  int hkv, int sq, int skv, int d, int causal, float scale,
                  int dtype, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = lse;
  a.b = b;
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.scale = scale;
  fill_strides(a, strides, 6);
  return (int)dispatch<false>(a, d, dtype, static_cast<cudaStream_t>(stream));
}

// K3: q [b, sq, hq, d]; cache k/v [b, >= split, hkv, d]; chunk k2/v2
// [b, sq, hkv, d]; cache_len [b] int32. strides: 18 element strides of
// q, k, v, k2, v2, out.
int skt_flash_fwd_chunk(const void* q, const void* k, const void* v,
                        const void* k2, const void* v2,
                        const int32_t* cache_len, void* out,
                        const long long* strides, int b, int hq, int hkv,
                        int sq, int split, int d, float scale, int dtype,
                        void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.k2 = k2;
  a.v2 = v2;
  a.cache_len = cache_len;
  a.out = out;
  a.b = b;
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.skv = split;
  a.causal = 1;
  a.scale = scale;
  fill_strides(a, strides, 6);
  return (int)dispatch<true>(a, d, dtype, static_cast<cudaStream_t>(stream));
}

const char* skt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
