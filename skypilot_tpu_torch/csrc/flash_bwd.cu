// K5a and K5b: the flash-attention backward for NVIDIA Hopper (sm_90a).
//
// K5a (`skt_flash_bwd_dkv`) replaces the TPU kernel `_bwd_dkv_kernel`
// (:284, called at :419) and K5b (`skt_flash_bwd_dq`) replaces
// `_bwd_dq_kernel` (:341, called at :448), both behind `_bwd` (:391) in
// skypilot_tpu/ops/flash_attention.py: the FlashAttention-2 backward of
// K4's forward, causal or full, from the saved logsumexp.
//
// What each computes, per batch row b, query head h (GQA: kv head
// h / (hq / hkv)), query row i and kv row j:
//   s_ij = (q_i . k_j) * scale; p_ij = exp(s_ij - lse_i), 0 where (i, j)
//     is masked (the reference's exp(DEFAULT_MASK_VALUE - lse), exactly 0);
//   dp_ij = do_i . v_j; ds_ij = p_ij * (dp_ij - delta_i) * scale;
//   K5a: dv_j = sum_i p_ij do_i, dk_j = sum_i ds_ij q_i, summed over the
//     query heads of the kv head's group (the reference repeats k/v to
//     the query heads and sums the per-head bf16 dk/dv afterwards; here
//     the sum is fp32, inside the kernel, with no atomics);
//   K5b: dq_i = sum_j ds_ij k_j.
// delta_i = rowsum(out_i * do_i) in fp32 comes from the caller (one plain
// torch op, as the reference computes it outside its kernels, :406).
// Operands are read in the model layout [b, s, h, d] through element
// strides (the last axis contiguous); lse and delta are [b, hq, sq] fp32;
// dq comes out in q's dtype, dk/dv in k's.
//
// What bounds it: at the training shape (llama3-1b: s 2048, d 64, hq 32,
// hkv 8) the operations, 8 d flops per valid (q, k) pair in K5a (s, dp,
// dv, dk) and 6 d in K5b (s, dp, dq); they belong on the tensor cores
// (989 TFLOP/s bf16).
//
// Two kernel bodies for each, chosen by the operands' dtype in
// `dispatch`: bf16 runs the tensor-core bodies, fp32 the CUDA-core ones
// (which hold the fp32 parity checks to 2e-5; bf16 mma operands could
// not). No bf16 call reaches a CUDA-core body.
//
// bf16 K5a (`flash_bwd_dkv_kernel_tc`, tensor cores): one block per (k
// tile of BK rows, kv head, batch row); warp w owns 16 k rows and 64
// columns of dK/dV (d 64: 4 warps; d 128: 8, two along head_dim; d 256:
// BK 32, 8 warps, four along head_dim), kept in fp32 registers over the
// whole walk and written once. The K and V tiles are copied once (d 64
// keeps them as mma A fragments in registers; wider heads reload them
// with ldmatrix, as the registers hold the dK/dV accumulators); the
// block walks the group's query heads and their q tiles (BQ = BK rows),
// with Q, dO, lse and delta double-buffered in shared memory by
// cp.async, so the next step loads while this one computes. The scores
// are computed TRANSPOSED, S^T = K Q^T and dP^T = V dO^T (mma.sync
// m16n8k16, bf16 in, fp32 accumulators), so each warp gets P^T =
// exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale for its own
// k rows in its accumulator layout, and feeds them from registers as the
// A operand of dV += P^T dO and dK += dS^T Q (dO and Q through
// ldmatrix.trans). P^T and dS^T are fp32: each is split into a bf16 high
// and low part and both are multiplied, which keeps the reference's fp32
// precision. With head_dim split over warps, each warp of a row group
// computes the same 16 x BQ scores (the price of keeping every
// accumulator in registers). The GQA sum stays in the kernel: no
// atomics, no second pass.
//
// bf16 K5b (`flash_bwd_dq_kernel_tc`, tensor cores): K4's structure with
// K5a's arithmetic. One block per (q tile of BQ = 64 rows, q head, batch
// row); warp w owns 16 q rows and CW columns of dQ (d 64 and 128: 4
// warps, all columns; d 256: 8 warps, two along head_dim, each
// recomputing its row group's scores), so no warp holds more than 64 dQ
// accumulator floats. Q, dO, lse and delta are copied once (d 64 keeps
// Q and dO as A fragments in registers; wider heads reload them with
// ldmatrix); K/V tiles of BK rows (64; 32 at d 128 and 256) are
// double-buffered by cp.async up to the causal limit, so tiles above the
// block's diagonal are never loaded. S = Q K^T and dP = dO V^T on
// mma.sync (K and V as B operands through ldmatrix); P = exp(S scale -
// lse) and dS = P (dP - delta) scale in the accumulator layout, masked
// only on tiles that cross the diagonal or the kv end; dQ += dS K with dS
// from registers as the A operand (split into bf16 high and low parts,
// as in K5a) and K through ldmatrix.trans. A warp whose rows all lie
// above a tile skips it. dQ stays in fp32 registers and is written once.
//
// fp32 K5a and K5b (`flash_bwd_dkv_kernel`, `flash_bwd_dq_kernel`, CUDA
// cores): blocks of 256 threads. K5a: one block per (k tile of BK rows,
// kv head, batch row); it stages its K and V tiles once, then walks the
// group's query heads and, for each, the q tiles of BQ rows from the
// first one that holds a row >= the tile's first k row (causal), keeping
// the fp32 dK and dV tiles in registers and writing each once. K5b: one
// block per (q tile, q head, batch row); it stages Q and dO once and
// walks the k tiles up to the causal limit, keeping dQ in registers. BQ
// = BK = 64 for d 64 and 128, 32 for d 256 (shared memory: K5a holds
// four operand tiles and two score tiles, 166 KB at d 128). Thread (rg,
// cg), rg = tid / 16, cg = tid % 16, owns rows rg * R .. rg * R + R - 1
// and columns cg + 16 j of every tile it accumulates, so the score-tile
// products read broadcast rows and 16 consecutive columns; padded
// shared-memory strides keep those reads free of bank conflicts. Ragged
// q and k tiles are masked row by row (out-of-range rows are
// zero-filled, never loaded, and their p and ds are 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using skt_flash::store_float;

constexpr int kThreads = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;         // [b, hq, sq]
  const float* delta;       // [b, hq, sq]
  void* dq;                 // K5b
  void* dk;                 // K5a
  void* dv;                 // K5a
  int b, hq, hkv, sq, skv;
  int causal;
  float scale;
  // element strides (batch, seq, head) of q, k, v, do, dq, dk, dv
  long long st[7][3];
};

template <int D>
struct Shape {
  static constexpr int BQ = D >= 256 ? 32 : 64;  // q rows per tile
  static constexpr int BK = D >= 256 ? 32 : 64;  // k rows per tile
  static constexpr int STR = D + 1;              // padded strides (floats)
  static constexpr int PSTR = BK + 1;
  static constexpr int RQ = BQ / 16;             // score rows per thread
  static constexpr int CK = BK / 16;             // score columns per thread
  static constexpr int RK = BK / 16;             // dK/dV rows per thread
  static constexpr int CD = D / 16;              // head_dim columns per thread
  // K5a: K, V, Q, dO tiles, P and dS, lse and delta.
  static constexpr int kDkvFloats =
      2 * BK * STR + 2 * BQ * STR + 2 * BQ * PSTR + 2 * BQ;
  // K5b: Q, dO, K, V tiles, dS, lse and delta.
  static constexpr int kDqFloats =
      2 * BQ * STR + 2 * BK * STR + BQ * PSTR + 2 * BQ;
};

template <typename T, int D, int SSTR, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int rows,
                                           RowPtr row_ptr) {
  skt_flash::stage_rows<T, D, SSTR, kThreads>(dst, rows, row_ptr);
}

// Row pointer of operand `o` (0 q, 1 k, 2 v, 3 do) at (batch, row, head),
// or null past `n` rows.
template <typename T>
__device__ __forceinline__ const T* row_of(const Args& a, int o, int bi,
                                           int row, int n, int head) {
  if (row >= n) return nullptr;
  const void* base = o == 0 ? a.q : o == 1 ? a.k : o == 2 ? a.v : a.dout;
  return static_cast<const T*>(base) + bi * a.st[o][0] +
         row * a.st[o][1] + head * a.st[o][2];
}

// lse and delta of rows q_start .. q_start + BQ - 1 of head h (0 past sq).
template <int BQ>
__device__ __forceinline__ void stage_row_stats(const Args& a, int bi, int h,
                                                int q_start, float* lse_s,
                                                float* delta_s) {
  const long long base = ((long long)bi * a.hq + h) * a.sq;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int qi = q_start + r;
    lse_s[r] = qi < a.sq ? a.lse[base + qi] : 0.f;
    delta_s[r] = qi < a.sq ? a.delta[base + qi] : 0.f;
  }
}

// One (q tile, k tile) pair: s = Q K^T and dp = dO V^T over the staged
// tiles, then p and ds for the thread's rows rg * RQ + i and columns
// cg + 16 j, written to ps (when given) and dss.
template <int D>
__device__ __forceinline__ void scores_and_ds(
    const Args& a, const float* qs, const float* dos, const float* ks,
    const float* vs, const float* lse_s, const float* delta_s, int q_start,
    int k_start, int rg, int cg, float* ps, float* dss) {
  using S = Shape<D>;
  constexpr int RQ = S::RQ, CK = S::CK;
  float s[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float qv[RQ], dov[RQ], kv[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qv[i] = qs[(rg * RQ + i) * S::STR + dd];
      dov[i] = dos[(rg * RQ + i) * S::STR + dd];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      kv[j] = ks[(cg + 16 * j) * S::STR + dd];
      vv[j] = vs[(cg + 16 * j) * S::STR + dd];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = rg * RQ + i;
    const int qi = q_start + r;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      const int c = cg + 16 * j;
      const int kj = k_start + c;
      const bool valid =
          qi < a.sq && kj < a.skv && (!a.causal || kj <= qi);
      const float p = valid ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
      const float ds = valid ? p * (dp[i][j] - delta_s[r]) * a.scale : 0.f;
      if (ps != nullptr) ps[r * S::PSTR + c] = p;
      dss[r * S::PSTR + c] = ds;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Args a) {
  using S = Shape<D>;
  constexpr int BQ = S::BQ, BK = S::BK, RK = S::RK, CD = S::CD;
  extern __shared__ float smem[];
  float* ks = smem;                    // [BK][STR]
  float* vs = ks + BK * S::STR;        // [BK][STR]
  float* qs = vs + BK * S::STR;        // [BQ][STR]
  float* dos = qs + BQ * S::STR;       // [BQ][STR]
  float* ps = dos + BQ * S::STR;       // [BQ][PSTR]
  float* dss = ps + BQ * S::PSTR;      // [BQ][PSTR]
  float* lse_s = dss + BQ * S::PSTR;   // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]

  const int k_start = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = a.hq / a.hkv;
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;

  stage_rows<T, D, S::STR>(ks, BK, [&](int r) {
    return row_of<T>(a, 1, bi, k_start + r, a.skv, kvh);
  });
  stage_rows<T, D, S::STR>(vs, BK, [&](int r) {
    return row_of<T>(a, 2, bi, k_start + r, a.skv, kvh);
  });

  float dk[RK][CD], dv[RK][CD];
#pragma unroll
  for (int x = 0; x < RK; ++x)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk[x][c] = dv[x][c] = 0.f;

  // Causal: q rows below k_start see no row of this k tile.
  const int q_first = a.causal ? (k_start / BQ) * BQ : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    for (int q_start = q_first; q_start < a.sq; q_start += BQ) {
      __syncthreads();                 // previous tile's Q, dO, P, dS reads
      stage_rows<T, D, S::STR>(qs, BQ, [&](int r) {
        return row_of<T>(a, 0, bi, q_start + r, a.sq, h);
      });
      stage_rows<T, D, S::STR>(dos, BQ, [&](int r) {
        return row_of<T>(a, 3, bi, q_start + r, a.sq, h);
      });
      stage_row_stats<BQ>(a, bi, h, q_start, lse_s, delta_s);
      __syncthreads();
      scores_and_ds<D>(a, qs, dos, ks, vs, lse_s, delta_s, q_start, k_start,
                       rg, cg, ps, dss);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's q rows.
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float pv[RK], dsv[RK], dov[CD], qv[CD];
#pragma unroll
        for (int x = 0; x < RK; ++x) {
          pv[x] = ps[i * S::PSTR + rg * RK + x];
          dsv[x] = dss[i * S::PSTR + rg * RK + x];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dov[c] = dos[i * S::STR + cg + 16 * c];
          qv[c] = qs[i * S::STR + cg + 16 * c];
        }
#pragma unroll
        for (int x = 0; x < RK; ++x)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dv[x][c] = fmaf(pv[x], dov[c], dv[x][c]);
            dk[x][c] = fmaf(dsv[x], qv[c], dk[x][c]);
          }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int x = 0; x < RK; ++x) {
    const int kj = k_start + rg * RK + x;
    if (kj >= a.skv) continue;
    T* dkp = dk_out + bi * a.st[5][0] + kj * a.st[5][1] + kvh * a.st[5][2];
    T* dvp = dv_out + bi * a.st[6][0] + kj * a.st[6][1] + kvh * a.st[6][2];
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      store_float(dk[x][c], dkp + cg + 16 * c);
      store_float(dv[x][c], dvp + cg + 16 * c);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args a) {
  using S = Shape<D>;
  constexpr int BQ = S::BQ, BK = S::BK, RQ = S::RQ, CD = S::CD;
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][STR]
  float* dos = qs + BQ * S::STR;       // [BQ][STR]
  float* ks = dos + BQ * S::STR;       // [BK][STR]
  float* vs = ks + BK * S::STR;        // [BK][STR]
  float* dss = vs + BK * S::STR;       // [BQ][PSTR]
  float* lse_s = dss + BQ * S::PSTR;   // [BQ]
  float* delta_s = lse_s + BQ;         // [BQ]

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;

  stage_rows<T, D, S::STR>(qs, BQ, [&](int r) {
    return row_of<T>(a, 0, bi, q_start + r, a.sq, h);
  });
  stage_rows<T, D, S::STR>(dos, BQ, [&](int r) {
    return row_of<T>(a, 3, bi, q_start + r, a.sq, h);
  });
  stage_row_stats<BQ>(a, bi, h, q_start, lse_s, delta_s);

  float dq[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dq[i][c] = 0.f;

  // k tiles that can hold a valid row for this q tile.
  const int q_end = min(q_start + BQ, a.sq);
  const int k_stop = a.causal ? min(q_end, a.skv) : a.skv;
  for (int k_start = 0; k_start < k_stop; k_start += BK) {
    __syncthreads();                   // previous tile's K and dS reads
    stage_rows<T, D, S::STR>(ks, BK, [&](int r) {
      return row_of<T>(a, 1, bi, k_start + r, a.skv, kvh);
    });
    stage_rows<T, D, S::STR>(vs, BK, [&](int r) {
      return row_of<T>(a, 2, bi, k_start + r, a.skv, kvh);
    });
    __syncthreads();
    scores_and_ds<D>(a, qs, dos, ks, vs, lse_s, delta_s, q_start, k_start,
                     rg, cg, nullptr, dss);
    __syncthreads();
    // dQ += dS K over the tile's k rows.
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RQ], kv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = dss[(rg * RQ + i) * S::PSTR + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = ks[kk * S::STR + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) dq[i][c] = fmaf(dsv[i], kv[c], dq[i][c]);
    }
  }

  T* dq_out = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q_start + rg * RQ + i;
    if (qi >= a.sq) continue;
    T* o = dq_out + bi * a.st[4][0] + qi * a.st[4][1] + h * a.st[4][2];
#pragma unroll
    for (int c = 0; c < CD; ++c) store_float(dq[i][c], o + cg + 16 * c);
  }
}

// --------------------------------------------------------------- bf16 K5a
template <int D>
struct TcDkv {
  static constexpr int BK = D >= 256 ? 32 : 64;   // k rows per block
  static constexpr int BQ = D >= 256 ? 32 : 64;   // q rows per tile
  static constexpr int kRowWarps = BK / 16;       // warps along the k rows
  static constexpr int CW = 64;                   // dK/dV columns per warp
  static constexpr int kColWarps = D / CW;        // warps along head_dim
  static constexpr int kThreads = 32 * kRowWarps * kColWarps;
  static constexpr int SD = D + skt_mma::kPad;    // shared row stride
  static constexpr bool kKvRegs = D == 64;        // K, V fragments in registers
  // K, V; 2 x (Q, dO) in bf16, then 2 x (lse, delta) in fp32.
  static constexpr size_t kSmemBytes =
      (size_t)(2 * BK + 4 * BQ) * SD * 2 + 4 * BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(TcDkv<D>::kThreads)
flash_bwd_dkv_kernel_tc(const Args a) {
  using S = TcDkv<D>;
  using bf16 = __nv_bfloat16;
  constexpr int BK = S::BK, BQ = S::BQ, SD = S::SD, NTHR = S::kThreads;
  constexpr int KC = D / 16;           // k chunks of the head dim
  constexpr int NT = BQ / 8;           // 8-column tiles of S^T (q columns)
  constexpr int ND = S::CW / 8;        // 8-column tiles of the warp's dK/dV
  extern __shared__ uint4 smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);    // [BK][SD]
  bf16* vs = ks + BK * SD;                         // [BK][SD]
  bf16* qs = vs + BK * SD;                         // [2][BQ][SD]
  bf16* dos = qs + 2 * BQ * SD;                    // [2][BQ][SD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * SD);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                 // [2][BQ]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp % S::kRowWarps;  // the warp's 16 k rows
  const int col0 = (warp / S::kRowWarps) * S::CW;   // its dK/dV columns
  const int k_start = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = a.hq / a.hkv;

  auto load_rows = [](bf16* dst, const bf16* src, long long rstride,
                      int row0, int rows, int limit) {
    skt_mma::cp_async_rows<D, SD, NTHR>(dst, src, rstride, row0, rows,
                                      limit);
  };
  // Causal: q rows below k_start see no row of this k tile.
  const int q_first = a.causal ? (k_start / BQ) * BQ : 0;
  const int n_qt = a.sq > q_first ? (a.sq - q_first + BQ - 1) / BQ : 0;
  const int total = group * n_qt;      // (query head, q tile) steps
  // Q, dO, lse and delta of step `it` into stage `st`.
  auto load_step = [&](int it, int st) {
    const int h = kvh * group + it / n_qt;
    const int q0 = q_first + (it % n_qt) * BQ;
    load_rows(qs + st * BQ * SD,
              static_cast<const bf16*>(a.q) + bi * a.st[0][0] + h * a.st[0][2],
              a.st[0][1], q0, BQ, a.sq);
    load_rows(dos + st * BQ * SD,
              static_cast<const bf16*>(a.dout) + bi * a.st[3][0] +
                  h * a.st[3][2],
              a.st[3][1], q0, BQ, a.sq);
    const long long row = ((long long)bi * a.hq + h) * a.sq;
    for (int r = threadIdx.x; r < BQ; r += NTHR) {
      const bool ok = q0 + r < a.sq;
      skt_mma::cp_async_4(lse_s + st * BQ + r, a.lse + (ok ? row + q0 + r : 0),
                          ok);
      skt_mma::cp_async_4(delta_s + st * BQ + r,
                          a.delta + (ok ? row + q0 + r : 0), ok);
    }
  };

  load_rows(ks, static_cast<const bf16*>(a.k) + bi * a.st[1][0] +
                    kvh * a.st[1][2],
            a.st[1][1], k_start, BK, a.skv);
  load_rows(vs, static_cast<const bf16*>(a.v) + bi * a.st[2][0] +
                    kvh * a.st[2][2],
            a.st[2][1], k_start, BK, a.skv);
  if (total > 0) load_step(0, 0);
  skt_mma::cp_async_commit();

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  uint32_t kf[S::kKvRegs ? KC : 1][4], vf[S::kKvRegs ? KC : 1][4];
  const float sl2 = a.scale * skt_mma::kLog2e;
  const int kj0 = k_start + wr * 16 + gid;   // the lane's k rows: kj0, kj0 + 8

  for (int it = 0; it < total; ++it) {
    const int st = it & 1;
    if (it + 1 < total) load_step(it + 1, st ^ 1);
    skt_mma::cp_async_commit();
    skt_mma::cp_async_wait<1>();
    __syncthreads();
    if constexpr (S::kKvRegs) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          skt_mma::ldmatrix_x4(
              kf[kc], skt_mma::a_frag_addr(ks, SD, wr * 16, kc * 16, lane));
          skt_mma::ldmatrix_x4(
              vf[kc], skt_mma::a_frag_addr(vs, SD, wr * 16, kc * 16, lane));
        }
      }
    }
    const bf16* qt = qs + st * BQ * SD;
    const bf16* dot = dos + st * BQ * SD;
    const float* lse_t = lse_s + st * BQ;
    const float* delta_t = delta_s + st * BQ;
    const int q0 = q_first + (it % n_qt) * BQ;

    // S^T = K Q^T and dP^T = V dO^T over the warp's 16 k rows.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4], va[4];
      if constexpr (S::kKvRegs) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          ka[x] = kf[kc][x];
          va[x] = vf[kc][x];
        }
      } else {
        skt_mma::ldmatrix_x4(
            ka, skt_mma::a_frag_addr(ks, SD, wr * 16, kc * 16, lane));
        skt_mma::ldmatrix_x4(
            va, skt_mma::a_frag_addr(vs, SD, wr * 16, kc * 16, lane));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bq[4], bd[4];
        skt_mma::ldmatrix_x4(
            bq, skt_mma::b_frag_addr(qt, SD, np * 16, kc * 16, lane));
        skt_mma::ldmatrix_x4(
            bd, skt_mma::b_frag_addr(dot, SD, np * 16, kc * 16, lane));
        skt_mma::mma_16816(s[2 * np], ka, bq[0], bq[1]);
        skt_mma::mma_16816(s[2 * np + 1], ka, bq[2], bq[3]);
        skt_mma::mma_16816(dp[2 * np], va, bd[0], bd[1]);
        skt_mma::mma_16816(dp[2 * np + 1], va, bd[2], bd[3]);
      }
    }
    // P^T = exp(S^T scale - lse), 0 where masked; dS^T = P^T (dP^T -
    // delta) scale. s and dp are overwritten with them.
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tig + (e & 1);  // q row in the tile
        const int qi = q0 + c;
        const int kj = kj0 + 8 * (e >> 1);
        const bool valid = qi < a.sq && (!a.causal || kj <= qi);
        const float p =
            valid ? exp2f(fmaf(s[n][e], sl2, -lse_t[c] * skt_mma::kLog2e))
                  : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_t[c]) * a.scale;
      }
    // dV += P^T dO and dK += dS^T Q over the warp's columns, P^T and
    // dS^T split into bf16 high and low parts.
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t phi[4], plo[4], dhi[4], dlo[4];
      skt_mma::acc_to_a_split(s[2 * kk], s[2 * kk + 1], phi, plo);
      skt_mma::acc_to_a_split(dp[2 * kk], dp[2 * kk + 1], dhi, dlo);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t bd[4], bq[4];
        skt_mma::ldmatrix_x4_trans(
            bd, skt_mma::bt_frag_addr(dot, SD, kk * 16, col0 + np * 16, lane));
        skt_mma::ldmatrix_x4_trans(
            bq, skt_mma::bt_frag_addr(qt, SD, kk * 16, col0 + np * 16, lane));
        skt_mma::mma_16816(dv[2 * np], phi, bd[0], bd[1]);
        skt_mma::mma_16816(dv[2 * np], plo, bd[0], bd[1]);
        skt_mma::mma_16816(dv[2 * np + 1], phi, bd[2], bd[3]);
        skt_mma::mma_16816(dv[2 * np + 1], plo, bd[2], bd[3]);
        skt_mma::mma_16816(dk[2 * np], dhi, bq[0], bq[1]);
        skt_mma::mma_16816(dk[2 * np], dlo, bq[0], bq[1]);
        skt_mma::mma_16816(dk[2 * np + 1], dhi, bq[2], bq[3]);
        skt_mma::mma_16816(dk[2 * np + 1], dlo, bq[2], bq[3]);
      }
    }
    __syncthreads();                   // stage st is refilled next step
  }
  skt_mma::cp_async_wait<0>();

  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kj0 + 8 * r;
    if (kj >= a.skv) continue;
    bf16* dkp = dk_out + bi * a.st[5][0] + kj * a.st[5][1] + kvh * a.st[5][2];
    bf16* dvp = dv_out + bi * a.st[6][0] + kj * a.st[6][1] + kvh * a.st[6][2];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = col0 + n * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(dkp + c) =
          __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + c) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a, cudaStream_t stream) {
  using S = TcDkv<D>;
  auto kernel = flash_bwd_dkv_kernel_tc<D>;
  if (S::kSmemBytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)S::kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.skv + S::BK - 1) / S::BK, a.hkv, a.b);
  kernel<<<grid, S::kThreads, S::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// --------------------------------------------------------------- bf16 K5b
template <int D>
struct TcDq {
  static constexpr int BQ = 64;                   // q rows per block
  static constexpr int BK = D >= 128 ? 32 : 64;   // k rows per tile
  static constexpr int kRowWarps = BQ / 16;       // warps along the q rows
  static constexpr int CW = D >= 256 ? 128 : D;   // dQ columns per warp
  static constexpr int kColWarps = D / CW;        // warps along head_dim
  static constexpr int kThreads = 32 * kRowWarps * kColWarps;
  static constexpr int SD = D + skt_mma::kPad;    // shared row stride
  static constexpr bool kQRegs = D == 64;         // Q, dO fragments in regs
  // Q, dO, 2 x (K, V) in bf16, then lse and delta in fp32.
  static constexpr size_t kSmemBytes =
      (size_t)(2 * BQ + 4 * BK) * SD * 2 + 2 * BQ * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(TcDq<D>::kThreads)
flash_bwd_dq_kernel_tc(const Args a) {
  using S = TcDq<D>;
  using bf16 = __nv_bfloat16;
  constexpr int BQ = S::BQ, BK = S::BK, SD = S::SD, NTHR = S::kThreads;
  constexpr int KC = D / 16;           // k chunks of the head dim
  constexpr int NT = BK / 8;           // 8-column tiles of S (k columns)
  constexpr int ND = S::CW / 8;        // 8-column tiles of the warp's dQ
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);    // [BQ][SD]
  bf16* dos = qs + BQ * SD;                        // [BQ][SD]
  bf16* ks = dos + BQ * SD;                        // [2][BK][SD]
  bf16* vs = ks + 2 * BK * SD;                     // [2][BK][SD]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * BK * SD);  // [BQ]
  float* delta_s = lse_s + BQ;                     // [BQ]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp % S::kRowWarps;  // the warp's 16 q rows
  const int col0 = (warp / S::kRowWarps) * S::CW;   // its dQ columns
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int q_end = min(q_start + BQ, a.sq);
  const int w_row0 = q_start + wr * 16;           // the warp's first q row
  const bf16* kg = static_cast<const bf16*>(a.k) + bi * a.st[1][0] +
                   kvh * a.st[1][2];
  const bf16* vg = static_cast<const bf16*>(a.v) + bi * a.st[2][0] +
                   kvh * a.st[2][2];

  auto load_rows = [](bf16* dst, const bf16* src, long long rstride,
                      int row0, int rows, int limit) {
    skt_mma::cp_async_rows<D, SD, NTHR>(dst, src, rstride, row0, rows,
                                        limit);
  };

  // k tiles that can hold a valid row for this q tile.
  const int k_stop = a.causal ? min(q_end, a.skv) : a.skv;
  const int n_tiles = (k_stop + BK - 1) / BK;
  load_rows(qs, static_cast<const bf16*>(a.q) + bi * a.st[0][0] +
                    h * a.st[0][2],
            a.st[0][1], q_start, BQ, a.sq);
  load_rows(dos, static_cast<const bf16*>(a.dout) + bi * a.st[3][0] +
                     h * a.st[3][2],
            a.st[3][1], q_start, BQ, a.sq);
  const long long row = ((long long)bi * a.hq + h) * a.sq;
  for (int r = threadIdx.x; r < BQ; r += NTHR) {
    const bool ok = q_start + r < a.sq;
    skt_mma::cp_async_4(lse_s + r, a.lse + (ok ? row + q_start + r : 0), ok);
    skt_mma::cp_async_4(delta_s + r, a.delta + (ok ? row + q_start + r : 0),
                        ok);
  }
  if (n_tiles > 0) {
    load_rows(ks, kg, a.st[1][1], 0, BK, a.skv);
    load_rows(vs, vg, a.st[2][1], 0, BK, a.skv);
  }
  skt_mma::cp_async_commit();

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  uint32_t qf[S::kQRegs ? KC : 1][4], df[S::kQRegs ? KC : 1][4];
  // lse (log2 units) and delta of the lane's rows gid and gid + 8.
  float lse2[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  const float sl2 = a.scale * skt_mma::kLog2e;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int k_start = t * BK;
    if (t + 1 < n_tiles) {             // next tile loads during this one
      load_rows(ks + (buf ^ 1) * BK * SD, kg, a.st[1][1], k_start + BK, BK,
                a.skv);
      load_rows(vs + (buf ^ 1) * BK * SD, vg, a.st[2][1], k_start + BK, BK,
                a.skv);
    }
    skt_mma::cp_async_commit();
    skt_mma::cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = lse_s[wr * 16 + gid + 8 * r] * skt_mma::kLog2e;
        dlt[r] = delta_s[wr * 16 + gid + 8 * r];
      }
      if constexpr (S::kQRegs) {
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          skt_mma::ldmatrix_x4(
              qf[kc], skt_mma::a_frag_addr(qs, SD, wr * 16, kc * 16, lane));
          skt_mma::ldmatrix_x4(
              df[kc], skt_mma::a_frag_addr(dos, SD, wr * 16, kc * 16, lane));
        }
      }
    }
    // A warp whose rows all lie above this tile (causal) skips it.
    const bool live = !a.causal || k_start <= w_row0 + 15;
    if (live) {
      const bf16* kt = ks + buf * BK * SD;
      const bf16* vt = vs + buf * BK * SD;
      // S = Q K^T and dP = dO V^T over the warp's 16 q rows.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qa[4], da[4];
        if constexpr (S::kQRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            qa[x] = qf[kc][x];
            da[x] = df[kc][x];
          }
        } else {
          skt_mma::ldmatrix_x4(
              qa, skt_mma::a_frag_addr(qs, SD, wr * 16, kc * 16, lane));
          skt_mma::ldmatrix_x4(
              da, skt_mma::a_frag_addr(dos, SD, wr * 16, kc * 16, lane));
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4], bv[4];
          skt_mma::ldmatrix_x4(
              bk, skt_mma::b_frag_addr(kt, SD, np * 16, kc * 16, lane));
          skt_mma::ldmatrix_x4(
              bv, skt_mma::b_frag_addr(vt, SD, np * 16, kc * 16, lane));
          skt_mma::mma_16816(s[2 * np], qa, bk[0], bk[1]);
          skt_mma::mma_16816(s[2 * np + 1], qa, bk[2], bk[3]);
          skt_mma::mma_16816(dp[2 * np], da, bv[0], bv[1]);
          skt_mma::mma_16816(dp[2 * np + 1], da, bv[2], bv[3]);
        }
      }
      // P = exp(S scale - lse), exactly 0 where masked (only tiles that
      // cross the diagonal or the kv end are masked); dS = P (dP -
      // delta) scale, written over s.
      const bool masked = k_start + BK > a.skv ||
                          (a.causal && k_start + BK - 1 > w_row0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[n][e], sl2, -lse2[e >> 1]));
          if (masked) {
            const int kj = k_start + n * 8 + 2 * tig + (e & 1);
            const int qi = w_row0 + gid + 8 * (e >> 1);
            if (kj >= a.skv || (a.causal && kj > qi)) p = 0.f;
          }
          s[n][e] = p * (dp[n][e] - dlt[e >> 1]) * a.scale;
        }
      // dQ += dS K over the warp's columns, dS split into bf16 high and
      // low parts, K through ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t dhi[4], dlo[4];
        skt_mma::acc_to_a_split(s[2 * kk], s[2 * kk + 1], dhi, dlo);
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {
          uint32_t bk[4];
          skt_mma::ldmatrix_x4_trans(
              bk, skt_mma::bt_frag_addr(kt, SD, kk * 16, col0 + np * 16, lane));
          skt_mma::mma_16816(dq[2 * np], dhi, bk[0], bk[1]);
          skt_mma::mma_16816(dq[2 * np], dlo, bk[0], bk[1]);
          skt_mma::mma_16816(dq[2 * np + 1], dhi, bk[2], bk[3]);
          skt_mma::mma_16816(dq[2 * np + 1], dlo, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();                   // buf is refilled two tiles on
  }
  skt_mma::cp_async_wait<0>();

  bf16* dq_out = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = w_row0 + gid + 8 * r;
    if (qi >= a.sq) continue;
    bf16* o = dq_out + bi * a.st[4][0] + qi * a.st[4][1] + h * a.st[4][2];
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(o + col0 + n * 8 + 2 * tig) =
          __floats2bfloat162_rn(dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

template <int D>
cudaError_t launch_dq_tc(const Args& a, cudaStream_t stream) {
  using S = TcDq<D>;
  auto kernel = flash_bwd_dq_kernel_tc<D>;
  if (S::kSmemBytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)S::kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.sq + S::BQ - 1) / S::BQ, a.hq, a.b);
  kernel<<<grid, S::kThreads, S::kSmemBytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------- fp32 K5a, K5b (CUDA cores)
template <typename T, int D, bool kDkv>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using S = Shape<D>;
  const size_t smem =
      (size_t)(kDkv ? S::kDkvFloats : S::kDqFloats) * sizeof(float);
  void (*kernel)(const Args);           // only the body asked for is built
  if constexpr (kDkv) {
    kernel = flash_bwd_dkv_kernel<T, D>;
  } else {
    kernel = flash_bwd_dq_kernel<T, D>;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid = kDkv ? dim3((a.skv + S::BK - 1) / S::BK, a.hkv, a.b)
                         : dim3((a.sq + S::BQ - 1) / S::BQ, a.hq, a.b);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kDkv>
cudaError_t dispatch(const Args& a, int d, int dtype, cudaStream_t s) {
  // An empty grid writes nothing; an empty other side leaves the loops
  // empty, so the kernel writes zeros.
  if (a.b == 0 || (kDkv ? a.skv : a.sq) == 0) return cudaSuccess;
  if (dtype == 0) {
    if constexpr (kDkv) {              // bf16 K5a: the tensor-core body
      switch (d) {
        case 64: return launch_dkv_tc<64>(a, s);
        case 128: return launch_dkv_tc<128>(a, s);
        case 256: return launch_dkv_tc<256>(a, s);
      }
    } else {                           // bf16 K5b: the tensor-core body
      switch (d) {
        case 64: return launch_dq_tc<64>(a, s);
        case 128: return launch_dq_tc<128>(a, s);
        case 256: return launch_dq_tc<256>(a, s);
      }
    }
  } else if (dtype == 1) {
    switch (d) {
      case 64: return launch<float, 64, kDkv>(a, s);
      case 128: return launch<float, 128, kDkv>(a, s);
      case 256: return launch<float, 256, kDkv>(a, s);
    }
  }
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta,
               const long long* strides, int b, int hq, int hkv, int sq,
               int skv, int causal, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.b = b;
  a.hq = hq;
  a.hkv = hkv;
  a.sq = sq;
  a.skv = skv;
  a.causal = causal;
  a.scale = scale;
  for (int o = 0; o < 7; ++o)
    for (int x = 0; x < 3; ++x) a.st[o][x] = strides[o * 3 + x];
  return a;
}

}  // namespace

extern "C" {

// dtype: 0 = bf16, 1 = fp32 (q, k, v, do and the gradients alike).
// strides: 21 element strides (batch, seq, head) of q, k, v, do, dq, dk,
// dv (the unused output's may be 0). lse/delta: [b, hq, sq] fp32.
// Returns the CUDA error of the launch (0 = success).
int skt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, const long long* strides, int b,
                      int hq, int hkv, int sq, int skv, int d, int causal,
                      float scale, int dtype, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, strides, b, hq, hkv, sq, skv,
                     causal, scale);
  a.dk = dk;
  a.dv = dv;
  return (int)dispatch<true>(a, d, dtype, static_cast<cudaStream_t>(stream));
}

int skt_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, const long long* strides, int b, int hq,
                     int hkv, int sq, int skv, int d, int causal, float scale,
                     int dtype, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, strides, b, hq, hkv, sq, skv,
                     causal, scale);
  a.dq = dq;
  return (int)dispatch<false>(a, d, dtype, static_cast<cudaStream_t>(stream));
}

const char* skt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
