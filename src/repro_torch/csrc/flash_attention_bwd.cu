// Blocked attention backward: dq, dk, dv of the forward in
// flash_attention.cu (causal, sliding window or neither, GQA; with a mask
// queries right-aligned to keys and Sq <= Sk, without one any Sq and Sk),
// in the FlashAttention-2 form. Without a mask every query tile sees every
// key tile: dkdv walks all query tiles (i_lo 0, i_hi Sq), dq all key
// tiles, and the ragged edges (keys past Sk, rows past Sq, both zero-
// filled) are masked by their own tests, never by positions.
//
// Replaces what XLA's autodiff of the reference model's attention gives
// for training (src/repro/models/common.py::chunked_attention: no Pallas
// kernel sits on the reference's training path, its backward is
// generated). Layout as the forward's: q, o, do [B, Sq, H, Dh]; k, v, dk,
// dv [B, Sk, K, Dh]; lse [B, H, Sq] fp32, the forward's per-row
// log-sum-exp of the scaled, masked scores. Query head h reads KV head
// h / (H / K).
//
// Rounding follows the forward and the plain version (ref.attention_bwd):
// q^ = q * scale is rounded to q's dtype; P = exp(s - lse) with s = q^ k
// in fp32 (masked entries: P = 0, as the forward's -1e30 scores give);
// dV = round(P)^T dO with P rounded to v's dtype, as the forward rounds it
// before P.V; D = rowsum(dO * O) in fp32; dS = P * (dO V^T - D); dK =
// dS^T q^; dq = round(round(dS K) * scale), q having been scaled in its
// own dtype. Every sum is fp32; outputs are written in the input dtype.
// The bf16 route adds one rounding point: dS is rounded to bf16 before
// the dK and dQ products (tensor cores take bf16 operands). It is of the
// same kind as the reference's own autodiff, which rounds dP to bf16.
//
// Bound: operations. The bound counts 5 products (S, dP, dV, dK, dQ),
// 2.5x the causal forward's 2*2*Sq*Sk*H*Dh/2; both routes run 7, since
// S and dP are formed again in the dQ pass, which keeps dQ a separate,
// deterministic pass (no atomics: two launches on the same inputs give
// the same bits).
//
// bf16 (the training route): tensor cores, three launches.
//   dot   D[b, h, i] = sum_d dO * O in fp32, and q^ = round(q * scale)
//         into a bf16 scratch [B, Sq, H, Dh]: cp.async copies bytes and
//         cannot scale on the way, and at head_dim 128 the scale is not
//         a power of two, so q^ is formed once. 16 bytes a lane, Dh / 8
//         lanes a row.
//   dkdv  one block per (64-key tile, KV head, batch), 4 warps, each
//         owning 16 keys; K and V stay in swizzled bf16 shared memory
//         (their A fragments in registers up to head_dim 64), and 64-row
//         tiles of q^ and dO, with their lse and D rows, stream through a
//         2-stage cp.async ring while the block walks the G query heads
//         of its KV head (GQA with no atomics) and every query tile that
//         sees the key tile. Scores are formed transposed, keys as the M
//         rows: S^T = K q^T and dP^T = V dO^T by mma.sync.m16n8k16, then
//         P^T = exp(S^T - lse) and dS^T = P^T (dP^T - D) in fp32 with lse
//         and D indexed by column, masked only on tiles that meet an
//         edge. round(P^T) and round(dS^T) in the accumulator layout are
//         the A fragments of dV += P^T dO and dK += dS^T q^, with dO and
//         q^ as B fragments from ldmatrix.trans: up to head_dim 128, P
//         and dS never go through shared memory. At 256 (RecurrentGemma) the
//         fp32 dK and dV of 16 keys would take 256 registers a thread, so
//         8 warps run: two share each 16 keys, each accumulating half of
//         Dh (128 registers). Each forms S^T and dP^T for half of a
//         step's query columns and hands its packed round(P^T) and
//         round(dS^T) to its partner through 16 KB of shared memory (two
//         parities, one named barrier per pair and step), so no product
//         is formed twice. Grid (K * B, key tiles), key tile 0 first: in
//         causal attention it sees every query, so the heaviest tiles of
//         every head and batch start in the first wave. A key tile that
//         no query sees writes zeros.
//   dq    one block per (64-row query tile, head, batch), 4 warps of 16
//         rows; q^ and dO are A fragments (in registers up to head_dim
//         128, read by ldmatrix at 256), 64-key K and V tiles stream
//         through the 2-stage ring; S = q^ K^T, dP = dO V^T, dS rounded
//         to bf16 in the accumulator layout, dQ += dS K with K as B from
//         ldmatrix.trans; dq = round(round(acc) * scale). Grid (H * B, q
//         tiles), the heaviest causal q tiles first, as the forward's.
// Both product passes work in steps of query columns (dkdv: 64 up to
// head_dim 64, else 32) or keys (dq: 64 at head_dim 128, else 32), which
// bounds the S and dP accumulators a warp holds, and skip a warp's step
// when none of its pairs is visible. wgmma, TMA, a persistent schedule
// and a dQ summed by fp32 atomics inside dkdv (one launch fewer, 5
// products, but sums in run-to-run order) are later work.
//
// fp32 (the checks and the fp32 syncode-demo model): the FMA kernel of
// the first port, its arithmetic unchanged (plain float code). Each product is an fp32 FMA register tile
// over padded fp32 tiles in shared memory, 256 threads a block; dot, dkdv
// and dq as above but with dK/dV blocks in (key tile, KV head, batch)
// index order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

// ------------------------------------------------ fp32: FMA kernels

constexpr int kThreads = 256;

// Query rows and keys per tile, and the register tiles of the three
// products, by head_dim. (BQ / SQ) * (BK / SK), (BK / KR) * (D / KD) and
// (BQ / QR) * (D / QD) are each kThreads. dK and dV live in registers, so
// only K, V, q^ and dO tiles, P, dS and two row vectors take shared
// memory: at most 114 KB (head_dim 128). BWD_TILES in ops.py must agree.
template <int D>
struct BwdTiles;
template <>
struct BwdTiles<32> {
  static constexpr int BQ = 64, BK = 64, SQ = 4, SK = 4, KR = 2, KD = 4,
                       QR = 2, QD = 4;
};
template <>
struct BwdTiles<64> {
  static constexpr int BQ = 64, BK = 64, SQ = 4, SK = 4, KR = 4, KD = 4,
                       QR = 4, QD = 4;
};
template <>
struct BwdTiles<128> {
  static constexpr int BQ = 64, BK = 32, SQ = 4, SK = 2, KR = 4, KD = 4,
                       QR = 4, QD = 8;
};
template <>
struct BwdTiles<256> {
  static constexpr int BQ = 32, BK = 16, SQ = 2, SK = 1, KR = 4, KD = 4,
                       QR = 4, QD = 8;
};

template <int D>
struct Check {
  using T = BwdTiles<D>;
  static_assert((T::BQ / T::SQ) * (T::BK / T::SK) == kThreads, "S tile");
  static_assert((T::BK / T::KR) * (D / T::KD) == kThreads, "dK/dV tile");
  static_assert((T::BQ / T::QR) * (D / T::QD) == kThreads, "dQ tile");
  static constexpr bool ok = true;
};

// fp32 words of shared memory: K, V, q^, dO tiles [rows][D + 1], the P and
// dS tiles [BQ][BK + 1] (dq keeps dS only), lse and D rows [BQ].
template <int D>
constexpr size_t smem_words(bool dkdv) {
  using T = BwdTiles<D>;
  return (size_t)2 * T::BK * (D + 1) + 2 * T::BQ * (D + 1) + 2 * T::BQ +
         (dkdv ? 2 : 1) * T::BQ * (T::BK + 1);
}

// ---------------------------------------------------------- D = dO . O

__global__ void __launch_bounds__(kThreads)
    bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                   float* __restrict__ dvec, int rows, int Sq, int H, int D) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // row = (b * Sq + i) * H + h
  const float* orow = o + (size_t)row * D;
  const float* drow = dout + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += orow[d] * drow[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H, i = (row / H) % Sq, b = row / (H * Sq);
    dvec[((size_t)b * H + h) * Sq + i] = acc;
  }
}

// ------------------------------------------------- shared tile helpers

// rows [r0, r0 + R) of a [*, Dh] global head slice (row stride `stride`
// elements) into a padded fp32 tile; rows at or past `limit` read as 0;
// `mul` scales (q^), 0 copies as is
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t stride, int r0, int limit,
                                          float mul) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r0 + r < limit) {
      x = src[(size_t)(r0 + r) * stride + d];
      if (mul != 0.f) x = x * mul;
    }
    dst[r * (D + 1) + d] = x;
  }
}

// S = q^ K^T and dP = dO V^T on the [BQ][BK] tile, then P and dS.
// Thread (ty, tx) owns rows ty + r * (BQ / SQ) and keys tx + c * (BK / SK).
// Writes P to Ps (dkdv only, when Ps != nullptr) and dS to Ss.
template <int D>
__device__ __forceinline__ void scores_tile(
    const float* Qs, const float* Os, const float* Ks, const float* Vs,
    const float* Ls, const float* Dv, float* Ps, float* Ss, int q0, int k0,
    int Sq, int Sk, int q_offset, int causal, int window) {
  using TL = BwdTiles<D>;
  constexpr int SQ = TL::SQ, SK = TL::SK, NX = TL::BK / SK,
                RY = TL::BQ / SQ, DP = D + 1, BKP = TL::BK + 1;
  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  float s[SQ][SK], dp[SQ][SK];
#pragma unroll
  for (int r = 0; r < SQ; ++r)
#pragma unroll
    for (int c = 0; c < SK; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[SQ], ov[SQ], kv[SK], vv[SK];
#pragma unroll
    for (int r = 0; r < SQ; ++r) {
      qv[r] = Qs[(ty + r * RY) * DP + d];
      ov[r] = Os[(ty + r * RY) * DP + d];
    }
#pragma unroll
    for (int c = 0; c < SK; ++c) {
      kv[c] = Ks[(tx + c * NX) * DP + d];
      vv[c] = Vs[(tx + c * NX) * DP + d];
    }
#pragma unroll
    for (int r = 0; r < SQ; ++r)
#pragma unroll
      for (int c = 0; c < SK; ++c) {
        s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
        dp[r][c] = fmaf(ov[r], vv[c], dp[r][c]);
      }
  }
#pragma unroll
  for (int r = 0; r < SQ; ++r) {
    const int i = ty + r * RY, qi = q0 + i, pos = qi + q_offset;
#pragma unroll
    for (int c = 0; c < SK; ++c) {
      const int j = tx + c * NX, kp = k0 + j;
      const bool vis = qi < Sq && kp < Sk && (!causal || kp <= pos) &&
                       (window <= 0 || kp > pos - window);
      const float p = vis ? expf(s[r][c] - Ls[i]) : 0.f;
      if (Ps != nullptr) Ps[i * BKP + j] = p;
      Ss[i * BKP + j] = p * (dp[r][c] - Dv[i]);
    }
  }
}

// ------------------------------------------------------------ dK, dV

template <int D>
__global__ void __launch_bounds__(kThreads, 2) bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    float* __restrict__ dk, float* __restrict__ dv,
    int Sq, int Sk, int H, int KH, float qscale, int causal, int window) {
  using TL = BwdTiles<D>;
  static_assert(Check<D>::ok, "tiles");
  constexpr int BQ = TL::BQ, BK = TL::BK, KR = TL::KR, KD = TL::KD;
  constexpr int DP = D + 1, BKP = BK + 1, NX = D / KD, RY = BK / KR;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][DP]
  float* Vs = Ks + BK * DP;    // [BK][DP]
  float* Qs = Vs + BK * DP;    // q^ [BQ][DP]
  float* Os = Qs + BQ * DP;    // dO [BQ][DP]
  float* Ls = Os + BQ * DP;    // lse [BQ]
  float* Dv = Ls + BQ;         // D [BQ]
  float* Ps = Dv + BQ;         // P [BQ][BKP]
  float* Ss = Ps + BQ * BKP;   // dS [BQ][BKP]

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, q_offset = Sk - Sq;
  const size_t qstr = (size_t)H * D, kstr = (size_t)KH * D;
  const float* kb = k + (size_t)b * Sk * kstr + (size_t)kh * D;
  const float* vb = v + (size_t)b * Sk * kstr + (size_t)kh * D;
  load_rows<D, BK>(Ks, kb, kstr, k0, Sk, 0.f);
  load_rows<D, BK>(Vs, vb, kstr, k0, Sk, 0.f);

  // query rows that see a key of [k0, kmax]
  const int kmax = min(k0 + BK, Sk) - 1;
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Sq, kmax + window - q_offset) : Sq;

  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  float acck[KR][KD], accv[KR][KD];
#pragma unroll
  for (int r = 0; r < KR; ++r)
#pragma unroll
    for (int c = 0; c < KD; ++c) acck[r][c] = accv[r][c] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = kh * G + hh;
    const float* qb = q + (size_t)b * Sq * qstr + (size_t)h * D;
    const float* ob = dout + (size_t)b * Sq * qstr + (size_t)h * D;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* db = dvec + ((size_t)b * H + h) * Sq;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // K/V loaded; the previous tiles consumed
      load_rows<D, BQ>(Qs, qb, qstr, q0, Sq, qscale);
      load_rows<D, BQ>(Os, ob, qstr, q0, Sq, 0.f);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        Ls[r] = in ? lb[q0 + r] : 0.f;
        Dv[r] = in ? db[q0 + r] : 0.f;
      }
      __syncthreads();
      scores_tile<D>(Qs, Os, Ks, Vs, Ls, Dv, Ps, Ss, q0, k0, Sq, Sk,
                        q_offset, causal, window);
      __syncthreads();
      // dV[j][d] += sum_i P[i][j] dO[i][d]; dK likewise with dS, q^
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        float pv[KR], sv[KR], ov[KD], qv[KD];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          pv[r] = Ps[i * BKP + ty + r * RY];
          sv[r] = Ss[i * BKP + ty + r * RY];
        }
#pragma unroll
        for (int c = 0; c < KD; ++c) {
          ov[c] = Os[i * DP + tx + c * NX];
          qv[c] = Qs[i * DP + tx + c * NX];
        }
#pragma unroll
        for (int r = 0; r < KR; ++r)
#pragma unroll
          for (int c = 0; c < KD; ++c) {
            accv[r][c] = fmaf(pv[r], ov[c], accv[r][c]);
            acck[r][c] = fmaf(sv[r], qv[c], acck[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int kp = k0 + ty + r * RY;
    if (kp >= Sk) continue;
    const size_t off = ((size_t)b * Sk + kp) * kstr + (size_t)kh * D;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      dk[off + tx + c * NX] = acck[r][c];
      dv[off + tx + c * NX] = accv[r][c];
    }
  }
}

// ---------------------------------------------------------------- dQ

template <int D>
__global__ void __launch_bounds__(kThreads, 2) bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    float* __restrict__ dq, int Sq, int Sk,
    int H, int KH, float qscale, int causal, int window) {
  using TL = BwdTiles<D>;
  static_assert(Check<D>::ok, "tiles");
  constexpr int BQ = TL::BQ, BK = TL::BK, QR = TL::QR, QD = TL::QD;
  constexpr int DP = D + 1, BKP = BK + 1, NX = D / QD, RY = BQ / QR;
  extern __shared__ float smem[];
  float* Ks = smem;            // [BK][DP]
  float* Vs = Ks + BK * DP;    // [BK][DP]
  float* Qs = Vs + BK * DP;    // q^ [BQ][DP]
  float* Os = Qs + BQ * DP;    // dO [BQ][DP]
  float* Ls = Os + BQ * DP;    // lse [BQ]
  float* Dv = Ls + BQ;         // D [BQ]
  float* Ss = Dv + BQ;         // dS [BQ][BKP]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH), q_offset = Sk - Sq;
  const size_t qstr = (size_t)H * D, kstr = (size_t)KH * D;
  const float* kb = k + (size_t)b * Sk * kstr + (size_t)kh * D;
  const float* vb = v + (size_t)b * Sk * kstr + (size_t)kh * D;
  load_rows<D, BQ>(Qs, q + (size_t)b * Sq * qstr + (size_t)h * D, qstr,
                      q0, Sq, qscale);
  load_rows<D, BQ>(Os, dout + (size_t)b * Sq * qstr + (size_t)h * D,
                      qstr, q0, Sq, 0.f);
  const float* lb = lse + ((size_t)b * H + h) * Sq;
  const float* db = dvec + ((size_t)b * H + h) * Sq;
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < Sq;
    Ls[r] = in ? lb[q0 + r] : 0.f;
    Dv[r] = in ? db[q0 + r] : 0.f;
  }

  const int pos_lo = q0 + q_offset;
  const int pos_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  const int kend = causal ? min(Sk, pos_hi + 1) : Sk;
  const int kbeg = window > 0 ? max(0, pos_lo - window + 1) : 0;

  const int tx = threadIdx.x % NX, ty = threadIdx.x / NX;
  float acc[QR][QD];
#pragma unroll
  for (int r = 0; r < QR; ++r)
#pragma unroll
    for (int c = 0; c < QD; ++c) acc[r][c] = 0.f;

  for (int k0 = (kbeg / BK) * BK; k0 < kend; k0 += BK) {
    __syncthreads();  // q^/dO loaded; the previous tiles consumed
    load_rows<D, BK>(Ks, kb, kstr, k0, Sk, 0.f);
    load_rows<D, BK>(Vs, vb, kstr, k0, Sk, 0.f);
    __syncthreads();
    scores_tile<D>(Qs, Os, Ks, Vs, Ls, Dv, nullptr, Ss, q0, k0, Sq, Sk,
                      q_offset, causal, window);
    __syncthreads();
    // d(q^)[i][d] += sum_j dS[i][j] K[j][d]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sv[QR], kv[QD];
#pragma unroll
      for (int r = 0; r < QR; ++r) sv[r] = Ss[(ty + r * RY) * BKP + j];
#pragma unroll
      for (int c = 0; c < QD; ++c) kv[c] = Ks[j * DP + tx + c * NX];
#pragma unroll
      for (int r = 0; r < QR; ++r)
#pragma unroll
        for (int c = 0; c < QD; ++c) acc[r][c] = fmaf(sv[r], kv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < QR; ++r) {
    const int qi = q0 + ty + r * RY;
    if (qi >= Sq) continue;
    float* row = dq + ((size_t)b * Sq + qi) * qstr + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < QD; ++c)
      row[tx + c * NX] = acc[r][c] * qscale;
  }
}

// ------------------------------------------- bf16: tensor-core kernels

using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;    // keys per dK/dV block (16 per warp)
constexpr int kRows = 64;    // query rows per streamed tile and dq block
constexpr int kStages = 2;   // cp.async ring depth
constexpr int kDotThreads = 256;

// Per head_dim: WD warps share each 16 keys of a dK/dV block, each
// accumulating Dh / WD columns of dK and dV (fp32 registers: 2 * 16 *
// (Dh / WD) / 32 a thread, at most 128) and forming S^T and dP^T for
// STEP / WD of a step's STEP query columns; KREG keeps the K and V A
// fragments of dkdv in registers, QREG the q^ and dO A fragments of dq;
// QSTEP keys a dq step. Of 32 and 64, the steps are the faster on an
// NVIDIA H100 80GB HBM3 at 700 W among those that leave no spills
// (PERF.md, PR 20).
// BWD_KEY_WARPS and BWD_STEP in ops.py must agree with WD and STEP.
template <int D>
struct Bf16Bwd {
  static constexpr int WD = D >= 256 ? 2 : 1;
  static constexpr int STEP = D <= 64 ? 64 : 32;
  static constexpr int QSTEP = D == 128 ? 64 : 32;
  static constexpr int KV_THREADS = 4 * WD * 32;
  static constexpr bool KREG = D <= 64;
  static constexpr bool QREG = D <= 128;
  // 32-bit words a lane hands its partner warp each step (WD == 2): its
  // packed P^T and dS^T, 4 words per n-tile
  static constexpr int XW = WD > 1 ? 4 * STEP / WD / 8 : 0;
};

// dkdv: K and V tiles, kStages x (q^ and dO tiles, lse and D rows), and
// at WD == 2 two parities of the warp pairs' exchange slots
template <int D>
constexpr size_t dkdv_smem_bf16() {
  using TL = Bf16Bwd<D>;
  return sizeof(bf16) * 2 * kKeys * D +
         kStages * (sizeof(bf16) * 2 * kRows * D + sizeof(float) * 2 * kRows) +
         sizeof(uint32_t) * 2 * (TL::KV_THREADS / 32) * TL::XW * 32;
}

// dq: q^ and dO tiles, then kStages x (K and V tiles of kKeys keys)
template <int D>
constexpr size_t dq_smem_bf16() {
  return sizeof(bf16) * (2 * kRows * D + kStages * 2 * kKeys * D);
}

// D = rowsum(dO * O) and q^ = round(q * qscale); Dh / 8 lanes per row,
// one 16-byte chunk each, reduced over the lane group by shuffles
template <int D>
__global__ void __launch_bounds__(kDotThreads) bwd_dot_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, bf16* __restrict__ qhat,
    float* __restrict__ dvec, int rows, int Sq, int H, float qscale) {
  constexpr int LPR = D / 8;  // 4..32, divides the warp
  const int t = blockIdx.x * kDotThreads + threadIdx.x;
  const int row = t / LPR, c = t % LPR;  // row = (b * Sq + i) * H + h
  const bool in = row < rows;
  float acc = 0.f;
  if (in) {
    const size_t off = (size_t)row * D + c * 8;
    uint4 ov = *reinterpret_cast<const uint4*>(o + off);
    uint4 dv = *reinterpret_cast<const uint4*>(dout + off);
    uint4 qv = *reinterpret_cast<const uint4*>(q + off);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    __nv_bfloat162* q2 = reinterpret_cast<__nv_bfloat162*>(&qv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]);
      const float2 b = __bfloat1622float2(d2[i]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      const float2 f = __bfloat1622float2(q2[i]);
      q2[i] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
    }
    *reinterpret_cast<uint4*>(qhat + off) = qv;
  }
#pragma unroll
  for (int s = LPR / 2; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (in && c == 0) {
    const int h = row % H, i = (row / H) % Sq, b = row / (H * Sq);
    dvec[((size_t)b * H + h) * Sq + i] = acc;
  }
}

// 16-byte chunks of rows [r0, r0 + R) of a [*, D] global head slice (row
// stride `stride` elements) into a swizzled bf16 tile by cp.async; rows at
// or past `limit` are zero-filled
template <int D, int R, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src,
                                          size_t stride, int r0, int limit) {
  constexpr int NCH = D / 8;
  for (int e = threadIdx.x; e < R * NCH; e += NT) {
    const int r = e / NCH, c = e % NCH;
    const bool in = r0 + r < limit;
    const size_t off = in ? (size_t)(r0 + r) * stride + c * 8 : 0;
    cp_async16(smem_u32(dst + swz<D>(r, c)), src + off, in);
  }
}

// key kp is visible from the query at position pos
__device__ __forceinline__ bool visible(int kp, int pos, int causal,
                                        int window) {
  return (!causal || kp <= pos) && (window <= 0 || kp > pos - window);
}

template <int D>
__global__ void __launch_bounds__(Bf16Bwd<D>::KV_THREADS)
    bwd_dkdv_bf16_kernel(const bf16* __restrict__ qhat,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int Sq, int Sk, int H, int KH, int causal,
                         int window) {
  using TL = Bf16Bwd<D>;
  constexpr int NT = TL::KV_THREADS, WD = TL::WD, XW = TL::XW;
  constexpr int KQ = D / 16;         // k-steps of S^T and dP^T
  constexpr int DW = D / WD;         // dK/dV columns of one warp
  constexpr int NDW = DW / 8;        // their n-tiles
  constexpr int STEP = TL::STEP;     // query columns a step
  constexpr int NS = STEP / 8;       // n-tiles of a step's S^T
  constexpr int NSW = NS / WD;       // those this warp forms (even)
  constexpr int STAGE = 2 * kRows * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [kKeys][D]
  bf16* Vs = Ks + kKeys * D;                      // [kKeys][D]
  bf16* Rs = Vs + kKeys * D;      // [kStages][q^, dO][kRows][D]
  float* Ls = reinterpret_cast<float*>(Rs + kStages * STAGE);
                                  // [kStages][lse, D][kRows]
  uint32_t* Xs = reinterpret_cast<uint32_t*>(Ls + kStages * 2 * kRows);
                                  // [2][NT / 32][XW][32] (WD == 2)

  const int kh = blockIdx.x % KH, b = blockIdx.x / KH;
  const int k0 = blockIdx.y * kKeys;  // tile 0 first: the heaviest
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kw = (warp & 3) * 16;     // the warp's 16 keys in the tile
  const int half = warp >> 2;         // its share of columns (WD == 2)
  const int dw = half * DW;           // its first dK/dV column
  const int G = H / KH, q_offset = Sk - Sq;
  const size_t qstr = (size_t)H * D, kstr = (size_t)KH * D;

  // query tiles that see a key of [k0, kmax], for each of the G heads
  const int kmax = min(k0 + kKeys, Sk) - 1;
  const int i_lo = causal ? max(0, k0 - q_offset) : 0;
  const int i_hi = window > 0 ? min(Sq, kmax + window - q_offset) : Sq;
  const int qt0 = i_lo / kRows;
  const int nq = i_hi > qt0 * kRows ? (i_hi - qt0 * kRows + kRows - 1) / kRows
                                    : 0;
  const int items = G * nq;

  auto load_item = [&](int it, int buf) {
    const int h = kh * G + it / nq, q0 = (qt0 + it % nq) * kRows;
    const size_t hoff = (size_t)b * Sq * qstr + (size_t)h * D;
    bf16* qd = Rs + buf * STAGE;
    copy_rows<D, kRows, NT>(qd, qhat + hoff, qstr, q0, Sq);
    copy_rows<D, kRows, NT>(qd + kRows * D, dout + hoff, qstr, q0, Sq);
    float* ld = Ls + buf * 2 * kRows;
    const size_t lrow = ((size_t)b * H + h) * Sq;
    for (int r = tid; r < 2 * kRows; r += NT) {
      const int qi = q0 + (r & (kRows - 1));
      const bool in = qi < Sq;
      const float* src = (r < kRows ? lse : dvec) + (in ? lrow + qi : 0);
      cp_async4(smem_u32(ld + r), src, in);
    }
  };

  const size_t koff = (size_t)b * Sk * kstr + (size_t)kh * D;
  copy_rows<D, kKeys, NT>(Ks, k + koff, kstr, k0, Sk);
  copy_rows<D, kKeys, NT>(Vs, v + koff, kstr, k0, Sk);
  if (items > 0) load_item(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // A fragments: the warp's 16 keys x 16 columns of K or V
  auto a_frag = [&](uint32_t (&r)[4], const bf16* t, int kk) {
    ldsm_x4(r, smem_u32(t + swz<D>(kw + (lane & 15), kk * 2 + (lane >> 4))));
  };
  constexpr bool KREG = TL::KREG;
  uint32_t kf[KREG ? KQ : 1][4], vf[KREG ? KQ : 1][4];
  if constexpr (KREG) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      a_frag(kf[kk], Ks, kk);
      a_frag(vf[kk], Vs, kk);
    }
  }

  float dka[NDW][4], dva[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.f;

  const int kp0 = k0 + kw + g, kp1 = kp0 + 8;  // the thread's two keys
  const int kw_lo = k0 + kw, kw_hi = kw_lo + 15;
  for (int it = 0; it < items; ++it) {
    const int buf = it & 1;
    if (it > 0) {
      cp_async_wait<0>();  // item `it` has landed
      __syncthreads();     // and every warp is done with the other buffer
    }
    if (it + 1 < items) {
      load_item(it + 1, buf ^ 1);
      cp_async_commit();
    }
    const int q0 = (qt0 + it % nq) * kRows;
    const bf16* Qt = Rs + buf * STAGE;
    const bf16* Ot = Qt + kRows * D;
    const float* Lt = Ls + buf * 2 * kRows;
    const float* Dt = Lt + kRows;

#pragma unroll 1
    for (int c0 = 0; c0 < kRows; c0 += STEP) {
      const int pos_lo = q0 + c0 + q_offset, pos_hi = pos_lo + STEP - 1;
      if ((causal && kw_lo > pos_hi) ||
          (window > 0 && kw_hi <= pos_lo - window))
        continue;  // none of the warp's pairs in this step is visible
      const int cw = c0 + half * (STEP / WD);  // the columns it forms
      float st[NSW][4], dpt[NSW][4];
#pragma unroll
      for (int n = 0; n < NSW; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (KREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[i] = kf[kk][i];
            va[i] = vf[kk][i];
          }
        } else {
          a_frag(ka, Ks, kk);
          a_frag(va, Vs, kk);
        }
#pragma unroll
        for (int np = 0; np < NSW / 2; ++np) {
          const int r = cw + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int c = kk * 2 + ((lane >> 3) & 1);
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, smem_u32(Qt + swz<D>(r, c)));
          ldsm_x4(bo, smem_u32(Ot + swz<D>(r, c)));
          mma_bf16(st[2 * np], ka, bq[0], bq[1]);
          mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
          mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
          mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
        }
      }

      // P^T and dS^T, masked only where the step meets an edge
      const bool edge = kw_hi >= Sk || q0 + c0 + STEP > Sq ||
                        (causal && kw_hi > pos_lo) ||
                        (window > 0 && kw_lo <= pos_hi - window);
      uint32_t po[NSW][4];  // round(P^T) (words 0, 1), round(dS^T) (2, 3)
#pragma unroll
      for (int n = 0; n < NSW; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = cw + n * 8 + 2 * tq + (i & 1);
          float p = exp2f((st[n][i] - Lt[col]) * kLog2e);
          if (edge) {
            const int kp = i < 2 ? kp0 : kp1, qi = q0 + col;
            if (kp >= Sk || qi >= Sq ||
                !visible(kp, qi + q_offset, causal, window))
              p = 0.f;
          }
          st[n][i] = p;
          dpt[n][i] = p * (dpt[n][i] - Dt[col]);
        }
        po[n][0] = pack_bf16(st[n][0], st[n][1]);
        po[n][1] = pack_bf16(st[n][2], st[n][3]);
        po[n][2] = pack_bf16(dpt[n][0], dpt[n][1]);
        po[n][3] = pack_bf16(dpt[n][2], dpt[n][3]);
      }
      // the A fragments of the whole step: this warp's n-tiles and, at WD
      // == 2, its partner's (same keys, the other half of the columns),
      // traded through shared memory; the two parities alternate within
      // an item, and items are separated by __syncthreads
      uint32_t pp[NSW][4];
      if constexpr (WD > 1) {
        uint32_t* x = Xs + (c0 / STEP & 1) * (NT / 32) * XW * 32;
#pragma unroll
        for (int n = 0; n < NSW; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            x[(warp * XW + n * 4 + j) * 32 + lane] = po[n][j];
        bar_sync(1 + (warp & 3), 64);
#pragma unroll
        for (int n = 0; n < NSW; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pp[n][j] = x[((warp ^ 4) * XW + n * 4 + j) * 32 + lane];
      }
      uint32_t pa[NS / 2][4], sa[NS / 2][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bool own = WD == 1 || n / NSW == half;
        auto f = [&](int j) { return own ? po[n % NSW][j] : pp[n % NSW][j]; };
        pa[n >> 1][(n & 1) * 2] = f(0);
        pa[n >> 1][(n & 1) * 2 + 1] = f(1);
        sa[n >> 1][(n & 1) * 2] = f(2);
        sa[n >> 1][(n & 1) * 2 + 1] = f(3);
      }

      // dV += round(P^T) dO, dK += round(dS^T) q^ over the step's queries
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const int r = c0 + kk * 16 + (lane & 15);
#pragma unroll
        for (int dp = 0; dp < NDW / 2; ++dp) {
          const int c = dw / 8 + dp * 2 + (lane >> 4);
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, smem_u32(Ot + swz<D>(r, c)));
          ldsm_x4_t(bq, smem_u32(Qt + swz<D>(r, c)));
          mma_bf16(dva[2 * dp], pa[kk], bo[0], bo[1]);
          mma_bf16(dva[2 * dp + 1], pa[kk], bo[2], bo[3]);
          mma_bf16(dka[2 * dp], sa[kk], bq[0], bq[1]);
          mma_bf16(dka[2 * dp + 1], sa[kk], bq[2], bq[3]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NDW; ++n) {
    const int d = dw + n * 8 + 2 * tq;
    if (kp0 < Sk) {
      const size_t off = ((size_t)b * Sk + kp0) * kstr + (size_t)kh * D + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(dka[n][0], dka[n][1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dva[n][0], dva[n][1]);
    }
    if (kp1 < Sk) {
      const size_t off = ((size_t)b * Sk + kp1) * kstr + (size_t)kh * D + d;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(dka[n][2], dka[n][3]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dva[n][2], dva[n][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) bwd_dq_bf16_kernel(
    const bf16* __restrict__ qhat, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dvec,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int KH, float qscale,
    int causal, int window) {
  constexpr int KQ = D / 16;      // k-steps of S and dP
  constexpr int ND = D / 8;       // n-tiles of dQ
  constexpr int QSTEP = Bf16Bwd<D>::QSTEP;  // keys a step
  constexpr int NS = QSTEP / 8;   // n-tiles of a step's S
  constexpr int TILE = kKeys * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // q^ [kRows][D]
  bf16* Os = Qs + kRows * D;                     // dO [kRows][D]
  bf16* Ks = Os + kRows * D;                     // [kStages][kKeys][D]
  bf16* Vs = Ks + kStages * TILE;                // [kStages][kKeys][D]

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest first
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int q_offset = Sk - Sq;
  const size_t qstr = (size_t)H * D, kstr = (size_t)KH * D;
  const size_t hoff = (size_t)b * Sq * qstr + (size_t)h * D;
  const bf16* kb = k + (size_t)b * Sk * kstr + (size_t)kh * D;
  const bf16* vb = v + (size_t)b * Sk * kstr + (size_t)kh * D;

  const int pos_lo = q0 + q_offset;
  const int pos_hi = min(q0 + kRows, Sq) - 1 + q_offset;
  const int kend = causal ? min(Sk, pos_hi + 1) : Sk;
  const int kbeg = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int t_beg = kbeg / kKeys, t_end = (kend + kKeys - 1) / kKeys;

  auto load_tile = [&](int t, int buf) {
    copy_rows<D, kKeys, 128>(Ks + buf * TILE, kb, kstr, t * kKeys, Sk);
    copy_rows<D, kKeys, 128>(Vs + buf * TILE, vb, kstr, t * kKeys, Sk);
  };
  copy_rows<D, kRows, 128>(Qs, qhat + hoff, qstr, q0, Sq);
  copy_rows<D, kRows, 128>(Os, dout + hoff, qstr, q0, Sq);
  if (t_beg < t_end) load_tile(t_beg, 0);
  cp_async_commit();

  const int wr0 = warp * 16;              // the warp's first tile row
  const bool active = q0 + wr0 < Sq;      // any of its rows real
  const int qi0 = q0 + wr0 + g, qi1 = qi0 + 8;
  const int pos0 = qi0 + q_offset, pos1 = qi1 + q_offset;
  const int wpos_lo = q0 + wr0 + q_offset, wpos_hi = wpos_lo + 15;
  const float* lrow = lse + ((size_t)b * H + h) * Sq;
  const float* drow = dvec + ((size_t)b * H + h) * Sq;
  const float l0 = qi0 < Sq ? lrow[qi0] : 0.f, l1 = qi1 < Sq ? lrow[qi1] : 0.f;
  const float D0 = qi0 < Sq ? drow[qi0] : 0.f, D1 = qi1 < Sq ? drow[qi1] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  auto a_frag = [&](uint32_t (&r)[4], const bf16* t, int kk) {
    ldsm_x4(r, smem_u32(t + swz<D>(wr0 + (lane & 15), kk * 2 + (lane >> 4))));
  };
  constexpr bool QREG = Bf16Bwd<D>::QREG;
  uint32_t qf[QREG ? KQ : 1][4], of[QREG ? KQ : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      a_frag(qf[kk], Qs, kk);
      a_frag(of[kk], Os, kk);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int t = t_beg; t < t_end; ++t) {
    const int buf = (t - t_beg) & 1;
    if (t > t_beg) {
      cp_async_wait<0>();  // tile t has landed
      __syncthreads();     // and every warp is done with the other buffer
    }
    if (t + 1 < t_end) {
      load_tile(t + 1, buf ^ 1);
      cp_async_commit();
    }
    if (!active) continue;
    const bf16* Kt = Ks + buf * TILE;
    const bf16* Vt = Vs + buf * TILE;

#pragma unroll 1
    for (int c0 = 0; c0 < kKeys; c0 += QSTEP) {
      const int kl = t * kKeys + c0, kr = kl + QSTEP - 1;
      if (kl >= Sk || (causal && kl > wpos_hi) ||
          (window > 0 && kr <= wpos_lo - window))
        continue;  // none of the warp's pairs in this step is visible
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t qa[4], oa[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qa[i] = qf[kk][i];
            oa[i] = of[kk][i];
          }
        } else {
          a_frag(qa, Qs, kk);
          a_frag(oa, Os, kk);
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          const int r = c0 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int c = kk * 2 + ((lane >> 3) & 1);
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, smem_u32(Kt + swz<D>(r, c)));
          ldsm_x4(bv, smem_u32(Vt + swz<D>(r, c)));
          mma_bf16(s[2 * np], qa, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
          mma_bf16(dp[2 * np], oa, bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], oa, bv[2], bv[3]);
        }
      }

      const bool edge = kr >= Sk || (causal && kr > wpos_lo) ||
                        (window > 0 && kl <= wpos_hi - window);
      uint32_t da[NS / 2][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool lo = i < 2;
          float p = exp2f((s[n][i] - (lo ? l0 : l1)) * kLog2e);
          if (edge) {
            const int kp = kl + n * 8 + 2 * tq + (i & 1);
            if (kp >= Sk || !visible(kp, lo ? pos0 : pos1, causal, window))
              p = 0.f;
          }
          dp[n][i] = p * (dp[n][i] - (lo ? D0 : D1));
        }
        da[n >> 1][(n & 1) * 2] = pack_bf16(dp[n][0], dp[n][1]);
        da[n >> 1][(n & 1) * 2 + 1] = pack_bf16(dp[n][2], dp[n][3]);
      }

      // d(q^) += round(dS) K over the step's keys
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const int r = c0 + kk * 16 + (lane & 15);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t bk[4];
          ldsm_x4_t(bk, smem_u32(Kt + swz<D>(r, n2 * 2 + (lane >> 4))));
          mma_bf16(acc[2 * n2], da[kk], bk[0], bk[1]);
          mma_bf16(acc[2 * n2 + 1], da[kk], bk[2], bk[3]);
        }
      }
    }
  }

  // dq = round(round(d(q^)) * scale), q having been scaled in bf16
  auto out = [&](float a, float c) {
    return __floats2bfloat162_rn(
        __bfloat162float(__float2bfloat16(a)) * qscale,
        __bfloat162float(__float2bfloat16(c)) * qscale);
  };
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + 2 * tq;
    if (qi0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dq + hoff + (size_t)qi0 * qstr + d) =
          out(acc[n][0], acc[n][1]);
    if (qi1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dq + hoff + (size_t)qi1 * qstr + d) =
          out(acc[n][2], acc[n][3]);
  }
}

// ------------------------------------------------------- launching

template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;  // the attribute is per function
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) configured = true;
  return e;
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dq, void* dk,
               void* dv, void* dvec, int B, int Sq, int Sk, int H, int KH,
               float qscale, int causal, int window, cudaStream_t st) {
  using TL = BwdTiles<D>;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dvt = static_cast<float*>(dvec);

  const int rows = B * Sq * H;
  bwd_dot_kernel<<<(rows + 7) / 8, kThreads, 0, st>>>(
      static_cast<const float*>(o), dot, dvt, rows, Sq, H, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr size_t smem_kv = smem_words<D>(true) * sizeof(float);
  auto kv_kern = bwd_dkdv_kernel<D>;
  static bool kv_configured = false;
  e = allow_smem(kv_kern, smem_kv, kv_configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 kv_grid((Sk + TL::BK - 1) / TL::BK, KH, B);
  kv_kern<<<kv_grid, kThreads, smem_kv, st>>>(
      qt, kt, vt, dot, lt, dvt, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, H, KH, qscale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr size_t smem_q = smem_words<D>(false) * sizeof(float);
  auto q_kern = bwd_dq_kernel<D>;
  static bool q_configured = false;
  e = allow_smem(q_kern, smem_q, q_configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 q_grid((Sq + TL::BQ - 1) / TL::BQ, H, B);
  q_kern<<<q_grid, kThreads, smem_q, st>>>(qt, kt, vt, dot, lt, dvt,
                                           static_cast<float*>(dq), Sq, Sk, H,
                                           KH, qscale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_bf16(const void* q, const void* k, const void* v,
                    const void* o, const void* lse, const void* dout,
                    void* dq, void* dk, void* dv, void* dvec, void* qhat,
                    int B, int Sq, int Sk, int H, int KH, float qscale,
                    int causal, int window, cudaStream_t st) {
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float* lt = static_cast<const float*>(lse);
  bf16* qh = static_cast<bf16*>(qhat);
  float* dvt = static_cast<float*>(dvec);

  const int rows = B * Sq * H;
  const long long lanes = (long long)rows * (D / 8);
  bwd_dot_bf16_kernel<D>
      <<<(unsigned)((lanes + kDotThreads - 1) / kDotThreads), kDotThreads, 0,
         st>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(o), dot,
               qh, dvt, rows, Sq, H, qscale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr size_t smem_kv = dkdv_smem_bf16<D>();
  auto kv_kern = bwd_dkdv_bf16_kernel<D>;
  static bool kv_configured = false;
  e = allow_smem(kv_kern, smem_kv, kv_configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 kv_grid(KH * B, (Sk + kKeys - 1) / kKeys);
  kv_kern<<<kv_grid, Bf16Bwd<D>::KV_THREADS, smem_kv, st>>>(
      qh, kt, vt, dot, lt, dvt, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, KH, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr size_t smem_q = dq_smem_bf16<D>();
  auto q_kern = bwd_dq_bf16_kernel<D>;
  static bool q_configured = false;
  e = allow_smem(q_kern, smem_q, q_configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 q_grid(H * B, (Sq + kRows - 1) / kRows);
  q_kern<<<q_grid, 128, smem_q, st>>>(qh, kt, vt, dot, lt, dvt,
                                      static_cast<bf16*>(dq), Sq, Sk, H, KH,
                                      qscale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_smem(int dtype, int pass) {
  if (dtype == 1)
    return (int)(pass == 0 ? dkdv_smem_bf16<D>() : dq_smem_bf16<D>());
  return (int)(smem_words<D>(pass == 0) * sizeof(float));
}

}  // namespace

// Dynamic shared memory of one block (bytes) of the dK/dV pass (pass 0)
// or the dQ pass (pass 1) for dtype 0 = float32, 1 = bfloat16, or -1 for
// an unsupported head_dim. The wrapper's `bwd_launch_plan` must agree.
extern "C" int flash_attention_bwd_smem_bytes(int dtype, int D, int pass) {
  switch (D) {
    case 32:
      return bwd_smem<32>(dtype, pass);
    case 64:
      return bwd_smem<64>(dtype, pass);
    case 128:
      return bwd_smem<128>(dtype, pass);
    case 256:
      return bwd_smem<256>(dtype, pass);
    default:
      return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16; head_dim in {32, 64, 128, 256}. All
// tensors contiguous and 16-byte aligned; `dvec` is fp32 scratch [B, H,
// Sq] for D; `qhat` is scratch of q's shape for q^ (bf16 only; fp32
// ignores it and may pass null).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dvec, void* qhat, int dtype, int B, int Sq, int Sk, int H, int KH,
    int D, float qscale, int causal, int window, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FAB_CASE(DIM)                                                   \
  case DIM:                                                                   \
    return dtype == 1                                                         \
               ? launch_bwd_bf16<DIM>(q, k, v, o, lse, dout, dq, dk, dv,      \
                                      dvec, qhat, B, Sq, Sk, H, KH, qscale,   \
                                      causal, window, st)                     \
               : launch_bwd<DIM>(q, k, v, o, lse, dout, dq, dk, dv, dvec, B,  \
                                 Sq, Sk, H, KH, qscale, causal, window, st);
  switch (D) {
    REPRO_FAB_CASE(32)
    REPRO_FAB_CASE(64)
    REPRO_FAB_CASE(128)
    REPRO_FAB_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FAB_CASE
}
