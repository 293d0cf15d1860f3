// Blocked attention backward: dq, dk, dv of the forward in
// flash_attention.cu (causal and sliding window, GQA, queries
// right-aligned to keys, any Sq <= Sk), in the FlashAttention-2 form.
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
//
// Three launches:
//   dot   D[b, h, i] = sum_d dO * O, one warp per row;
//   dkdv  one block per (key tile, KV head, batch): K and V tiles stay in
//         shared memory, dK and dV accumulate in registers while the block
//         walks the G query heads of its KV head and every query tile that
//         can see the key tile; no atomics across query heads;
//   dq    one block per (query tile, head, batch) over the key tiles the
//         tile can see.
// Each product (S = q^ K^T, dP = dO V^T, dV, dK, dQ) is an fp32 FMA
// register tile over padded fp32 tiles in shared memory, 256 threads a
// block. This is the simple, right kernel; tensor cores (wgmma), TMA and
// a schedule for speed are later work.
//
// Bound: operations, about 2.5x the causal forward's 2*2*Sq*Sk*H*Dh/2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T's precision (identity for fp32)
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

// ---------------------------------------------------------- D = dO . O

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ dvec, int rows, int Sq, int H, int D) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // row = (b * Sq + i) * H + h
  const T* orow = o + (size_t)row * D;
  const T* drow = dout + (size_t)row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_f<T>(orow[d]) * to_f<T>(drow[d]);
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
// `mul` scales and rounds to T (q^), 0 copies as is
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t stride, int r0, int limit,
                                          float mul) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float x = 0.f;
    if (r0 + r < limit) {
      x = to_f<T>(src[(size_t)(r0 + r) * stride + d]);
      if (mul != 0.f) x = round_t<T>(x * mul);
    }
    dst[r * (D + 1) + d] = x;
  }
}

// S = q^ K^T and dP = dO V^T on the [BQ][BK] tile, then P and dS.
// Thread (ty, tx) owns rows ty + r * (BQ / SQ) and keys tx + c * (BK / SK).
// Writes round(P) to Ps (dkdv only, when Ps != nullptr) and dS to Ss.
template <typename T, int D>
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
      if (Ps != nullptr) Ps[i * BKP + j] = round_t<T>(p);
      Ss[i * BKP + j] = p * (dp[r][c] - Dv[i]);
    }
  }
}

// ------------------------------------------------------------ dK, dV

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
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
  float* Ps = Dv + BQ;         // round(P) [BQ][BKP]
  float* Ss = Ps + BQ * BKP;   // dS [BQ][BKP]

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH, q_offset = Sk - Sq;
  const size_t qstr = (size_t)H * D, kstr = (size_t)KH * D;
  const T* kb = k + (size_t)b * Sk * kstr + (size_t)kh * D;
  const T* vb = v + (size_t)b * Sk * kstr + (size_t)kh * D;
  load_rows<T, D, BK>(Ks, kb, kstr, k0, Sk, 0.f);
  load_rows<T, D, BK>(Vs, vb, kstr, k0, Sk, 0.f);

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
    const T* qb = q + (size_t)b * Sq * qstr + (size_t)h * D;
    const T* ob = dout + (size_t)b * Sq * qstr + (size_t)h * D;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* db = dvec + ((size_t)b * H + h) * Sq;
    for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
      __syncthreads();  // K/V loaded; the previous tiles consumed
      load_rows<T, D, BQ>(Qs, qb, qstr, q0, Sq, qscale);
      load_rows<T, D, BQ>(Os, ob, qstr, q0, Sq, 0.f);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        const bool in = q0 + r < Sq;
        Ls[r] = in ? lb[q0 + r] : 0.f;
        Dv[r] = in ? db[q0 + r] : 0.f;
      }
      __syncthreads();
      scores_tile<T, D>(Qs, Os, Ks, Vs, Ls, Dv, Ps, Ss, q0, k0, Sq, Sk,
                        q_offset, causal, window);
      __syncthreads();
      // dV[j][d] += sum_i round(P)[i][j] dO[i][d]; dK likewise with dS, q^
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
      dk[off + tx + c * NX] = from_f<T>(acck[r][c]);
      dv[off + tx + c * NX] = from_f<T>(accv[r][c]);
    }
  }
}

// ---------------------------------------------------------------- dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, T* __restrict__ dq, int Sq, int Sk,
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
  const T* kb = k + (size_t)b * Sk * kstr + (size_t)kh * D;
  const T* vb = v + (size_t)b * Sk * kstr + (size_t)kh * D;
  load_rows<T, D, BQ>(Qs, q + (size_t)b * Sq * qstr + (size_t)h * D, qstr,
                      q0, Sq, qscale);
  load_rows<T, D, BQ>(Os, dout + (size_t)b * Sq * qstr + (size_t)h * D,
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
    load_rows<T, D, BK>(Ks, kb, kstr, k0, Sk, 0.f);
    load_rows<T, D, BK>(Vs, vb, kstr, k0, Sk, 0.f);
    __syncthreads();
    scores_tile<T, D>(Qs, Os, Ks, Vs, Ls, Dv, nullptr, Ss, q0, k0, Sq, Sk,
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
    T* row = dq + ((size_t)b * Sq + qi) * qstr + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < QD; ++c)
      row[tx + c * NX] = from_f<T>(round_t<T>(acc[r][c]) * qscale);
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

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dq, void* dk,
               void* dv, void* dvec, int B, int Sq, int Sk, int H, int KH,
               float qscale, int causal, int window, cudaStream_t st) {
  using TL = BwdTiles<D>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lt = static_cast<const float*>(lse);
  float* dvt = static_cast<float*>(dvec);

  const int rows = B * Sq * H;
  bwd_dot_kernel<T><<<(rows + 7) / 8, kThreads, 0, st>>>(
      static_cast<const T*>(o), dot, dvt, rows, Sq, H, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr size_t smem_kv = smem_words<D>(true) * sizeof(float);
  auto kv_kern = bwd_dkdv_kernel<T, D>;
  static bool kv_configured = false;
  e = allow_smem(kv_kern, smem_kv, kv_configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 kv_grid((Sk + TL::BK - 1) / TL::BK, KH, B);
  kv_kern<<<kv_grid, kThreads, smem_kv, st>>>(
      qt, kt, vt, dot, lt, dvt, static_cast<T*>(dk), static_cast<T*>(dv), Sq,
      Sk, H, KH, qscale, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  constexpr size_t smem_q = smem_words<D>(false) * sizeof(float);
  auto q_kern = bwd_dq_kernel<T, D>;
  static bool q_configured = false;
  e = allow_smem(q_kern, smem_q, q_configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 q_grid((Sq + TL::BQ - 1) / TL::BQ, H, B);
  q_kern<<<q_grid, kThreads, smem_q, st>>>(qt, kt, vt, dot, lt, dvt,
                                           static_cast<T*>(dq), Sq, Sk, H,
                                           KH, qscale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_smem(int pass) {
  return (int)(smem_words<D>(pass == 0) * sizeof(float));
}

}  // namespace

// Dynamic shared memory of one block (bytes) of the dK/dV pass (pass 0)
// or the dQ pass (pass 1), or -1 for an unsupported head_dim. The
// wrapper's `bwd_launch_plan` must agree with it.
extern "C" int flash_attention_bwd_smem_bytes(int D, int pass) {
  switch (D) {
    case 32:
      return bwd_smem<32>(pass);
    case 64:
      return bwd_smem<64>(pass);
    case 128:
      return bwd_smem<128>(pass);
    case 256:
      return bwd_smem<256>(pass);
    default:
      return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16; head_dim in {32, 64, 128, 256}. All
// tensors contiguous; `dvec` is fp32 scratch [B, H, Sq] for D.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dvec, int dtype, int B, int Sq, int Sk, int H, int KH, int D,
    float qscale, int causal, int window, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FAB_CASE(DIM)                                                 \
  case DIM:                                                                 \
    return dtype == 1                                                       \
               ? launch_bwd<__nv_bfloat16, DIM>(q, k, v, o, lse, dout, dq,  \
                                                dk, dv, dvec, B, Sq, Sk, H, \
                                                KH, qscale, causal, window, \
                                                st)                         \
               : launch_bwd<float, DIM>(q, k, v, o, lse, dout, dq, dk, dv,  \
                                        dvec, B, Sq, Sk, H, KH, qscale,     \
                                        causal, window, st);
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
