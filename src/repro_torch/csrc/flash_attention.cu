// Blocked online-softmax attention forward: causal, sliding window, or
// neither (an encoder's self-attention, cross attention to its frames);
// GQA. With a causal mask or a window, queries are right-aligned to keys
// and Sq <= Sk; with neither, any Sq and Sk (the wrapper refuses the rest).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (the Pallas TPU kernel). Layout as at the reference's public function:
// q [B, Sq, H, Dh], k and v [B, Sk, K, Dh], all contiguous; query head h
// reads KV head h / (H / K) (no repeated KV). Query row i sits at
// position i + Sk - Sq; key j is visible iff (!causal or j <= pos) and
// (!window or j > pos - window). Without a mask the position is read by
// nothing, so Sq > Sk (a negative offset) is harmless; keys past Sk are cut
// by their own -inf test on every tile that reaches past Sk. Running max,
// denominator and accumulator are fp32; the output is written in q's dtype.
//
// Rounding follows the port's plain version (models' chunked_attention):
// q is scaled in its own dtype (`qscale` is the scale rounded to that
// dtype by the caller), scores accumulate in fp32, masked scores are
// -1e30 (keys past Sk: -inf, they contribute exactly nothing), and the
// probabilities are rounded to the value dtype before the P.V product.
//
// With a non-null `lse` the kernel also writes each row's log-sum-exp of
// its scaled, masked scores, m + log(l) in fp32, [B, H, Sq]: the training
// forward keeps it for the backward kernel (flash_attention_bwd.cu). The
// output does not depend on it, bit for bit.
//
// Bound: operations at long prompts (2*2*Sq*Sk*H*Dh/2 FLOPs causal,
// 4*Sq*Sk*H*Dh without a mask); launch and latency at serving prompt
// lengths (tens of tokens); bytes for one query over many keys (a decode
// step's cross attention: K and V read once).
//
// bf16: tensor cores, FlashAttention-2 form. One block of 4 warps per
// (64-row q tile, head, batch); each warp owns 16 query rows. T(q*scale)
// is held in registers as the A fragments of mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate) up to head_dim 128. At head_dim 256 (RecurrentGemma)
// a warp's O accumulator alone is 128 registers per thread, so the Q
// fragments stay in shared memory and are read by ldmatrix at each k-step
// (64 registers fewer), and the K/V tiles hold 64 keys, so that the Q tile
// and two stages of K and V fit a block's shared memory (160 KB; 128-key
// tiles would need 288 KB). K/V tiles of 128 keys (64 at head_dim 256) go
// through a ring of 2-3 stages in shared memory (Tiles<D>), filled by
// cp.async 16-byte copies
// of the bf16 data, rows swizzled by an XOR on their 16-byte chunks so
// that ldmatrix (ldmatrix.trans for V) is free of bank conflicts. S = QK^T
// is masked in registers, only on tiles that meet an edge; the online
// softmax is fp32 with the row max reduced over the quad of lanes that
// share a row; P = T(exp(s - m)) feeds the P.V mma directly, since the
// m16n8 accumulator layout is the A layout of the next product. Tiles
// wholly above the diagonal or left of the window are skipped, and the
// grid starts the heaviest causal q tiles of all heads first, so that the
// last wave holds light tiles (without a causal mask every tile weighs
// the same and the order is immaterial).
//
// fp32: the FMA kernel of the first port, unchanged (fp32 tiles in shared
// memory, 4x4 register tiles). TF32 tensor cores would round q and k to
// 10 mantissa bits, which breaks the 1e-5 fp32 tolerance and the fp32
// mask-exactness check; fp32 runs only for those checks and the
// syncode-demo model check, never on the bf16 serving path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ------------------------------------------------ fp32: FMA kernel

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int KH, float qscale,
    int causal, int window) {
  constexpr int DP = D + 1;     // padded rows spread the banks
  constexpr int BKP = kBK + 1;
  constexpr int DC = D / 8;     // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;    // [kBK][DP]
  float* Vs = Ks + kBK * DP;    // [kBK][D]
  float* Ps = Vs + kBK * D;     // [kBQ][BKP]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7;                  // column group 0..7
  const int rg = warp * 4 + (lane >> 3);    // row group 0..15 (4 rows)
  const int q_offset = Sk - Sq;
  const size_t qs = (size_t)H * D, ks = (size_t)KH * D;
  const float* qb = q + (size_t)b * Sq * qs + (size_t)h * D;
  const float* kb = k + (size_t)b * Sk * ks + (size_t)kh * D;
  const float* vb = v + (size_t)b * Sk * ks + (size_t)kh * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, qi = q0 + r;
    Qs[r * DP + d] = qi < Sq ? qb[(size_t)qi * qs + d] * qscale : 0.f;
  }

  const int pos_lo = q0 + q_offset;
  const int pos_hi = min(q0 + kBQ, Sq) - 1 + q_offset;
  const int kend = causal ? min(Sk, pos_hi + 1) : Sk;
  const int kbeg = window > 0 ? max(0, pos_lo - window + 1) : 0;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (kbeg / kBK) * kBK; k0 < kend; k0 += kBK) {
    __syncthreads();  // Q visible; previous tile's K/V/P consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e % D, kp = k0 + c;
      float kx = 0.f, vx = 0.f;
      if (kp < Sk) {
        kx = kb[(size_t)kp * ks + d];
        vx = vb[(size_t)kp * ks + d];
      }
      Ks[c * DP + d] = kx;
      Vs[c * D + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(cg + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int pos = q0 + r + q_offset;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 8 * j;
        float x = s[i][j];
        if (kp >= Sk)
          x = -INFINITY;  // past the end: contributes exactly nothing
        else if ((causal && kp > pos) || (window > 0 && kp <= pos - window))
          x = kNegInf;    // masked as the plain version masks
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 4));
      const float mnew = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - mnew);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mnew);
        rsum += p;
        Ps[r * BKP + cg + 8 * j] = p;
      }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 4);
      l[i] = l[i] * alpha + rsum;
      m[i] = mnew;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * BKP + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float vv = Vs[c * D + cg + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && cg == 0)
      lse[((size_t)b * H + h) * Sq + qi] = m[i] + logf(den);
    float* orow = o + ((size_t)b * Sq + qi) * qs + (size_t)h * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) orow[cg + 8 * jj] = acc[i][jj] / den;
  }
}

// ------------------------------------------- bf16: tensor-core kernel

constexpr int kTQ = 64;        // query rows per block (16 per warp)
constexpr int kWarps = 4;

// Keys per K/V tile and cp.async stages per head_dim: the fastest of the
// sizes tried on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md) up to head_dim
// 128; at 256 the largest tile that fits two stages in shared memory.
// QREG: the Q fragments live in registers for the whole block.
template <int D>
struct Tiles {
  static constexpr int BK = D >= 256 ? 64 : 128;
  static constexpr int ST = D == 32 ? 3 : 2;
  static constexpr bool QREG = D <= 128;
};

template <int D>
constexpr size_t smem_bytes_bf16() {
  // Q tile + a ring of ST K tiles and ST V tiles, bf16
  return sizeof(__nv_bfloat16) *
         (size_t)(kTQ + 2 * Tiles<D>::ST * Tiles<D>::BK) * D;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int KH, float qscale,
    int causal, int window) {
  constexpr int kTK = Tiles<D>::BK, ST = Tiles<D>::ST;
  constexpr int NCH = D / 8;    // 16-byte chunks per row
  constexpr int NT = kTK / 8;   // n-tiles of S per warp
  constexpr int ND = D / 8;     // n-tiles of O per warp
  constexpr int KQ = D / 16;    // k-steps of QK^T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTQ * D;        // [ST][kTK][D]
  __nv_bfloat16* Vs = Ks + ST * kTK * D;   // [ST][kTK][D]

  // grid (H, q tiles, B): the heaviest causal q tiles of every head go
  // first, so the last wave holds the light ones
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTQ;
  const int h = blockIdx.x, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma row group, lane in quad
  const int q_offset = Sk - Sq;
  const size_t qstr = (size_t)H * D, kstr = (size_t)KH * D;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * qstr + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Sk * kstr + (size_t)kh * D;
  const __nv_bfloat16* vb = v + (size_t)b * Sk * kstr + (size_t)kh * D;

  const int pos_lo = q0 + q_offset;
  const int pos_hi = min(q0 + kTQ, Sq) - 1 + q_offset;
  const int kend = causal ? min(Sk, pos_hi + 1) : Sk;
  const int kbeg = window > 0 ? max(0, pos_lo - window + 1) : 0;
  const int t_beg = kbeg / kTK, t_end = (kend + kTK - 1) / kTK;

  auto load_tile = [&](int t, int buf) {
    const int k0 = t * kTK;
    __nv_bfloat16* kd = Ks + buf * kTK * D;
    __nv_bfloat16* vd = Vs + buf * kTK * D;
    for (int e = tid; e < kTK * NCH; e += kWarps * 32) {
      const int r = e / NCH, c = e % NCH, kp = k0 + r;
      const bool in = kp < Sk;
      const size_t off = in ? (size_t)kp * kstr + c * 8 : 0;
      cp_async16(smem_u32(kd + swz<D>(r, c)), kb + off, in);
      cp_async16(smem_u32(vd + swz<D>(r, c)), vb + off, in);
    }
  };

#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {   // ST - 1 tiles in flight ahead
    if (t_beg + i < t_end) load_tile(t_beg + i, i);
    cp_async_commit();
  }

  // T(q * scale), rows past Sq zero; rounded once, as the plain version
  for (int e = tid; e < kTQ * NCH; e += kWarps * 32) {
    const int r = e / NCH, c = e % NCH, qi = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (qi < Sq) {
      raw = *reinterpret_cast<const uint4*>(qb + (size_t)qi * qstr + c * 8);
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(x[i]);
        x[i] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
      }
    }
    *reinterpret_cast<uint4*>(Qs + swz<D>(r, c)) = raw;
  }
  __syncthreads();

  const int wr0 = warp * 16;                 // the warp's first tile row
  const bool active = q0 + wr0 < Sq;         // any of its rows real
  auto q_frag = [&](uint32_t (&r)[4], int kk) {
    ldsm_x4(r, smem_u32(Qs + swz<D>(wr0 + (lane & 15),
                                    kk * 2 + (lane >> 4))));
  };
  constexpr bool QREG = Tiles<D>::QREG;
  uint32_t qf[QREG ? KQ : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) q_frag(qf[kk], kk);
  }

  // rows g and g + 8 of the warp's 16
  const int pos0 = q0 + wr0 + g + q_offset, pos1 = pos0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[n][i] = 0.f;

  for (int t = t_beg; t < t_end; ++t) {
    const int buf = (t - t_beg) % ST;
    if (t + ST - 1 < t_end) load_tile(t + ST - 1, (buf + ST - 1) % ST);
    cp_async_commit();
    cp_async_wait<ST - 1>();  // tile t has landed
    __syncthreads();
    const int k0 = t * kTK;
    const __nv_bfloat16* kt = Ks + buf * kTK * D;
    const __nv_bfloat16* vt = Vs + buf * kTK * D;

    if (active) {
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t qa[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
        } else {
          q_frag(qa, kk);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, smem_u32(kt + swz<D>(np * 16 + (lane & 7) +
                                               ((lane >> 4) << 3),
                                           kk * 2 + ((lane >> 3) & 1))));
          mma_bf16(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
        }
      }

      // mask in registers only where the tile meets an edge
      const bool edge = k0 + kTK > Sk ||
                        (causal && k0 + kTK - 1 > pos_lo) ||
                        (window > 0 && k0 <= pos_hi - window);
      if (edge) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kp = k0 + n * 8 + 2 * tq + (i & 1);
            const int pos = i < 2 ? pos0 : pos1;
            if (kp >= Sk)
              s[n][i] = -INFINITY;
            else if ((causal && kp > pos) ||
                     (window > 0 && kp <= pos - window))
              s[n][i] = kNegInf;
          }
      }

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // exp(x) as exp2(x * log2 e): one MUFU op, within a few fp32 ulps
      // of expf; x = s - m is formed first, so s = m (a row whose keys
      // so far are all masked at -1e30) gives exactly 1
      const float a0 = exp2f((m0 - mn0) * kLog2e);
      const float a1 = exp2f((m1 - mn1) * kLog2e);
      m0 = mn0;
      m1 = mn1;

      uint32_t pf[NT / 2][4];  // P as the A fragments of P.V
      float r0 = 0.f, r1 = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = exp2f((s[n][0] - mn0) * kLog2e);
        const float p1 = exp2f((s[n][1] - mn0) * kLog2e);
        const float p2 = exp2f((s[n][2] - mn1) * kLog2e);
        const float p3 = exp2f((s[n][3] - mn1) * kLog2e);
        r0 += p0 + p1;
        r1 += p2 + p3;
        pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
        pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * a0 + r0;  // lane-partial sums, reduced over the quad
      l1 = l1 * a1 + r1;  // once at the end (alpha is uniform per row)
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        oacc[n][0] *= a0;
        oacc[n][1] *= a0;
        oacc[n][2] *= a1;
        oacc[n][3] *= a1;
      }

#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t vf[4];
          ldsm_x4_t(vf, smem_u32(vt + swz<D>(kk * 16 + (lane & 15),
                                             dp * 2 + (lane >> 4))));
          mma_bf16(oacc[2 * dp], pf[kk], vf[0], vf[1]);
          mma_bf16(oacc[2 * dp + 1], pf[kk], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buf before it refills
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int qi0 = q0 + wr0 + g, qi1 = qi0 + 8;
  if (lse != nullptr && tq == 0) {
    float* lrow = lse + ((size_t)b * H + h) * Sq;
    if (qi0 < Sq) lrow[qi0] = m0 + logf(d0);
    if (qi1 < Sq) lrow[qi1] = m1 + logf(d1);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + 2 * tq;
    if (qi0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)b * Sq + qi0) * qstr +
                                         (size_t)h * D + d) =
          __floats2bfloat162_rn(oacc[n][0] / d0, oacc[n][1] / d0);
    if (qi1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)b * Sq + qi1) * qstr +
                                         (size_t)h * D + d) =
          __floats2bfloat162_rn(oacc[n][2] / d1, oacc[n][3] / d1);
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
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Sk, int H, int KH, float qscale,
               int causal, int window, cudaStream_t st) {
  constexpr size_t smem = smem_bytes_f32<D>();
  auto kern = flash_fwd_f32_kernel<D>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Sk, H, KH, qscale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Sq, int Sk, int H, int KH, float qscale,
                int causal, int window, cudaStream_t st) {
  constexpr size_t smem = smem_bytes_bf16<D>();
  auto kern = flash_fwd_bf16_kernel<D>;
  static bool configured = false;
  cudaError_t e = allow_smem(kern, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(H, (Sq + kTQ - 1) / kTQ, B);
  kern<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, KH, qscale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block (bytes), or -1 for an unsupported
// (dtype, head_dim). The wrapper's launch plan must agree with it.
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  switch (D) {
    case 32:
      return (int)(dtype == 1 ? smem_bytes_bf16<32>() : smem_bytes_f32<32>());
    case 64:
      return (int)(dtype == 1 ? smem_bytes_bf16<64>() : smem_bytes_f32<64>());
    case 128:
      return (int)(dtype == 1 ? smem_bytes_bf16<128>()
                              : smem_bytes_f32<128>());
    case 256:
      return (int)(dtype == 1 ? smem_bytes_bf16<256>()
                              : smem_bytes_f32<256>());
    default:
      return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16. head_dim in {32, 64, 128, 256}. Pointers
// 16-byte aligned (the wrapper copies a tensor that is not). `lse` (fp32
// [B, H, Sq]) may be null: then no log-sum-exp is written.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int B, int Sq, int Sk, int H,
                                      int KH, int D, float qscale, int causal,
                                      int window, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_CASE(DIM)                                                  \
  case DIM:                                                                 \
    return dtype == 1 ? launch_bf16<DIM>(q, k, v, o, lse, B, Sq, Sk, H, KH, \
                                         qscale, causal, window, st)        \
                      : launch_f32<DIM>(q, k, v, o, lse, B, Sq, Sk, H, KH,  \
                                        qscale, causal, window, st);
  switch (D) {
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(128)
    REPRO_FA_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FA_CASE
}
