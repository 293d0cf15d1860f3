// Blocked online-softmax attention forward: causal and sliding window,
// GQA, queries right-aligned to keys, any Sq <= Sk.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (the Pallas TPU kernel). Layout as at the reference's public function:
// q [B, Sq, H, Dh], k and v [B, Sk, K, Dh], all contiguous; query head h
// reads KV head h / (H / K) (no repeated KV). Query row i sits at
// position i + Sk - Sq; key j is visible iff (!causal or j <= pos) and
// (!window or j > pos - window). Running max, denominator and accumulator
// are fp32; the output is written in q's dtype.
//
// Rounding follows the port's plain version (models' chunked_attention):
// q is scaled in its own dtype (`qscale` is the scale rounded to that
// dtype by the caller), scores accumulate in fp32, masked scores are
// -1e30, and the probabilities are rounded to the value dtype before the
// P.V product.
//
// Bound: operations at long prompts (2*2*Sq*Sk*H*Dh/2 FLOPs causal);
// launch and latency at serving prompt lengths (tens of tokens). This
// first version is the simple one: one block of 128 threads per
// (q-tile of 64 rows, head, batch), K/V tiles of 32 rows staged in shared
// memory as fp32, scores and P.V with plain FMAs on 4x4 and 4x(Dh/8)
// register tiles. Tiles wholly above the causal diagonal or left of the
// window are skipped; ragged edges are masked in the kernel. wgmma, TMA
// and bf16 tensor cores are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
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
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int H, int KH, float qscale,
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
  const T* qb = q + (size_t)b * Sq * qs + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * ks + (size_t)kh * D;
  const T* vb = v + (size_t)b * Sk * ks + (size_t)kh * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, qi = q0 + r;
    Qs[r * DP + d] =
        qi < Sq ? round_to<T>(to_f(qb[(size_t)qi * qs + d]) * qscale) : 0.f;
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
        kx = to_f(kb[(size_t)kp * ks + d]);
        vx = to_f(vb[(size_t)kp * ks + d]);
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
        Ps[r * BKP + cg + 8 * j] = round_to<T>(p);
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
    T* orow = o + ((size_t)b * Sq + qi) * qs + (size_t)h * D;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      orow[cg + 8 * jj] = from_f<T>(acc[i][jj] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KH, float qscale, int causal,
           int window, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  static bool configured = false;  // the attribute is per function: once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KH, qscale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(int D, const void* q, const void* k, const void* v, void* o,
                 int B, int Sq, int Sk, int H, int KH, float qscale,
                 int causal, int window, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KH, qscale, causal,
                           window, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KH, qscale, causal,
                           window, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KH, qscale, causal,
                            window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim in {32, 64, 128}.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Sk, int H, int KH,
                                      int D, float qscale, int causal,
                                      int window, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, KH,
                                       qscale, causal, window, st);
  return dispatch_dim<float>(D, q, k, v, o, B, Sq, Sk, H, KH, qscale, causal,
                             window, st);
}
