// Attention of query spans through a page table over shared KV pools.
//
// Replaces src/repro/kernels/paged_attention/kernel.py::
// paged_attention_span (body `_kernel`; `paged_attention_decode` is its
// S = 1 wrapper), the Pallas TPU kernel. For slot b, kv head k and the G
// query heads h = k*G + g of each span row s (query position
// qpos = pos[b] + s), over the L = nP * ps logical positions
// l = j * ps + o held at (page_table[b, j], o):
//   score[l] = (T(q * scale) . K[l]) in fp32, or -1e30 where the page is
//              unmapped or l > qpos
//   P        = T(softmax(score))                 (exact: max, exp-sum)
//   out      = T(sum_l P[l] * V[l])              (fp32 accumulation)
// A row with no valid position gets uniform weights over all L positions
// (an unmapped page reads page 0), as the plain version's gather does.
//
// Bound: bytes at serving sizes. A span row's scores need the mapped K/V
// pages of its slot (2 x L x Dh elements per kv head) against 4 x L x Dh
// operations per query head; with G = 3 heads per kv head and S <= 32 that
// is far below the card's ~295 operations per byte.
//
// Design. The Pallas kernel copies a slot's whole gathered K and V,
// [L, K, Dh] each, into VMEM and runs one softmax over it. At this path's
// size (L = 512, K = 5, Dh = 64, bf16) that is 640 KB, which does not fit
// a block's 227 KB of shared memory, so it is not carried over. Instead
// one block per (slot, kv head, tile of R query rows): the block reads its
// page ids itself, streams K pages through shared memory to build the
// tile's fp32 scores (R x L floats, kept in shared memory; the wrapper
// picks R so they fit), takes the exact softmax of each row (one warp per
// row), rounds P to the value dtype, then streams the V pages for P.V with
// the accumulators in registers. Pages that are unmapped or wholly past
// the tile's last query position are skipped, unless a row of the tile
// has no valid position at all. Shared-memory rows of a page are padded
// to Dh + 1 floats so the score loop's threads hit distinct banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAcc = 16;                 // rows x Dh <= 16 x kThreads
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
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ kpool,
                                       const T* __restrict__ vpool,
                                       const int32_t* __restrict__ pt,
                                       const int32_t* __restrict__ pos,
                                       T* __restrict__ out, int S, int H,
                                       int K, int Dh, int ps, int nP, int R,
                                       float qscale) {
  extern __shared__ float sm[];
  __shared__ int dead;
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int rows = S * G;
  const int r0 = blockIdx.z * R;
  const int nr = min(R, rows - r0);
  const int L = nP * ps;
  const int ld = Dh + 1;                    // padded page row stride
  float* qs = sm;                           // [R, Dh] scaled queries
  float* kv = qs + R * Dh;                  // [ps, Dh + 1] one page
  float* sc = kv + ps * ld;                 // [R, L] scores, then P
  const int t = threadIdx.x;
  const int p0 = pos[b];
  const int32_t* ptab = pt + static_cast<size_t>(b) * nP;
  // tile row rr is span row s = (r0 + rr) / G, head h = kh*G + (r0+rr) % G
  const int qmax = p0 + (r0 + nr - 1) / G;

  if (t == 0) dead = 0;
  for (int i = t; i < nr * Dh; i += kThreads) {
    const int rr = i / Dh, d = i % Dh;
    const int gr = r0 + rr;
    const int s = gr / G, h = kh * G + gr % G;
    const float x =
        to_f(q[((static_cast<size_t>(b) * S + s) * H + h) * Dh + d]);
    qs[i] = to_f(from_f<T>(x * qscale));
  }

  // ---- scores: stream the slot's K pages through shared memory ----
  for (int j = 0; j < nP; ++j) {
    const int page = ptab[j];
    const int l0 = j * ps;
    const bool live = page >= 0 && l0 <= qmax;
    __syncthreads();
    if (live) {
      for (int i = t; i < ps * Dh; i += kThreads) {
        const int o = i / Dh, d = i % Dh;
        kv[o * ld + d] = to_f(
            kpool[((static_cast<size_t>(page) * ps + o) * K + kh) * Dh + d]);
      }
    }
    __syncthreads();
    for (int i = t; i < nr * ps; i += kThreads) {
      const int rr = i / ps, o = i % ps;
      const int l = l0 + o;
      const int qpos = p0 + (r0 + rr) / G;
      float s = kNegInf;
      if (live && l <= qpos) {
        float acc = 0.f;
        const float* qr = qs + rr * Dh;
        const float* kr = kv + o * ld;
        for (int d = 0; d < Dh; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc;
      }
      sc[rr * L + l] = s;
    }
  }
  __syncthreads();

  // ---- exact softmax per row, one warp per row; P rounded to T ----
  const int warp = t >> 5, lane = t & 31;
  for (int rr = warp; rr < nr; rr += kThreads / 32) {
    float* row = sc + rr * L;
    float m = -INFINITY;
    for (int l = lane; l < L; l += 32) m = fmaxf(m, row[l]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int l = lane; l < L; l += 32) {
      const float e = expf(row[l] - m);
      row[l] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int l = lane; l < L; l += 32) row[l] = to_f(from_f<T>(row[l] / sum));
    if (lane == 0 && m <= kNegInf) dead = 1;
  }
  __syncthreads();
  const bool any_dead = dead != 0;

  // ---- P.V: stream the V pages; accumulators in registers ----
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;
  for (int j = 0; j < nP; ++j) {
    const int page = ptab[j];
    const int l0 = j * ps;
    if (!any_dead && (page < 0 || l0 > qmax)) continue;   // zero weights
    const int sp = page < 0 ? 0 : page;
    __syncthreads();
    for (int i = t; i < ps * Dh; i += kThreads) {
      const int o = i / Dh, d = i % Dh;
      kv[o * ld + d] = to_f(
          vpool[((static_cast<size_t>(sp) * ps + o) * K + kh) * Dh + d]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int i = t + a * kThreads;
      if (i < nr * Dh) {
        const int rr = i / Dh, d = i % Dh;
        const float* p = sc + rr * L + l0;
        float x = acc[a];
        for (int o = 0; o < ps; ++o) x = fmaf(p[o], kv[o * ld + d], x);
        acc[a] = x;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int i = t + a * kThreads;
    if (i < nr * Dh) {
      const int rr = i / Dh, d = i % Dh;
      const int gr = r0 + rr;
      const int s = gr / G, h = kh * G + gr % G;
      out[((static_cast<size_t>(b) * S + s) * H + h) * Dh + d] =
          from_f<T>(acc[a]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pt, const void* pos, void* o, int B, int S,
                   int H, int K, int Dh, int ps, int nP, int R, int smem,
                   float qscale, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int rows = S * (H / K);
  dim3 grid(B, K, (rows + R - 1) / R);
  paged_attention_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(pos), static_cast<T*>(o), S, H, K, Dh, ps,
      nP, R, qscale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B,S,H,Dh]; pools [P,ps,K,Dh];
// page table [B,nP] int32 (-1 = unmapped); pos [B] int32; out like q.
// R query rows per block and `smem` dynamic bytes come from the wrapper
// (R * Dh <= 16 * 256 accumulators).
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* pt,
                                      const void* pos, void* o, int dtype,
                                      int B, int S, int H, int K, int Dh,
                                      int ps, int nP, int R, int smem,
                                      float qscale, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (K < 1 || H % K || R < 1 || R * Dh > kMaxAcc * kThreads || nP < 1 ||
      ps < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k, v, pt, pos, o, B, S, H, K, Dh, ps, nP, R, smem, qscale, st));
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k, v, pt, pos, o, B, S, H, K,
                                          Dh, ps, nP, R, smem, qscale, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
