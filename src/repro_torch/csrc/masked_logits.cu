// Grammar mask over a batch of logits rows, [N, V] with N = B or B*K.
//
// Replaces src/repro/kernels/masked_logits/kernel.py::masked_logits
// (body `_kernel`) and ::masked_logits_span (body `_kernel_span`), the
// Pallas TPU kernels. For each row r:
//   words    = cd[r] | OR_a store[rows[r, a]]      (rows < 0 skipped)
//   allow[i] = bit (i & 31) of words[i >> 5] | (i == eos_id & eos[r])
//              | !constrained[r]
//   out[r,i] = allow[i] ? logits[r,i] : NEG        (NEG = -1e30 in T)
// The span form [B, K, V] is the same function on B*K flattened rows, so
// one kernel serves both entry points.
//
// Bound: bytes. Each row reads its logits and writes its output (2 x V
// elements), plus A store rows of W words and the cd words: at B = 8,
// V = 49152, bf16, A = 48 that is ~0.8 MB of logits traffic and up to
// ~2.4 MB of store words (rows shared between slots are served by L2).
//
// Design (simple and right first). The Pallas grid (B, V-blocks, A) runs
// A innermost on one core, carrying the union in VMEM across grid steps.
// On Hopper blocks run in parallel with nothing carried between them, so
// the A loop moves inside the block: one block per (row, vocab tile of
// kTileV entries). The block stages its row ids in shared memory in
// chunks, ORs the tile's kTileW words over its A rows (four partial
// unions per word, then combined), seeds the union with cd, and writes
// where(bit, logit, NEG) for its tile. Any A (every accept_width bucket)
// and any V (the last tile is ragged) are handled.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileV = 2048;                // vocab entries per block
constexpr int kTileW = kTileV / 32;         // 64 packed words
constexpr int kParts = kThreads / kTileW;   // partial unions per word

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
__global__ void masked_logits_kernel(const T* __restrict__ logits,
                                     const uint32_t* __restrict__ store,
                                     const int32_t* __restrict__ rows,
                                     const bool* __restrict__ eos,
                                     const bool* __restrict__ constrained,
                                     const uint32_t* __restrict__ cd,
                                     T* __restrict__ out, int V, int W,
                                     int A, int eos_id, float neg_value) {
  __shared__ int32_t rid[kThreads];
  __shared__ uint32_t part[kParts][kTileW];
  __shared__ uint32_t words[kTileW];

  const int r = blockIdx.y;
  const int v0 = blockIdx.x * kTileV;
  const int w0 = v0 >> 5;
  const int t = threadIdx.x;
  const T* lrow = logits + static_cast<size_t>(r) * V;
  T* orow = out + static_cast<size_t>(r) * V;
  const int vend = min(V, v0 + kTileV);

  if (constrained != nullptr && !constrained[r]) {
    for (int i = v0 + t; i < vend; i += kThreads) orow[i] = lrow[i];
    return;
  }

  // thread t ORs word (t % kTileW) of the tile over rows a = t / kTileW
  // (mod kParts) of each staged chunk
  const int wl = t % kTileW;
  const int pt = t / kTileW;
  const int w = w0 + wl;
  uint32_t acc = 0u;
  for (int a0 = 0; a0 < A; a0 += kThreads) {
    __syncthreads();
    rid[t] = (a0 + t < A) ? rows[static_cast<size_t>(r) * A + a0 + t] : -1;
    __syncthreads();
    const int n = min(kThreads, A - a0);
    if (w < W) {
      for (int a = pt; a < n; a += kParts) {
        const int id = rid[a];
        if (id >= 0) acc |= store[static_cast<size_t>(id) * W + w];
      }
    }
  }
  part[pt][wl] = acc;
  __syncthreads();
  if (t < kTileW) {
    uint32_t u = 0u;
#pragma unroll
    for (int p = 0; p < kParts; ++p) u |= part[p][t];
    if (cd != nullptr && w0 + t < W)
      u |= cd[static_cast<size_t>(r) * W + w0 + t];
    words[t] = u;
  }
  __syncthreads();

  const bool eos_ok = eos[r];
  const T neg = from_f<T>(neg_value);
  for (int i = v0 + t; i < vend; i += kThreads) {
    const int li = i - v0;
    bool allow = (words[li >> 5] >> (li & 31)) & 1u;
    allow |= (i == eos_id) && eos_ok;
    orow[i] = allow ? lrow[i] : neg;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const void* store, const void* rows,
                   const void* eos, const void* constrained, const void* cd,
                   void* out, int N, int V, int W, int A, int eos_id,
                   float neg, cudaStream_t stream) {
  dim3 grid((V + kTileV - 1) / kTileV, N);
  masked_logits_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const uint32_t*>(store),
      static_cast<const int32_t*>(rows), static_cast<const bool*>(eos),
      static_cast<const bool*>(constrained),
      static_cast<const uint32_t*>(cd), static_cast<T*>(out), V, W, A,
      eos_id, neg);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `neg` is -1e30 already rounded to
// the logits' dtype by the wrapper (exact in T), so the fill has the
// plain version's bits. `constrained` and `cd` may be null.
extern "C" int masked_logits_launch(const void* logits, int dtype,
                                    const void* store, const void* rows,
                                    const void* eos, const void* constrained,
                                    const void* cd, void* out, int N, int V,
                                    int W, int A, int eos_id, float neg,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || V < 1 || A < 1 || W * 32 < V || N > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e;
  if (dtype == 0) {
    e = launch<float>(logits, store, rows, eos, constrained, cd, out, N, V,
                      W, A, eos_id, neg, s);
  } else if (dtype == 1) {
    e = launch<__nv_bfloat16>(logits, store, rows, eos, constrained, cd, out,
                              N, V, W, A, eos_id, neg, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
