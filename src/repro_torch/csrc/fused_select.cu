// Fused grammar mask + top-k/top-p filter + sample for one decode step.
//
// Replaces src/repro/kernels/fused_select/kernel.py::fused_select (the
// Pallas TPU kernel). For each row b of the batch:
//   words    = cd[b] | OR_a store[rows[b, a]]      (rows < 0 skipped)
//   allow[i] = bit (i & 31) of words[i >> 5]  | (i == eos_id & eos[b])
//              | !constrained[b]
//   masked   = allow ? logits : NEG            (NEG = -1e30 in T)
//   ok[b]    = any(masked > -5e29)
//   greedy   = argmax(masked)                  (first index on ties)
//   sample   = argmax(topk_topp_filter(masked / max(temp, 1e-6)) + noise)
//   ids[b]   = greedy_flags[b] ? greedy : sample
//
// Bound: bytes. Per row it must read the logits, the noise, the residue
// words and the store rows it ORs, and write the masked row: about 8 B
// per vocab entry plus 4 B per store word. At B <= 16 and V = 49152 that
// is a few MB, so at serving sizes the kernel is bound by its launch and
// by the serial passes inside one block, not by the card.
//
// Design (the simple one that is right): one block of 1024 threads per
// row. The union lives in shared memory (W words, 6 KB at V = 49152).
// The row is never sorted: the top-k cutoff is found by a radix select
// (four 8-bit histogram passes) on the order-preserving uint32 image of
// the fp32 scaled values, and the nucleus cutoff by the same four passes
// over exp-mass histograms: the largest value v whose inclusive mass
// sum_{x >= v} exp(x - max) reaches top_p * Z. That equals the reference
// rule "first sorted index whose cumulative softmax reaches top_p", ties
// included, up to the order in which the masses are summed; when no value
// reaches top_p the cutoff is the smallest value (nothing is demoted).
// The passes re-read the row, which stays in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kNoIndex = 0x7fffffff;

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

__device__ __forceinline__ uint32_t key_of(float f) {
  uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ void am_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

struct Scratch {
  float v[kWarps];
  int i[kWarps];
  float f[kWarps];
  unsigned int cnt[256];
  float mass[256];
  int digit;
  int rank;
  float above;
  int found;
};

// Block-wide (max, first index); every thread gets the result.
__device__ void block_argmax(float& v, int& i, Scratch& s) {
  for (int off = 16; off > 0; off >>= 1)
    am_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
             __shfl_xor_sync(0xffffffffu, i, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s.v[warp] = v;
    s.i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s.v[lane] : -INFINITY;
    i = lane < kWarps ? s.i[lane] : kNoIndex;
    for (int off = 16; off > 0; off >>= 1)
      am_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
               __shfl_xor_sync(0xffffffffu, i, off));
    if (lane == 0) {
      s.v[0] = v;
      s.i[0] = i;
    }
  }
  __syncthreads();
  v = s.v[0];
  i = s.i[0];
  __syncthreads();
}

__device__ float block_sum(float x, Scratch& s) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s.f[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? s.f[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) s.f[0] = x;
  }
  __syncthreads();
  x = s.f[0];
  __syncthreads();
  return x;
}

// Scaled value of entry i after the top-k demotion (`kth` = -inf: none).
template <typename T>
__device__ __forceinline__ float filtered_k(const T* mrow, int i, float t,
                                            float kth) {
  const float x = to_f(mrow[i]) / t;
  return x < kth ? kNegInf : x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fused_select_kernel(
    const T* __restrict__ logits, const uint32_t* __restrict__ store,
    const int* __restrict__ rows, const uint32_t* __restrict__ cd,
    const uint8_t* __restrict__ eos, const uint8_t* __restrict__ cons,
    const uint8_t* __restrict__ greedy, const float* __restrict__ temp,
    const int* __restrict__ topk, const float* __restrict__ topp,
    const float* __restrict__ noise, int* __restrict__ ids, T* masked,
    uint8_t* __restrict__ ok, int V, int W, int A, int R, int eos_id,
    float neg_value, int sample) {
  extern __shared__ uint32_t words[];
  __shared__ Scratch s;
  const int b = blockIdx.x, tid = threadIdx.x;
  const T* lrow = logits + (size_t)b * V;
  T* mrow = masked + (size_t)b * V;
  const bool constrained = cons[b] != 0;
  const bool eos_ok = eos[b] != 0;

  // ---- 1. union of the accepted store rows, seeded with the residue ----
  if (constrained) {
    const int* rrow = rows + (size_t)b * A;
    for (int w = tid; w < W; w += kThreads) {
      uint32_t acc = cd ? cd[(size_t)b * W + w] : 0u;
      for (int a = 0; a < A; ++a) {
        const int r = rrow[a];
        if (r >= 0 && r < R) acc |= store[(size_t)r * W + w];
      }
      words[w] = acc;
    }
  }
  __syncthreads();

  // ---- 2. mask, write, greedy argmax, ok ----
  const T neg = from_f<T>(neg_value);
  float best = -INFINITY;
  int bi = kNoIndex;
  int any_ok = 0;
  for (int i = tid; i < V; i += kThreads) {
    const bool allow = !constrained || ((words[i >> 5] >> (i & 31)) & 1u) ||
                       (i == eos_id && eos_ok);
    const T x = allow ? lrow[i] : neg;
    mrow[i] = x;
    const float f = to_f(x);
    any_ok |= f > -5e29f;
    if (f > best) {
      best = f;
      bi = i;
    }
  }
  any_ok = __syncthreads_or(any_ok);
  block_argmax(best, bi, s);
  if (bi == kNoIndex) bi = 0;
  if (tid == 0) ok[b] = any_ok ? 1 : 0;
  if (!sample || greedy[b]) {
    if (tid == 0) ids[b] = bi;
    return;
  }

  // ---- 3. sampled row: scaled = masked / max(temp, 1e-6) ----
  const float t = fmaxf(temp[b], 1e-6f);
  const float smax = best / t;  // max of scaled: division is monotone

  // top-k: kth = value of rank k-1 (descending); 0 < k < V, else off
  float kth = -INFINITY;
  const int k = topk[b];
  if (k > 0 && k < V) {
    uint32_t prefix = 0, pmask = 0;
    int rank = k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int j = tid; j < 256; j += kThreads) s.cnt[j] = 0;
      __syncthreads();
      for (int i = tid; i < V; i += kThreads) {
        const uint32_t key = key_of(to_f(mrow[i]) / t);
        if ((key & pmask) == prefix) atomicAdd(&s.cnt[(key >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        int cum = 0, d = 255;
        for (; d > 0; --d) {
          const int c = (int)s.cnt[d];
          if (cum + c >= rank) break;
          cum += c;
        }
        s.digit = d;
        s.rank = rank - cum;
      }
      __syncthreads();
      prefix |= (uint32_t)s.digit << shift;
      pmask |= 255u << shift;
      rank = s.rank;
      __syncthreads();
    }
    kth = float_of(prefix);
  }

  // top-p over the top-k-filtered row (top_p >= 1 disables exactly)
  float cutoff = -INFINITY;
  const float p = topp[b];
  if (p < 1.0f) {
    float z = 0.f;
    for (int i = tid; i < V; i += kThreads)
      z += expf(filtered_k(mrow, i, t, kth) - smax);
    z = block_sum(z, s);
    const float target = p * z;
    uint32_t prefix = 0, pmask = 0;
    if (tid == 0) s.above = 0.f;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int j = tid; j < 256; j += kThreads) {
        s.cnt[j] = 0;
        s.mass[j] = 0.f;
      }
      __syncthreads();
      for (int i = tid; i < V; i += kThreads) {
        const float x = filtered_k(mrow, i, t, kth);
        const uint32_t key = key_of(x);
        if ((key & pmask) == prefix) {
          const uint32_t d = (key >> shift) & 255u;
          atomicAdd(&s.cnt[d], 1u);
          atomicAdd(&s.mass[d], expf(x - smax));
        }
      }
      __syncthreads();
      if (tid == 0) {
        // highest non-empty bucket whose inclusive mass reaches the
        // target; below the first level, fall back to the lowest
        // non-empty bucket (the sums differ from the level above only
        // by summation order)
        float cum = s.above;
        int sel = -1, lowest = -1;
        float above_sel = 0.f;
        for (int d = 255; d >= 0; --d) {
          if (s.cnt[d] == 0) continue;
          const float next = cum + s.mass[d];
          lowest = d;
          if (next >= target) {
            sel = d;
            above_sel = cum;
            break;
          }
          cum = next;
        }
        if (sel < 0 && shift < 24) {
          sel = lowest;
          above_sel = cum - s.mass[lowest];
        }
        s.found = sel >= 0;
        s.digit = sel < 0 ? 0 : sel;
        s.above = above_sel;
      }
      __syncthreads();
      if (!s.found) break;  // no value reaches top_p: nothing demoted
      prefix |= (uint32_t)s.digit << shift;
      pmask |= 255u << shift;
      __syncthreads();
    }
    if (s.found) cutoff = float_of(prefix);
    __syncthreads();
  }

  // ---- 4. argmax(filtered + noise) ----
  const float* nrow = noise + (size_t)b * V;
  best = -INFINITY;
  bi = kNoIndex;
  for (int i = tid; i < V; i += kThreads) {
    float x = filtered_k(mrow, i, t, kth);
    if (x < cutoff) x = kNegInf;
    const float y = x + nrow[i];
    if (y > best) {
      best = y;
      bi = i;
    }
  }
  block_argmax(best, bi, s);
  if (tid == 0) ids[b] = bi == kNoIndex ? 0 : bi;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Flags are bytes (torch.bool).
// cd may be null (no residue); noise may be null when sample == 0.
extern "C" int fused_select_launch(
    const void* logits, int dtype, const void* store, const void* rows,
    const void* cd, const void* eos, const void* cons, const void* greedy,
    const void* temp, const void* topk, const void* topp, const void* noise,
    void* ids, void* masked, void* ok, int B, int V, int W, int A, int R,
    int eos_id, float neg_value, int sample, void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)W * sizeof(uint32_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    fused_select_kernel<__nv_bfloat16><<<B, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(logits),
        static_cast<const uint32_t*>(store), static_cast<const int*>(rows),
        static_cast<const uint32_t*>(cd), static_cast<const uint8_t*>(eos),
        static_cast<const uint8_t*>(cons), static_cast<const uint8_t*>(greedy),
        static_cast<const float*>(temp), static_cast<const int*>(topk),
        static_cast<const float*>(topp), static_cast<const float*>(noise),
        static_cast<int*>(ids), static_cast<__nv_bfloat16*>(masked),
        static_cast<uint8_t*>(ok), V, W, A, R, eos_id, neg_value, sample);
  } else {
    fused_select_kernel<float><<<B, kThreads, smem, st>>>(
        static_cast<const float*>(logits), static_cast<const uint32_t*>(store),
        static_cast<const int*>(rows), static_cast<const uint32_t*>(cd),
        static_cast<const uint8_t*>(eos), static_cast<const uint8_t*>(cons),
        static_cast<const uint8_t*>(greedy), static_cast<const float*>(temp),
        static_cast<const int*>(topk), static_cast<const float*>(topp),
        static_cast<const float*>(noise), static_cast<int*>(ids),
        static_cast<float*>(masked), static_cast<uint8_t*>(ok), V, W, A, R,
        eos_id, neg_value, sample);
  }
  return static_cast<int>(cudaGetLastError());
}
