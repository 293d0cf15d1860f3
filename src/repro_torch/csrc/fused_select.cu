// Fused grammar mask + top-k/top-p filter + sample for one decode step.
//
// Replaces src/repro/kernels/fused_select/kernel.py::fused_select (the
// Pallas TPU kernel, body at kernel.py:47-93). For each row b:
//   words    = cd[b] | OR_a store[rows[b, a]]      (rows < 0 skipped)
//   allow[i] = bit (i & 31) of words[i >> 5]  | (i == eos_id & eos[b])
//              | !constrained[b]
//   masked   = allow ? logits : NEG            (NEG = -1e30 in T)
//   ok[b]    = any(masked > -5e29)
//   greedy   = argmax(masked)                  (first index on ties)
//   sample   = argmax(topk_topp_filter(masked / max(temp, 1e-6)) + noise)
//   ids[b]   = greedy_flags[b] ? greedy : sample
//
// Bound: bytes. A row must read its logits, the residue and store words it
// ORs, the noise of the tokens that survive the filter, and write the
// masked row: about 4 B per vocab entry. At B = 8 and V = 49152 that is
// about 1.6 MB, under a microsecond at the card's memory rate. What sets
// the time is the number of serial passes one block makes over its row,
// the latency of each pass and the work per entry inside it.
//
// What held the first design back: eleven passes over the row for a
// sampled row with top_k and top_p (mask, four top-k radix levels, z, four
// nucleus levels, noise), each a chain of 2-byte loads, one in flight per
// thread, and histogram atomics that every disallowed or demoted entry
// sent to the same bin (they all share one key).
//
// Design: one block of 1024 threads per row, 16-byte loads (8 bf16 or 4
// fp32 entries per thread and step, two steps in flight); the union lives
// in shared memory. V is a multiple of 8, so every row starts 16-byte
// aligned and one access never straddles two union words; it need not be
// a multiple of 32 (mamba2's 50280): the last word covers V % 32 tokens
// and its higher bits, zero in the store, are never read. Greedy rows (and the noise=None mode) take one pass:
// mask, write, argmax. Division by t > 0 is monotone, so ranks and bins
// are taken on the unscaled values' order-preserving keys, and t divides
// only what a route keeps. A sampled row with a filter first tries the
// candidate list:
//   * pass 1 also builds a 4096-bin count histogram of the top 12 key
//     bits. The entries of the key that every NEG entry has are counted in
//     a register and added once; the others spread over the bins, so each
//     takes one plain shared atomic (a __match_any_sync per entry to
//     aggregate them cost more than it saved).
//   * top_k in (0, V) and <= kCap: a block scan of the histogram finds the
//     bin of rank k; the candidates are the entries at or above it, a
//     superset of the top-k survivors, ties with the k-th value included.
//     When fewer than k entries lie above NEG (a grammar that allows few
//     tokens) and NEG holds no mass, top-k keeps every entry and no NEG
//     entry can win: the candidates are the other entries, top-k off.
//   * top_k off and top_p < 1: pass 2 sums exp(x/t - max) into z (fp32)
//     and a mass histogram (fixed point: native integer atomics, and an
//     entry whose share rounds to 0 adds nothing); the candidates are the
//     entries at or above the bin below the one where the mass from the
//     top reaches top_p of the total.
//   If they fit kCap, the next pass copies (scaled key, index) of every
//   candidate into a list in shared memory; it is sorted (bitonic,
//   descending) and the rest runs on it: kth = list[k-1], z over the
//   survivors, the nucleus cut (the first sorted position whose
//   cumulative mass reaches top_p * z: the reference's inclusive-first-
//   over rule), and the noise argmax, which reads noise only at the
//   survivors' indices and breaks ties on the lowest index. The list must
//   be a strict prefix of the row in scaled order, and the cut must lie in
//   it; if either fails (fp32 values that collide after the division,
//   sums that differ by rounding) the row takes the radix route.
// The radix route (every other sampled row, and the overflows): the top-k
// cutoff by a radix select (four 8-bit histogram passes), the nucleus
// cutoff by four passes over count and exp-mass histograms (the largest
// value v whose inclusive mass sum_{x >= v} exp(x - max) reaches top_p *
// z, the same rule), then the noise argmax over the row, reading noise
// only where an entry survives. Its histograms use the same register count
// for the shared key and warp-aggregated atomics for the rest.
// Both routes equal the reference up to the order in which masses are
// summed; when no value reaches top_p nothing is demoted.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr int kNoIndex = 0x7fffffff;
constexpr int kBinShift = 20;                      // top 12 key bits
constexpr int kBins = 1 << (32 - kBinShift);       // 4096
constexpr int kPer = kBins / kThreads;             // bins per thread
constexpr int kCap = 4096;                         // candidate list entries
constexpr int kMaxWords = 12288;                   // the wrapper's W limit
static_assert(kBins % kThreads == 0, "bins split evenly over threads");
static_assert(kCap * 8 >= kBins * 4, "the mass histogram reuses the list");

// Dynamic shared memory: the candidate list (8 B entries; the mass
// histogram before it), the count histogram, the union words.
// ops.py::launch_plan must agree.
constexpr size_t smem_bytes(int W) {
  return (size_t)kCap * 8 + (size_t)kBins * 4 + (size_t)W * 4;
}

template <typename T>
struct Raw;  // the bit pattern of one entry
template <>
struct Raw<float> {
  using type = uint32_t;
};
template <>
struct Raw<__nv_bfloat16> {
  using type = uint16_t;
};

// 16 bytes of a row: 4 fp32 or 8 bf16 entries.
template <typename T>
union Chunk {
  uint4 v;
  typename Raw<T>::type r[16 / sizeof(T)];
};

__device__ __forceinline__ float raw_f(uint32_t r) { return __uint_as_float(r); }
__device__ __forceinline__ float raw_f(uint16_t r) {
  return __uint_as_float((uint32_t)r << 16);
}
__device__ __forceinline__ uint32_t raw_of(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint16_t raw_of(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
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

// fn(i, value, live) for every entry of `row`, 16 bytes per thread and
// step, two steps' loads in flight. Every lane of a warp calls fn the same
// number of times (live is false past the row's end), so fn may use warp
// collectives.
template <typename T, typename F>
__device__ __forceinline__ void for_each(const T* row, int V, F&& fn) {
  constexpr int kv = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, nchunk = V / kv;
  for (int c0 = threadIdx.x - lane; c0 < nchunk; c0 += 2 * kThreads) {
    Chunk<T> ch[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + lane + u * kThreads;
      ch[u].v = c < nchunk ? *reinterpret_cast<const uint4*>(row + (size_t)c * kv)
                           : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + lane + u * kThreads;
      if (c0 + u * kThreads >= nchunk) break;  // uniform over the warp
#pragma unroll
      for (int j = 0; j < kv; ++j) fn(c * kv + j, raw_f(ch[u].r[j]), c < nchunk);
    }
  }
}

struct Scratch {
  float v[kWarps];
  int i[kWarps];
  float f[kWarps];
  unsigned int u[kWarps];
  unsigned int cnt[256];
  float mass[256];
  int digit;
  int rank;
  float above;
  int found;
  int n;     // candidates at or above the chosen bin
  unsigned nneg;  // entries with the NEG key
  int fill;  // list entries written
  int m;     // list entries that survive top-k
  int cut;   // first list position past the nucleus edge, -1: none
};

// Block-wide (max, first index); every thread gets the result.
__device__ void block_argmax(float& v, int& i, Scratch& s) {
  for (int off = 16; off > 0; off >>= 1)
    am_merge(v, i, __shfl_xor_sync(kFull, v, off),
             __shfl_xor_sync(kFull, i, off));
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
      am_merge(v, i, __shfl_xor_sync(kFull, v, off),
               __shfl_xor_sync(kFull, i, off));
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
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s.f[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? s.f[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(kFull, x, off);
    if (lane == 0) s.f[0] = x;
  }
  __syncthreads();
  x = s.f[0];
  __syncthreads();
  return x;
}

// Exclusive prefix sum over the block's threads, in thread order.
__device__ unsigned block_excl_scan(unsigned x, unsigned* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = part[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    part[lane] = w;
  }
  __syncthreads();
  const unsigned excl = incl - x + (warp > 0 ? part[warp - 1] : 0u);
  __syncthreads();
  return excl;
}

// hist[d] += 1 for every lane with `valid`, one atomic per distinct d in
// the warp. Every lane of the warp calls it.
__device__ __forceinline__ void warp_count(unsigned* hist, uint32_t d,
                                           bool valid) {
  if (!__ballot_sync(kFull, valid)) return;
  const unsigned peers = __match_any_sync(kFull, valid ? d : 0xffffffffu);
  if (valid && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[d], (unsigned)__popc(peers));
}

// cnt[d] += 1 and mass[d] += e for every lane with `valid`, one atomic
// pair per distinct d in the warp. Every lane of the warp calls it.
__device__ __forceinline__ void warp_count_mass(unsigned* cnt, float* mass,
                                                uint32_t d, float e,
                                                bool valid) {
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(kFull, valid);
  while (todo) {
    const int leader = __ffs(todo) - 1;
    const uint32_t ld = __shfl_sync(kFull, d, leader);
    const bool mine = valid && d == ld;
    const unsigned grp = __ballot_sync(kFull, mine);
    float sum = mine ? e : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == leader) {
      atomicAdd(&cnt[ld], (unsigned)__popc(grp));
      atomicAdd(&mass[ld], sum);
    }
    todo &= ~grp;
  }
}

// Entries (or mass) of the block's bins at or above D; thread j holds
// bins hi, hi - 1, ... in m.
__device__ __forceinline__ unsigned count_at_or_above(
    int D, const unsigned (&m)[kPer], int hi, Scratch& s) {
  unsigned mine = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) mine += hi - q >= D ? m[q] : 0u;
  mine = __reduce_add_sync(kFull, mine);
  if (threadIdx.x == 0) s.n = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicAdd((unsigned*)&s.n, mine);
  __syncthreads();
  const unsigned n = (unsigned)s.n;
  __syncthreads();
  return n;
}

// The highest bin whose count (mass) from the top reaches target, or -1.
__device__ __forceinline__ int highest_reaching(const unsigned (&m)[kPer],
                                                int hi, unsigned target,
                                                Scratch& s) {
  unsigned mine = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) mine += m[q];
  if (threadIdx.x == 0) s.digit = -1;
  unsigned cum = block_excl_scan(mine, s.u);
  int d = -1;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    cum += m[q];
    if (d < 0 && cum >= target) d = hi - q;
  }
  d = __reduce_max_sync(kFull, d + 1) - 1;
  if ((threadIdx.x & 31) == 0 && d >= 0) atomicMax(&s.digit, d);
  __syncthreads();
  d = s.digit;
  __syncthreads();
  return d;
}

__device__ __forceinline__ uint32_t key_at(const uint64_t* list, int i) {
  return (uint32_t)(list[i] >> 32);
}

// ---- candidate-list route ----
// list[0, n) holds (scaled key, index) of the candidates; `below` is the
// largest unscaled value of the other entries. k > 0: top-k survivors are
// the entries at or above the k-th; k == 0: all n. z >= 0 is the row's
// exp-mass (the nucleus cut may then lie below the list); z < 0: the
// other entries hold no mass, z is summed over the survivors. Returns the
// sampled id, or -1 when the list cannot decide the row.
__device__ int select_from_list(uint64_t* list, int n, int k, float z,
                                float below, float t, float smax, float p,
                                const float* nrow, Scratch& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  int np = 32;
  while (np < n) np <<= 1;
  for (int i = n + tid; i < np; i += kThreads) list[i] = 0;  // sorts last
  __syncthreads();
  for (int size = 2; size <= np; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int j = tid; j < np / 2; j += kThreads) {
        const int lo = 2 * j - (j & (stride - 1)), hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const uint64_t a = list[lo], c = list[hi];
        if ((a < c) == desc) {
          list[lo] = c;
          list[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  // the list must be a strict prefix of the row in scaled order: no other
  // entry scales to the list's smallest value or above
  if (below / t >= float_of(key_at(list, n - 1))) return -1;
  int m = n;
  if (k > 0) {  // survivors of top-k: keys at least the k-th's
    const uint32_t kkey = key_at(list, k - 1);
    for (int i = tid; i < n; i += kThreads)
      if (key_at(list, i) >= kkey && (i + 1 == n || key_at(list, i + 1) < kkey))
        s.m = i + 1;
    __syncthreads();
    m = s.m;
  }
  float cutoff = -INFINITY;
  if (p < 1.0f) {
    const bool z_given = z >= 0.f;
    if (!z_given) {
      float zp = 0.f;
      for (int i = tid; i < m; i += kThreads)
        zp += expf(float_of(key_at(list, i)) - smax);
      z = block_sum(zp, s);
    }
    const float target = p * z;
    // first sorted position whose cumulative mass reaches the target:
    // one warp walks the list 32 entries at a time (monotone sums)
    if (tid < 32) {
      float carry = 0.f;
      int cut = -1;
      for (int base = 0; base < m; base += 32) {
        const int i = base + lane;
        float c = i < m ? expf(float_of(key_at(list, i)) - smax) : 0.f;
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(kFull, c, off);
          if (lane >= off) c += y;
        }
        c += carry;
        const unsigned hit = __ballot_sync(kFull, i < m && c >= target);
        if (hit) {
          cut = base + __ffs(hit) - 1;
          break;
        }
        carry = __shfl_sync(kFull, c, 31);
      }
      if (lane == 0) s.cut = cut;
    }
    __syncthreads();
    const int cut = s.cut;
    __syncthreads();
    if (cut >= 0)
      cutoff = float_of(key_at(list, cut));
    else if (z_given)
      return -1;  // the cut lies below the list
  }
  float best = -INFINITY;
  int bi = kNoIndex;
  for (int i = tid; i < m; i += kThreads) {
    const float x = float_of(key_at(list, i));
    if (x < cutoff) continue;
    const int idx = (int)(uint32_t)list[i];
    am_merge(best, bi, x + nrow[idx], idx);
  }
  block_argmax(best, bi, s);
  return bi == kNoIndex ? 0 : bi;
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
  using Rw = typename Raw<T>::type;
  constexpr int kv = 16 / sizeof(T);
  extern __shared__ uint64_t smem[];
  uint64_t* list = smem;                                      // [kCap]
  unsigned* mh = reinterpret_cast<unsigned*>(smem);           // [kBins]
  unsigned* hist = reinterpret_cast<unsigned*>(smem + kCap);  // [kBins]
  uint32_t* words = hist + kBins;                             // [W]
  __shared__ Scratch s;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const T* lrow = logits + (size_t)b * V;
  T* mrow = masked + (size_t)b * V;
  const bool constrained = cons[b] != 0;
  const bool eos_ok = eos[b] != 0;
  const bool sampled = sample && !greedy[b];
  const float t = fmaxf(temp[b], 1e-6f);
  const int k = sampled ? topk[b] : 0;
  const float p = sampled ? topp[b] : 1.0f;
  const bool topk_on = k > 0 && k < V;
  const bool klist = topk_on && k <= kCap;
  const bool plist = sampled && !topk_on && p < 1.0f;
  const bool listing = klist || plist;

  // ---- 1. union of the accepted store rows, seeded with the residue ----
  if (constrained) {
    const int* rrow = rows + (size_t)b * A;
    for (int w = tid; w < W; w += kThreads) {
      uint32_t acc = cd ? cd[(size_t)b * W + w] : 0u;
      int a = 0;
      for (; a + 8 <= A; a += 8) {  // eight loads in flight
        uint32_t v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = rrow[a + u];
          v[u] = r >= 0 && r < R ? store[(size_t)r * W + w] : 0u;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc |= v[u];
      }
      for (; a < A; ++a) {
        const int r = rrow[a];
        if (r >= 0 && r < R) acc |= store[(size_t)r * W + w];
      }
      words[w] = acc;
    }
  }
  if (tid == 0) s.nneg = 0;
  if (listing)
    for (int j = tid; j < kBins; j += kThreads) {
      hist[j] = 0;
      mh[j] = 0;
    }
  __syncthreads();

  // ---- 2. mask, write, greedy argmax, ok (+ first-level histogram) ----
  const T neg = from_f<T>(neg_value);
  const Rw negr = raw_of(neg);
  const float negf = raw_f(negr);
  const uint32_t nkey = key_of(negf);  // every NEG entry's (unscaled) key
  float best = -INFINITY;
  int bi = kNoIndex;
  int any_ok = 0;
  unsigned nneg = 0;
  int low = 0;  // an entry below NEG
  {
    const int nchunk = V / kv;
    for (int c0 = tid - lane; c0 < nchunk; c0 += kThreads) {
      const int c = c0 + lane, i0 = c * kv;
      const bool live = c < nchunk;
      Chunk<T> ch;
      ch.v = make_uint4(0, 0, 0, 0);
      if (live) {
        ch.v = *reinterpret_cast<const uint4*>(lrow + i0);
        if (constrained) {
          const uint32_t bits = words[i0 >> 5] >> (i0 & 31);
#pragma unroll
          for (int j = 0; j < kv; ++j)
            if (!((bits >> j) & 1u) && !(i0 + j == eos_id && eos_ok))
              ch.r[j] = negr;
        }
        *reinterpret_cast<uint4*>(mrow + i0) = ch.v;
      }
#pragma unroll
      for (int j = 0; j < kv; ++j) {
        const float f = raw_f(ch.r[j]);
        if (live) {
          any_ok |= f > -5e29f;
          if (f > best) {
            best = f;
            bi = i0 + j;
          }
        }
        if (listing) {  // uniform over the block
          const uint32_t key = key_of(f);
          nneg += live && key == nkey;
          low |= live && key < nkey;
          if (live && key != nkey) atomicAdd(&hist[key >> kBinShift], 1u);
        }
      }
    }
  }
  if (listing) {
    nneg = __reduce_add_sync(kFull, nneg);
    if (lane == 0 && nneg) {
      atomicAdd(&hist[nkey >> kBinShift], nneg);
      atomicAdd(&s.nneg, nneg);
    }
    low = __syncthreads_or(low);
  }
  any_ok = __syncthreads_or(any_ok);
  block_argmax(best, bi, s);
  if (bi == kNoIndex) bi = 0;
  if (tid == 0) ok[b] = any_ok ? 1 : 0;
  if (!sampled) {
    if (tid == 0) ids[b] = bi;
    return;
  }

  // ---- 3. sampled row: scaled = masked / t ----
  const float smax = best / t;  // max of scaled: division is monotone
  const float* nrow = noise + (size_t)b * V;

  if (listing) {
    // thread j holds bins hi, hi - 1, ... (hi = kBins - 1 - kPer * j), so
    // its exclusive scan is the count (mass) of every higher bin
    const int hi = kBins - 1 - kPer * tid;
    unsigned cc[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) cc[q] = hist[hi - q];
    // fewer entries than k above NEG, whose mass is 0: top-k keeps
    // every entry, and the NEG entries can neither hold mass nor win, so
    // the list is every other entry with top-k off
    const int nreal = V - (int)s.nneg;
    const bool allbut = klist && nreal < k && nreal > 0 && !low &&
                        expf(negf / t - smax) == 0.f;
    float z = -1.f;
    int D = 0;
    if (klist && !allbut) {  // the bin of rank k
      D = highest_reaching(cc, hi, (unsigned)k, s);
    } else if (plist) {
      // pass 2: the row's exp-mass, z in fp32 and per bin in fixed point
      // (2^31 / V per unit, so no sum overflows); the bin where the mass
      // from the top reaches top_p of it, one bin lower for the rounding
      const float scale = floorf(2147483648.0f / (float)V);
      const float eneg = expf(negf / t - smax);
      unsigned nn = 0;
      float zp = 0.f;
      for_each(mrow, V, [&](int, float f, bool live) {
        const uint32_t key = key_of(f);
        nn += live && key == nkey;
        if (!live || key == nkey) return;
        const float e = expf(f / t - smax);
        zp += e;
        const unsigned u = __float2uint_rn(e * scale);
        if (u) atomicAdd(&mh[key >> kBinShift], u);
      });
      nn = __reduce_add_sync(kFull, nn);
      const unsigned un = __float2uint_rn(eneg * scale);
      if (lane == 0 && nn) {
        zp += (float)nn * eneg;
        if (un) atomicAdd(&mh[nkey >> kBinShift], nn * un);
      }
      z = block_sum(zp, s);  // its barriers also publish mh
      unsigned mm[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) mm[q] = mh[hi - q];
      const unsigned total = count_at_or_above(0, mm, hi, s);
      D = highest_reaching(mm, hi, (unsigned)(p * (float)total), s);
      if (D > 0) --D;
    }
    const int n = allbut ? nreal
                  : D >= 0 ? (int)count_at_or_above(D, cc, hi, s) : kCap + 1;
    if (n <= kCap) {
      if (tid == 0) s.fill = 0;
      __syncthreads();
      // pass 3: the candidates into the list, (scaled key, index), and
      // the largest value left out
      float below = -INFINITY;
      for_each(mrow, V, [&](int i, float f, bool live) {
        const uint32_t key = key_of(f);
        const bool in = live && (allbut ? key != nkey
                                        : (int)(key >> kBinShift) >= D);
        if (live && !in) below = fmaxf(below, f);
        const unsigned bal = __ballot_sync(kFull, in);
        if (!bal) return;
        int base = 0;
        if (lane == 0) base = atomicAdd(&s.fill, __popc(bal));
        base = __shfl_sync(kFull, base, 0) + __popc(bal & ((1u << lane) - 1u));
        if (in && base < kCap)
          list[base] = ((uint64_t)key_of(f / t) << 32) | (uint32_t)i;
      });
      int unused = 0;
      block_argmax(below, unused, s);  // its barriers also publish the list
      const int id = select_from_list(list, n, klist && !allbut ? k : 0, z,
                                      below, t, smax, p, nrow, s);
      if (id >= 0) {
        if (tid == 0) ids[b] = id;
        return;
      }
      __syncthreads();
    }
  }

  // ---- 4. radix route ----
  float kth = -INFINITY;
  if (topk_on) {  // kth = value of rank k-1 (descending), on unscaled keys
    uint32_t prefix = 0, pmask = 0;
    int rank = k;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int j = tid; j < 256; j += kThreads) s.cnt[j] = 0;
      __syncthreads();
      unsigned nsp = 0;
      for_each(mrow, V, [&](int, float f, bool live) {
        const uint32_t key = key_of(f);
        nsp += live && key == nkey;
        warp_count(s.cnt, (key >> shift) & 255u,
                   live && key != nkey && (key & pmask) == prefix);
      });
      nsp = __reduce_add_sync(kFull, nsp);
      if (lane == 0 && nsp && (nkey & pmask) == prefix)
        atomicAdd(&s.cnt[(nkey >> shift) & 255u], nsp);
      __syncthreads();
      if (tid == 0) {
        int cum = 0, d = 255;
        for (; d > 0; --d) {
          const int cd_ = (int)s.cnt[d];
          if (cum + cd_ >= rank) break;
          cum += cd_;
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
    kth = float_of(prefix) / t;
  }

  // top-p over the top-k-filtered row (top_p >= 1 disables exactly)
  float cutoff = -INFINITY;
  if (p < 1.0f) {
    // the value most entries share after top-k: NEG / t, or the demotion
    // value when top-k demotes the NEG entries too
    const float sv = kth > negf / t ? kNegInf : negf / t;
    const uint32_t sk = key_of(sv);
    const float se = expf(sv - smax);
    float zp = 0.f;
    for_each(mrow, V, [&](int, float f, bool live) {
      const float x = f / t;
      if (live) zp += expf((x < kth ? kNegInf : x) - smax);
    });
    const float target = p * block_sum(zp, s);
    uint32_t prefix = 0, pmask = 0;
    if (tid == 0) s.above = 0.f;
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int j = tid; j < 256; j += kThreads) {
        s.cnt[j] = 0;
        s.mass[j] = 0.f;
      }
      __syncthreads();
      unsigned nsp = 0;
      for_each(mrow, V, [&](int, float f, bool live) {
        float x = f / t;
        if (x < kth) x = kNegInf;
        const uint32_t key = key_of(x);
        const bool in = live && key != sk && (key & pmask) == prefix;
        nsp += live && key == sk;
        warp_count_mass(s.cnt, s.mass, (key >> shift) & 255u,
                        in ? expf(x - smax) : 0.f, in);
      });
      nsp = __reduce_add_sync(kFull, nsp);
      if (lane == 0 && nsp && (sk & pmask) == prefix) {
        atomicAdd(&s.cnt[(sk >> shift) & 255u], nsp);
        atomicAdd(&s.mass[(sk >> shift) & 255u], (float)nsp * se);
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

  // argmax(filtered + noise); a demoted entry is -1e30 whatever its noise
  // (|noise| is far below half an ulp of 1e30), so its noise is not read
  best = -INFINITY;
  bi = kNoIndex;
  for_each(mrow, V, [&](int i, float f, bool live) {
    float x = f / t;
    if (x < kth || x < cutoff) x = kNegInf;
    if (!live) return;
    const float y = x == kNegInf ? kNegInf : x + nrow[i];
    if (y > best) {
      best = y;
      bi = i;
    }
  });
  block_argmax(best, bi, s);
  if (tid == 0) ids[b] = bi == kNoIndex ? 0 : bi;
}

template <typename T>
int launch(const void* logits, const void* store, const void* rows,
           const void* cd, const void* eos, const void* cons,
           const void* greedy, const void* temp, const void* topk,
           const void* topp, const void* noise, void* ids, void* masked,
           void* ok, int B, int V, int W, int A, int R, int eos_id,
           float neg_value, int sample, cudaStream_t st) {
  auto kern = fused_select_kernel<T>;
  static bool configured = false;  // the attribute is per function
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxWords));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  kern<<<B, kThreads, smem_bytes(W), st>>>(
      static_cast<const T*>(logits), static_cast<const uint32_t*>(store),
      static_cast<const int*>(rows), static_cast<const uint32_t*>(cd),
      static_cast<const uint8_t*>(eos), static_cast<const uint8_t*>(cons),
      static_cast<const uint8_t*>(greedy), static_cast<const float*>(temp),
      static_cast<const int*>(topk), static_cast<const float*>(topp),
      static_cast<const float*>(noise), static_cast<int*>(ids),
      static_cast<T*>(masked), static_cast<uint8_t*>(ok), V, W, A, R, eos_id,
      neg_value, sample);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block (bytes) for W union words, or -1 for
// a W the kernel does not take. The wrapper's launch plan must agree.
extern "C" int fused_select_smem_bytes(int dtype, int W) {
  (void)dtype;  // the list holds fp32 keys for either logit type
  if (W < 1 || W > kMaxWords) return -1;
  return (int)smem_bytes(W);
}

// dtype: 0 = float32, 1 = bfloat16. Flags are bytes (torch.bool). Rows of
// logits 16-byte aligned (V % 8 == 0 and an aligned base; the wrapper
// copies a tensor that is not). cd may be null (no residue); noise may be
// null when sample == 0.
extern "C" int fused_select_launch(
    const void* logits, int dtype, const void* store, const void* rows,
    const void* cd, const void* eos, const void* cons, const void* greedy,
    const void* temp, const void* topk, const void* topp, const void* noise,
    void* ids, void* masked, void* ok, int B, int V, int W, int A, int R,
    int eos_id, float neg_value, int sample, void* stream) {
  if (B == 0) return 0;
  if (W < 1 || W > kMaxWords || V % 8 || (long long)W * 32 < V)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, store, rows, cd, eos, cons, greedy,
                                 temp, topk, topp, noise, ids, masked, ok, B,
                                 V, W, A, R, eos_id, neg_value, sample, st);
  return launch<float>(logits, store, rows, cd, eos, cons, greedy, temp,
                       topk, topp, noise, ids, masked, ok, B, V, W, A, R,
                       eos_id, neg_value, sample, st);
}
