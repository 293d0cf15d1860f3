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
// elements), plus its valid store rows (W words each) and its cd words.
// At B = 8, K = 8, V = 49152, bf16 that is 12.6 MB of logits traffic;
// store rows shared between rows and blocks mostly come from L2. At one
// row the work is ~0.25 MB and a launch's own latency sets the time.
//
// Design. The Pallas grid (B, V-blocks, A) runs A innermost on one core,
// carrying the union in VMEM across grid steps. On Hopper blocks run in
// parallel with nothing carried between them, so the A loop moves inside
// the block: one block per (row, vocab tile), rows fastest in the grid
// so that rows with many store rows mix with light ones. The tile and
// the threads come from `launch_plan` in kernels/masked_logits/ops.py:
// the tile shrinks from 4096 entries until even one row fills the card's
// 132 SMs and until a block's union reads at most 2^20 tokens of store
// rows (A x tile), so many rows at the engine's bucket launch few large
// blocks and a wide accept bucket spreads its store reads over more SMs.
// A block is never more than a latency chain of two dependent loads:
//   1. Every load that depends on nothing is issued first: the row's
//      flags, its logits (16 bytes an access: 8 bf16 or 4 fp32, held in
//      registers, PER of them a thread, PER a template argument so a
//      launch holds only what it uses), its cd words and, in warp 0, its
//      A ids (16 bytes a load where A % 4 == 0).
//   2. Warp 0 drops the -1 pads (and ids >= R) with a ballot and a prefix
//      count into a shared list: padding costs nothing. Pass-through rows
//      (constrained[r] false) store their logits and stop. One barrier
//      publishes the list.
//   3. The union: the tile's words are read as uint4 (4 words, 128
//      tokens), neighbouring lanes on neighbouring groups of one store
//      row; the threads split the valid ids, 16 independent loads in
//      flight per thread while 16 are left, then one at a time. Lanes
//      that share a group OR their partials with shuffles, warps through
//      shared memory; cd and the EOS bit are ORed in last.
//   4. Each thread selects, for its logits, the logit's bits or NEG's
//      bits (no float arithmetic) and stores 16 bytes at a time with
//      st.global.cs (evict first), so that the output does not push the
//      store rows out of L2. bf16 logits are loaded evict-first too; fp32
//      logits (twice the bytes) with plain loads, which measured faster
//      (PERF.md).
// Measured alternative: reading only the 16-byte groups whose mask bits
// are not all 0, after the union, was no faster at any planned shape on
// the json rows (PERF.md, the masked_logits redesign) and adds one
// dependent load at one row.
// The scalar path (V * sizeof(T) or W not a multiple of 16 bytes, or a
// pointer not 16-byte aligned) is the same kernel with one element and
// one word an access; the plan chooses it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxTile = 4096;   // vocab entries per block
constexpr int kMaxIds = 8192;    // row ids a block can list (32 KB)
constexpr int kUnroll = 16;      // union loads in flight per thread

// E is the logits' element as raw bits (uint16_t for bf16, uint32_t for
// fp32). VEC picks the 16-byte accesses: L is one logits access (kE
// entries), U one union access (kWords store words).
template <typename E, bool VEC>
struct Path;
template <typename E>
struct Path<E, true> {
  using L = uint4;
  using U = uint4;
  static constexpr int kE = 16 / sizeof(E);
  static constexpr int kWords = 4;
};
template <typename E>
struct Path<E, false> {
  using L = E;
  using U = uint32_t;
  static constexpr int kE = 1;
  static constexpr int kWords = 1;
};

__device__ __forceinline__ uint4 bor(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint32_t bor(uint32_t a, uint32_t b) {
  return a | b;
}
__device__ __forceinline__ uint4 shfl_bor(uint4 v, int off) {
  v.x |= __shfl_xor_sync(0xffffffffu, v.x, off);
  v.y |= __shfl_xor_sync(0xffffffffu, v.y, off);
  v.z |= __shfl_xor_sync(0xffffffffu, v.z, off);
  v.w |= __shfl_xor_sync(0xffffffffu, v.w, off);
  return v;
}
__device__ __forceinline__ uint32_t shfl_bor(uint32_t v, int off) {
  return v | __shfl_xor_sync(0xffffffffu, v, off);
}
template <typename U>
__device__ __forceinline__ U zero();
template <>
__device__ __forceinline__ uint4 zero<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ uint32_t zero<uint32_t>() {
  return 0u;
}
// set bit b (< 32 * kWords) of a union access
__device__ __forceinline__ void set_bit(uint4& v, int b) {
  const uint32_t m = 1u << (b & 31);
  switch (b >> 5) {
    case 0: v.x |= m; break;
    case 1: v.y |= m; break;
    case 2: v.z |= m; break;
    default: v.w |= m; break;
  }
}
__device__ __forceinline__ void set_bit(uint32_t& v, int b) { v |= 1u << b; }
__device__ __forceinline__ void put_words(uint32_t* w, int g, uint4 v) {
  w[4 * g] = v.x;
  w[4 * g + 1] = v.y;
  w[4 * g + 2] = v.z;
  w[4 * g + 3] = v.w;
}
__device__ __forceinline__ void put_words(uint32_t* w, int g, uint32_t v) {
  w[g] = v;
}

// streaming loads and stores of the logits (evict first: read once)
__device__ __forceinline__ uint4 ld_cs(const uint4* p) { return __ldcs(p); }
__device__ __forceinline__ uint16_t ld_cs(const uint16_t* p) {
  return __ldcs(p);
}
__device__ __forceinline__ uint32_t ld_cs(const uint32_t* p) {
  return __ldcs(p);
}
__device__ __forceinline__ void st_cs(uint4* p, uint4 v) { __stcs(p, v); }
__device__ __forceinline__ void st_cs(uint16_t* p, uint16_t v) {
  __stcs(p, v);
}
__device__ __forceinline__ void st_cs(uint32_t* p, uint32_t v) {
  __stcs(p, v);
}

// a logits load: evict-first for bf16 rows, plain for fp32 ones (the
// faster of the two for each dtype on the H100, PERF.md)
template <typename E, typename T>
__device__ __forceinline__ T ld_logits(const T* p) {
  if constexpr (sizeof(E) == 2) return ld_cs(p); else return *p;
}

// keep[i] ? x : neg for the kE entries of one access; m holds keep's bits
__device__ __forceinline__ uint32_t pick2(uint32_t x, uint32_t m,
                                          uint32_t neg2) {
  const uint32_t keep = ((m & 1u) ? 0x0000ffffu : 0u) |
                        ((m & 2u) ? 0xffff0000u : 0u);
  return (x & keep) | (neg2 & ~keep);
}
__device__ __forceinline__ uint4 pick(uint4 x, uint32_t m, uint32_t neg,
                                      uint16_t) {
  const uint32_t neg2 = neg | (neg << 16);
  return make_uint4(pick2(x.x, m, neg2), pick2(x.y, m >> 2, neg2),
                    pick2(x.z, m >> 4, neg2), pick2(x.w, m >> 6, neg2));
}
__device__ __forceinline__ uint4 pick(uint4 x, uint32_t m, uint32_t neg,
                                      uint32_t) {
  return make_uint4((m & 1u) ? x.x : neg, (m & 2u) ? x.y : neg,
                    (m & 4u) ? x.z : neg, (m & 8u) ? x.w : neg);
}
template <typename E>
__device__ __forceinline__ E pick(E x, uint32_t m, uint32_t neg, E) {
  return (m & 1u) ? x : static_cast<E>(neg);
}

// One ballot step of the id compaction: lanes whose id is a store row
// append it to the shared list in lane order.
__device__ __forceinline__ int keep_id(int id, int R, unsigned lt, int n,
                                       int32_t* ids) {
  const bool ok = id >= 0 && id < R;
  const unsigned b = __ballot_sync(0xffffffffu, ok);
  if (ok) ids[n + __popc(b & lt)] = id;
  return n + __popc(b);
}

template <typename E, bool VEC, int PER>
__global__ void __launch_bounds__(kMaxThreads)
    masked_logits_kernel(const E* __restrict__ logits,
                         const uint32_t* __restrict__ store,
                         const int32_t* __restrict__ rows,
                         const bool* __restrict__ eos,
                         const bool* __restrict__ constrained,
                         const uint32_t* __restrict__ cd,
                         E* __restrict__ out, int V, int W, int A, int R,
                         int tile, int eos_id, uint32_t neg) {
  using P = Path<E, VEC>;
  using L = typename P::L;
  using U = typename P::U;
  constexpr int kE = P::kE;
  constexpr int kT = 32 * P::kWords;           // tokens per union access
  constexpr uint32_t kMask = (1u << kE) - 1u;  // kE <= 8
  extern __shared__ int32_t ids[];             // the row's valid ids
  __shared__ U part[kMaxThreads];              // partial unions
  __shared__ uint32_t words[kMaxTile / 32];    // the tile's mask words
  __shared__ int n_ids;

  const int r = blockIdx.x;
  const int v0 = blockIdx.y * tile;
  const int len = min(tile, V - v0);           // entries in this tile
  const int nacc = len / kE;                   // exact: V % kE == 0
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const L* lrow = reinterpret_cast<const L*>(logits + static_cast<size_t>(r)
                                             * V + v0);
  L* orow = reinterpret_cast<L*>(out + static_cast<size_t>(r) * V + v0);

  // Every load that depends on nothing is issued first: the row's flags,
  // its logits, its cd words and (warp 0) its ids. The flags are waited
  // for only after the ids' compaction.
  const bool on = constrained == nullptr || constrained[r];
  const bool eos_ok = eos[r];
  const int gcount = (len + kT - 1) / kT;      // union accesses in the tile
  const int gw0 = v0 / kT;
  L x[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = t + k * T;
    if (i < nacc) x[k] = ld_logits<E>(lrow + i);
  }
  U cdw = zero<U>();
  if (cd != nullptr && t < gcount)
    cdw = __ldg(reinterpret_cast<const U*>(cd + static_cast<size_t>(r) * W)
                + gw0 + t);

  if (t < 32) {
    const int32_t* rrow = rows + static_cast<size_t>(r) * A;
    const unsigned lt = (1u << t) - 1u;
    int n = 0;
    if ((A & 3) == 0 && (reinterpret_cast<uintptr_t>(rrow) & 15) == 0) {
      for (int a0 = 0; a0 < A; a0 += 4 * 4 * 32) {
        int4 q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int a = a0 + 4 * (32 * k + t);
          q[k] = a < A ? __ldg(reinterpret_cast<const int4*>(rrow + a))
                       : make_int4(-1, -1, -1, -1);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          n = keep_id(q[k].x, R, lt, n, ids);
          n = keep_id(q[k].y, R, lt, n, ids);
          n = keep_id(q[k].z, R, lt, n, ids);
          n = keep_id(q[k].w, R, lt, n, ids);
        }
      }
    } else {
      for (int a0 = 0; a0 < A; a0 += 8 * 32) {
        int q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int a = a0 + 32 * k + t;
          q[k] = a < A ? __ldg(rrow + a) : -1;
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) n = keep_id(q[k], R, lt, n, ids);
      }
    }
    if (t == 0) n_ids = n;
  }
  if (!on) {                                   // pass-through: a copy
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = t + k * T;
      if (i < nacc) st_cs(orow + i, x[k]);
    }
    return;
  }
  __syncthreads();
  const int n = n_ids;

  // thread t ORs union access g = t % G of the tile over the ids
  // s, s + S, ... of the list (G a power of two <= T, from the plan)
  const int G = tile / kT;
  const int WU = W / P::kWords;
  const int g = t & (G - 1);
  const int S = T / G;
  U acc = zero<U>();
  if (g < gcount) {
    const U* col = reinterpret_cast<const U*>(store) + gw0 + g;
    int j = t / G;
    for (; j + (kUnroll - 1) * S < n; j += kUnroll * S) {
      U a[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        a[k] = __ldg(col + static_cast<size_t>(ids[j + k * S]) * WU);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc = bor(acc, a[k]);
    }
    for (; j < n; j += S)
      acc = bor(acc, __ldg(col + static_cast<size_t>(ids[j]) * WU));
  }
  int sets;
  if (G < 32) {               // lanes l and l ^ off share a group
    for (int off = 16; off >= G; off >>= 1) acc = shfl_bor(acc, off);
    if ((t & 31) < G) part[(t >> 5) * G + g] = acc;
    sets = T >> 5;
  } else {
    part[t] = acc;
    sets = S;
  }
  __syncthreads();
  if (t < gcount) {
    U u = cdw;
    for (int p = 0; p < sets; ++p) u = bor(u, part[p * G + t]);
    const int e = eos_id - v0;
    if (eos_ok && e >= 0 && e < len && e / kT == t) set_bit(u, e % kT);
    put_words(words, t, u);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = t + k * T;
    if (i < nacc) {
      const int o = i * kE;
      const uint32_t m = (words[o >> 5] >> (o & 31)) & kMask;
      st_cs(orow + i, pick(x[k], m, neg, E()));
    }
  }
}

// logits accesses per thread, rounded up to the instantiated counts: the
// kernel keeps that many in registers, no more
int per_thread(int tile, int threads, int kE) {
  const int need = (tile / kE + threads - 1) / threads;
  int per = 1;
  while (per < need) per *= 2;
  return per;
}

// The plan's checks: the dynamic shared memory the kernel uses for this
// launch, or -1 if it does not take it.
int plan_smem(int dtype, long long N, long long V, long long W, int A,
              int R, int tile, int threads, int vec, int aligned) {
  if (dtype != 0 && dtype != 1) return -1;
  const int elem = dtype == 1 ? 2 : 4;
  const int kE = vec ? 16 / elem : 1;
  const int kT = vec ? 128 : 32;
  const int max_per = vec ? 8 : 32;          // the instantiated PERs
  if (N < 1 || N > 0x7fffffffLL || V < 1 || A < 1 || A > kMaxIds ||
      R < 1 || W < 1 || W * 32 < V || W > 0x7fffffffLL / 32)
    return -1;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return -1;
  if (tile < kT || tile > kMaxTile || (tile & (tile - 1)) ||
      tile / kT > threads)
    return -1;
  if (per_thread(tile, threads, kE) > max_per) return -1;
  if ((V + tile - 1) / tile > 65535) return -1;
  if (vec && (!aligned || (V * elem) % 16 || W % 4)) return -1;
  return 4 * A;
}

template <typename E, bool VEC, int PER>
cudaError_t launch(const void* logits, const void* store, const void* rows,
                   const void* eos, const void* constrained, const void* cd,
                   void* out, int N, int V, int W, int A, int R, int eos_id,
                   uint32_t neg, int tile, int threads, cudaStream_t stream) {
  dim3 grid(N, (V + tile - 1) / tile);
  masked_logits_kernel<E, VEC, PER>
      <<<grid, threads, 4 * A, stream>>>(
          static_cast<const E*>(logits), static_cast<const uint32_t*>(store),
          static_cast<const int32_t*>(rows), static_cast<const bool*>(eos),
          static_cast<const bool*>(constrained),
          static_cast<const uint32_t*>(cd), static_cast<E*>(out), V, W, A, R,
          tile, eos_id, neg);
  return cudaGetLastError();
}

template <typename E, bool VEC>
cudaError_t launch_per(int per, const void* logits, const void* store,
                       const void* rows, const void* eos,
                       const void* constrained, const void* cd, void* out,
                       int N, int V, int W, int A, int R, int eos_id,
                       uint32_t neg, int tile, int threads,
                       cudaStream_t stream) {
#define ML_PER(K)                                                      \
  launch<E, VEC, K>(logits, store, rows, eos, constrained, cd, out, N, V, \
                    W, A, R, eos_id, neg, tile, threads, stream)
  switch (per) {
    case 1: return ML_PER(1);
    case 2: return ML_PER(2);
    case 4: return ML_PER(4);
    case 8: return ML_PER(8);
    default:
      if constexpr (!VEC) {
        if (per == 16) return ML_PER(16);
        if (per == 32) return ML_PER(32);
      }
      return cudaErrorInvalidValue;
  }
#undef ML_PER
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int masked_logits_plan_smem(int dtype, int N, int V, int W,
                                       int A, int R, int tile, int threads,
                                       int vec, int aligned) {
  return plan_smem(dtype, N, V, W, A, R, tile, threads, vec, aligned);
}

// dtype: 0 = float32, 1 = bfloat16. `neg` holds the bits of -1e30
// rounded to the logits' dtype by the wrapper, so the fill has the plain
// version's bits. `constrained` and `cd` may be null. tile, threads and
// vec come from the wrapper's launch plan; a plan the kernel does not
// take is refused (cudaErrorInvalidValue), never changed.
extern "C" int masked_logits_launch(const void* logits, int dtype,
                                    const void* store, const void* rows,
                                    const void* eos, const void* constrained,
                                    const void* cd, void* out, int N, int V,
                                    int W, int A, int R, int eos_id,
                                    unsigned neg, int tile, int threads,
                                    int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = aligned16(logits) && aligned16(out) && aligned16(store) &&
                  (cd == nullptr || aligned16(cd));
  if (plan_smem(dtype, N, V, W, A, R, tile, threads, vec, al) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = per_thread(tile, threads,
                             vec ? 16 / (dtype == 1 ? 2 : 4) : 1);
  cudaError_t e;
#define ML_LAUNCH(E, VEC)                                                     \
  launch_per<E, VEC>(per, logits, store, rows, eos, constrained, cd, out, N, \
                     V, W, A, R, eos_id, neg, tile, threads, s)
  if (dtype == 0) {
    e = vec ? ML_LAUNCH(uint32_t, true) : ML_LAUNCH(uint32_t, false);
  } else {
    e = vec ? ML_LAUNCH(uint16_t, true) : ML_LAUNCH(uint16_t, false);
  }
#undef ML_LAUNCH
  return static_cast<int>(e);
}
