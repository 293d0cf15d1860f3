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
// Partial form (`lse` given): the pools hold one rank's in-page offsets
// [base, base + ps) of pages of gps positions (a pool split on the
// in-page offset, [P, gps/M, K, Dh] a rank), so the position of local
// offset o of page j is j * gps + base + o. The kernel then writes the
// fp32 sum before rounding (`out` is fp32) and each row's fp32
// log-sum-exp of its scaled scores, lse = m + log(l), which the cluster
// already holds; a row with no valid position on this rank gets out 0
// and lse -1e30, so the ranks' combine gives it no weight. The whole
// form is the partial one with gps = ps and base 0.
//
// Bound: bytes at serving sizes. A span row's scores need the mapped K/V
// pages of its slot (2 x L x Dh elements per kv head) against 4 x L x Dh
// operations per query head; with G = 3 heads per kv head and S <= 32 that
// is far below the card's ~295 operations per byte. What a decode step
// (S = 1) pays for is latency: 40 (slot, kv head) pairs on 132 SMs, each
// with a few dependent loads.
//
// Design: split-KV over a thread-block cluster. The Pallas kernel copies a
// slot's whole gathered K and V into VMEM and takes one softmax over it;
// 640 KB here, more than a block's shared memory. Instead one cluster of
// C <= 8 blocks runs per (slot, kv head, tile of R query rows), and block
// `rank` takes the contiguous pages [rank * ppb, (rank + 1) * ppb) of the
// slot (ppb = ceil(nP / C); the wrapper's launch plan). Each block copies
// its page ids into shared memory, then starts cp.async copies of all its
// live K pages at once (in their own dtype, rows swizzled on 16-byte
// chunks), so several pages are in flight instead of one round trip per
// page, and keeps its rows' fp32 scores in shared memory. The blocks
// exchange each row's max and then its exp-sum through distributed shared
// memory, so every block holds the exact global m and l and rounds
// P = T(exp(s - m) / l) at the plain version's point. The V pages are
// copied while that exchange runs. Each block forms its partial P.V in
// fp32; after a cluster barrier each block sums a slice of the output
// over the C partials in rank order, through distributed shared memory,
// and writes it. Pages that are unmapped or wholly past the tile's last
// query are skipped, unless a row of the tile has no valid position (the
// cluster agrees on that, since all blocks hold the same m). A block with
// no live page still takes part in every cluster barrier. When a block's
// pages do not fit its shared memory at once they go in chunks of `cpp`
// pages (the launch plan picks it; at the served sizes there is one).
// Scores and P.V are fp32 FMAs on a decode step's few rows (G = 3 at
// S = 1); bf16 spans of 16 or more rows (S >= 8 here) run both products
// as mma.sync.m16n8k16 instead, with T(q * scale) and P in bf16 shared
// memory as the A operands (P is rounded there anyway) and the page
// copies as the B operands.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kRT = 4;                      // query rows per thread item
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr int kSmemMax = 200 * 1024;        // as the wrapper's plan
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

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(x[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// two consecutive elements of T as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Physical 16-byte chunk of logical chunk c in row r of a [rows][...]
// tile with nch chunks per row: eight consecutive rows put one logical
// chunk in eight distinct bank groups (what one 8x8 ldmatrix phase or a
// warp's 16-byte loads read). Other chunk counts are left unswizzled.
__device__ __forceinline__ int swz(int r, int c, int nch) {
  if (nch % 8 == 0) return c ^ (r & 7);
  if (nch == 4) return c ^ ((r >> 1) & 3);
  if (nch == 2) return c ^ ((r >> 2) & 1);
  return c;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero = fill the 16 bytes with zeros instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool zero = false) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(zero ? 0 : 16));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int up16(int x) { return (x + 15) & ~15; }

// Dynamic shared memory of one block, in the kernel's layout (the
// wrapper's `block_smem` is the same formula).
__host__ __device__ inline size_t block_smem(int R, int ppb, int cpp, int ps,
                                             int Dh, int esz, bool mma) {
  const size_t kv = (size_t)(mma ? up16(cpp * ps) : cpp * ps) * Dh * esz;
  const size_t qp = mma ? (size_t)up16(R) * (Dh + up16(ppb * ps)) * esz
                        : (size_t)R * Dh * 4;
  return kv + qp + (size_t)R * Dh * 4 + (size_t)R * ppb * ps * 4 +
         (size_t)4 * R * 4 + (size_t)ppb * 4;
}

// MMA: both products on tensor cores (bf16, one chunk; the note above).
template <typename T, bool MMA>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ pos, void* __restrict__ out,
    float* __restrict__ lse, int S, int H, int K, int Dh, int ps, int gps,
    int base, int nP, int R, int ppb, int cpp, float qscale) {
  constexpr int ECS = 16 / sizeof(T);        // elements per 16-byte chunk
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int kh = blockIdx.z % K;
  const int r0 = (blockIdx.z / K) * R;
  const int G = H / K;
  const int nr = min(R, S * G - r0);
  const int Lb = ppb * ps;                   // score row stride
  const int nch = Dh / ECS;
  const int pbeg = min(nP, rank * ppb);
  const int np = min(nP, pbeg + ppb) - pbeg; // this block's pages (>= 0)
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;    // mma row group, lane in quad
  const int Rp = up16(R), Lbp = up16(Lb);    // MMA: padded to 16

  extern __shared__ __align__(16) unsigned char sm[];
  unsigned char* cur = sm;
  T* kv = reinterpret_cast<T*>(cur);         // [cpp*ps][Dh] K, then V
  cur += (size_t)(MMA ? up16(cpp * ps) : cpp * ps) * Dh * sizeof(T);
  float* qs = reinterpret_cast<float*>(cur); // FMA: [R][Dh] fp32 q
  T* qb = reinterpret_cast<T*>(cur);         // MMA: [Rp][Dh] q
  T* pb = qb + Rp * Dh;                      // MMA: [Rp][Lbp] P
  cur += MMA ? (size_t)Rp * (Dh + Lbp) * sizeof(T) : (size_t)R * Dh * 4;
  float* op = reinterpret_cast<float*>(cur); // [R][Dh] partial P.V
  float* sc = op + R * Dh;                   // [R][Lb] scores, then P
  float* red_m = sc + R * Lb;                // [R] block max (remote-read)
  float* red_l = red_m + R;                  // [R] block sum (remote-read)
  float* gm = red_l + R;                     // [R] cluster max
  float* gl = gm + R;                        // [R] cluster sum
  int* pts = reinterpret_cast<int*>(gl + R);  // [ppb] page ids

  const int p0 = pos[b];
  const int qmax = p0 + (r0 + nr - 1) / G;   // the tile's last query
  for (int j = t; j < np; j += kThreads)
    pts[j] = pt[static_cast<size_t>(b) * nP + pbeg + j];
  auto qval = [&](int rr, int d) {           // T(q * scale) as a float
    const int gr = r0 + rr;
    const int s = gr / G, h = kh * G + gr % G;
    const float x =
        to_f(q[((static_cast<size_t>(b) * S + s) * H + h) * Dh + d]);
    return to_f(from_f<T>(x * qscale));
  };
  if constexpr (MMA) {
    for (int i = t; i < Rp * Dh; i += kThreads) {
      const int rr = i / Dh, d = i % Dh;
      qb[rr * Dh + swz(rr, d / ECS, nch) * ECS + d % ECS] =
          from_f<T>(rr < nr ? qval(rr, d) : 0.f);
    }
    for (int i = t; i < Rp * Lbp; i += kThreads) pb[i] = from_f<T>(0.f);
  } else {
    for (int i = t; i < nr * Dh; i += kThreads) qs[i] = qval(i / Dh, i % Dh);
  }
  for (int i = t; i < nr * Dh; i += kThreads) op[i] = 0.f;
  __syncthreads();

  auto live = [&](int j) {  // mapped, and its first position <= qmax
    return pts[j] >= 0 && (pbeg + j) * gps + base <= qmax;
  };
  // cp.async of pages [cb, ce) of this block into kv: the live pages if
  // `take_live`; the others by `rest`: 0 skip, 1 copy (an unmapped page
  // reads page 0), 2 fill with zeros
  auto copy_pages = [&](const T* pool, int cb, int ce, bool take_live,
                        int rest) {
    const int per_page = ps * nch;
    for (int i = t; i < (ce - cb) * per_page; i += kThreads) {
      const int jj = i / per_page, rem = i % per_page;
      const int o = rem / nch, c = rem % nch, j = cb + jj;
      const bool lv = live(j);
      if (lv ? !take_live : rest == 0) continue;
      const int page = max(pts[j], 0);
      const int row = jj * ps + o;
      cp_async16(kv + row * Dh + swz(row, c, nch) * ECS,
                 pool + ((static_cast<size_t>(page) * ps + o) * K + kh) *
                            Dh + c * ECS,
                 !lv && rest == 2);
    }
    cp_async_commit();
  };

  // ---- scores: all of a chunk's live K pages in flight at once ----
  const int ngr = (nr + kRT - 1) / kRT;
  for (int cb = 0; cb < np; cb += cpp) {
    const int ce = min(np, cb + cpp), nl = (ce - cb) * ps;
    copy_pages(kpool, cb, ce, true, 0);
    cp_async_wait_all();
    __syncthreads();
    if constexpr (MMA) {
      // warp units of 16 rows x 16 positions; rows past nr, positions
      // past nl and pages that are not live are computed but not kept
      const int nrt = Rp / 16, nct = up16(nl) / 16;
      for (int u = warp; u < nrt * nct; u += kThreads / 32) {
        const int rt = u % nrt, ct = u / nrt;
        float acc[2][4] = {};
        for (int kk = 0; kk < Dh / 16; ++kk) {
          uint32_t a[4], bf[4];
          const int ar = rt * 16 + (lane & 15);
          ldsm_x4(a, qb + ar * Dh + swz(ar, kk * 2 + (lane >> 4), nch) * 8);
          const int kr = ct * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldsm_x4(bf, kv + kr * Dh +
                          swz(kr, kk * 2 + ((lane >> 3) & 1), nch) * 8);
          mma_bf16(acc[0], a, bf[0], bf[1]);
          mma_bf16(acc[1], a, bf[2], bf[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rr = rt * 16 + g + (i >> 1) * 8;
            const int li = ct * 16 + n * 8 + 2 * tq + (i & 1);
            if (rr < nr && li < nl) {
              const int l = (pbeg + cb + li / ps) * gps + base + li % ps;
              const int qpos = p0 + (r0 + rr) / G;
              sc[rr * Lb + cb * ps + li] =
                  live(cb + li / ps) && l <= qpos ? acc[n][i] : kNegInf;
            }
          }
      }
    } else {
      for (int i = t; i < ngr * nl; i += kThreads) {
        const int li = i % nl, rg = i / nl;
        const int j = cb + li / ps;
        const int l = (pbeg + j) * gps + base + li % ps;  // position
        float acc[kRT];
#pragma unroll
        for (int r = 0; r < kRT; ++r) acc[r] = 0.f;
        const bool lv = live(j);
        if (lv) {
          const T* krow = kv + li * Dh;
          for (int c = 0; c < nch; ++c) {
            float kf[ECS];
            unpack(*reinterpret_cast<const uint4*>(krow +
                                                   swz(li, c, nch) * ECS),
                   kf);
#pragma unroll
            for (int r = 0; r < kRT; ++r) {
              const int rr = min(rg * kRT + r, nr - 1);
              const float4* qr =
                  reinterpret_cast<const float4*>(qs + rr * Dh + c * ECS);
#pragma unroll
              for (int e4 = 0; e4 < ECS / 4; ++e4) {
                const float4 qv = qr[e4];
                acc[r] = fmaf(qv.x, kf[4 * e4], acc[r]);
                acc[r] = fmaf(qv.y, kf[4 * e4 + 1], acc[r]);
                acc[r] = fmaf(qv.z, kf[4 * e4 + 2], acc[r]);
                acc[r] = fmaf(qv.w, kf[4 * e4 + 3], acc[r]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const int rr = rg * kRT + r;
          if (rr < nr) {
            const int qpos = p0 + (r0 + rr) / G;
            sc[rr * Lb + cb * ps + li] =
                (lv && l <= qpos) ? acc[r] : kNegInf;
          }
        }
      }
    }
    __syncthreads();  // kv is free for the next chunk
  }
  // the first V chunk's live pages load while the cluster agrees on m, l
  if (np > 0) copy_pages(vpool, 0, min(np, cpp), true, 0);

  // ---- exact softmax over the cluster: max, then exp-sum ----
  const int nloc = np * ps;
  for (int rr = warp; rr < nr; rr += kThreads / 32) {
    float m = -INFINITY;
    for (int l = lane; l < nloc; l += 32) m = fmaxf(m, sc[rr * Lb + l]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red_m[rr] = m;
  }
  cluster.sync();
  int dead = 0;
  if (t < nr) {
    float m = -INFINITY;
    for (int r = 0; r < C; ++r)
      m = fmaxf(m, cluster.map_shared_rank(red_m, r)[t]);
    gm[t] = m;
    dead = m <= kNegInf;                     // no valid position at all
  }
  const bool any_dead = __syncthreads_or(dead) != 0;
  for (int rr = warp; rr < nr; rr += kThreads / 32) {
    const float m = gm[rr];
    float sum = 0.f;
    for (int l = lane; l < nloc; l += 32) {
      const float e = expf(sc[rr * Lb + l] - m);
      sc[rr * Lb + l] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) red_l[rr] = sum;
  }
  cluster.sync();
  if (t < nr) {
    float sum = 0.f;
    for (int r = 0; r < C; ++r)               // rank order: every block
      sum += cluster.map_shared_rank(red_l, r)[t];  // gets the same l
    gl[t] = sum;
  }
  __syncthreads();
  for (int i = t; i < nr * nloc; i += kThreads) {
    const int rr = i / nloc, l = i % nloc;
    const T p = from_f<T>(sc[rr * Lb + l] / gl[rr]);
    if constexpr (MMA)
      pb[rr * Lbp + swz(rr, l / 8, Lbp / 8) * 8 + l % 8] = p;
    else
      sc[rr * Lb + l] = to_f(p);
  }
  // the pages that are not live: needed when a row is dead; MMA reads
  // every row of the chunk, so it zero-fills them otherwise
  if (np > 0 && (any_dead || MMA))
    copy_pages(vpool, 0, min(np, cpp), false, any_dead ? 1 : 2);

  // ---- partial P.V over this block's pages, fp32 ----
  const int nd2 = Dh / 2;
  for (int cb = 0; cb < np; cb += cpp) {
    const int ce = min(np, cb + cpp), nl = (ce - cb) * ps;
    if (cb > 0) copy_pages(vpool, cb, ce, true, any_dead ? 1 : 0);
    if constexpr (MMA) {  // rows past nl up to the k-step: zeros, not junk
      for (int i = t; i < (up16(nl) - nl) * Dh; i += kThreads)
        kv[nl * Dh + i] = from_f<T>(0.f);
    }
    cp_async_wait_all();
    __syncthreads();                          // and P is complete
    if constexpr (MMA) {
      const int nrt = Rp / 16, ndt = Dh / 16;
      for (int u = warp; u < nrt * ndt; u += kThreads / 32) {
        const int rt = u % nrt, dt = u / nrt;
        float acc[2][4] = {};
        for (int k16 = 0; k16 < up16(nl) / 16; ++k16) {
          uint32_t a[4], vf[4];
          const int ar = rt * 16 + (lane & 15);
          ldsm_x4(a, pb + ar * Lbp +
                         swz(ar, (cb * ps + k16 * 16) / 8 + (lane >> 4),
                             Lbp / 8) * 8);
          const int vr = k16 * 16 + (lane & 15);
          ldsm_x4_t(vf, kv + vr * Dh + swz(vr, dt * 2 + (lane >> 4), nch) * 8);
          mma_bf16(acc[0], a, vf[0], vf[1]);
          mma_bf16(acc[1], a, vf[2], vf[3]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rr = rt * 16 + g + (i >> 1) * 8;
            if (rr < nr) op[rr * Dh + dt * 16 + n * 8 + 2 * tq + (i & 1)] +=
                acc[n][i];
          }
      }
    } else {
      for (int i = t; i < ngr * nd2; i += kThreads) {
        const int dp = i % nd2, rg = i / nd2, d = 2 * dp;
        const int c = d / ECS, within = d % ECS;
        float ax[kRT], ay[kRT];
#pragma unroll
        for (int r = 0; r < kRT; ++r) ax[r] = ay[r] = 0.f;
        for (int j = cb; j < ce; ++j) {
          if (!any_dead && !live(j)) continue;  // all its weights are 0
          for (int o = 0; o < ps; ++o) {
            const int li = (j - cb) * ps + o;
            const float2 vv =
                load2(kv + li * Dh + swz(li, c, nch) * ECS + within);
#pragma unroll
            for (int r = 0; r < kRT; ++r) {
              const int rr = min(rg * kRT + r, nr - 1);
              const float p = sc[rr * Lb + j * ps + o];
              ax[r] = fmaf(p, vv.x, ax[r]);
              ay[r] = fmaf(p, vv.y, ay[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          const int rr = rg * kRT + r;
          if (rr < nr) {
            op[rr * Dh + d] += ax[r];
            op[rr * Dh + d + 1] += ay[r];
          }
        }
      }
    }
    __syncthreads();  // kv is free for the next chunk
  }

  // ---- sum the partials over the cluster, in rank order ----
  cluster.sync();
  for (int i = rank * kThreads + t; i < nr * Dh; i += C * kThreads) {
    float acc = 0.f;
    for (int r = 0; r < C; ++r) acc += cluster.map_shared_rank(op, r)[i];
    const int rr = i / Dh, d = i % Dh, gr = r0 + rr;
    const int s = gr / G, h = kh * G + gr % G;
    const size_t row = (static_cast<size_t>(b) * S + s) * H + h;
    if (lse != nullptr) {  // partial form: fp32, a dead row weighs 0
      const bool dead_row = gm[rr] <= kNegInf;
      static_cast<float*>(out)[row * Dh + d] = dead_row ? 0.f : acc;
      if (d == 0) lse[row] = dead_row ? kNegInf : gm[rr] + logf(gl[rr]);
    } else {
      static_cast<T*>(out)[row * Dh + d] = from_f<T>(acc);
    }
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <typename T, bool MMA>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pt, const void* pos, void* o, float* lse,
                   int B, int S, int H, int K, int Dh, int ps, int gps,
                   int base, int nP, int R, int C, int ppb, int cpp,
                   int smem, float qscale, cudaStream_t st) {
  auto kern = paged_attention_kernel<T, MMA>;
  static bool configured = false;  // once per instantiation, at the most
  if (!configured) {               // any plan may ask for
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int tiles = (S * (H / K) + R - 1) / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B, K * tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(pos), o, lse, S, H, K, Dh, ps, gps, base,
      nP, R, ppb, cpp, qscale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B,S,H,Dh]; pools [P,ps,K,Dh]
// holding offsets [base, base + ps) of pages of gps positions (the whole
// form: gps = ps, base 0); page table [B,nP] int32 (-1 = unmapped); pos
// [B] int32; out like q, or, with lse [B,S,H] given (the partial form),
// fp32 [B,S,H,Dh].
// The launch plan comes from the wrapper (kernels/paged_attention/ops.py::
// launch_plan): R query rows per cluster, C blocks per cluster of ppb
// pages each (C * ppb >= nP > (C - 1) * ppb), cpp pages per
// shared-memory chunk, `smem` dynamic bytes per block and `mma` (both
// products on tensor cores: bf16, Dh a multiple of 16, one chunk). Dh *
// element size is a multiple of 16 bytes with 1, 2, 4 or a multiple of 8
// chunks of 16 bytes per row; the pools are 16-byte aligned.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* pt,
                                      const void* pos, void* o, void* lse,
                                      int dtype, int B, int S, int H, int K,
                                      int Dh, int ps, int gps, int base,
                                      int nP, int R, int C, int ppb, int cpp,
                                      int mma, int smem, float qscale,
                                      void* stream) {
  if (B == 0 || S == 0) return 0;
  const int esz = dtype == 1 ? 2 : 4;
  const int nch = Dh * esz / 16;
  if (K < 1 || H % K || R < 1 || R > kThreads || nP < 1 || ps < 1 ||
      base < 0 || base + ps > gps ||
      Dh * esz % 16 ||
      !(nch == 1 || nch == 2 || nch == 4 || nch % 8 == 0) || C < 1 ||
      C > kMaxCluster || ppb < 1 || C * ppb < nP || (C - 1) * ppb >= nP ||
      cpp < 1 || cpp > ppb || (dtype != 0 && dtype != 1) ||
      (mma && (dtype != 1 || Dh % 16 || cpp != ppb)) || smem > kSmemMax ||
      (size_t)smem < block_smem(R, ppb, cpp, ps, Dh, esz, mma != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t e;
  if (dtype == 0)
    e = launch<float, false>(q, k, v, pt, pos, o, l, B, S, H, K, Dh, ps,
                             gps, base, nP, R, C, ppb, cpp, smem, qscale,
                             st);
  else if (mma)
    e = launch<__nv_bfloat16, true>(q, k, v, pt, pos, o, l, B, S, H, K, Dh,
                                    ps, gps, base, nP, R, C, ppb, cpp, smem,
                                    qscale, st);
  else
    e = launch<__nv_bfloat16, false>(q, k, v, pt, pos, o, l, B, S, H, K,
                                     Dh, ps, gps, base, nP, R, C, ppb, cpp,
                                     smem, qscale, st);
  return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// The head_dim form: a pool split on head_dim over M ranks (a trunk-sharded
// engine where M divides neither the kv heads nor the page size), each
// rank holding channels [d0, d0 + dw) of every position, [P, ps, K, dw].
// The reference's GSPMD program, for the rank's block, computes the
// partial scores, all-reduces them, masks and softmaxes once, and
// multiplies P by the rank's V block; the port does the same in two
// launches around the all-reduce (kernels/paged_attention/ref.py::
// paged_scores_ref, paged_values_ref are the plain versions):
//   scores[b,s,h,l] = sum_{d < dw} T(q[b,s,h,d0+d] * scale) * K[l][d]
//                     (fp32; l = j * ps + o at (page_table[b, j], o))
//   values[b,s,h,d] = sum_l P[b,s,h,l] * V[l][d]   (P in T, sums fp32)
// An unmapped page reads page 0, as the plain version's gather does (its
// scores are masked after the join, its P is 0).
//
// Bound: bytes. Scores read the rank's K block of every page a slot
// names and write 4 bytes a (row, position) for 2 dw operations; values
// read P and the V block for 2 dw operations a (row, position). At the
// served sizes (S <= 32, G <= 8 heads a kv head, dw 8-128) that is well
// under the card's ~295 operations a byte.
//
// Design: simple fp32 FMA tiles, no tensor cores. Scores: one block per
// (page, slot, kv head) copies the page's K block into shared memory as
// fp32 (rows padded by one word, so that threads on consecutive positions
// hit distinct banks) and gives each thread (row, position) dots over the
// dw channels, written position-contiguous. Values: one block per (slot,
// kv head, tile of R rows) walks the slot's pages in order; per page it
// copies the tile's P and the page's V block into shared memory and each
// thread adds P[r] . V[:, d] to up to kVPer (row, channel) accumulators in
// registers. A page whose P is 0 on every row of the tile (past every
// row's position, or unmapped) is skipped: it would add exact zeros.

namespace {

constexpr int kVPer = 8;  // (row, channel) accumulators a thread

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_scores_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const int32_t* __restrict__ pt, float* __restrict__ out, int S, int H,
    int K, int Dh, int dw, int d0, int ps, int nP, float qscale) {
  extern __shared__ float ks[];  // [ps][dw + 1]
  const int j = blockIdx.x, b = blockIdx.y, kh = blockIdx.z;
  const int G = H / K, ld = dw + 1;
  const int page = max(pt[static_cast<size_t>(b) * nP + j], 0);
  const T* src = kp + (static_cast<size_t>(page) * ps * K + kh) * dw;
  for (int i = threadIdx.x; i < ps * dw; i += blockDim.x) {
    const int o = i / dw, d = i - o * dw;
    ks[o * ld + d] = to_f(src[static_cast<size_t>(o) * K * dw + d]);
  }
  __syncthreads();
  const size_t L = static_cast<size_t>(nP) * ps;
  for (int i = threadIdx.x; i < S * G * ps; i += blockDim.x) {
    const int r = i / ps, o = i - r * ps;
    const int s = r / G, h = kh * G + r % G;
    const size_t row = (static_cast<size_t>(b) * S + s) * H + h;
    const T* qr = q + row * Dh + d0;
    const float* kr = ks + o * ld;
    float acc = 0.f;
    for (int d = 0; d < dw; ++d)
      acc = fmaf(to_f(from_f<T>(to_f(qr[d]) * qscale)), kr[d], acc);
    out[row * L + static_cast<size_t>(j) * ps + o] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_values_kernel(
    const T* __restrict__ p, const T* __restrict__ vp,
    const int32_t* __restrict__ pt, float* __restrict__ out, int S, int H,
    int K, int dw, int ps, int nP, int R) {
  extern __shared__ float vsm[];
  float* vs = vsm;            // [ps][dw]
  float* pr = vsm + ps * dw;  // [R][ps]
  const int b = blockIdx.x, kh = blockIdx.y;
  const int G = H / K, r0 = blockIdx.z * R;
  const int nr = min(R, S * G - r0);
  const size_t L = static_cast<size_t>(nP) * ps;
  float acc[kVPer];
#pragma unroll
  for (int t = 0; t < kVPer; ++t) acc[t] = 0.f;
  for (int j = 0; j < nP; ++j) {
    int live = 0;
    for (int i = threadIdx.x; i < nr * ps; i += blockDim.x) {
      const int r = i / ps, o = i - r * ps;
      const int s = (r0 + r) / G, h = kh * G + (r0 + r) % G;
      const float x = to_f(p[((static_cast<size_t>(b) * S + s) * H + h) * L +
                             static_cast<size_t>(j) * ps + o]);
      pr[i] = x;
      live |= x != 0.f;
    }
    if (!__syncthreads_or(live)) continue;
    const int page = max(pt[static_cast<size_t>(b) * nP + j], 0);
    const T* src = vp + (static_cast<size_t>(page) * ps * K + kh) * dw;
    for (int i = threadIdx.x; i < ps * dw; i += blockDim.x) {
      const int o = i / dw, d = i - o * dw;
      vs[i] = to_f(src[static_cast<size_t>(o) * K * dw + d]);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kVPer; ++t) {
      const int i = threadIdx.x + t * kThreads;
      if (i < nr * dw) {
        const int r = i / dw, d = i - r * dw;
        float a = acc[t];
        for (int o = 0; o < ps; ++o)
          a = fmaf(pr[r * ps + o], vs[o * dw + d], a);
        acc[t] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < kVPer; ++t) {
    const int i = threadIdx.x + t * kThreads;
    if (i < nr * dw) {
      const int r = i / dw, d = i - r * dw;
      const int s = (r0 + r) / G, h = kh * G + (r0 + r) % G;
      out[((static_cast<size_t>(b) * S + s) * H + h) * dw + d] = acc[t];
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B,S,H,Dh] (every channel); k_pool
// [P,ps,K,dw] channels [d0, d0 + dw) of each position; page table [B,nP]
// int32 (-1 = unmapped); out fp32 [B,S,H,nP*ps]; qscale 1/sqrt(Dh)
// rounded to the dtype.
extern "C" int paged_scores_launch(const void* q, const void* k,
                                   const void* pt, void* out, int dtype,
                                   int B, int S, int H, int K, int Dh,
                                   int dw, int d0, int ps, int nP,
                                   float qscale, void* stream) {
  if (B == 0 || S == 0) return 0;
  const int smem = ps * (dw + 1) * 4;
  if (K < 1 || H % K || dw < 1 || d0 < 0 || d0 + dw > Dh || ps < 1 ||
      nP < 1 || B > 65535 || K > 65535 || smem > kSmemMax ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nP, B, K);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    auto kern = paged_scores_kernel<float>;
    if ((e = allow_smem(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const int32_t*>(pt), static_cast<float*>(out), S, H, K,
        Dh, dw, d0, ps, nP, qscale);
  } else {
    auto kern = paged_scores_kernel<__nv_bfloat16>;
    if ((e = allow_smem(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const int32_t*>(pt), static_cast<float*>(out), S, H, K,
        Dh, dw, d0, ps, nP, qscale);
  }
  return static_cast<int>(cudaGetLastError());
}

// p [B,S,H,nP*ps] the joined probabilities in the dtype; v_pool
// [P,ps,K,dw]; page table [B,nP]; out fp32 [B,S,H,dw]. R rows of the S *
// (H/K) of each (slot, kv head) a block, R * dw <= 128 * kVPer.
extern "C" int paged_values_launch(const void* p, const void* v,
                                   const void* pt, void* out, int dtype,
                                   int B, int S, int H, int K, int dw,
                                   int ps, int nP, int R, void* stream) {
  if (B == 0 || S == 0) return 0;
  const int smem = (ps * dw + R * ps) * 4;
  const int tiles = (S * (H / (K > 0 ? K : 1)) + R - 1) / (R > 0 ? R : 1);
  if (K < 1 || H % K || dw < 1 || ps < 1 || nP < 1 || R < 1 ||
      R * dw > kThreads * kVPer || K > 65535 || tiles > 65535 ||
      smem > kSmemMax || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, K, tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    auto kern = paged_values_kernel<float>;
    if ((e = allow_smem(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(p), static_cast<const float*>(v),
        static_cast<const int32_t*>(pt), static_cast<float*>(out), S, H, K,
        dw, ps, nP, R);
  } else {
    auto kern = paged_values_kernel<__nv_bfloat16>;
    if ((e = allow_smem(kern, smem)) != cudaSuccess) return e;
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(p),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const int32_t*>(pt), static_cast<float*>(out), S, H, K,
        dw, ps, nP, R);
  }
  return static_cast<int>(cudaGetLastError());
}
