// The brute route's selection for lists no block holds: for every query,
// its top-k of all candidates under the TPU-KNN per-block fold, and the
// certificate that the selection is a true top-k set, in two passes
// through device memory.  For NVIDIA Hopper (sm_90a).
//
// mxu_select.cu and mxu_select_bf16.cu keep each query's lists of k in
// shared memory, so their launch gates (mxu/kernel.py pick_launch,
// pick_launch_bf16) refuse k from about 1,600 on.  The reference sends the
// shapes its kernel cannot hold to solve_blocks_xla
// (cuda_knearests_tpu/mxu/scorer.py:209); this source is the port's kernel
// for them.  It computes bit for bit what the plain torch version
// (cuda_knearests_tpu_torch/mxu/scorer.py select_plain) computes, at both
// tiers:
//   * f32: s = (qn + pn) - 2*qp, with qn, pn and qp = q.p each summed in
//     order over axes 0..d-1 from the first term, every multiply and add
//     rounded on its own (the intrinsics below, and the build passes
//     --fmad=false);
//   * bf16: the same over the bf16-rounded coordinates of the bf16 prep
//     pass (whose products are exact in f32), with its bf16 scoring norms;
//   * keys order (score, id) as scorer.score_key does: the score's bits
//     made order-preserving in the high word, the id in the low word, here
//     with the sign bit flipped so that unsigned order is that order;
//     pads (id < 0), the query's own id (exclude_self) and non-finite
//     scores are missing (all ones, after every real key), (inf, -1) in
//     the output;
//   * each 128-slot block keeps its first m keys, the selection is the
//     first k of the kept pool, kplus = the smaller of the smallest
//     (m+1)-th score of a block (m < 128) and the pool's (k+1)-th score,
//     t = the k-th selected score, B = coef * (qn + pn_max) with qn the f32
//     norm; certified iff kplus >= t + 2*B.
//
// Two arms, chosen by shape in mxu/kernel.py split_plan:
//   * direct (m >= 128, d <= _SPLIT_DIRECT_MAX_D and n2 <= 32,768): the
//     fold keeps every key, so a pool would be each query's whole score
//     row, 8 bytes a candidate (3.2 GB at 20k queries), written once and
//     read on every pass.  This arm writes none: one kernel rescores the
//     candidates on each pass, a block taking kDirectQ = 4 queries (in
//     shared memory) and each thread 4 candidates a step, loaded once a
//     block a pass (at d=3 the 20 bytes a candidate stay in L2).  One
//     launch a call (chunks only when rows go to the caller's scratch).
//   * pool (m < 128, or d above the threshold): the fold (a block of 8
//     warps, a warp a query, 4 candidates a lane) sorts each 128-slot
//     block's keys (a bitonic network over registers and shuffles) and
//     writes the first m to the query's pool row and the (m+1)-th score to
//     rem, or with m = 128 every key as it is; then a block of 256 threads
//     a query selects from the pool row.  Chunks of queries bound the pool.
// Both arms select with the same code (select_passes, on a key source:
// rescored candidates or a pool row): pass 1 counts each query's keys by
// their top kBits = 12 bits (the flipped sign, the exponent, 3 mantissa
// bits) in a shared histogram, scanned by the whole block, which fixes
// the bucket holding rank k and the keys below it; pass 2 appends the keys
// below the bucket, and the bucket's when both fit the row width n2, to
// the query's row (a shuffle scan of each lane's counts and one shared
// atomic a warp a batch place them).  A bucket that does not fit is
// refined by more histogram passes on the keys under its prefix, kBits at
// a time; keys equal under all 64 bits, and a bucket whose fixed bits are
// all ones, can only be missing keys, which are not gathered but padded.
// The row (sharing the histogram's shared memory, or in the caller's
// scratch row) is sorted by a bitonic network in registers, shuffles and
// shared memory, put back into the row in order and written out in
// coalesced runs with the certificate.
// Work: a pass of the direct arm scores every (query, candidate) pair,
// about 2d + 8 instructions without fused multiply-adds (d = 3 is compiled
// with its axis count), pass 1 adds a shared atomic a pair and pass 2 a
// store a gathered key: the arm is bound by issued instructions (two
// scoring passes, then the sort of n2 keys a query and its output, each
// about a third of its time at d=3; scripts/split_select_phases.cu times
// them apart), not by bytes.  The pool arm writes 8 bytes a kept key and
// reads them twice at 3.35 TB/s, and scores each pair once; rescoring
// costs the direct arm more than those bytes from d = 15 on (the measured
// crossing, PERF.md "PR 9").

// Plain C interface, loaded with ctypes.  The launcher allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// (mxu/kernel.py mirrors kSmemSortKeys, kDirectQ, kDirectSmemKeys and
// kDirectMaxKeys as _SPLIT_SMEM_KEYS, _SPLIT_DIRECT_QUERIES,
// _SPLIT_DIRECT_SMEM_KEYS and _SPLIT_DIRECT_MAX_KEYS.)
constexpr int kBlock = 128;            // candidate slots per fold block
constexpr int kFoldWarps = 8;          // queries per fold block
constexpr int kThreads = 256;          // threads of a selection block
constexpr int kSmemSortKeys = 8192;    // pool arm: rows in shared memory
constexpr int kDirectQ = 4;            // queries a direct block
constexpr int kDirectCols = 4;         // candidates a thread a step
constexpr int kDirectSmemKeys = 2048;  // direct arm: rows in shared memory
constexpr int kDirectMaxKeys = 32768;  // direct arm: 16-bit row counts
constexpr int kBits = 12;              // histogram digit
constexpr int kBins = 1 << kBits;
constexpr int kMaxPasses = 16;         // pass-count bins of the stats
constexpr uint64_t kMissing = ~0ull;
constexpr uint64_t kSign = 1ull << 63;

// The high word of the flipped score_key of s: the score's bits made
// order-preserving, sign flipped, so that unsigned order is score order;
// all ones for every non-finite score (the missing key's).  No finite
// score reaches the top kBits bits all ones (the largest is 0xff7fffff).
__device__ __forceinline__ uint32_t score_hi(float s) {
  const int bits = __float_as_int(s);
  const uint32_t hi = (uint32_t)(bits ^ ((bits >> 31) | (int)0x80000000));
  return fabsf(s) < INFINITY ? hi : ~0u;
}

// The key of high word hi and id lo: unsigned order is (score, id) order;
// the missing key (hi all ones) is all ones.
__device__ __forceinline__ uint64_t join_key(uint32_t hi, uint32_t lo) {
  return hi == ~0u ? kMissing : ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ float key_score(uint64_t u) {
  if (u == kMissing) return INFINITY;
  int hi = (int)(uint32_t)((u ^ kSign) >> 32);
  if (hi < 0) hi ^= 0x7fffffff;
  return __int_as_float(hi);
}

__device__ __forceinline__ int key_id(uint64_t u) {
  return u == kMissing ? -1 : (int)(uint32_t)u;
}

// A compare-exchange seen from one side: the smaller of mine and other
// if keep_min, else the larger (one comparison, one select).
__device__ __forceinline__ uint64_t keep(uint64_t mine, uint64_t other,
                                         bool keep_min) {
  return (other < mine) == keep_min ? other : mine;
}

// Axis ax of row `row`: f32 operands are axis-major (d, ld) from the f32
// prep, bf16 ones (rows, ld) rows from the bf16 prep.
template <bool kBf16>
__device__ __forceinline__ float coord(const void* x, int ld, int64_t row,
                                       int ax) {
  if (kBf16)
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(x)[row * ld + ax]);
  return static_cast<const float*>(x)[(int64_t)ax * ld + row];
}

// The scoring both arms share, so that they cannot drift: q.p summed over
// axes in order from the first product, every op rounded on its own ...
__device__ __forceinline__ float dot_step(float acc, float qv, float pv,
                                          int ax) {
  const float t = __fmul_rn(qv, pv);
  return ax ? __fadd_rn(acc, t) : t;
}

// ... and the high word of the key of s = (qn + pn) - 2 qp; pads (id < 0)
// and the query's own id under exclude_self are missing.
__device__ __forceinline__ uint32_t pair_hi(float qn, float pn, float qp,
                                            int id, int self, int excl) {
  float s = __fsub_rn(__fadd_rn(qn, pn), __fmul_rn(2.f, qp));
  if (id < 0 || (excl && id == self)) s = INFINITY;
  return score_hi(s);
}

// Grid (candidate blocks, ceil(n_rows / 8)).  qn and pn are the scoring
// norms.  Pool row r holds gridDim.x * m keys (block b's at b * m), rem
// row r gridDim.x scores (m < 128 only).
template <bool kBf16>
__global__ void __launch_bounds__(kFoldWarps * 32) fold_kernel(
    const void* __restrict__ qx, int ldq, const float* __restrict__ qn,
    const int* __restrict__ qid, const void* __restrict__ px, int ldp,
    const float* __restrict__ pn, const int* __restrict__ cid, int row0,
    int n_rows, int d, int m, int exclude_self, uint64_t* __restrict__ pool,
    float* __restrict__ rem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x, g = gridDim.x;
  const int r = blockIdx.y * kFoldWarps + warp;
  if (r >= n_rows) return;
  const int64_t q = (int64_t)row0 + r;
  const int64_t c0 = (int64_t)b * kBlock + lane;

  float acc[4];
  for (int ax = 0; ax < d; ++ax) {
    const float qv = coord<kBf16>(qx, ldq, q, ax);
#pragma unroll
    for (int t = 0; t < 4; ++t)
      acc[t] = dot_step(acc[t], qv, coord<kBf16>(px, ldp, c0 + 32 * t, ax),
                        ax);
  }
  const float qnv = qn[q];
  const int self = qid[q];
  uint64_t key[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int64_t c = c0 + 32 * t;
    const int id = cid[c];
    key[t] = join_key(pair_hi(qnv, pn[c], acc[t], id, self, exclude_self),
                      (uint32_t)id);
  }

  uint64_t* row = pool + (int64_t)r * g * m;
  if (m >= kBlock) {  // every key is kept: no order needed
#pragma unroll
    for (int t = 0; t < 4; ++t) row[(int64_t)b * kBlock + lane + 32 * t] = key[t];
    return;
  }
  // Bitonic sort of the block's 128 keys, element i = 4 * lane + t.
#pragma unroll
  for (int size = 2; size <= kBlock; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 4) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint64_t other =
              __shfl_xor_sync(0xffffffffu, key[t], stride >> 2);
          const int i = 4 * lane + t;
          const bool asc = (i & size) == 0, lower = (i & stride) == 0;
          key[t] = keep(key[t], other, asc == lower);
        }
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (t & stride) continue;
          const int u = t | stride;
          const bool asc = ((4 * lane + t) & size) == 0;
          if ((key[t] > key[u]) == asc) {
            const uint64_t x = key[t];
            key[t] = key[u];
            key[u] = x;
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = 4 * lane + t;
    if (i < m)
      row[(int64_t)b * m + i] = key[t];
    else if (i == m)
      rem[(int64_t)r * g + b] = key_score(key[t]);
  }
}

// -- the selection both arms share ---------------------------------------

enum : int { kDone = 0, kHist = 1, kGather = 2 };

// One query's radix state, in shared memory: the bits of prefix from
// `shift` up are fixed, `rank` is the rank of the wanted key among the keys
// that share them, `lt` how many keys lie below them; `take`: the gather
// appends the keys that share them too.
struct SelState {
  uint64_t prefix;
  int shift, rank, lt, phase, take;
};

// One query's view of a pass, made from its SelState when the pass starts
// and read from shared memory by every batch of keys (registers are what
// the direct arm's scoring loop runs short of).  A key is its high word
// hi (score) and low word lo (id); where the fixed bits (a gather) or the
// digit (a histogram) lie in hi, only hi is compared (wide = 0).
struct PassView {
  uint64_t m64, p64;  // the fixed bits of the key, and the prefix's
  uint64_t lim64;     // a gather wants the keys below lim64 ...
  uint32_t m32, p32;  // the same within hi
  uint32_t lim32;     // ... or (wide = 0) whose hi lies below lim32
  int mode, wide, ds;  // ds: the digit's shift
  unsigned dmask;
};

__device__ __forceinline__ void make_view(PassView* v, const SelState& s) {
  v->mode = s.phase;
  v->m64 = s.shift >= 64 ? 0 : (~0ull << s.shift);
  v->p64 = s.prefix & v->m64;
  const int bits = s.shift < kBits ? s.shift : kBits;
  v->ds = s.shift - bits;
  v->dmask = (1u << bits) - 1;
  v->wide = s.phase == kHist ? v->ds < 32 : s.shift < 32;
  v->m32 = (uint32_t)(v->m64 >> 32);
  v->p32 = (uint32_t)(v->p64 >> 32);
  // keys below the prefix, and (take) those under it: the prefix plus its
  // lowest fixed bit, which cannot overflow (a prefix of ones only is the
  // missing key's, kept with take = 0)
  const uint64_t step = s.shift >= 64 ? 0 : (uint64_t)s.take << s.shift;
  v->lim64 = v->p64 + step;
  v->lim32 = (uint32_t)(v->lim64 >> 32);
}

// What a pass does with a batch of keys of Q queries: count them in query
// j's histogram (kHist), or append the wanted ones to query j's row
// (kGather).  Views, histograms and rows live in shared memory (rows in
// scratch when wide); n_app counts the keys appended to each row this
// pass, kField bits a query.
template <int Q>
struct Visit {
  const PassView* view;  // Q views
  bool any_gather;
  unsigned* hist;        // query j's at hist + j * rstride32
  uint64_t* buf;         // query j's row at buf + j * bstride
  int rstride32;
  int64_t bstride;
  unsigned long long* n_app;
  static constexpr int kField = 64 / Q;
  static constexpr unsigned long long kFieldMask =
      Q == 1 ? ~0ull : (1ull << kField) - 1;

  // Every lane of a warp calls this together; valid[i] is false on lanes
  // past the end of the source.
  template <int C>
  __device__ __forceinline__ void operator()(const uint32_t (&hi)[Q][C],
                                             const uint32_t (&lo)[C],
                                             const bool (&valid)[C]) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      if (view[j].mode != kHist) continue;
      const PassView v = view[j];
      unsigned* h = hist + j * rstride32;
      if (!v.wide) {
        const int sh = v.ds - 32;
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (valid[i] && (hi[j][i] & v.m32) == v.p32)
            atomicAdd(h + ((hi[j][i] >> sh) & v.dmask), 1u);
        }
      } else {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const uint64_t u = join_key(hi[j][i], lo[i]);
          if (valid[i] && (u & v.m64) == v.p64)
            atomicAdd(h + ((u >> v.ds) & v.dmask), 1u);
        }
      }
    }
    if (!any_gather) return;
    // Each lane's wanted keys (a bit a key) and their counts, 8 bits a
    // query (at most C a lane, 32 * C a warp); one shuffle scan of the
    // counts places every lane's keys, and one atomic a batch reserves
    // every query's room in its row.
    static_assert(Q * 8 <= 32 && 32 * C < 256, "packed counts overflow");
    const int lane = threadIdx.x & 31;
    unsigned want[Q], packed = 0;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      want[j] = 0;
      if (view[j].mode != kGather) continue;
      const PassView v = view[j];
      if (!v.wide) {
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (valid[i] && hi[j][i] < v.lim32) want[j] |= 1u << i;
      } else {
#pragma unroll
        for (int i = 0; i < C; ++i)
          if (valid[i] && join_key(hi[j][i], lo[i]) < v.lim64)
            want[j] |= 1u << i;
      }
      packed += (unsigned)__popc(want[j]) << (8 * j);
    }
    unsigned inc = packed;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned x = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += x;
    }
    const unsigned tot = __shfl_sync(0xffffffffu, inc, 31);
    if (tot == 0) return;
    unsigned long long add = 0;
#pragma unroll
    for (int j = 0; j < Q; ++j)
      add |= (unsigned long long)((tot >> (8 * j)) & 255u) << (kField * j);
    unsigned long long old = 0;
    if (lane == 31) old = atomicAdd(n_app, add);
    old = __shfl_sync(0xffffffffu, old, 31);
    const unsigned ex = inc - packed;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      if (want[j] == 0) continue;
      const unsigned pos = (unsigned)((old >> (kField * j)) & kFieldMask) +
                           ((ex >> (8 * j)) & 255u);
#pragma unroll
      for (int i = 0; i < C; ++i)  // wanted keys are never missing keys
        if (want[j] >> i & 1)
          buf[j * bstride + pos + __popc(want[j] & ((1u << i) - 1))] =
              ((uint64_t)hi[j][i] << 32) | lo[i];
    }
  }
};

// After a histogram pass: the whole block scans the histograms of the
// queries that counted (mode kHist), fixes each one's bucket of rank
// st[j].rank and decides its next pass.  A warp sums 512 bins (lanes on
// consecutive bins), and the warp holding the rank finds its bin 32 bins
// at a time.
template <int Q>
__device__ __forceinline__ void settle(SelState* st, const int* mode,
                                       const unsigned* hist, int rstride32,
                                       int n2, unsigned* s_part) {
  constexpr int nw = kThreads / 32, span = kBins / nw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned rank[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (mode[j] != kHist) continue;
    rank[j] = (unsigned)st[j].rank;
    const unsigned* h = hist + j * rstride32 + warp * span;
    unsigned sum = 0;
#pragma unroll
    for (int b = 0; b < span / 32; ++b) sum += h[b * 32 + lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) s_part[j * nw + warp] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    if (mode[j] != kHist) continue;
    unsigned cum = 0, total = 0;
    for (int w = 0; w < nw; ++w) {
      const unsigned c = s_part[j * nw + w];
      if (w < warp) cum += c;
      total += c;
    }
    SelState& s = st[j];
    if (total <= rank[j]) {  // fewer keys than k + 1: all, then missing
      if (tid == 0) {
        s.prefix = kMissing;
        s.shift = 0;
        s.take = 0;
        s.phase = kGather;
      }
      continue;
    }
    if (rank[j] < cum || cum + s_part[j * nw + warp] <= rank[j]) continue;
    const unsigned* h = hist + j * rstride32 + warp * span;
    for (int b = 0; b < span / 32; ++b) {
      const unsigned c = h[b * 32 + lane];
      unsigned inc = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += x;
      }
      const unsigned chunk = __shfl_sync(0xffffffffu, inc, 31);
      if (rank[j] >= cum + chunk) {
        cum += chunk;
        continue;
      }
      const unsigned below = cum + inc - c;  // keys under this lane's bin
      if (below <= rank[j] && rank[j] < below + c) {
        const int bits = s.shift < kBits ? s.shift : kBits;
        const int ds = s.shift - bits;
        const int bin = warp * span + b * 32 + lane;
        const uint64_t prefix = s.prefix | ((uint64_t)bin << ds);
        const uint64_t fixed = ~0ull << ds;
        s.prefix = prefix;
        s.shift = ds;
        s.lt += (int)below;
        s.rank = (int)(rank[j] - below);
        if ((prefix & fixed) == fixed) {
          // every fixed bit is one: no finite score's key has them
          s.prefix = kMissing;
          s.shift = 0;
          s.take = 0;
          s.phase = kGather;
        } else if ((long long)s.lt + c <= (long long)n2) {
          s.take = 1;
          s.phase = kGather;
        } else if (ds == 0) {  // equal keys under all 64 bits: missing
          s.take = 0;
          s.phase = kGather;
        }  // else the bucket is refined by another histogram pass
      }
      break;
    }
  }
  __syncthreads();
}

// The passes of up to Q queries by the whole block: histogram and gather
// passes over src's keys until every query has its row of n2 keys,
// unsorted (row j at buf + j * bstride, aliasing query j's histogram at
// hist + j * rstride32 when in shared memory).  st holds Q states (queries
// past the end in phase kDone).  Returns the passes made.
template <int Q, class Src>
__device__ __forceinline__ int select_passes(
    Src& src, SelState* st, PassView* view, unsigned long long* n_app,
    unsigned* hist, int rstride32, uint64_t* buf, int64_t bstride, int n2,
    unsigned* s_part) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int passes = 0;
  for (;;) {
    bool any = false, any_gather = false, any_hist = false;
    int mode[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      mode[j] = st[j].phase;
      if (tid == j) make_view(view + j, st[j]);
      any |= mode[j] != kDone;
      any_gather |= mode[j] == kGather;
      any_hist |= mode[j] == kHist;
    }
    if (!any) break;
    // At most ceil(64 / kBits) histogram passes and a gather: more is a
    // fault, which stops the kernel rather than loop.
    if (passes > (64 + kBits - 1) / kBits) __trap();
    if (tid == 0) *n_app = 0;
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (mode[j] == kHist)
        for (int i = tid; i < kBins; i += nt) hist[j * rstride32 + i] = 0;
    __syncthreads();
    Visit<Q> v{view, any_gather, hist, buf, rstride32, bstride, n_app};
    src.scan(v);
    ++passes;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      if (mode[j] != kGather) continue;  // pad the row with missing keys
      using V = Visit<Q>;
      const int n = (int)((*n_app >> (V::kField * j)) & V::kFieldMask);
      for (int i = n + tid; i < n2; i += nt) buf[j * bstride + i] = kMissing;
    }
    if (any_hist) settle<Q>(st, mode, hist, rstride32, n2, s_part);
#pragma unroll
    for (int j = 0; j < Q; ++j)
      if (tid == j && mode[j] == kGather) st[j].phase = kDone;
    __syncthreads();
  }
  return passes;
}

__device__ __forceinline__ void init_state(SelState* st, int k, bool live) {
  st->prefix = 0;
  st->shift = 64;
  st->rank = k;
  st->lt = 0;
  st->phase = live ? kHist : kDone;
  st->take = 0;
}

// What a row's selection writes: query q's k entries, and its certificate
// from kplus = min(rm, score of entry k) (rm: the smallest score a block
// rejected, inf when every key is kept) and t = score of entry k - 1.
struct RowOut {
  int k;
  float coef;
  const float* qnf;
  const float* pn_max;
  int* out_i;
  float* out_s;
  uint8_t* out_cert;

  __device__ __forceinline__ void entry(int64_t q, int j, uint64_t u) const {
    out_i[q * k + j] = key_id(u);
    out_s[q * k + j] = key_score(u);
  }
  __device__ __forceinline__ void cert(int64_t q, float rm, uint64_t t,
                                       uint64_t next) const {
    const float kplus = fminf(rm, key_score(next));
    const float err = __fmul_rn(coef, __fadd_rn(qnf[q], *pn_max));
    const float thr = __fadd_rn(key_score(t), __fmul_rn(2.f, err));
    out_cert[q] = kplus >= thr ? 1 : 0;
  }
};

// Sort row [0, n2) (n2 = E * nt, any order in) by threads tid < nt of a
// group and, if `write`, write query q's selection: a bitonic sort with
// element t * E + e in register e of thread t, strides below E within a
// thread, below 32 * E by shuffles, wider ones through the row in shared
// memory (element (t, e) at e * nt + t).  Every thread of the block calls
// it in step (it synchronizes the block).
template <int E>
__device__ void sort_row_regs(uint64_t* row, int n2, int64_t q, float rm,
                              const RowOut& o, int tid, int nt, bool write) {
  uint64_t key[E];
#pragma unroll
  for (int e = 0; e < E; ++e) key[e] = row[e * nt + tid];
  const int t0 = tid * E;  // element bits >= E: those of t0
  for (int size = 2; size <= n2; size <<= 1) {
    // strides >= E: one direction a thread (size > stride >= E)
    for (int stride = size >> 1; stride >= E; stride >>= 1) {
      const bool keep_min = ((t0 & size) == 0) == ((t0 & stride) == 0);
      if (stride < 32 * E) {
        const int lm = stride / E;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          key[e] = keep(key[e], __shfl_xor_sync(0xffffffffu, key[e], lm),
                        keep_min);
        }
      } else {
        __syncthreads();
#pragma unroll
        for (int e = 0; e < E; ++e) row[e * nt + tid] = key[e];
        __syncthreads();
        const int pt = tid ^ (stride / E);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          key[e] = keep(key[e], row[e * nt + pt], keep_min);
        }
      }
    }
    // strides < E, within the thread
#pragma unroll
    for (int s = E / 2; s > 0; s >>= 1) {
      if (s >= size) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e & s) continue;
        const bool asc = ((t0 + e) & size) == 0;
        const uint64_t a = key[e], b = key[e | s];
        const bool swap = (a > b) == asc;
        key[e] = swap ? b : a;
        key[e | s] = swap ? a : b;
      }
    }
  }
  // Back to the row in sorted order, element i at i ^ (i / E % E) (no
  // bank conflicts either way), then out in coalesced runs.
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) row[t0 + (e ^ (tid % E))] = key[e];
  __syncthreads();
  if (write) {
    for (int i = tid; i < o.k; i += nt)
      o.entry(q, i, row[i ^ (i / E % E)]);
    if (tid == 0) {
      const int t = o.k - 1, n = o.k;
      o.cert(q, rm, row[t ^ (t / E % E)], row[n ^ (n / E % E)]);
    }
  }
  __syncthreads();
}

// Sort row [0, n2) in place (bitonic, shared or device memory) and write
// query q's selection: any n2 (a power of two).
__device__ void sort_row_mem(uint64_t* row, int n2, int64_t q, float rm,
                             const RowOut& o) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n2 / 2; i += nt) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const uint64_t a = row[lo], c = row[hi];
        if ((a > c) == asc) {
          row[lo] = c;
          row[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < o.k; j += nt) o.entry(q, j, row[j]);
  if (tid == 0) o.cert(q, rm, row[o.k - 1], row[o.k]);
  __syncthreads();
}

// Row j's sort and output: in registers where the row is in shared
// memory and n2 is 8 keys a thread, else in place.
__device__ void sort_row(uint64_t* row, int n2, bool in_smem, int64_t q,
                         float rm, const RowOut& o) {
  const int e = n2 / (int)blockDim.x;
  if (in_smem && e * (int)blockDim.x == n2 && e == 8)
    sort_row_regs<8>(row, n2, q, rm, o, threadIdx.x, blockDim.x, true);
  else
    sort_row_mem(row, n2, q, rm, o);
}

__device__ __forceinline__ void count_passes(int* stats, int passes) {
  if (stats != nullptr && threadIdx.x == 0)
    atomicAdd(stats + (passes < kMaxPasses ? passes : kMaxPasses - 1), 1);
}

// -- pool arm: the selection of a pool row ----------------------------------

constexpr int kPoolCols = 4;  // pool keys a thread a step

struct PoolSource {
  const uint64_t* row;
  int p_len;
  template <class V>
  __device__ __forceinline__ void scan(V& v) {
    const int nt = blockDim.x;
    for (int base = 0; base < p_len; base += kPoolCols * nt) {
      uint32_t hi[1][kPoolCols], lo[kPoolCols];
      bool valid[kPoolCols];
#pragma unroll
      for (int i = 0; i < kPoolCols; ++i) {
        const int c = base + threadIdx.x + i * nt;
        valid[i] = c < p_len;
        const uint64_t u = valid[i] ? row[c] : kMissing;
        hi[0][i] = (uint32_t)(u >> 32);
        lo[i] = (uint32_t)u;
      }
      v(hi, lo, valid);
    }
  }
};

// One block of kThreads per query of the chunk.  n2 is a power of two at
// least k + 1: the row's width, in dynamic shared memory (sharing it with
// the histogram) when scratch is null, else in scratch row r.
__global__ void __launch_bounds__(kThreads, 4) select_kernel(
    const uint64_t* __restrict__ pool, int p_len,
    const float* __restrict__ rem, int g, int k, int n2,
    uint64_t* __restrict__ scratch, const float* __restrict__ qnf,
    const float* __restrict__ pn_max_p, float coef, int row0,
    int* __restrict__ out_i, float* __restrict__ out_s,
    uint8_t* __restrict__ out_cert, int* __restrict__ stats) {
  extern __shared__ uint64_t s_dyn[];
  __shared__ SelState st[1];
  __shared__ PassView view[1];
  __shared__ unsigned long long n_app;
  __shared__ unsigned s_part[kThreads / 32];
  __shared__ float s_rem[kThreads / 32];
  const int tid = threadIdx.x;
  const int r = blockIdx.x;
  const int64_t q = (int64_t)row0 + r;
  unsigned* hist = reinterpret_cast<unsigned*>(s_dyn);
  uint64_t* buf = scratch != nullptr ? scratch + (int64_t)r * n2 : s_dyn;

  // The smallest rejected score of any block.
  float rm = INFINITY;
  if (rem != nullptr)
    for (int i = tid; i < g; i += kThreads)
      rm = fminf(rm, rem[(int64_t)r * g + i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    rm = fminf(rm, __shfl_xor_sync(0xffffffffu, rm, o));
  if ((tid & 31) == 0) s_rem[tid >> 5] = rm;
  if (tid == 0) init_state(st, k, true);
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) rm = fminf(rm, s_rem[w]);

  PoolSource src{pool + (int64_t)r * p_len, p_len};
  const int passes =
      select_passes<1>(src, st, view, &n_app, hist, 0, buf, 0, n2, s_part);
  const RowOut o{k, coef, qnf, pn_max_p, out_i, out_s, out_cert};
  sort_row(buf, n2, scratch == nullptr, q, rm, o);
  count_passes(stats, passes);
}

// -- direct arm: candidates rescored on every pass --------------------------

// kD > 0: d = kD at compile time (the axis loop unrolled); 0: d at run time.
template <bool kBf16, int kD>
struct DirectSource {
  const void* px;
  int ldp;
  const float* pn;
  const int* cid;
  int n_c, d, excl;
  // the queries' coordinates (kDirectQ, d), norms and ids, in shared
  // memory (the scoring loop is short of registers)
  const float* s_q;
  const float* s_qn;
  const int* s_self;

  template <class V>
  __device__ __forceinline__ void scan(V& v) {
    const int tid = threadIdx.x, dd = kD > 0 ? kD : d;
    for (int base = 0; base < n_c; base += kDirectCols * kThreads) {
      float acc[kDirectQ][kDirectCols], pv[kDirectCols], pnv[kDirectCols];
      int id[kDirectCols];
      bool valid[kDirectCols];
#pragma unroll
      for (int i = 0; i < kDirectCols; ++i) {
        const int c = base + tid + i * kThreads;
        valid[i] = c < n_c;
        pnv[i] = valid[i] ? pn[c] : 0.f;
        id[i] = valid[i] ? cid[c] : -1;
        pv[i] = valid[i] ? coord<kBf16>(px, ldp, c, 0) : 0.f;
      }
      // axis ax + 1 is loaded before axis ax is summed
      constexpr int kUnroll = kD > 0 ? kD : 1;
#pragma unroll kUnroll
      for (int ax = 0; ax < dd; ++ax) {
        float nx[kDirectCols];
#pragma unroll
        for (int i = 0; i < kDirectCols; ++i) {
          const int c = base + tid + i * kThreads;
          nx[i] = valid[i] && ax + 1 < dd ? coord<kBf16>(px, ldp, c, ax + 1)
                                          : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kDirectQ; ++j) {
          const float qv = s_q[j * dd + ax];
#pragma unroll
          for (int i = 0; i < kDirectCols; ++i)
            acc[j][i] = dot_step(acc[j][i], qv, pv[i], ax);
        }
#pragma unroll
        for (int i = 0; i < kDirectCols; ++i) pv[i] = nx[i];
      }
      uint32_t hi[kDirectQ][kDirectCols], lo[kDirectCols];
#pragma unroll
      for (int i = 0; i < kDirectCols; ++i) {
        lo[i] = (uint32_t)id[i];
#pragma unroll
        for (int j = 0; j < kDirectQ; ++j)
          hi[j][i] = pair_hi(s_qn[j], pnv[i], acc[j][i], id[i], s_self[j],
                             excl);
      }
      v(hi, lo, valid);
    }
  }
};

// One block of kThreads per kDirectQ queries of the chunk.  Dynamic shared
// memory: the queries' coordinates (kDirectQ * d floats, rounded up to 8
// bytes), then kDirectQ regions of rbytes, each a query's histogram and,
// when scratch is null, its row of n2 keys.
template <bool kBf16, int kD>
__global__ void __launch_bounds__(kThreads, 3) direct_kernel(
    const void* __restrict__ qx, int ldq, const float* __restrict__ qn,
    const int* __restrict__ qid, const void* __restrict__ px, int ldp,
    const float* __restrict__ pn, const int* __restrict__ cid, int row0,
    int n_rows, int n_c, int d, int k, int n2, int exclude_self,
    int qbytes, int rbytes, uint64_t* __restrict__ scratch,
    const float* __restrict__ qnf, const float* __restrict__ pn_max_p,
    float coef, int* __restrict__ out_i, float* __restrict__ out_s,
    uint8_t* __restrict__ out_cert, int* __restrict__ stats) {
  extern __shared__ uint64_t s_dyn[];
  __shared__ SelState st[kDirectQ];
  __shared__ PassView view[kDirectQ];
  __shared__ unsigned long long n_app;
  __shared__ unsigned s_part[kDirectQ * kThreads / 32];
  __shared__ float s_qn[kDirectQ];
  __shared__ int s_self[kDirectQ];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kDirectQ;  // first row of the chunk
  float* s_q = reinterpret_cast<float*>(s_dyn);
  char* regions = reinterpret_cast<char*>(s_dyn) + qbytes;
  unsigned* hist = reinterpret_cast<unsigned*>(regions);
  uint64_t* buf;
  int64_t bstride;
  if (scratch != nullptr) {
    buf = scratch + (int64_t)r0 * n2;
    bstride = n2;
  } else {
    buf = reinterpret_cast<uint64_t*>(regions);
    bstride = rbytes / 8;
  }

  for (int t = tid; t < kDirectQ * d; t += kThreads) {
    const int j = t / d, ax = t - j * d;
    const int r = r0 + j < n_rows ? r0 + j : n_rows - 1;
    s_q[t] = coord<kBf16>(qx, ldq, (int64_t)row0 + r, ax);
  }
  if (tid < kDirectQ) {
    const int r = r0 + tid < n_rows ? r0 + tid : n_rows - 1;
    s_qn[tid] = qn[(int64_t)row0 + r];
    s_self[tid] = qid[(int64_t)row0 + r];
    init_state(st + tid, k, r0 + tid < n_rows);
  }
  __syncthreads();

  DirectSource<kBf16, kD> src;
  src.px = px;
  src.ldp = ldp;
  src.pn = pn;
  src.cid = cid;
  src.n_c = n_c;
  src.d = d;
  src.excl = exclude_self;
  src.s_q = s_q;
  src.s_qn = s_qn;
  src.s_self = s_self;
  const int passes = select_passes<kDirectQ>(
      src, st, view, &n_app, hist, rbytes / 4, buf, bstride, n2, s_part);
  const RowOut o{k, coef, qnf, pn_max_p, out_i, out_s, out_cert};
  const int live = n_rows - r0 < kDirectQ ? n_rows - r0 : kDirectQ;
  if (scratch == nullptr && n2 == 16 * (kThreads / 2)) {
    // two rows at a time, half the block each
    const int half = tid / (kThreads / 2);
    for (int p = 0; p < kDirectQ; p += 2) {
      const int j = p + half;
      sort_row_regs<16>(buf + j * bstride, n2, (int64_t)row0 + r0 + j,
                        INFINITY, o, tid - half * (kThreads / 2),
                        kThreads / 2, j < live);
    }
  } else {
    for (int j = 0; j < live; ++j)
      sort_row(buf + j * bstride, n2, scratch == nullptr,
               (int64_t)row0 + r0 + j, INFINITY, o);
  }
  count_passes(stats, passes);
}

template <bool kBf16, int kD>
cudaError_t launch_direct(
    unsigned blocks, size_t smem, cudaStream_t s, const void* qx, int ldq,
    const float* qn, const int* qid, const void* px, int ldp, const float* pn,
    const int* cid, int row0, int n_rows, int n_c, int d, int k, int n2,
    int exclude_self, int qbytes, int rbytes, uint64_t* scratch,
    const float* qnf, const float* pn_max, float coef, int* out_i,
    float* out_s, uint8_t* out_cert, int* stats) {
  const cudaError_t err = cudaFuncSetAttribute(
      direct_kernel<kBf16, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  direct_kernel<kBf16, kD><<<blocks, kThreads, smem, s>>>(
      qx, ldq, qn, qid, px, ldp, pn, cid, row0, n_rows, n_c, d, k, n2,
      exclude_self, qbytes, rbytes, scratch, qnf, pn_max, coef, out_i, out_s,
      out_cert, stats);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One chunk of n_rows queries from row0 into rows row0.. of the (n_q, k)
// outputs.  direct: the direct arm (m >= 128; pool and rem unused), else
// the fold into pool (n_rows, (n_c / 128) * min(m, 128)) and rem (n_rows,
// n_c / 128; m < 128 only) and the pool's selection.  bf16 selects the
// tier and the layouts of qx / px (see coord); qns and pns are the scoring
// norms, qnf the queries' f32 norms, pn_max the largest f32 norm of a real
// candidate.  n2 is a power of two at least k + 1; scratch, (n_rows, n2)
// keys, is used (and must be given) when n2 exceeds kSmemSortKeys (pool)
// or kDirectSmemKeys (direct).  stats, when not null, (kMaxPasses,) ints:
// stats[p] counts the selection blocks that made p passes over their key
// source (candidates or a pool row).  n_c a multiple of 128; pool arm
// n_rows <= 65535 * 8.
int mxu_select_split_launch(int direct, int bf16, const void* qx, int ldq,
                            const float* qns, const float* qnf,
                            const int* qid, const void* px, int ldp,
                            const float* pns, const int* cid,
                            const float* pn_max, int row0, int n_rows,
                            int n_c, int d, int k, int m, int exclude_self,
                            float coef, uint64_t* pool, float* rem,
                            uint64_t* scratch, int n2, int* out_i,
                            float* out_s, uint8_t* out_cert, int* stats,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (direct) {
    // 16-bit counts of appended keys a query (Visit::n_app)
    if (n2 > kDirectMaxKeys) return (int)cudaErrorInvalidValue;
    const bool in_smem = n2 <= kDirectSmemKeys;
    if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int qbytes = (kDirectQ * d * 4 + 7) / 8 * 8;
    const int hbytes = kBins * 4;
    const int rbytes = in_smem && n2 * 8 > hbytes ? n2 * 8 : hbytes;
    const size_t smem = (size_t)qbytes + (size_t)kDirectQ * rbytes;
    const unsigned blocks = (unsigned)((n_rows + kDirectQ - 1) / kDirectQ);
    uint64_t* sc = in_smem ? nullptr : scratch;
    // d = 3, the port's clouds, compiled with its axis count
    const auto launch = bf16 ? (d == 3 ? launch_direct<true, 3>
                                       : launch_direct<true, 0>)
                             : (d == 3 ? launch_direct<false, 3>
                                       : launch_direct<false, 0>);
    return (int)launch(blocks, smem, s, qx, ldq, qns, qid, px, ldp, pns,
                       cid, row0, n_rows, n_c, d, k, n2, exclude_self, qbytes,
                       rbytes, sc, qnf, pn_max, coef, out_i, out_s, out_cert,
                       stats);
  }
  const int g = n_c / kBlock;
  const int me = m < kBlock ? m : kBlock;
  const dim3 grid((unsigned)g, (unsigned)((n_rows + kFoldWarps - 1) /
                                          kFoldWarps));
  if (bf16)
    fold_kernel<true><<<grid, kFoldWarps * 32, 0, s>>>(
        qx, ldq, qns, qid, px, ldp, pns, cid, row0, n_rows, d, me,
        exclude_self, pool, rem);
  else
    fold_kernel<false><<<grid, kFoldWarps * 32, 0, s>>>(
        qx, ldq, qns, qid, px, ldp, pns, cid, row0, n_rows, d, me,
        exclude_self, pool, rem);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool in_smem = n2 <= kSmemSortKeys;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int hbytes = kBins * 4;
  const size_t smem = in_smem && n2 * 8 > hbytes ? (size_t)n2 * 8 : hbytes;
  err = cudaFuncSetAttribute(select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  select_kernel<<<(unsigned)n_rows, kThreads, smem, s>>>(
      pool, g * me, me < kBlock ? rem : nullptr, g, k, n2,
      in_smem ? nullptr : scratch, qnf, pn_max, coef, row0, out_i, out_s,
      out_cert, stats);
  return (int)cudaGetLastError();
}

const char* mxu_select_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
