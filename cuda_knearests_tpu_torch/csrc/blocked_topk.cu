// Blocked two-stage supercell top-k (KnnConfig.kernel='blocked') for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel_blocked of
// cuda_knearests_tpu/ops/pallas_solve.py (:168), launched by _pallas_topk
// (:659) with kernel='blocked'.  For each query slot of a class pack (the
// same inputs as csrc/supercell_topk.cu), with
//   d2 = ((qx-cx)^2 + (qy-cy)^2) + (qz-cz)^2,
// every op rounded on its own (intrinsics, --fmad=false), pads (id ==
// PAD_C) and, with exclude_self, the query's own id skipped, and keys in
// (d2, id) order:
//   stage 1: each 128-slot candidate block keeps its first m keys; rem =
//            the smallest d2 a block did not keep (inf where m = 128);
//   stage 2: the row is the first k keys of the kept pool, ascending;
//   deficit: when rem < t strictly (t = the row's k-th d2, inf when the
//            pool holds fewer than k), a hidden candidate could beat the
//            row's k-th entry: d2 at column k-1 becomes NaN, which fails
//            the solve's certificate (NaN <= margin is false), so the row
//            goes to the exact fallback.
// Missing entries are (inf, -1).  Output modes as in supercell_topk.cu:
// (a) rows at tgt[slot] of (n, k) buffers, (b) the raw (S, k, Q) layout.
//
// What bounds it on this card.  The same pair arithmetic as the one-stage
// kernel (~8 float ops per (query, candidate) pair against 16 bytes of
// candidate data shared by the supercell's queries): operations, not
// bytes.
//
// Why the exact top-k answers most rows.  Let T be the query's first k
// keys over all its candidates (fewer if it has fewer), t its k-th d2.
// Suppose no block holds more than m entries of T.  Then
//   (i) T's entries in a block are that block's first keys (a key of the
//       block below an entry of T is itself in T), at most m of them, so
//       the block keeps them all: the pool holds T, and the first k of the
//       pool is T;
//  (ii) a block's (m+1)-th key, if it is a real candidate, is not in T (or
//       T would hold the block's first m+1 keys), so it follows T's k-th
//       key and its d2 is at least t; where T holds fewer than k entries
//       every real key is in T, so no block has a real (m+1)-th key.
//       Either way rem >= t: no NaN.
// So such a row is T with t at column k-1, exactly the one-stage kernel's
// row.  Only a row where some block holds more than m of T can differ: a
// deficit, or (rem == t) the first k of a pool that misses part of T.
// Under config.blocked_topm's m, with the pack's slots interleaved across
// blocks, such rows are rare.
//
// What the design does about it.  The first Hopper version ran a thread
// per query slot with two sorted lists in shared memory (the running k and
// the current block's m), a divergent shift loop on every insertion, every
// block's survivors re-offered at its end, and no stop rule: 4.2x the
// one-stage kernel on the same packs.  Here the one-stage kernel's
// warp-per-query structure (warp_topk.cuh: center-out staging, register
// lists, ballot survivors inserted with shuffles, the stop once a row's
// shell lies beyond the k-th distance) computes T, which the stop leaves
// exact.  Each list entry carries the pack slot of its candidate in a
// second register array, moved by the same shuffles (its block is slot /
// 128; staging keeps each staged row's tile-local slot as a u16 after the
// rows, and between tiles of a wide class a list waits in its output row
// as (d2, slot)).  At the end a warp counts T's entries per block
// (__match_any_sync at E = 1, shuffles above).  Where no count exceeds m
// it writes T.  Otherwise it re-answers the row literally in the same
// launch: it walks the blocks, sorts each block's 128 keys across the
// warp (bitonic, 4 a lane), offers the first m to a fresh register list
// and folds the (m+1)-th into rem, then applies the NaN rule.  It starts
// at the block of the nearest candidate and skips a block whose smallest
// key is not below the list's k-th (exact: see reanswer).  That path costs
// up to G sorts of 128 keys a row (G = ccap / 128), and matters only on
// packs that crowd neighbours into a block.
//
// Plain C interface, loaded with ctypes.  The launcher allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include "warp_topk.cuh"

namespace {

constexpr int kBlock = 128;  // candidate slots per stage-1 block

// Shared memory of one block staging tiles of ``tile`` candidates: the
// 16-byte rows and their u16 tile-local slots.
inline size_t smem_of(int tile) { return (size_t)18 * tile; }

// Whether some block holds more than m entries of the list (v, slots s):
// the same answer on every lane.
template <int E>
__device__ __forceinline__ bool overflows(const u64 (&v)[E],
                                          const unsigned (&s)[E], int k,
                                          int m, int lane) {
  if (m >= k) return false;
  unsigned b[E];
  bool real[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    real[e] = v[e] != 0ull && v[e] != kEmpty;
    // positions off the list get distinct values that no block takes
    b[e] = real[e] ? s[e] / kBlock : 0x80000000u | (unsigned)(32 * e + lane);
  }
  bool over = false;
  if constexpr (E == 1) {
    // every lane takes part in the match (no short-circuit before it)
    const int same = __popc(__match_any_sync(kFull, b[0]));
    over = real[0] && same > m;
  } else {
    int cnt[E];
#pragma unroll
    for (int e = 0; e < E; ++e) cnt[e] = 0;
#pragma unroll
    for (int e2 = 0; e2 < E; ++e2) {
#pragma unroll 1
      for (int src = 0; src < 32; ++src) {
        const unsigned x = __shfl_sync(kFull, b[e2], src);
#pragma unroll
        for (int e = 0; e < E; ++e) cnt[e] += x == b[e];
      }
    }
#pragma unroll
    for (int e = 0; e < E; ++e) over |= real[e] && cnt[e] > m;
  }
  return __any_sync(kFull, over);
}

// The row of the query at (px, py, pz) answered literally: for each block
// its 128 keys (pads and the query itself at kEmpty) sorted across the
// warp, the first m offered to a fresh list, the d2 of the (m+1)-th folded
// into rem.  Leaves the first k keys of the kept pool in v and returns rem.
// The order of the blocks changes neither result, so they go from
// ``first`` (the block of the query's nearest candidate) on in slot order,
// wrapping, and a block whose smallest key is not below the list's k-th
// is skipped: none of its keys enters the list, and its (m+1)-th d2 is at
// least the k-th d2 now, so at least the final t, where it cannot decide
// "rem < t".
template <int E>
__device__ float reanswer(u64 (&v)[E], const float* __restrict__ cx,
                          const float* __restrict__ cy,
                          const float* __restrict__ cz,
                          const int* __restrict__ cid, int64_t cbase,
                          int ccap, int first, float px, float py, float pz,
                          unsigned self1, int k, int m, int lane) {
  const int base = 32 * E - k, g = ccap / kBlock;
  unsigned s[E];  // unused: no slots carried
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = 32 * e + lane < base ? 0ull : kEmpty;
  u64 kth = kEmpty;
  float rem = INFINITY;
  for (int i = 0, b = first; i < g; ++i, b = b + 1 < g ? b + 1 : 0) {
    const int64_t b0 = cbase + (int64_t)b * kBlock;
    u64 key[4];
    unsigned none[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t c = b0 + 32 * j + lane;
      const int id = cid[c];
      key[j] = id == kPadC ? kEmpty
               : cand_key(make_float4(cx[c], cy[c], cz[c],
                                      __uint_as_float((unsigned)id + 1u)),
                          px, py, pz);
      if ((unsigned)key[j] == self1) key[j] = kEmpty;
    }
    u64 lo = key[0] < key[1] ? key[0] : key[1];
    lo = key[2] < lo ? key[2] : lo;
    lo = key[3] < lo ? key[3] : lo;
    for (int o = 16; o > 0; o >>= 1) {
      const u64 x = shfl_xor_u64(lo, o);
      lo = x < lo ? x : lo;
    }
    if (lo >= kth) continue;
    warp_sort<4, false>(key, none, lane);
    if (m < kBlock) {  // the block's (m+1)-th key
      u64 x = key[0];
#pragma unroll
      for (int j = 1; j < 4; ++j) x = j == (m >> 5) ? key[j] : x;
      rem = fminf(rem, key_d2(shfl_u64(x, m & 31)));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (32 * j >= m) break;
      take<E, false>(32 * j + lane < m ? key[j] : kEmpty, 0u, v, s, kth,
                     lane, base >> 5, nullptr, 0u);
    }
  }
  return rem;
}

// Lists of up to 64 entries (E <= 2) run five 8-warp blocks an SM, as in
// supercell_topk.cu, where the staged tile leaves room for five (on an
// H100 five beat four at 900k/k=10, 1.30 against 1.39 ms, though the
// 48-register cap spills a few bytes at E <= 2).
template <int E>
__global__ void __launch_bounds__(kMaxWarps * 32, E <= 2 ? 5 : 1)
    blocked_topk_kernel(
    const float* __restrict__ qx, const float* __restrict__ qy,
    const float* __restrict__ qz, const int* __restrict__ qid,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const int* __restrict__ cid,
    int qcap, int ccap, int k, int m, int exclude_self,
    const int* __restrict__ tgt, int n_rows,
    float* __restrict__ out_d, int* __restrict__ out_i, int tile,
    int qchunk) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t sc = blockIdx.x;
  const int q0 = blockIdx.y * qchunk;
  const int nq = min(qchunk, qcap - q0);
  const int64_t qbase = sc * qcap + q0;
  const int64_t cbase = sc * ccap;
  // ccap == 0 still takes one (empty) tile, so every row is written
  const int n_tiles = max(1, (ccap + tile - 1) / tile);

  if (!stage_queries(qx, qy, qz, qid, tgt, n_rows, qbase, nq)) return;
  const float mx = s_center[0], my = s_center[1], mz = s_center[2];
  unsigned short* slot = reinterpret_cast<unsigned short*>(s_rows + tile);
  const int base = 32 * E - k;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * tile;
    const int n = max(0, min(tile, ccap - c0));
    const bool last = t + 1 == n_tiles;
    if (t > 0) __syncthreads();  // every warp is done with the last tile
    stage<true>(cx, cy, cz, cid, cbase + c0, n, (n + 31) & ~31, mx, my, mz,
                slot);
    for (int q = warp; q < nq; q += warps) {
      const int row = s_target[q];
      if (row < 0) continue;
      const float4 sq = s_query[q];
      const float px = sq.x, py = sq.y, pz = sq.z;
      // no real candidate's id + 1 is 0
      const unsigned self1 =
          exclude_self ? (unsigned)__float_as_int(sq.w) + 1u : 0u;
      const float rho =
          sqrtf(center_d2(px, py, pz, mx, my, mz)) * (1.f + kSlack);
      u64 v[E];
      unsigned s[E];  // pack slot of each real entry
      u64 kth = kEmpty;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = e * 32 + lane - base;
        v[e] = j < 0 ? 0ull : kEmpty;
        s[e] = 0u;
        if (j >= 0 && t > 0) {  // the list parked as (d2, slot)
          const int64_t o = tgt != nullptr ? (int64_t)row * k + j
                                           : (sc * k + j) * qcap + q0 + q;
          const float d = out_d[o];
          if (!isinf(d)) {
            s[e] = (unsigned)out_i[o];
            v[e] = ((u64)__float_as_uint(d) << 32) |
                   ((unsigned)cid[cbase + s[e]] + 1u);
          }
        }
      }
      if (t > 0) kth = shfl_u64(v[E - 1], 31);
      scan<E, true>(px, py, pz, rho, self1, k, t == 0, v, s, kth, lane,
                    slot, (unsigned)c0);
      float rem = INFINITY;
      if (last && overflows<E>(v, s, k, m, lane)) {
        unsigned s0 = s[0];  // the slot of the list's first entry
#pragma unroll
        for (int e = 1; e < E; ++e) s0 = e == base >> 5 ? s[e] : s0;
        s0 = __shfl_sync(kFull, s0, base & 31);
        rem = reanswer<E>(v, cx, cy, cz, cid, cbase, ccap,
                          (int)(s0 / kBlock) % (ccap / kBlock), px, py, pz,
                          self1, k, m, lane);
      }
      const float t_d = key_d2(shfl_u64(v[E - 1], 31));
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = e * 32 + lane - base;
        if (j < 0) continue;
        const float d = key_d2(v[e]);
        const int64_t o =
            tgt != nullptr ? (int64_t)row * k + j               // mode (a)
                           : (sc * k + j) * qcap + q0 + q;      // mode (b)
        if (!last) {  // park until the next tile
          out_d[o] = d;
          out_i[o] = (int)s[e];
          continue;
        }
        out_d[o] = j == k - 1 && rem < t_d ? NAN : d;
        out_i[o] = isinf(d) ? -1 : (int)((unsigned)v[e] - 1u);
      }
    }
  }
}

template <int E>
int launch(const float* qx, const float* qy, const float* qz, const int* qid,
           const float* cx, const float* cy, const float* cz, const int* cid,
           int n_sc, int qcap, int ccap, int k, int m, int exclude_self,
           const int* tgt, int n_rows, float* out_d, int* out_i, int warps,
           int tile, int qchunk, cudaStream_t stream) {
  const size_t smem = smem_of(tile);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_topk_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_sc, (unsigned)((qcap + qchunk - 1) / qchunk));
  blocked_topk_kernel<E><<<grid, warps * 32, smem, stream>>>(
      qx, qy, qz, qid, cx, cy, cz, cid, qcap, ccap, k, m, exclude_self, tgt,
      n_rows, out_d, out_i, tile, qchunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one block staging tiles of ``tile`` candidates.
size_t blocked_topk_smem_bytes(int tile) { return smem_of(tile); }

// Launch one block of ``warps`` warps per (supercell, chunk of ``qchunk``
// query slots), lists of ``lane_entries`` entries a lane (1, 2, 4, 8, 16
// or 28; 32 * lane_entries >= k), candidates staged ``tile`` (a multiple
// of 32, at most kMaxTile) at a time.  ccap must be a multiple of 128 and
// 1 <= m <= 128.  tgt == NULL selects mode (b).  Returns
// cudaGetLastError() (0 = launched).
int blocked_topk_launch(const float* qx, const float* qy, const float* qz,
                        const int* qid, const float* cx, const float* cy,
                        const float* cz, const int* cid, int n_sc, int qcap,
                        int ccap, int k, int m, int exclude_self,
                        const int* tgt, int n_rows, float* out_d,
                        int* out_i, int warps, int lane_entries, int tile,
                        int qchunk, void* stream) {
  if (warps < 1 || warps > kMaxWarps || tile < 32 || tile % 32 != 0 ||
      tile > kMaxTile || qchunk < 1 || qchunk > kMaxChunk || k < 1 ||
      32 * lane_entries < k || m < 1 || m > kBlock || ccap % kBlock != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define BLOCKED_TOPK_CASE(E)                                                 \
  case E:                                                                    \
    return launch<E>(qx, qy, qz, qid, cx, cy, cz, cid, n_sc, qcap, ccap, k,  \
                     m, exclude_self, tgt, n_rows, out_d, out_i, warps,      \
                     tile, qchunk, st);
  switch (lane_entries) {
    BLOCKED_TOPK_CASE(1)
    BLOCKED_TOPK_CASE(2)
    BLOCKED_TOPK_CASE(4)
    BLOCKED_TOPK_CASE(8)
    BLOCKED_TOPK_CASE(16)
    BLOCKED_TOPK_CASE(28)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BLOCKED_TOPK_CASE
}

const char* blocked_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
