// Supercell top-k: the exact k nearest candidates of every packed query slot
// of one capacity class, for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of cuda_knearests_tpu/ops/pallas_solve.py
// that carry the all-points solve:
//   * _kernel_rows (:480), launched by _pallas_topk_rows -- row-major output
//     placed at the destination rows of the scatter epilogue: mode (a) here,
//     which writes each query's row straight to its final row tgt[slot];
//   * _kernel (:117), launched by _pallas_topk -- the raw (S, k, Q) layout:
//     mode (b) here.
// Both make the same selection: for each query slot, the first k candidates
// of its supercell in (d2, stored id) lexicographic order, where
//   d2 = ((qx-cx)^2 + (qy-cy)^2) + (qz-cz)^2,
// every multiply and add rounded on its own in that order (no contraction:
// the intrinsics below, and the build passes --fmad=false), pad candidates
// (id == PAD_C) skipped, and the query's own stored id skipped when
// exclude_self is set.  Rows are ascending; missing slots are (inf, -1).
// Mode (a) skips pad query slots (target outside [0, n_rows)); mode (b)
// answers every slot, pads included, as the plain version does.
//
// What bounds it on this card.  The work is one distance and one compare
// per (query, candidate) pair of a supercell: ~8 float operations on 16
// bytes of candidate data that every query of the supercell shares.  Read
// once from device memory, the candidates cost far less time than the pair
// arithmetic (~10^9 pairs for a 900k-point cloud at k=10), so the kernel is
// bound by operations -- instruction issue -- not by bytes.
//
// What the design does about it.  The TPU kernel held a whole (Q, C)
// distance tile in VMEM and ran k min-and-mask passes over it.  This
// kernel's first Hopper version ran one thread per query slot with a sorted
// list in shared memory: a divergent shift loop ran whenever any of 32
// lanes improved and lasted as long as the longest shift, so most of the
// issued work at k=10, and nearly all of it at k=50, was insertion.  Here
// selection is warp-uniform and its work follows the real insertions:
//   * one block per (supercell, chunk of query slots) stages the
//     supercell's candidates once in shared memory as (x, y, z, id + 1)
//     rows of 16 bytes, bucketed center-out: 31 shells of equal squared
//     distance to the center of the chunk's queries (a counting sort with
//     shared-memory atomics), then pads and the ragged tail as (inf, inf,
//     inf, 0xffffffff), which no query selects.  A class whose ccap
//     exceeds the tile takes its candidates tile by tile, each tile
//     staged once per block and ordered about the same center; between
//     tiles a query's list waits in its output row;
//   * a warp owns one query at a time, and each lane scores one candidate
//     of a row of 32 (one 16-byte shared load);
//   * keys are (bits(d2) << 32) | (id + 1): a non-negative float's bits
//     order like the float, so one 64-bit compare is the (d2, id) order;
//   * the query's list lives in registers, E entries a lane (32*E >= k),
//     ascending over positions e*32 + lane and aligned to the END, so
//     position 32*E - 1 is always the k-th entry (slot E-1 of lane 31);
//     the positions before the list hold key 0, below every real key;
//   * the first row (the 32 candidates nearest the center) is sorted
//     across the warp (bitonic, 15 steps) and placed as the list's first
//     entries, so the k-th key starts near its final value;
//   * after that, __ballot_sync of "key < k-th" picks a row's survivors;
//     each is broadcast, re-tested against the k-th (which falls as the
//     list fills), and inserted by every lane at once: an entry below the
//     new key stays, the others take their predecessor's (one shuffle a
//     slot) or the new key.  That is O(E) uniform instructions a real
//     insertion, with no divergent loop;
//   * rows come in ascending shells, so once a row's lowest center
//     distance, less the query's own (both with a relative slack far above
//     float rounding), exceeds the k-th distance, the warp stops: no later
//     candidate can enter the list.  The order and the stop change the
//     work, never the selection;
//   * pad query slots cost nothing in mode (a): a warp skips them, and a
//     chunk of pad slots returns at once.
// Work per query is O(C'/32 + insertions * E) warp instructions, where C'
// is the candidates inside the query's stopping shell; in center-out order
// the k-th falls early, so far fewer candidates insert than the ~k(1 +
// ln(C/k)) of an unordered scan.  k is a runtime argument; E is a template
// argument chosen by the launcher, so the lists stay in registers.
//
// Plain C interface, loaded with ctypes.  The launcher allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kPadC = -3;        // pad candidate id (cuda_solve._PAD_C)
constexpr int kMaxWarps = 8;     // warps per block (cuda_solve._TOPK_WARPS)
constexpr int kMaxTile = 3072;   // staged candidates (cuda_solve._TOPK_TILE)
constexpr int kMaxChunk = 128;   // query slots a block (16 a warp at most)
constexpr unsigned kFull = 0xffffffffu;
// (inf, all-ones id): the key of an empty list entry and of a staged pad;
// every real candidate's key is smaller.
constexpr u64 kEmpty = 0x7f800000ffffffffull;

// Shared memory of one block staging tiles of ``tile`` candidates.
inline size_t smem_of(int tile) { return (size_t)16 * tile; }

__device__ __forceinline__ u64 shfl_u64(u64 v, int src) {
  const unsigned lo = __shfl_sync(kFull, (unsigned)v, src);
  const unsigned hi = __shfl_sync(kFull, (unsigned)(v >> 32), src);
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 shfl_xor_u64(u64 v, int mask) {
  const unsigned lo = __shfl_xor_sync(kFull, (unsigned)v, mask);
  const unsigned hi = __shfl_xor_sync(kFull, (unsigned)(v >> 32), mask);
  return ((u64)hi << 32) | lo;
}

// The key of staged candidate c for the query at (px, py, pz).
__device__ __forceinline__ u64 cand_key(float4 c, float px, float py,
                                        float pz) {
  const float dx = __fsub_rn(px, c.x);
  const float dy = __fsub_rn(py, c.y);
  const float dz = __fsub_rn(pz, c.z);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return ((u64)__float_as_uint(d) << 32) | __float_as_uint(c.w);
}

// Ascending bitonic sort of one key a lane across the warp.
__device__ __forceinline__ u64 warp_sort(u64 key, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = shfl_xor_u64(key, stride);
      const bool keep_min = ((lane & size) == 0) == ((lane & stride) == 0);
      const bool o_less = o < key;
      key = (keep_min == o_less) ? o : key;
    }
  }
  return key;
}

// Insert nk (below the k-th entry) into the list: every position whose
// entry is not below nk takes its predecessor's entry, or nk where the
// predecessor is below it; the k-th entry drops out.  Slots below e_lo
// hold only positions before the list and never change.
template <int E>
__device__ __forceinline__ void insert(u64 (&v)[E], u64 nk, int lane,
                                       int e_lo) {
#pragma unroll
  for (int e = E - 1; e >= 0; --e) {
    if (e < e_lo) break;
    // lane 31 hands the previous slot's entry to lane 0 (a rotation)
    const u64 w = lane == 31 ? (e == 0 ? 0ull : v[e > 0 ? e - 1 : 0]) : v[e];
    const u64 up = shfl_u64(w, (lane + 31) & 31);
    v[e] = v[e] < nk ? v[e] : (up < nk ? nk : up);
  }
}

// Real candidates go to kBuckets - 1 shells of equal squared center
// distance; pads and the ragged tail to the last bucket.
constexpr int kBuckets = 32;
constexpr int kPadBucket = kBuckets - 1;
// Relative slack of the pruning bound: far above the rounding of the
// distances it bounds (a few units of 2^-24).
constexpr float kSlack = 1e-4f;

// The block's staging area (file-scope, so every access is a direct
// shared-memory address): a tile of candidate rows in center-out order,
// per row of 32 a lower bound on its candidates' center distance (inf for
// rows of pads), the buckets' counters and starts, the largest squared
// center distance (float bits), the tile's real candidates and the center;
// and the block's query slots (x, y, z, bits of the stored id) with their
// output rows (-1: a pad slot that mode (a) skips).
extern __shared__ float4 s_rows[];
__shared__ float s_row_lo[kMaxTile / 32];
__shared__ int s_count[kBuckets], s_start[kBuckets], s_n_real;
__shared__ unsigned s_d2max;
__shared__ float s_center[3];
__shared__ float4 s_query[kMaxChunk];
__shared__ int s_target[kMaxChunk];

__device__ __forceinline__ float center_d2(float x, float y, float z,
                                           float mx, float my, float mz) {
  const float dx = x - mx, dy = y - my, dz = z - mz;
  return dx * dx + dy * dy + dz * dz;
}

// Candidate j of the tile (its row and its bucket), j < n_pad.
__device__ __forceinline__ int tile_row(
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const int* __restrict__ cid,
    int64_t cbase, int j, int n, float mx, float my, float mz, float scale,
    float4& row) {
  row = make_float4(INFINITY, INFINITY, INFINITY, __uint_as_float(kFull));
  if (j >= n) return kPadBucket;
  const int id = cid[cbase + j];
  if (id == kPadC) return kPadBucket;
  row = make_float4(cx[cbase + j], cy[cbase + j], cz[cbase + j],
                    __uint_as_float((unsigned)id + 1u));
  const float d2 = center_d2(row.x, row.y, row.z, mx, my, mz);
  return min(kPadBucket - 1, (int)(d2 * scale));
}

// Stage candidates [0, n) of the tile at cbase into s_rows[0, n_pad), in
// buckets of ascending squared distance to the center (mx, my, mz), pads
// and the tail last; fill s_row_lo and s_n_real.  The order only speeds
// the scan: the selection does not depend on it.  Called by every thread
// of the block; ends with a barrier.
__device__ void stage(const float* __restrict__ cx,
                      const float* __restrict__ cy,
                      const float* __restrict__ cz,
                      const int* __restrict__ cid, int64_t cbase, int n,
                      int n_pad, float mx, float my, float mz) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float4 row;
  if (tid < kBuckets) s_count[tid] = 0;
  if (tid == 0) s_d2max = 0u;
  __syncthreads();
  unsigned mine = 0u;  // bits of a non-negative float order like it
  for (int j = tid; j < n; j += nt) {
    const int id = cid[cbase + j];
    if (id != kPadC) {
      mine = max(mine, __float_as_uint(center_d2(
          cx[cbase + j], cy[cbase + j], cz[cbase + j], mx, my, mz)));
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    mine = max(mine, __shfl_xor_sync(kFull, mine, o));
  if ((tid & 31) == 0) atomicMax(&s_d2max, mine);
  __syncthreads();
  const float d2max = __uint_as_float(s_d2max);
  const float scale = d2max > 0.f ? kPadBucket / d2max : 0.f;
  for (int j = tid; j < n_pad; j += nt) {
    atomicAdd(&s_count[tile_row(cx, cy, cz, cid, cbase, j, n, mx, my, mz,
                                 scale, row)], 1);
  }
  __syncthreads();
  if (tid < 32) {  // exclusive scan of the kBuckets = 32 counts
    const int c = s_count[tid];
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, o);
      if (tid >= o) incl += up;
    }
    s_start[tid] = incl - c;
    s_count[tid] = incl - c;  // the scatter's cursors
    if (tid == kPadBucket) s_n_real = incl - c;
  }
  __syncthreads();
  for (int j = tid; j < n_pad; j += nt) {
    const int b = tile_row(cx, cy, cz, cid, cbase, j, n, mx, my, mz, scale,
                           row);
    s_rows[atomicAdd(&s_count[b], 1)] = row;
  }
  for (int r = tid; r < n_pad / 32; r += nt) {
    int b = 0;  // the bucket of the row's first position
    while (b + 1 < kBuckets && s_start[b + 1] <= 32 * r) ++b;
    // bucket b holds squared center distances of at least b / scale
    s_row_lo[r] = b == kPadBucket ? INFINITY
                   : sqrtf(b * (d2max / kPadBucket)) * (1.f - kSlack);
  }
  __syncthreads();
}

// Offer a row of keys, one a lane, to the list: the survivors of "key <
// k-th", in lane order, each re-tested against the falling k-th.
template <int E>
__device__ __forceinline__ void take(u64 key, unsigned self1, u64 (&v)[E],
                                     u64& kth, int lane, int e_lo) {
  unsigned mask = __ballot_sync(kFull, key < kth);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const u64 nk = shfl_u64(key, src);
    if (nk >= kth || (unsigned)nk == self1) continue;
    insert<E>(v, nk, lane, e_lo);
    kth = shfl_u64(v[E - 1], 31);
  }
}

// One warp's pass over the staged tile for its query, whose distance to
// the tile's center is at most rho.  ``first``: the list is empty and this
// is the first tile, whose first row is sorted into it.  Rows are in
// ascending bucket order, so once a row's center distance bound minus rho
// exceeds the k-th distance, no later candidate can enter the list.  Rows
// go two at a time (the second never tested for the stop: scanning it
// anyway changes nothing).
template <int E>
__device__ __forceinline__ void scan(float px, float py, float pz, float rho,
                                     unsigned self1, int k, bool first,
                                     u64 (&v)[E], u64& kth, int lane) {
  const int n_rows = (s_n_real + 31) >> 5;
  const int base = 32 * E - k;  // the list's first position
  const int e_lo = base >> 5;
  const float4* rows = s_rows + lane;
  int r = 0;
  if (first && n_rows > 0) {
    u64 key = cand_key(rows[0], px, py, pz);
    if ((unsigned)key == self1) key = kEmpty;
    key = warp_sort(key, lane);
    // sorted entry j goes to position base + j
    const int e0 = base >> 5, off = base & 31;
    const u64 x = shfl_u64(key, (lane - off) & 31);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[e] = e < e0 ? 0ull
             : e == e0 ? (lane >= off ? x : 0ull)
             : (e == e0 + 1 && lane < off) ? x : kEmpty;
    }
    kth = shfl_u64(v[E - 1], 31);
    r = 1;
  }
  for (; r < n_rows; r += 2) {
    // every candidate from row r on lies at least g from the query
    const float g = fmaxf(s_row_lo[r] - rho, 0.f);
    const float g2 = g * g * (1.f - kSlack);
    if (g2 > 1e-30f && g2 > __uint_as_float((unsigned)(kth >> 32))) break;
    const u64 k0 = cand_key(rows[32 * r], px, py, pz);
    const u64 k1 =
        r + 1 < n_rows ? cand_key(rows[32 * r + 32], px, py, pz) : kEmpty;
    take<E>(k0, self1, v, kth, lane, e_lo);
    take<E>(k1, self1, v, kth, lane, e_lo);
  }
}

// Lists of up to 64 entries (E <= 2) keep to 51 registers, so five 8-warp
// blocks -- 40 warps -- can share an SM and hide more of each query's
// latency.  Shared memory allows five only where the staged tile is at
// most ~2,500 candidates (5 x (16 * tile + 3,232 static + 1,024 reserved)
// <= 228 KB), as in the 900k/k=10 and 300k/k=50 classes; at the full
// 3,072-candidate tile four fit.
template <int E>
__global__ void __launch_bounds__(kMaxWarps * 32, E <= 2 ? 5 : 1)
    supercell_topk_kernel(
    const float* __restrict__ qx, const float* __restrict__ qy,
    const float* __restrict__ qz, const int* __restrict__ qid,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const int* __restrict__ cid,
    int qcap, int ccap, int k, int exclude_self,
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

  bool any = false;  // mode (a): a chunk of pad slots costs nothing
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    const int row = tgt != nullptr ? tgt[qbase + q] : 0;
    const bool ok = tgt == nullptr || (row >= 0 && row < n_rows);
    s_query[q] = make_float4(qx[qbase + q], qy[qbase + q], qz[qbase + q],
                             __int_as_float(qid[qbase + q]));
    s_target[q] = ok ? row : -1;
    any |= ok;
  }
  if (!__syncthreads_or(any)) return;
  if (warp == 0) {  // the center of the chunk's real queries' bounding box
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int q = lane; q < nq; q += 32) {
      const float4 sq = s_query[q];
      if (__float_as_int(sq.w) < 0) continue;
      const float c[3] = {sq.x, sq.y, sq.z};
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], c[a]);
        hi[a] = fmaxf(hi[a], c[a]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      for (int o = 16; o > 0; o >>= 1) {
        lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], o));
        hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], o));
      }
      if (lane == 0) s_center[a] = lo[a] <= hi[a] ? 0.5f * (lo[a] + hi[a]) : 0.f;
    }
  }
  __syncthreads();
  const float mx = s_center[0], my = s_center[1], mz = s_center[2];
  const int base = 32 * E - k;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * tile;
    const int n = max(0, min(tile, ccap - c0));
    if (t > 0) __syncthreads();  // every warp is done with the last tile
    stage(cx, cy, cz, cid, cbase + c0, n, (n + 31) & ~31, mx, my, mz);
    // each warp takes its queries through the tile on its own; between
    // tiles a query's list waits in its output row
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
      u64 kth = kEmpty;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = e * 32 + lane - base;
        if (j < 0) {
          v[e] = 0ull;
        } else if (t == 0) {
          v[e] = kEmpty;
        } else {
          const int64_t o = tgt != nullptr ? (int64_t)row * k + j
                                           : (sc * k + j) * qcap + q0 + q;
          const float d = out_d[o];
          v[e] = isinf(d) ? kEmpty
                          : ((u64)__float_as_uint(d) << 32) |
                                ((unsigned)out_i[o] + 1u);
        }
      }
      if (t > 0) kth = shfl_u64(v[E - 1], 31);
      scan<E>(px, py, pz, rho, self1, k, t == 0, v, kth, lane);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = e * 32 + lane - base;
        if (j < 0) continue;
        const float d = __uint_as_float((unsigned)(v[e] >> 32));
        const int id = isinf(d) ? -1 : (int)((unsigned)v[e] - 1u);
        const int64_t o =
            tgt != nullptr ? (int64_t)row * k + j               // mode (a)
                           : (sc * k + j) * qcap + q0 + q;      // mode (b)
        out_d[o] = d;
        out_i[o] = id;
      }
    }
  }
}

template <int E>
int launch(const float* qx, const float* qy, const float* qz, const int* qid,
           const float* cx, const float* cy, const float* cz, const int* cid,
           int n_sc, int qcap, int ccap, int k, int exclude_self,
           const int* tgt, int n_rows, float* out_d, int* out_i, int warps,
           int tile, int qchunk, cudaStream_t stream) {
  const size_t smem = smem_of(tile);
  cudaError_t err = cudaFuncSetAttribute(
      supercell_topk_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_sc, (unsigned)((qcap + qchunk - 1) / qchunk));
  supercell_topk_kernel<E><<<grid, warps * 32, smem, stream>>>(
      qx, qy, qz, qid, cx, cy, cz, cid, qcap, ccap, k, exclude_self, tgt,
      n_rows, out_d, out_i, tile, qchunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of one block staging tiles of ``tile`` candidates.
size_t supercell_topk_smem_bytes(int tile) { return smem_of(tile); }

// Launch one block of ``warps`` warps per (supercell, chunk of ``qchunk``
// query slots), lists of ``lane_entries`` entries a lane (1, 2, 4, 8, 16
// or 28; 32 * lane_entries >= k), candidates staged ``tile`` (a multiple
// of 32, at most kMaxTile) at a time.  tgt == NULL selects mode (b).
// Returns cudaGetLastError() (0 = launched).
int supercell_topk_launch(const float* qx, const float* qy, const float* qz,
                          const int* qid, const float* cx, const float* cy,
                          const float* cz, const int* cid, int n_sc,
                          int qcap, int ccap, int k, int exclude_self,
                          const int* tgt, int n_rows, float* out_d,
                          int* out_i, int warps, int lane_entries, int tile,
                          int qchunk, void* stream) {
  if (warps < 1 || warps > kMaxWarps || tile < 32 || tile % 32 != 0 ||
      tile > kMaxTile || qchunk < 1 || qchunk > kMaxChunk || k < 1 ||
      32 * lane_entries < k)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define SUPERCELL_TOPK_CASE(E)                                               \
  case E:                                                                    \
    return launch<E>(qx, qy, qz, qid, cx, cy, cz, cid, n_sc, qcap, ccap, k,  \
                     exclude_self, tgt, n_rows, out_d, out_i, warps, tile,   \
                     qchunk, st);
  switch (lane_entries) {
    SUPERCELL_TOPK_CASE(1)
    SUPERCELL_TOPK_CASE(2)
    SUPERCELL_TOPK_CASE(4)
    SUPERCELL_TOPK_CASE(8)
    SUPERCELL_TOPK_CASE(16)
    SUPERCELL_TOPK_CASE(28)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SUPERCELL_TOPK_CASE
}

const char* supercell_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
