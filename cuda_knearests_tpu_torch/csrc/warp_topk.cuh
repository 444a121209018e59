// Warp-per-query top-k over a supercell's staged candidates: the device
// code that csrc/supercell_topk.cu and csrc/blocked_topk.cu share.
//
// A block serves one (supercell, chunk of <= 128 query slots).  It stages
// the chunk's queries (stage_queries) and then the supercell's candidates,
// tile by tile, in shared memory as (x, y, z, id + 1) rows of 16 bytes,
// bucketed center-out (stage).  A warp owns one query at a time and keeps
// its list in registers, E entries a lane, ascending over positions
// e*32 + lane and aligned to the END: position 32*E - 1 is the k-th entry
// (slot E-1 of lane 31), and positions before the list hold key 0.  Keys
// are (bits(d2) << 32) | (id + 1), so one 64-bit compare is the (d2, id)
// order.  scan() sorts the first row into the list, then offers rows two
// at a time (ballot of "key < k-th", each survivor broadcast and inserted
// by every lane at once) and stops once a row's shell lies beyond the k-th
// distance.  The design and its reasons are in supercell_topk.cu's header.
//
// kSlot: each entry also carries the pack slot of its candidate (a second
// register array moved by the same shuffles; the tile-local slot of each
// staged row in a u16 array after the rows), which the blocked kernel
// needs to count its list's entries per 128-slot block.

#pragma once

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

__device__ __forceinline__ float key_d2(u64 key) {
  return __uint_as_float((unsigned)(key >> 32));
}

// The key of candidate c = (x, y, z, bits of id + 1) for the query at
// (px, py, pz).
__device__ __forceinline__ u64 cand_key(float4 c, float px, float py,
                                        float pz) {
  const float dx = __fsub_rn(px, c.x);
  const float dy = __fsub_rn(py, c.y);
  const float dz = __fsub_rn(pz, c.z);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return ((u64)__float_as_uint(d) << 32) | __float_as_uint(c.w);
}

// Ascending bitonic sort of 32*J keys across the warp, element 32*j + lane
// in key[j]; with kVal, val[j] moves with its key.
template <int J, bool kVal>
__device__ __forceinline__ void warp_sort(u64 (&key)[J], unsigned (&val)[J],
                                          int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * J; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int i = 32 * j + lane;
        if (stride >= 32) {  // both elements in this lane
          const int jo = j | (stride >> 5);
          if (jo == j) continue;
          const bool asc = (i & size) == 0, swap = (key[jo] < key[j]) == asc;
          const u64 a = key[j];
          key[j] = swap ? key[jo] : a;
          key[jo] = swap ? a : key[jo];
          if constexpr (kVal) {
            const unsigned b = val[j];
            val[j] = swap ? val[jo] : b;
            val[jo] = swap ? b : val[jo];
          }
        } else {
          const u64 o = shfl_xor_u64(key[j], stride);
          const bool keep_min = ((i & size) == 0) == ((i & stride) == 0);
          // on equal keys (empty ones only) both lanes end with one val
          const bool take = keep_min == (o < key[j]);
          if constexpr (kVal) {
            const unsigned ov = __shfl_xor_sync(kFull, val[j], stride);
            val[j] = take ? ov : val[j];
          }
          key[j] = take ? o : key[j];
        }
      }
    }
  }
}

// Insert nk (below the k-th entry; with kSlot, its slot ns) into the list:
// every position whose entry is not below nk takes its predecessor's
// entry, or nk where the predecessor is below it; the k-th entry drops
// out.  Slots below e_lo hold only positions before the list and never
// change.
template <int E, bool kSlot>
__device__ __forceinline__ void insert(u64 (&v)[E], unsigned (&s)[E], u64 nk,
                                       unsigned ns, int lane, int e_lo) {
#pragma unroll
  for (int e = E - 1; e >= 0; --e) {
    if (e < e_lo) break;
    // lane 31 hands the previous slot's entry to lane 0 (a rotation)
    const u64 w = lane == 31 ? (e == 0 ? 0ull : v[e > 0 ? e - 1 : 0]) : v[e];
    const u64 up = shfl_u64(w, (lane + 31) & 31);
    const bool keep = v[e] < nk, fresh = up < nk;
    if constexpr (kSlot) {
      const unsigned ws = lane == 31 ? s[e > 0 ? e - 1 : 0] : s[e];
      const unsigned ups = __shfl_sync(kFull, ws, (lane + 31) & 31);
      s[e] = keep ? s[e] : (fresh ? ns : ups);
    }
    v[e] = keep ? v[e] : (fresh ? nk : up);
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
// shared-memory address): a tile of candidate rows in center-out order
// (with kSlot, followed by their tile-local slots as u16), per row of 32 a
// lower bound on its candidates' center distance (inf for rows of pads),
// the buckets' counters and starts, the largest squared center distance
// (float bits), the tile's real candidates and the center; and the block's
// query slots (x, y, z, bits of the stored id) with their output rows (-1:
// a pad slot that mode (a) skips).
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

// Stage the chunk of nq query slots at qbase in s_query / s_target, and the
// center of the real queries' bounding box in s_center: in mode (a) the
// slots with a target row (external queries carry no stored id), in mode
// (b) the slots with a stored id.  Returns false (to every thread) when
// mode (a) finds no real slot in the chunk.  Called by every thread of the
// block; ends with a barrier.
__device__ __forceinline__ bool stage_queries(const float* __restrict__ qx,
                              const float* __restrict__ qy,
                              const float* __restrict__ qz,
                              const int* __restrict__ qid,
                              const int* __restrict__ tgt, int n_rows,
                              int64_t qbase, int nq) {
  const int lane = threadIdx.x & 31;
  bool any = false;  // mode (a): a chunk of pad slots costs nothing
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    const int row = tgt != nullptr ? tgt[qbase + q] : 0;
    const bool ok = tgt == nullptr || (row >= 0 && row < n_rows);
    s_query[q] = make_float4(qx[qbase + q], qy[qbase + q], qz[qbase + q],
                             __int_as_float(qid[qbase + q]));
    s_target[q] = ok ? row : -1;
    any |= ok;
  }
  if (!__syncthreads_or(any)) return false;
  if (threadIdx.x < 32) {
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int q = lane; q < nq; q += 32) {
      const float4 sq = s_query[q];
      if (tgt != nullptr ? s_target[q] < 0 : __float_as_int(sq.w) < 0) {
        continue;
      }
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
  return true;
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
// and the tail last; fill s_row_lo and s_n_real, and with kSlot slot[p],
// the tile-local slot of the candidate staged at p.  The order only speeds
// the scan: the selection does not depend on it.  Called by every thread
// of the block; ends with a barrier.
template <bool kSlot>
__device__ void stage(const float* __restrict__ cx,
                      const float* __restrict__ cy,
                      const float* __restrict__ cz,
                      const int* __restrict__ cid, int64_t cbase, int n,
                      int n_pad, float mx, float my, float mz,
                      unsigned short* slot) {
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
    const int p = atomicAdd(&s_count[b], 1);
    s_rows[p] = row;
    if constexpr (kSlot) slot[p] = (unsigned short)j;
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
// k-th", in lane order, each re-tested against the falling k-th.  With
// kSlot, lane i's candidate has tile-local slot rs[i] (pack slot c0 +
// rs[i]).
template <int E, bool kSlot>
__device__ __forceinline__ void take(u64 key, unsigned self1, u64 (&v)[E],
                                     unsigned (&s)[E], u64& kth, int lane,
                                     int e_lo, const unsigned short* rs,
                                     unsigned c0) {
  unsigned mask = __ballot_sync(kFull, key < kth);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const u64 nk = shfl_u64(key, src);
    if (nk >= kth || (unsigned)nk == self1) continue;
    unsigned ns = 0u;
    if constexpr (kSlot) ns = c0 + rs[src];
    insert<E, kSlot>(v, s, nk, ns, lane, e_lo);
    kth = shfl_u64(v[E - 1], 31);
  }
}

// One warp's pass over the staged tile for its query, whose distance to
// the tile's center is at most rho.  ``first``: the list is empty and this
// is the first tile, whose first row is sorted into it.  Rows are in
// ascending bucket order, so once a row's center distance bound minus rho
// exceeds the k-th distance, no later candidate can enter the list.  Rows
// go two at a time (the second never tested for the stop: scanning it
// anyway changes nothing).  With kSlot, ``slot`` holds the staged rows'
// tile-local slots and c0 is the tile's first pack slot.
template <int E, bool kSlot>
__device__ __forceinline__ void scan(float px, float py, float pz, float rho,
                                     unsigned self1, int k, bool first,
                                     u64 (&v)[E], unsigned (&s)[E], u64& kth,
                                     int lane, const unsigned short* slot,
                                     unsigned c0) {
  const int n_rows = (s_n_real + 31) >> 5;
  const int base = 32 * E - k;  // the list's first position
  const int e_lo = base >> 5;
  const float4* rows = s_rows + lane;
  int r = 0;
  if (first && n_rows > 0) {
    u64 key[1] = {cand_key(rows[0], px, py, pz)};
    if ((unsigned)key[0] == self1) key[0] = kEmpty;
    unsigned pos[1] = {(unsigned)lane};
    warp_sort<1, kSlot>(key, pos, lane);
    // sorted entry j goes to position base + j
    const int e0 = base >> 5, off = base & 31, from = (lane - off) & 31;
    const u64 x = shfl_u64(key[0], from);
    unsigned xs = 0u;
    if constexpr (kSlot) xs = c0 + slot[__shfl_sync(kFull, pos[0], from)];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      v[e] = e < e0 ? 0ull
             : e == e0 ? (lane >= off ? x : 0ull)
             : (e == e0 + 1 && lane < off) ? x : kEmpty;
      s[e] = xs;  // read only where v[e] is a real entry
    }
    kth = shfl_u64(v[E - 1], 31);
    r = 1;
  }
  for (; r < n_rows; r += 2) {
    // every candidate from row r on lies at least g from the query
    const float g = fmaxf(s_row_lo[r] - rho, 0.f);
    const float g2 = g * g * (1.f - kSlack);
    if (g2 > 1e-30f && g2 > key_d2(kth)) break;
    const u64 k0 = cand_key(rows[32 * r], px, py, pz);
    const u64 k1 =
        r + 1 < n_rows ? cand_key(rows[32 * r + 32], px, py, pz) : kEmpty;
    take<E, kSlot>(k0, self1, v, s, kth, lane, e_lo, slot + 32 * r, c0);
    take<E, kSlot>(k1, self1, v, s, kth, lane, e_lo, slot + 32 * r + 32, c0);
  }
}

}  // namespace
