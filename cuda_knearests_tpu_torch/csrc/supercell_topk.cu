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
// argument chosen by the launcher, so the lists stay in registers.  The
// staging, the scan and the insertion live in warp_topk.cuh, which
// blocked_topk.cu shares.
//
// Plain C interface, loaded with ctypes.  The launcher allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include "warp_topk.cuh"

namespace {

// Shared memory of one block staging tiles of ``tile`` candidates.
inline size_t smem_of(int tile) { return (size_t)16 * tile; }

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

  if (!stage_queries(qx, qy, qz, qid, tgt, n_rows, qbase, nq)) return;
  const float mx = s_center[0], my = s_center[1], mz = s_center[2];
  const int base = 32 * E - k;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * tile;
    const int n = max(0, min(tile, ccap - c0));
    if (t > 0) __syncthreads();  // every warp is done with the last tile
    stage<false>(cx, cy, cz, cid, cbase + c0, n, (n + 31) & ~31, mx, my, mz,
                 nullptr);
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
      unsigned s[E];  // unused: no slots carried
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
      scan<E, false>(px, py, pz, rho, self1, k, t == 0, v, s, kth, lane,
                     nullptr, 0u);
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
