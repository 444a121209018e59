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
//
// What bounds it on this card.  The work is one distance and one compare
// per (query, candidate) pair of a supercell: ~8 float operations on 16
// bytes of candidate data that every query of the supercell shares.  Read
// once from device memory, the candidates cost far less time than the pair
// arithmetic (~10^9 pairs for a 900k-point cloud at k=10), so the kernel is
// bound by operations -- instruction issue of the distance, the compare and
// the shared-memory reads -- not by bytes.
//
// What the design does about it.  The TPU kernel held a whole (Q, C)
// distance tile in VMEM and ran k min-and-mask passes over it (O(k*C) per
// query).  A Hopper block has at most 227 KB of shared memory, so instead:
// one block per (supercell, tile of query slots), one thread per query
// slot; the supercell's candidates stream through shared memory in SoA
// tiles (x, y, z, id) that every thread of the block reads by broadcast;
// each thread keeps its sorted (d2, id) list of length k in shared memory
// (column j of thread t at j*blockDim + t, so the threads of a warp hit
// distinct banks) and its current k-th entry in registers.  A candidate
// costs one distance and one compare against that k-th entry; only the
// rare improving candidate pays an insertion.  Work per query is O(C + k *
// insertions) instead of O(k*C).  k is a runtime argument: the list takes
// 8*k*blockDim bytes, and the wrapper sizes blockDim so it fits.
//
// Plain C interface, loaded with ctypes.  The launcher allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPadC = -3;       // pad candidate id (cuda_solve._PAD_C)
constexpr int kTile = 256;      // candidates per shared-memory tile

// Lexicographic (d2, id) order; ids are unique within a supercell.
__device__ __forceinline__ bool key_less(float d, int i, float ed, int ei) {
  return d < ed || (d == ed && i < ei);
}

__global__ void supercell_topk_kernel(
    const float* __restrict__ qx, const float* __restrict__ qy,
    const float* __restrict__ qz, const int* __restrict__ qid,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const int* __restrict__ cid,
    int qcap, int ccap, int k, int exclude_self,
    const int* __restrict__ tgt, int n_rows,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  float* sx = smem;
  float* sy = sx + kTile;
  float* sz = sy + kTile;
  int* sid = reinterpret_cast<int*>(sz + kTile);
  float* ld = reinterpret_cast<float*>(sid + kTile);  // k * nt distances
  int* li = reinterpret_cast<int*>(ld + (size_t)k * nt);  // k * nt ids

  const int64_t sc = blockIdx.x;
  const int q = blockIdx.y * nt + t;
  const int64_t slot = sc * qcap + q;
  bool active = q < qcap;
  int row = -1;
  if (active && tgt != nullptr) {
    row = tgt[slot];
    active = row >= 0 && row < n_rows;  // pad slots carry the sentinel
  }
  if (!__syncthreads_or(active)) return;  // a block of pad slots only

  float px = 0.f, py = 0.f, pz = 0.f;
  int self = -2;
  if (active) {
    px = qx[slot];
    py = qy[slot];
    pz = qz[slot];
    self = exclude_self ? qid[slot] : -2;  // -2 never matches a candidate
  }
  for (int j = 0; j < k; ++j) {
    ld[j * nt + t] = INFINITY;
    li[j * nt + t] = -1;
  }
  float wd = INFINITY;  // current k-th entry
  int wi = -1;

  const int64_t cbase = sc * ccap;
  for (int c0 = 0; c0 < ccap; c0 += kTile) {
    const int n = min(kTile, ccap - c0);
    for (int j = t; j < n; j += nt) {
      sx[j] = cx[cbase + c0 + j];
      sy[j] = cy[cbase + c0 + j];
      sz[j] = cz[cbase + c0 + j];
      sid[j] = cid[cbase + c0 + j];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const int id = sid[j];
        if (id == kPadC || id == self) continue;
        const float dx = __fsub_rn(px, sx[j]);
        const float dy = __fsub_rn(py, sy[j]);
        const float dz = __fsub_rn(pz, sz[j]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        if (!key_less(d, id, wd, wi)) continue;
        int p = k - 1;
        while (p > 0) {
          const float pd = ld[(p - 1) * nt + t];
          const int pi = li[(p - 1) * nt + t];
          if (key_less(pd, pi, d, id)) break;
          ld[p * nt + t] = pd;
          li[p * nt + t] = pi;
          --p;
        }
        ld[p * nt + t] = d;
        li[p * nt + t] = id;
        wd = ld[(k - 1) * nt + t];
        wi = li[(k - 1) * nt + t];
      }
    }
    __syncthreads();
  }
  if (!active) return;
  if (tgt != nullptr) {
    const int64_t base = (int64_t)row * k;          // mode (a): final row
    for (int j = 0; j < k; ++j) {
      out_d[base + j] = ld[j * nt + t];
      out_i[base + j] = li[j * nt + t];
    }
  } else {
    for (int j = 0; j < k; ++j) {                   // mode (b): (S, k, Q)
      const int64_t o = (sc * k + j) * qcap + q;
      out_d[o] = ld[j * nt + t];
      out_i[o] = li[j * nt + t];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block of q_tile threads needs at this k.
size_t supercell_topk_smem_bytes(int k, int q_tile) {
  return (size_t)4 * kTile * 4 + (size_t)2 * k * q_tile * 4;
}

// Launch over a (n_sc, ceil(qcap / q_tile)) grid of q_tile-thread blocks.
// tgt == NULL selects mode (b).  Returns cudaGetLastError() (0 = launched).
int supercell_topk_launch(const float* qx, const float* qy, const float* qz,
                          const int* qid, const float* cx, const float* cy,
                          const float* cz, const int* cid, int n_sc,
                          int qcap, int ccap, int k, int exclude_self,
                          const int* tgt, int n_rows, float* out_d,
                          int* out_i, int q_tile, void* stream) {
  const size_t smem = supercell_topk_smem_bytes(k, q_tile);
  cudaError_t err = cudaFuncSetAttribute(
      supercell_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_sc, (unsigned)((qcap + q_tile - 1) / q_tile));
  supercell_topk_kernel<<<grid, q_tile, smem, (cudaStream_t)stream>>>(
      qx, qy, qz, qid, cx, cy, cz, cid, qcap, ccap, k, exclude_self, tgt,
      n_rows, out_d, out_i);
  return (int)cudaGetLastError();
}

const char* supercell_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
