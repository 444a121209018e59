// Blocked two-stage supercell top-k (KnnConfig.kernel='blocked') for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel_blocked of
// cuda_knearests_tpu/ops/pallas_solve.py (:168), launched by _pallas_topk
// (:659) with kernel='blocked'.  For each query slot of a class pack (the
// same inputs as csrc/supercell_topk.cu), with
//   d2 = ((qx-cx)^2 + (qy-cy)^2) + (qz-cz)^2,
// every op rounded on its own (intrinsics below, --fmad=false), pads
// (id == PAD_C) and, with exclude_self, the query's own id skipped:
//   stage 1: each 128-slot candidate block keeps its first m candidates in
//            (d2, id) order; rem = the smallest d2 a block did not keep;
//   stage 2: the row is the first k of the kept pool, ascending;
//   deficit: when rem < t strictly for any block (t = the k-th d2, inf when
//            the pool holds fewer than k), a hidden candidate could beat
//            the row's k-th entry: d2 at column k-1 becomes NaN, which
//            fails the solve's certificate (NaN <= margin is false), so
//            the row goes to the exact fallback.
// Missing entries are (inf, -1).  Output modes as in supercell_topk.cu:
// (a) rows at tgt[slot] of (n, k) buffers, (b) the raw (S, k, Q) layout.
//
// What bounds it on this card.  The same pair arithmetic as the one-stage
// kernel (~8 float ops per (query, candidate) pair against 16 bytes of
// candidate data shared by the supercell's queries): operations, not
// bytes.
//
// What the design does about it.  The TPU kernel extracted each block's
// top-m by m min-and-mask passes over a (Q, 128) register tile and wrote a
// (G*m, Q) pool to VMEM scratch.  Here, as in supercell_topk.cu, one
// thread owns one query slot and candidates stream through shared memory
// by broadcast; each thread keeps a sorted list of length m for the
// current block and a running sorted list of length k (both in shared
// memory, their last entries in registers).  At each block's end its m
// survivors are offered to the running list, so the pool never exists,
// and rem is one running minimum over everything the block lists
// rejected.  m and k are runtime arguments; the wrapper sizes the block
// so the lists fit shared memory.
//
// Plain C interface, loaded with ctypes.  The launcher allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPadC = -3;    // pad candidate id (cuda_solve._PAD_C)
constexpr int kTile = 256;   // candidates per shared-memory tile
constexpr int kBlock = 128;  // candidate slots per stage-1 block

__device__ __forceinline__ bool key_less(float d, int i, float ed, int ei) {
  return d < ed || (d == ed && i < ei);
}

// Sorted (d2, id) list of `len` entries of thread t, entry j at j*nt + t,
// its last entry mirrored in (wd, wi).
struct List {
  float* d;
  int* i;
  int len;
  float wd;
  int wi;

  __device__ void init(int nt, int t) {
    for (int j = 0; j < len; ++j) {
      d[j * nt + t] = INFINITY;
      i[j * nt + t] = -1;
    }
    wd = INFINITY;
    wi = -1;
  }

  // Insert (dv, id) when it orders before the last entry; returns the d2
  // of whatever is left out (dv itself, or the entry pushed out).
  __device__ float offer(float dv, int id, int nt, int t) {
    if (!key_less(dv, id, wd, wi)) return dv;
    const float out = wd;
    int p = len - 1;
    while (p > 0) {
      const float pd = d[(p - 1) * nt + t];
      const int pi = i[(p - 1) * nt + t];
      if (key_less(pd, pi, dv, id)) break;
      d[p * nt + t] = pd;
      i[p * nt + t] = pi;
      --p;
    }
    d[p * nt + t] = dv;
    i[p * nt + t] = id;
    wd = d[(len - 1) * nt + t];
    wi = i[(len - 1) * nt + t];
    return out;
  }
};

__global__ void blocked_topk_kernel(
    const float* __restrict__ qx, const float* __restrict__ qy,
    const float* __restrict__ qz, const int* __restrict__ qid,
    const float* __restrict__ cx, const float* __restrict__ cy,
    const float* __restrict__ cz, const int* __restrict__ cid,
    int qcap, int ccap, int k, int m, int exclude_self,
    const int* __restrict__ tgt, int n_rows,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  float* sx = smem;
  float* sy = sx + kTile;
  float* sz = sy + kTile;
  int* sid = reinterpret_cast<int*>(sz + kTile);
  List run{reinterpret_cast<float*>(sid + kTile), nullptr, k, 0.f, 0};
  run.i = reinterpret_cast<int*>(run.d + (size_t)k * nt);
  List blk{reinterpret_cast<float*>(run.i + (size_t)k * nt), nullptr, m,
           0.f, 0};
  blk.i = reinterpret_cast<int*>(blk.d + (size_t)m * nt);

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
    run.init(nt, t);
    blk.init(nt, t);
  }
  float rem = INFINITY;  // smallest d2 any block did not keep

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
        if (id != kPadC && id != self) {
          const float dx = __fsub_rn(px, sx[j]);
          const float dy = __fsub_rn(py, sy[j]);
          const float dz = __fsub_rn(pz, sz[j]);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                              __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          rem = fminf(rem, blk.offer(d, id, nt, t));
        }
        if ((c0 + j + 1) % kBlock == 0) {  // block ends: pool its survivors
          for (int e = 0; e < m; ++e) {
            const int bi = blk.i[e * nt + t];
            if (bi < 0) break;  // missing entries trail
            run.offer(blk.d[e * nt + t], bi, nt, t);
          }
          blk.init(nt, t);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
  const float kth = rem < run.wd ? NAN : run.wd;
  if (tgt != nullptr) {
    const int64_t base = (int64_t)row * k;          // mode (a): final row
    for (int j = 0; j < k; ++j) {
      out_d[base + j] = j == k - 1 ? kth : run.d[j * nt + t];
      out_i[base + j] = run.i[j * nt + t];
    }
  } else {
    for (int j = 0; j < k; ++j) {                   // mode (b): (S, k, Q)
      const int64_t o = (sc * k + j) * qcap + q;
      out_d[o] = j == k - 1 ? kth : run.d[j * nt + t];
      out_i[o] = run.i[j * nt + t];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block of q_tile threads needs at this (k, m).
size_t blocked_topk_smem_bytes(int k, int m, int q_tile) {
  return (size_t)4 * kTile * 4 + (size_t)2 * (k + m) * q_tile * 4;
}

// Launch over a (n_sc, ceil(qcap / q_tile)) grid of q_tile-thread blocks.
// ccap must be a multiple of 128.  tgt == NULL selects mode (b).  Returns
// cudaGetLastError() (0 = launched).
int blocked_topk_launch(const float* qx, const float* qy, const float* qz,
                        const int* qid, const float* cx, const float* cy,
                        const float* cz, const int* cid, int n_sc, int qcap,
                        int ccap, int k, int m, int exclude_self,
                        const int* tgt, int n_rows, float* out_d,
                        int* out_i, int q_tile, void* stream) {
  const size_t smem = blocked_topk_smem_bytes(k, m, q_tile);
  cudaError_t err = cudaFuncSetAttribute(
      blocked_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_sc, (unsigned)((qcap + q_tile - 1) / q_tile));
  blocked_topk_kernel<<<grid, q_tile, smem, (cudaStream_t)stream>>>(
      qx, qy, qz, qid, cx, cy, cz, cid, qcap, ccap, k, m, exclude_self, tgt,
      n_rows, out_d, out_i);
  return (int)cudaGetLastError();
}

const char* blocked_topk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
