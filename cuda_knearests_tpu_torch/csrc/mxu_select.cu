// Dot-form selection of the brute route, f32 tier: for every query, its
// top-k of all candidates under the TPU-KNN per-block fold, and the
// certificate that the selection is a true top-k set.  For NVIDIA Hopper
// (sm_90a).
//
// Replaces the f32 tier of the Pallas TPU kernel _select_kernel of
// cuda_knearests_tpu/mxu/kernel.py (:59), launched by select_pallas (:146);
// the bf16 tier runs on tensor cores in mxu_select_bf16.cu.
// It computes what that kernel and its XLA twin (mxu/scorer.py
// solve_blocks_xla) compute, and bit for bit what the plain torch version
// (cuda_knearests_tpu_torch/mxu/scorer.py select_plain) computes:
//   * score s = (qn + pn) - 2*qp, with qn, pn and qp = q.p each summed in
//     order over axes 0..d-1, every multiply and add rounded on its own
//     (the intrinsics below, and the build passes --fmad=false);
//   * on CUDA cores, never TF32 (the f32 certification band, (d+8)*eps32,
//     does not cover TF32's 10-bit mantissa);
//   * pads (id < 0), the query's own id (exclude_self) and non-finite
//     scores are skipped; missing entries are (inf, -1);
//   * candidates form 128-slot blocks; each block keeps its first m by
//     (score, id) and the selection is the first k of the kept pool;
//   * kplus = the smallest score left out anywhere (rejected by its block,
//     or in the pool beyond the k-th), t = the k-th selected score (inf
//     when fewer), B = coef * (qn_f32 + pn_max) with coef the f32 of
//     topk.dot_error_bound's factor and pn_max the largest f32 norm of a
//     real candidate (at least 0); certified iff kplus >= t + 2*B.
//
// What bounds it on this card.  2*d float operations per (query,
// candidate) pair: ~2.6e12 for 100k points at d=128, 40 ms at the 67
// TFLOP/s FP32 peak, against ~100 MB of inputs and outputs (0.03 ms at
// 3.35 TB/s).  So operations bound it, and this kernel issues each as a
// separate multiply and add plus two shared-memory loads per step.
//
// What the design does about it.  The TPU kernel held the whole candidate
// set and a (G*m, 128) survivor pool in VMEM and ran m + k min-and-mask
// passes over register tiles.  Here one thread owns one query: its scoring
// coordinates sit in shared memory column-wise (bank-conflict free), the
// candidates stream through shared memory in tiles that every thread reads
// by broadcast, each tile's norms are computed once per block, and each
// thread keeps a sorted list of length m for the current 128-slot block and
// a running sorted list of length k (both in shared memory, its k-th entry
// in registers).  A candidate costs the d-step dot product and one compare;
// only improving candidates pay an insertion.  There is no (G*m) pool and
// no VMEM-style gate: the only limit is that the lists and tiles fit one
// block's shared memory, which the wrapper checks (LaunchBudgetError).
// When m >= k or m >= 128 the block lists cannot change the selection or
// kplus, and candidates go straight to the running list.
//
// Plain C interface, loaded with ctypes.  The launcher allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // candidate slots per block (topk.BLOCK)

__device__ __forceinline__ bool key_less(float s, int i, float es, int ei) {
  return s < es || (s == es && i < ei);
}

// Sorted (score, id) list of `len` entries of thread t, entry j at
// j * nt + t.  Inserts (s, id), which must order before the last entry,
// and returns the score of the entry pushed out.
__device__ __forceinline__ float list_insert(float* ls, int* li, int len,
                                             int nt, int t, float s, int id) {
  const float out = ls[(len - 1) * nt + t];
  int p = len - 1;
  while (p > 0) {
    const float ps = ls[(p - 1) * nt + t];
    const int pi = li[(p - 1) * nt + t];
    if (key_less(ps, pi, s, id)) break;
    ls[p * nt + t] = ps;
    li[p * nt + t] = pi;
    --p;
  }
  ls[p * nt + t] = s;
  li[p * nt + t] = id;
  return out;
}

struct List {
  float* s;
  int* i;
  int len;
  float ws;  // last entry, in registers
  int wi;

  __device__ void init(int nt, int t) {
    for (int j = 0; j < len; ++j) {
      s[j * nt + t] = INFINITY;
      i[j * nt + t] = -1;
    }
    ws = INFINITY;
    wi = -1;
  }

  // Offer (s, id); the score of whatever is left out (the offer itself or
  // the entry it pushed out) lowers `out_min`.
  __device__ void offer(float sc, int id, int nt, int t, float& out_min) {
    if (key_less(sc, id, ws, wi)) {
      out_min = fminf(out_min, list_insert(s, i, len, nt, t, sc, id));
      ws = s[(len - 1) * nt + t];
      wi = i[(len - 1) * nt + t];
    } else {
      out_min = fminf(out_min, sc);
    }
  }
};

__global__ void mxu_select_kernel(
    const float* __restrict__ q, const int* __restrict__ qid,
    const float* __restrict__ p, const int* __restrict__ cid, int n_q,
    int n_c, int d, int k, int m, int exclude_self, float coef,
    int tile, int* __restrict__ out_i, float* __restrict__ out_s,
    uint8_t* __restrict__ out_cert) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const bool direct = m >= k || m >= kBlock;
  float* sq = smem;                            // d * nt query coordinates
  float* sp = sq + (size_t)d * nt;             // tile * d candidates
  float* spn = sp + (size_t)tile * d;          // tile norms
  int* sid = reinterpret_cast<int*>(spn + tile);
  List run{reinterpret_cast<float*>(sid + tile), nullptr, k, 0.f, 0};
  run.i = reinterpret_cast<int*>(run.s + (size_t)k * nt);
  List blk{reinterpret_cast<float*>(run.i + (size_t)k * nt), nullptr,
           direct ? 0 : m, 0.f, 0};
  blk.i = reinterpret_cast<int*>(blk.s + (size_t)blk.len * nt);

  const int64_t row = (int64_t)blockIdx.x * nt + t;
  const bool active = row < n_q;
  float qn = 0.f;
  int self = -1;  // pads (id < 0) are skipped before this compare
  if (active) {
    self = exclude_self ? qid[row] : -1;
    for (int ax = 0; ax < d; ++ax) {
      const float x = q[row * d + ax];
      const float f = __fmul_rn(x, x);
      qn = ax ? __fadd_rn(qn, f) : f;
      sq[ax * nt + t] = x;
    }
    run.init(nt, t);
    blk.init(nt, t);
  }
  float out_min = INFINITY;  // kplus
  float pn_max = 0.f;

  for (int c0 = 0; c0 < n_c; c0 += tile) {
    __syncthreads();  // the previous tile is consumed
    const float* src = p + (int64_t)c0 * d;
    for (int e = t; e < tile * d; e += nt) sp[e] = src[e];
    for (int j = t; j < tile; j += nt) sid[j] = cid[c0 + j];
    __syncthreads();
    for (int j = t; j < tile; j += nt) {  // norms
      const float* pj = sp + (size_t)j * d;
      float nf = 0.f;
      for (int ax = 0; ax < d; ++ax) {
        const float f = __fmul_rn(pj[ax], pj[ax]);
        nf = ax ? __fadd_rn(nf, f) : f;
      }
      spn[j] = nf;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < tile; ++j) {
      const int id = sid[j];
      if (id >= 0) {
        pn_max = fmaxf(pn_max, spn[j]);
        if (id != self) {
          const float* pj = sp + (size_t)j * d;
          const float* qt = sq + t;
          float qp = __fmul_rn(qt[0], pj[0]);
          int ax = 1;
          // Eight axes' loads first, then their in-order sum: the loads
          // overlap instead of each multiply waiting on its own.
          for (; ax + 8 <= d; ax += 8) {
            float a[8], b[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              a[u] = qt[(ax + u) * nt];
              b[u] = pj[ax + u];
            }
#pragma unroll
            for (int u = 0; u < 8; ++u)
              qp = __fadd_rn(qp, __fmul_rn(a[u], b[u]));
          }
          for (; ax < d; ++ax)
            qp = __fadd_rn(qp, __fmul_rn(qt[ax * nt], pj[ax]));
          const float s = __fsub_rn(__fadd_rn(qn, spn[j]),
                                    __fmul_rn(2.f, qp));
          if (isfinite(s)) {
            if (direct) run.offer(s, id, nt, t, out_min);
            else blk.offer(s, id, nt, t, out_min);
          }
        }
      }
      if (!direct && (c0 + j + 1) % kBlock == 0) {  // block ends: pool it
        for (int e = 0; e < blk.len; ++e) {
          const int bi = blk.i[e * nt + t];
          if (bi < 0) break;  // missing entries trail
          run.offer(blk.s[e * nt + t], bi, nt, t, out_min);
        }
        blk.init(nt, t);
      }
    }
  }
  if (!active) return;
  const float err = __fmul_rn(coef, __fadd_rn(qn, pn_max));
  const float thr = __fadd_rn(run.ws, __fmul_rn(2.f, err));
  out_cert[row] = out_min >= thr ? 1 : 0;
  for (int j = 0; j < k; ++j) {
    out_s[row * k + j] = run.s[j * nt + t];
    out_i[row * k + j] = run.i[j * nt + t];
  }
}

}  // namespace

extern "C" {

// Shared memory of one block of nt threads.
size_t mxu_select_smem_bytes(int d, int k, int m, int nt, int tile) {
  const int mb = (m >= k || m >= kBlock) ? 0 : m;
  return (size_t)4 * ((size_t)d * nt + (size_t)tile * d + 2 * (size_t)tile +
                      2 * (size_t)(k + mb) * nt);
}

// Launch over ceil(n_q / nt) blocks of nt threads.  n_c must be a multiple
// of 128 and of tile, and tile must divide 128.  Returns cudaGetLastError()
// (0 = launched).
int mxu_select_launch(const float* q, const int* qid, const float* p,
                      const int* cid, int n_q, int n_c, int d, int k, int m,
                      int exclude_self, float coef, int nt,
                      int tile, int* out_i, float* out_s, uint8_t* out_cert,
                      void* stream) {
  const size_t smem = mxu_select_smem_bytes(d, k, m, nt, tile);
  cudaError_t err = cudaFuncSetAttribute(
      mxu_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_q + nt - 1) / nt);
  mxu_select_kernel<<<blocks, nt, smem, (cudaStream_t)stream>>>(
      q, qid, p, cid, n_q, n_c, d, k, m, exclude_self, coef, tile,
      out_i, out_s, out_cert);
  return (int)cudaGetLastError();
}

const char* mxu_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
