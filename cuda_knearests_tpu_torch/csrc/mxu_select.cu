// The f32 tier of the brute route's dot-form selection: for every query,
// its top-k of all candidates under the TPU-KNN per-block fold, and the
// certificate that the selection is a true top-k set.  For NVIDIA Hopper
// (sm_90a).
//
// Replaces the f32 tier of the Pallas TPU kernel _select_kernel of
// cuda_knearests_tpu/mxu/kernel.py (:59), launched by select_pallas (:146);
// the bf16 tier runs on tensor cores in mxu_select_bf16.cu, whose block
// structure this kernel shares.  It computes bit for bit what the plain
// torch version (cuda_knearests_tpu_torch/mxu/scorer.py select_plain)
// computes:
//   * score s = (qn + pn) - 2*qp, with qn, pn and qp = q.p each summed in
//     order over axes 0..d-1 from the first term, every multiply and add
//     rounded on its own (the intrinsics below, and the build passes
//     --fmad=false);
//   * on CUDA cores, never TF32 (the f32 certification band, (d+8)*eps32,
//     does not cover TF32's 10-bit mantissa);
//   * pads (id < 0), the query's own id (exclude_self) and non-finite
//     scores are missing, (inf, -1) in the output;
//   * candidates form 128-slot blocks; each block keeps its first m by
//     (score, id) and the selection is the first k of the kept pool;
//   * kplus = the smallest score left out anywhere (rejected by its block,
//     or in the pool beyond the k-th), t = the k-th selected score (inf
//     when fewer), B = coef * (qn + pn_max) with coef the f32 of
//     topk.dot_error_bound's factor and pn_max the largest f32 norm of a
//     real candidate (at least 0); certified iff kplus >= t + 2*B.
//
// Two kernels:
//   * prep (mxu_select_prep_launch): one pass over an operand, twice per
//     selection (queries, candidates).  It writes the operand axis-major,
//     xT (d, ld) with zero columns past its rows, so that a block streams
//     any d-chunk of any 64 rows with 16-byte copies; the f32 norms nf
//     (scorer.norms op for op); and for candidates pn_max, the largest nf
//     of a real id (>= 0).
//   * selection (mxu_select_launch): a block of R threads owns R query rows
//     (R in {128, 64, 32, 16}) and walks the candidates 64 at a time (half
//     a 128-slot fold block), their coordinates in d-chunks of kc axes,
//     norms and ids streamed into shared memory by cp.async, double
//     buffered.  The query rows' coordinates stay in shared memory for the
//     launch when they are small (qres), or stream with the candidates in
//     the same d-chunks, so no d is too wide.  The R x 64 product tile is
//     register-tiled: each thread owns 8 rows x 8 columns (two runs of 4
//     consecutive rows, two of 4 columns), reads them per axis as four
//     float4 from the axis-major tiles, and updates its 64 sums as
//     qp = qp + q*p, axis by axis in order, the first product starting
//     each sum; the sums survive across d-chunks.  After the last chunk
//     each sum becomes s = (qn + pn) - 2*qp (three rounded ops), pads, the
//     query's own id and non-finite scores become +inf, and s goes
//     column-major into a score tile of row stride R + 4 as one float4 per
//     run of 4 rows (free of bank conflicts per quarter warp).  A warp's
//     tiles hold exactly the 32 rows its lanes fold, so the fold follows
//     after a warp barrier.  Then one thread per query row folds its 64
//     scores as mxu_select_bf16.cu does: the block list of m, the running
//     list of k, kplus, a flush every 128 candidates, the direct path when
//     m >= k or m >= 128, and for m = 1 a block list of two registers
//     updated branch free.  For m >= 2 one branch-free pass first leaves
//     out every score above the list's last entry (fold_step), so only
//     the few that can enter touch the list.  The certificate is written
//     at the end.  The fold (RowFold) is select_fold.cuh's, shared with
//     mxu_select_bf16.cu.
//
// What bounds it on this card.  2*d float operations per (query,
// candidate) pair, 2.56e12 for 100k points at d=128: 38 ms at the 67
// TFLOP/s FP32 peak, which counts a fused multiply-add as two operations.
// Bit identity with select_plain rules out fused multiply-adds, so each
// (pair, axis) is a separate FMUL and FADD, one instruction each: the
// pipes' ceiling is twice the bound, 76 ms at 100k x 128 (16 ms at
// 300k x 3).  Per pair the epilogue and the fold add about 13
// instructions (three rounded ops, masks, a shared store, a shared load,
// a compare and a minimum), which set the time at small d.  Inputs and
// outputs are
// ~100 MB (0.03 ms at 3.35 TB/s).  The design keeps the CUDA cores on the
// product: 64 independent sums per thread for four shared loads per axis
// (shared bandwidth no longer sets the pace, as it did when one thread
// owned one query and loaded two operands per multiply-add), norms
// computed once by prep instead of once per block, copies overlapped with
// compute, and a fold whose common case is one load, one compare and one
// minimum per pair with no branch.
//
// Plain C interface, loaded with ctypes.  The launchers allocate nothing,
// run on the caller's stream and return cudaGetLastError().

#include "select_fold.cuh"

namespace {

__global__ void prep_kernel(const float* __restrict__ x,
                            const int* __restrict__ ids, int rows, int d,
                            int ld, float* __restrict__ xT,
                            float* __restrict__ nf,
                            float* __restrict__ pn_max) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= ld) return;
  if (row >= rows) {  // zero columns up to ld: safe 16-byte copies
    for (int ax = 0; ax < d; ++ax) xT[(int64_t)ax * ld + row] = 0.f;
    return;
  }
  const float* xr = x + row * d;
  float f_sum = 0.f;
  for (int ax = 0; ax < d; ++ax) {
    const float v = xr[ax];
    const float f = __fmul_rn(v, v);
    f_sum = ax ? __fadd_rn(f_sum, f) : f;
    xT[(int64_t)ax * ld + row] = v;
  }
  nf[row] = f_sum;
  // nf >= 0, so its bits order as signed ints; pn_max starts at +0.
  if (ids != nullptr && ids[row] >= 0)
    atomicMax(reinterpret_cast<int*>(pn_max), __float_as_int(f_sum));
}

__device__ __forceinline__ void load8(float (&v)[8], const float* lo,
                                      const float* hi) {
  const float4 a = *reinterpret_cast<const float4*>(lo);
  const float4 b = *reinterpret_cast<const float4*>(hi);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// A block of R = blockDim.x threads owns R query rows.
__global__ void __launch_bounds__(128) select_kernel(
    const float* __restrict__ qT, const float* __restrict__ qnf,
    const int* __restrict__ qid, int ldq, const float* __restrict__ pT,
    const float* __restrict__ pnf, const int* __restrict__ cid,
    const float* __restrict__ pn_max_p, int n_q, int n_c, int d, int k,
    int m, int exclude_self, float coef, int kc, int qres,
    int* __restrict__ out_i, float* __restrict__ out_s,
    uint8_t* __restrict__ out_cert) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const unsigned wmask = R >= 32 ? 0xffffffffu : (1u << R) - 1;
  const int RS = R + 4;  // score tile stride
  const int row0 = blockIdx.x * R;

  float* sq = reinterpret_cast<float*>(smem);
  float* sp = sq + (size_t)(qres ? d : 2 * kc) * R;
  float* spn = sp + (size_t)2 * kc * kCols;
  int* sid = reinterpret_cast<int*>(spn + 2 * kCols);
  float* ss = reinterpret_cast<float*>(sid + 2 * kCols);
  RowFold fold(ss + (size_t)kCols * RS, k, m, R);

  // The product tile of this thread: rows r_lo + {0..3} and r_hi + {0..3}
  // (a warp's 32 rows, or the 16 of a 16-row block), columns c_lo + {0..3}
  // and c_lo + 32 + {0..3}.
  const int rgw = R >= 32 ? 4 : 2;  // row groups of 4 per warp
  const int rg = lane % rgw, cg = lane / rgw;
  const int r_lo = warp * 32 + rg * 4, r_hi = r_lo + 4 * rgw;
  const int c_lo = cg * 4, c_hi = c_lo + 32;
  float e_qn[8];
  int e_self[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t er = (int64_t)row0 + (i < 4 ? r_lo + i : r_hi + i - 4);
    e_qn[i] = er < n_q ? qnf[er] : 0.f;
    e_self[i] = (exclude_self && er < n_q) ? qid[er] : -1;
  }

  // The fold's row: one per thread, among the rows its own warp scored.
  const int r = tid;
  const int64_t row = (int64_t)row0 + r;
  const bool folds = row < n_q;
  float qn_f = 0.f;
  if (folds) {
    qn_f = qnf[row];
    fold.init(R, r);
  }
  const float pn_max = *pn_max_p;

  const int kchunks = (d + kc - 1) / kc;
  const int n_steps = (n_c / kCols) * kchunks;
  const int qvec = R / 4;

  if (qres) {  // the block's query rows, once for the launch
    for (int e = tid; e < d * qvec; e += R) {
      const int a = e / qvec, v = e - a * qvec;
      cp_async16(sq + (size_t)a * R + v * 4,
                 qT + (int64_t)a * ldq + row0 + v * 4);
    }
  }
  auto load_step = [&](int step, int buf) {
    const int c0 = (step / kchunks) * kCols;
    const int kk = (step % kchunks) * kc;
    const int kw = min(kc, d - kk);
    float* pd = sp + (size_t)buf * kc * kCols;
    for (int e = tid; e < kw * (kCols / 4); e += R) {
      const int a = e / (kCols / 4), v = e % (kCols / 4);
      cp_async16(pd + a * kCols + v * 4,
                 pT + (int64_t)(kk + a) * n_c + c0 + v * 4);
    }
    if (!qres) {
      float* qd = sq + (size_t)buf * kc * R;
      for (int e = tid; e < kw * qvec; e += R) {
        const int a = e / qvec, v = e - a * qvec;
        cp_async16(qd + (size_t)a * R + v * 4,
                   qT + (int64_t)(kk + a) * ldq + row0 + v * 4);
      }
    }
    for (int e = tid; e < 2 * kCols; e += R) {
      if (e < kCols)
        cp_async4(spn + buf * kCols + e, pnf + c0 + e);
      else
        cp_async4(sid + buf * kCols + e - kCols, cid + c0 + e - kCols);
    }
    cp_async_commit();
  };

  float acc[8][8];
  load_step(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    cp_async_wait_all();
    __syncthreads();  // this step's tiles landed; step - 1's are consumed
    if (step + 1 < n_steps) load_step(step + 1, buf ^ 1);

    const int chunk = step % kchunks;
    const int kk = chunk * kc;
    const int kw = min(kc, d - kk);
    const float* qa = qres ? sq + (size_t)kk * R : sq + (size_t)buf * kc * R;
    const float* pa = sp + (size_t)buf * kc * kCols;
    int a = 0;
    if (chunk == 0) {  // axis 0: each sum starts from its first product
      float qv[8], pv[8];
      load8(qv, qa + r_lo, qa + r_hi);
      load8(pv, pa + c_lo, pa + c_hi);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmul_rn(qv[i], pv[j]);
      a = 1;
    }
#pragma unroll 2
    for (; a < kw; ++a) {
      float qv[8], pv[8];
      load8(qv, qa + (size_t)a * R + r_lo, qa + (size_t)a * R + r_hi);
      load8(pv, pa + a * kCols + c_lo, pa + a * kCols + c_hi);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(qv[i], pv[j]));
    }
    if (chunk != kchunks - 1) continue;

    // Epilogue: this thread's scores into the score tile, one float4 per
    // run of 4 rows.  Norms and ids of its 8 columns are read once.
    const int c0 = (step / kchunks) * kCols;
    const float* tn = spn + buf * kCols;
    const int* ti = sid + buf * kCols;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j < 4 ? c_lo + j : c_hi + j - 4;
      const float pn = tn[col];
      const int id = ti[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float s4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ri = 4 * h + i;
          float s = __fsub_rn(__fadd_rn(e_qn[ri], pn),
                              __fmul_rn(2.f, acc[ri][j]));
          // pads, the query's own id and non-finite scores are missing
          if (id < 0 || id == e_self[ri] || !(fabsf(s) < INFINITY))
            s = INFINITY;
          s4[i] = s;
        }
        *reinterpret_cast<float4*>(ss + (size_t)col * RS +
                                   (h ? r_hi : r_lo)) =
            make_float4(s4[0], s4[1], s4[2], s4[3]);
      }
    }
    __syncwarp(wmask);
    if (folds) fold.step(ss, ti, RS, R, r, c0);
    __syncwarp(wmask);
  }
  if (folds)
    fold.finish(coef, qn_f, pn_max, row, k, R, r, out_i, out_s, out_cert);
}

}  // namespace

extern "C" {

// Shared memory of one selection block of `rows` query rows: the query
// rows (all d axes when resident, else two d-chunks of kc), two candidate
// chunks of 64 columns with their norms and ids, the score tile (row
// stride rows + 4) and each row's lists of k and, when the fold can
// matter, m.
size_t mxu_select_smem_bytes(int d, int k, int m, int rows, int kc,
                             int qres) {
  const size_t mb = (m >= k || m >= kBlock) ? 0 : m;
  const size_t q = qres ? (size_t)rows * d : (size_t)2 * rows * kc;
  return 4 * (q + (size_t)2 * kCols * kc + 4 * (size_t)kCols +
              (size_t)kCols * (rows + 4) + 2 * (size_t)(k + mb) * rows);
}

// Stage one (rows, d) f32 operand: xT (d, ld) axis-major with zero
// columns from rows to ld, and nf; with ids (candidates) also raise
// *pn_max (which the caller zeroes) to the largest nf of a real id.
int mxu_select_prep_launch(const float* x, const int* ids, int rows, int d,
                           int ld, float* xT, float* nf, float* pn_max,
                           void* stream) {
  const int nt = 256;
  const unsigned blocks = (unsigned)((ld + nt - 1) / nt);
  prep_kernel<<<blocks, nt, 0, (cudaStream_t)stream>>>(x, ids, rows, d, ld,
                                                       xT, nf, pn_max);
  return (int)cudaGetLastError();
}

// Launch over ceil(n_q / rows) blocks of `rows` threads, rows in {128, 64,
// 32, 16}.  qT is (d, ldq) and pT (d, n_c), both from prep; ldq must be a
// multiple of 128 at least n_q, n_c a multiple of 128.  kc >= 1 axes per
// d-chunk.
int mxu_select_launch(const float* qT, const float* qnf, const int* qid,
                      int ldq, const float* pT, const float* pnf,
                      const int* cid, const float* pn_max, int n_q, int n_c,
                      int d, int k, int m, int exclude_self, float coef,
                      int rows, int kc, int qres, int* out_i, float* out_s,
                      uint8_t* out_cert, void* stream) {
  const size_t smem = mxu_select_smem_bytes(d, k, m, rows, kc, qres);
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_q + rows - 1) / rows);
  select_kernel<<<blocks, rows, smem, (cudaStream_t)stream>>>(
      qT, qnf, qid, ldq, pT, pnf, cid, pn_max, n_q, n_c, d, k, m,
      exclude_self, coef, kc, qres, out_i, out_s, out_cert);
  return (int)cudaGetLastError();
}

const char* mxu_select_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
