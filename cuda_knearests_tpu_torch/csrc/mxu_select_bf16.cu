// The bf16 tier of the brute route's dot-form selection, with q.p on
// Hopper's tensor cores.  For NVIDIA Hopper (sm_90a).
//
// Replaces the bf16 tier of the Pallas TPU kernel _select_kernel of
// cuda_knearests_tpu/mxu/kernel.py (:59), launched by select_pallas (:146).
// The f32 tier stays in mxu_select.cu.  Two kernels:
//
//   * prep (mxu_select_bf16_prep_launch): one pass over an operand, once
//     per selection.  Each row's coordinates rounded to bf16 (nearest
//     even) into a (rows, d16) array, d16 = d rounded up to 16, zero padded;
//     the scoring norm ns (each term x*x of the bf16 coordinates rounded to
//     bf16, summed in f32 over axes 0..d-1 in order); the f32 norm nf; and
//     for candidates pn_max, the largest nf of a real candidate (>= 0).
//   * selection (mxu_select_bf16_launch): a block owns R query rows (R in
//     {128, 64, 32, 16}) and walks the candidates 64 at a time (half a
//     128-slot fold block).  The candidates' bf16 rows, scoring norms
//     and ids stream into shared memory with cp.async, double buffered; the
//     query rows' bf16 coordinates stay in shared memory for the launch
//     when they fit (qres), or stream with the candidates in d-chunks.
//     Each warp computes the q.p of its own 32 (or 16) rows against the 64
//     candidates with mma.sync.m16n8k16 bf16 -> f32 (fragments by
//     ldmatrix), turns each sum into s = (qn_s + pn_s) - 2*qp (three
//     rounded ops, in mxu_select.cu's order), makes pads, the query's own
//     id and non-finite scores +inf (missing), and stores s column-major
//     into a score tile whose row stride R + 4 makes both the stores and
//     the fold's reads free of bank conflicts.  Then one thread per query
//     row folds its 64 scores with select_fold.cuh's RowFold, shared with
//     mxu_select.cu: one branch-free pass leaves out every score above the
//     list's last entry, the rest enter the block list of m or the running
//     list of k, kplus falls with everything left out, the block list
//     flushes every 128 candidates, and the direct path runs when m >= k
//     or m >= 128.  A block list of one (m = 1, the recall-bounded runs at
//     scale) is two registers updated once per step, branch free.  The
//     certificate is written at the end: kplus >= t + 2*B,
//     B = coef * (qn_f + pn_max).
//
// The contract (against mxu/scorer.py select_plain, the plain version):
//   * ns, nf and pn_max equal scorer.norms bit for bit (same ops, same
//     order, every op rounded on its own: --fmad=false and _rn intrinsics).
//   * q.p: each product of two bf16 values is exact in f32 (8 x 8
//     significand bits), so the tensor core's sum differs from the plain
//     in-order sum only in the order and rounding of its f32 additions.
//     Fasi, Higham, Mikaitis and Pranesh ("Numerical behavior of NVIDIA
//     tensor cores", PeerJ Computer Science 7:e330, 2021) find the products
//     exact and each accumulation step aligned to the largest magnitude and
//     truncated (rounded toward zero), never worse than one rounding of a
//     recursive sum per step.  A recursive f32 sum of d terms, each
//     addition rounded to nearest or truncated, errs by at most about
//     d * 2 * 2^-24 * sum |q_i p_i| <= d * 2^-24 * (qn + pn_max), since
//     2 |q_i p_i| <= q_i^2 + p_i^2.  Both sums err by at most that, so
//     delta = |qp_tc - qp_plain| <= 2 * d * 2^-24 * (qn + pn_max) and
//     2 * delta <= 4 * d * 2^-24 * (qn + pn_max), below the f32 term of B,
//     4 * (d + 8) * 2^-23 * (qn + pn_max).  The score's last subtraction
//     adds at most one ulp of s, about 2^-22 * (qn + pn_max), still inside:
//     the checks hold each row's measured 2 * delta_max of the scores to
//     this f32 term.  B's second term covers the bf16 casts, so
//     certificates stay sound.
//   * Fold: moving every score by at most eps moves each block's j-th
//     smallest score, each pool order statistic and kplus by at most eps.
//     So the k selected scores agree with select_plain's element by element
//     within 2 * delta_max, delta_max the row's largest |qp_tc - qp_plain|
//     (2 * delta_max within the f32 term of B); ids may differ only among
//     candidates whose plain scores lie within that band of each other.
//   * Exact inputs stay exact: where every partial sum of q.p is exact (the
//     lattice coordinates k * 2.5 of the tests), the kernel equals
//     select_plain bit for bit: ids, scores and certificates.
//   * Certified rows are true top-k sets (B bounds |s - d2| at bf16).
//
// What bounds it on this card.  2*d operations per (query, candidate)
// pair on the tensor cores (2.56e12 for 100k points at d=128, 2.6 ms at the
// 989 TFLOP/s dense BF16 peak), plus per pair one epilogue (three rounded
// ops and a shared store) and one fold step (a shared load and a compare):
// at small d the fold, not the product, sets the time.  The design keeps
// the candidates' norms and casts out of the inner loop (computed once by
// prep instead of once per block), overlaps loads with compute, and keeps
// every shared access conflict free.  wgmma and TMA are later work.
//
// Plain C interface, loaded with ctypes.  The launchers allocate nothing,
// run on the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>

#include "select_fold.cuh"

namespace {

constexpr int kPad = 8;  // bf16 pad of each staged row (16 bytes)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void prep_kernel(const float* __restrict__ x,
                            const int* __restrict__ ids, int rows, int d,
                            int d16, __nv_bfloat16* __restrict__ xb,
                            float* __restrict__ ns, float* __restrict__ nf,
                            float* __restrict__ pn_max) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* xr = x + row * d;
  __nv_bfloat16* br = xb + row * d16;
  float f_sum = 0.f, s_sum = 0.f;
  for (int ax = 0; ax < d; ++ax) {
    const float v = xr[ax];
    const float f = __fmul_rn(v, v);
    f_sum = ax ? __fadd_rn(f_sum, f) : f;
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    const float vs = __bfloat162float(b);
    const float fs = round_bf16(__fmul_rn(vs, vs));
    s_sum = ax ? __fadd_rn(s_sum, fs) : fs;
    br[ax] = b;
  }
  for (int ax = d; ax < d16; ++ax) br[ax] = __float2bfloat16_rn(0.f);
  ns[row] = s_sum;
  nf[row] = f_sum;
  // nf >= 0, so its bits order as signed ints; pn_max starts at +0.
  if (ids != nullptr && ids[row] >= 0)
    atomicMax(reinterpret_cast<int*>(pn_max), __float_as_int(f_sum));
}

// MT m16 tiles per warp: each warp owns RW = 16 * MT query rows.
template <int MT>
__global__ void __launch_bounds__(128) select_kernel(
    const __nv_bfloat16* __restrict__ qb, const float* __restrict__ qns,
    const float* __restrict__ qnf, const int* __restrict__ qid,
    const __nv_bfloat16* __restrict__ pb, const float* __restrict__ pns,
    const int* __restrict__ cid, const float* __restrict__ pn_max_p, int n_q,
    int n_c, int d16, int k, int m, int exclude_self, float coef, int kc,
    int qres, int* __restrict__ out_i, float* __restrict__ out_s,
    uint8_t* __restrict__ out_cert, float* __restrict__ dump) {
  constexpr int RW = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int R = (nt >> 5) * RW;  // query rows of the block
  const int RS = R + 4;          // score tile stride (conflict free)
  const int row0 = blockIdx.x * R;
  const int qs = qres ? d16 + kPad : kc + kPad;  // staged query row stride
  const int ps = kc + kPad;                      // staged candidate stride

  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sp = sq + (size_t)(qres ? 1 : 2) * R * qs;
  float* spn = reinterpret_cast<float*>(sp + (size_t)2 * kCols * ps);
  int* sid = reinterpret_cast<int*>(spn + 2 * kCols);
  float* ss = reinterpret_cast<float*>(sid + 2 * kCols);
  RowFold fold(ss + (size_t)kCols * RS, k, m, R);

  // The fold's row: one per lane (the first RW lanes of each warp).
  const int r = warp * RW + lane;
  const int64_t row = (int64_t)row0 + r;
  const bool folds = lane < RW && row < n_q;
  float qn_f = 0.f;
  if (folds) {
    qn_f = qnf[row];
    fold.init(R, r);
  }
  // The epilogue's rows: g and g + 8 of each m16 tile of the warp.
  const int g = lane >> 2, q4 = lane & 3;
  float e_qn[MT][2];
  int e_self[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t er = (int64_t)row0 + warp * RW + mt * 16 + g + 8 * h;
      e_qn[mt][h] = er < n_q ? qns[er] : 0.f;
      e_self[mt][h] = (exclude_self && er < n_q) ? qid[er] : -1;
    }
  const float pn_max = *pn_max_p;

  const int kchunks = (d16 + kc - 1) / kc;
  const int n_steps = (n_c / kCols) * kchunks;

  if (qres) {  // the block's query rows, once for the launch
    const int vec = d16 / 8;
    for (int e = tid; e < R * vec; e += nt) {
      const int rr = e / vec, v = e - rr * vec;
      const int64_t qr = (int64_t)row0 + rr;
      const bool ok = qr < n_q;
      cp_async16(sq + (size_t)rr * qs + v * 8,
                 qb + (ok ? qr : 0) * d16 + v * 8, ok);
    }
  }
  auto load_step = [&](int step, int buf) {
    const int c0 = (step / kchunks) * kCols;
    const int kk = (step % kchunks) * kc;
    const int vec = min(kc, d16 - kk) / 8;
    __nv_bfloat16* pd = sp + (size_t)buf * kCols * ps;
    for (int e = tid; e < kCols * vec; e += nt) {
      const int rr = e / vec, v = e - rr * vec;
      cp_async16(pd + (size_t)rr * ps + v * 8,
                 pb + (int64_t)(c0 + rr) * d16 + kk + v * 8, true);
    }
    if (!qres) {
      __nv_bfloat16* qd = sq + (size_t)buf * R * qs;
      for (int e = tid; e < R * vec; e += nt) {
        const int rr = e / vec, v = e - rr * vec;
        const int64_t qr = (int64_t)row0 + rr;
        const bool ok = qr < n_q;
        cp_async16(qd + (size_t)rr * qs + v * 8,
                   qb + (ok ? qr : 0) * d16 + kk + v * 8, ok);
      }
    }
    for (int e = tid; e < 2 * kCols; e += nt) {
      if (e < kCols)
        cp_async4(spn + buf * kCols + e, pns + c0 + e);
      else
        cp_async4(sid + buf * kCols + e - kCols, cid + c0 + e - kCols);
    }
    cp_async_commit();
  };

  float acc[MT][kCols / 8][4];
  load_step(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    cp_async_wait_all();
    __syncthreads();  // this step's tiles landed; step - 1's are consumed
    if (step + 1 < n_steps) load_step(step + 1, buf ^ 1);

    const int chunk = step % kchunks;
    const int kk = chunk * kc;
    const int kw = min(kc, d16 - kk);
    if (chunk == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nb = 0; nb < kCols / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nb][e] = 0.f;
    }
    const __nv_bfloat16* a_base =
        qres ? sq + kk : sq + (size_t)buf * R * qs;
    const __nv_bfloat16* b_base = sp + (size_t)buf * kCols * ps;
    for (int k16 = 0; k16 < kw; k16 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], a_base + (size_t)(warp * RW + mt * 16 +
                                             (lane & 15)) * qs +
                               k16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kCols / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, b_base + (size_t)(np * 16 + (lane & 7) +
                                         ((lane >> 4) << 3)) * ps +
                           k16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if (chunk != kchunks - 1) continue;

    // Epilogue: scores of the warp's rows into the score tile.  The norms
    // and ids of this lane's 16 columns are read once; a pad's norm becomes
    // inf, so its score is inf (its coordinates are 0, so q.p is 0).
    const int c0 = (step / kchunks) * kCols;
    const float* tn = spn + buf * kCols;
    const int* ti = sid + buf * kCols;
    float c_pn[kCols / 8][2];
    int c_id[kCols / 8][2];
#pragma unroll
    for (int nb = 0; nb < kCols / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nb * 8 + 2 * q4 + e;
        c_id[nb][e] = ti[col];
        c_pn[nb][e] = tn[col];
      }
    if (dump != nullptr) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t er = (int64_t)row0 + warp * RW + mt * 16 + g + 8 * h;
#pragma unroll
          for (int nb = 0; nb < kCols / 8; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (er < n_q)
                dump[er * n_c + c0 + nb * 8 + 2 * q4 + e] =
                    __fsub_rn(__fadd_rn(e_qn[mt][h], c_pn[nb][e]),
                              __fmul_rn(2.f, acc[mt][nb][2 * h + e]));
        }
    }
#pragma unroll
    for (int nb = 0; nb < kCols / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c_id[nb][e] < 0) c_pn[nb][e] = INFINITY;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int er = warp * RW + mt * 16 + g + 8 * h;
#pragma unroll
        for (int nb = 0; nb < kCols / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = nb * 8 + 2 * q4 + e;
            float s = __fsub_rn(__fadd_rn(e_qn[mt][h], c_pn[nb][e]),
                                __fmul_rn(2.f, acc[mt][nb][2 * h + e]));
            // the query's own id and non-finite scores are missing
            if (c_id[nb][e] == e_self[mt][h] || !(fabsf(s) < INFINITY))
              s = INFINITY;
            ss[col * RS + er] = s;
          }
      }
    __syncwarp();
    if (folds) fold.step(ss, ti, RS, R, r, c0);
    __syncwarp();
  }
  if (folds)
    fold.finish(coef, qn_f, pn_max, row, k, R, r, out_i, out_s, out_cert);
}

}  // namespace

extern "C" {

// Shared memory of one selection block of `rows` query rows, candidate
// chunks of kc (a multiple of 16) bf16 columns, queries resident (qres) or
// streamed in chunks.
size_t mxu_select_bf16_smem_bytes(int d16, int k, int m, int rows, int kc,
                                  int qres) {
  const size_t mb = (m >= k || m >= kBlock) ? 0 : m;
  const size_t q = qres ? (size_t)rows * (d16 + kPad)
                        : (size_t)2 * rows * (kc + kPad);
  const size_t p = (size_t)2 * kCols * (kc + kPad);
  return 2 * (q + p) + 4 * (size_t)4 * kCols + 4 * (size_t)kCols * (rows + 4) +
         8 * (size_t)(k + mb) * rows;
}

// Stage one (rows, d) f32 operand: xb (rows, d16) bf16, ns, nf; with ids
// (candidates) also raise *pn_max (which the caller zeroes) to the largest
// nf of a real id.
int mxu_select_bf16_prep_launch(const float* x, const int* ids, int rows,
                                int d, int d16, void* xb, float* ns,
                                float* nf, float* pn_max, void* stream) {
  const int nt = 256;
  const unsigned blocks = (unsigned)((rows + nt - 1) / nt);
  prep_kernel<<<blocks, nt, 0, (cudaStream_t)stream>>>(
      x, ids, rows, d, d16, reinterpret_cast<__nv_bfloat16*>(xb), ns, nf,
      pn_max);
  return (int)cudaGetLastError();
}

// Launch over ceil(n_q / rows) blocks.  rows in {128, 64, 32} runs rows
// threads (32 rows a warp), rows = 16 one warp of 16 rows.  n_c must be a
// multiple of 128, d16 of 16, kc of 16.  dump, when not null, receives
// every (query, candidate) score before masking, (n_q, n_c) row-major.
int mxu_select_bf16_launch(const void* qb, const float* qns,
                           const float* qnf, const int* qid, const void* pb,
                           const float* pns, const int* cid,
                           const float* pn_max, int n_q, int n_c, int d16,
                           int k, int m, int exclude_self, float coef,
                           int rows, int kc, int qres, int* out_i,
                           float* out_s, uint8_t* out_cert, float* dump,
                           void* stream) {
  const size_t smem = mxu_select_bf16_smem_bytes(d16, k, m, rows, kc, qres);
  const unsigned blocks = (unsigned)((n_q + rows - 1) / rows);
  const auto* q = reinterpret_cast<const __nv_bfloat16*>(qb);
  const auto* p = reinterpret_cast<const __nv_bfloat16*>(pb);
  cudaError_t err;
  if (rows >= 32) {
    err = cudaFuncSetAttribute(select_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    select_kernel<2><<<blocks, rows, smem, (cudaStream_t)stream>>>(
        q, qns, qnf, qid, p, pns, cid, pn_max, n_q, n_c, d16, k, m,
        exclude_self, coef, kc, qres, out_i, out_s, out_cert, dump);
  } else {
    err = cudaFuncSetAttribute(select_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    select_kernel<1><<<blocks, 32, smem, (cudaStream_t)stream>>>(
        q, qns, qnf, qid, p, pns, cid, pn_max, n_q, n_c, d16, k, m,
        exclude_self, coef, kc, qres, out_i, out_s, out_cert, dump);
  }
  return (int)cudaGetLastError();
}

const char* mxu_select_bf16_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
