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
// Two kernels for each chunk of queries (mxu_select_split_launch):
//   * fold: a block of 8 warps takes one 128-slot candidate block and 8
//     queries, a warp a query and 4 candidates a lane, and scores them.
//     With m < 128 the warp sorts its 128 keys (a bitonic network over
//     registers and shuffles), writes the first m to the query's pool row
//     and the (m+1)-th score to rem; with m = 128 every key enters the
//     pool as it is (the pool is then the whole candidate set).
//   * select: a block of 256 threads a query finds the pool row's (k+1)-th
//     key by radix selection on 8-bit digits from the top (a shared
//     histogram a digit, stopping as soon as one key holds the rank),
//     gathers the k+1 smallest keys, sorts them (bitonic, in shared memory
//     up to kSmemSortKeys keys, else in a device scratch row of the
//     caller's) and writes the selection and the certificate.
// Work: the fold scores each (query, candidate) pair once (2d operations)
// and writes 8 bytes a kept key; the selection reads a pool row once for
// each radix digit it needs (three to five on spread scores) and once to
// gather.
//
// Plain C interface, loaded with ctypes.  The launcher allocates nothing,
// runs on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;          // candidate slots per fold block
constexpr int kFoldWarps = 8;        // queries per fold block
constexpr int kSelectThreads = 256;  // threads per query in select
constexpr int kSmemSortKeys = 8192;  // (mxu/kernel.py _SPLIT_SMEM_KEYS)
constexpr uint64_t kMissing = ~0ull;
constexpr uint64_t kSign = 1ull << 63;

// The flipped score_key of (s, id): unsigned order is (score, id) order,
// and every non-finite score is the missing key.
__device__ __forceinline__ uint64_t make_key(float s, int id) {
  if (!(fabsf(s) < INFINITY)) return kMissing;
  int bits = __float_as_int(s);
  if (bits < 0) bits ^= 0x7fffffff;
  return (((uint64_t)(uint32_t)bits << 32) | (uint32_t)id) ^ kSign;
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

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t umax64(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// Grid (candidate blocks, ceil(n_rows / 8)).  f32: qx is qT (d, ldq) and px
// pT (d, ldp) axis-major from the f32 prep; bf16: qx (rows, ldq) and px
// (n_c, ldp) bf16 rows from the bf16 prep.  qn and pn are the scoring
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
    float qv, pv[4];
    if (kBf16) {
      const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(qx);
      const __nv_bfloat16* pb = static_cast<const __nv_bfloat16*>(px);
      qv = __bfloat162float(qb[q * ldq + ax]);
#pragma unroll
      for (int t = 0; t < 4; ++t)
        pv[t] = __bfloat162float(pb[(c0 + 32 * t) * ldp + ax]);
    } else {
      const float* qf = static_cast<const float*>(qx);
      const float* pf = static_cast<const float*>(px);
      qv = qf[(int64_t)ax * ldq + q];
#pragma unroll
      for (int t = 0; t < 4; ++t) pv[t] = pf[(int64_t)ax * ldp + c0 + 32 * t];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      acc[t] = ax ? __fadd_rn(acc[t], __fmul_rn(qv, pv[t]))
                  : __fmul_rn(qv, pv[t]);
  }
  const float qnv = qn[q];
  const int self = qid[q];
  uint64_t key[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int64_t c = c0 + 32 * t;
    const int id = cid[c];
    float s = __fsub_rn(__fadd_rn(qnv, pn[c]), __fmul_rn(2.f, acc[t]));
    if (id < 0 || (exclude_self && id == self)) s = INFINITY;
    key[t] = make_key(s, id);
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
          key[t] = asc == lower ? umin64(key[t], other)
                                : umax64(key[t], other);
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

// One block of kSelectThreads per query of the chunk.  n2 is a power of
// two at least k + 1: the sort's width, in dynamic shared memory when
// scratch is null, else in scratch row r.
__global__ void __launch_bounds__(kSelectThreads) select_kernel(
    const uint64_t* __restrict__ pool, int p_len,
    const float* __restrict__ rem, int g, int k, int n2,
    uint64_t* __restrict__ scratch, const float* __restrict__ qnf,
    const float* __restrict__ pn_max_p, float coef, int row0,
    int* __restrict__ out_i, float* __restrict__ out_s,
    uint8_t* __restrict__ out_cert) {
  extern __shared__ uint64_t s_sort[];
  __shared__ unsigned s_hist[256];
  __shared__ unsigned s_lt, s_count;
  __shared__ int s_digit, s_rank;
  __shared__ uint64_t s_t;
  __shared__ float s_rem[kSelectThreads / 32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int r = blockIdx.x;
  const int64_t q = (int64_t)row0 + r;
  const uint64_t* row = pool + (int64_t)r * p_len;
  uint64_t* buf = scratch != nullptr ? scratch + (int64_t)r * n2 : s_sort;
  const int kk = k + 1;

  // The smallest rejected score of any block.
  float rm = INFINITY;
  if (rem != nullptr)
    for (int i = tid; i < g; i += nt) rm = fminf(rm, rem[(int64_t)r * g + i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    rm = fminf(rm, __shfl_xor_sync(0xffffffffu, rm, o));
  if ((tid & 31) == 0) s_rem[tid >> 5] = rm;

  if (p_len <= k) {  // the whole pool, padded with missing keys
    for (int i = tid; i < n2; i += nt) buf[i] = i < p_len ? row[i] : kMissing;
  } else {
    // Radix selection of the key of rank k (0-based): prefix holds the
    // digits found so far, rank the rank among the keys that share them,
    // count how many keys share them.
    uint64_t prefix = 0;
    int rank = k, shift = 64;
    unsigned count = 0;
    do {
      shift -= 8;
      for (int i = tid; i < 256; i += nt) s_hist[i] = 0;
      __syncthreads();
      const int hs = shift + 8;  // the bits above this digit are fixed
      for (int i = tid; i < p_len; i += nt) {
        const uint64_t u = row[i];
        if (hs == 64 || (u >> hs) == (prefix >> hs))
          atomicAdd(&s_hist[(u >> shift) & 255], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        unsigned cum = 0;
        for (int dg = 0; dg < 256; ++dg) {
          const unsigned c = s_hist[dg];
          if ((unsigned)rank < cum + c) {
            s_digit = dg;
            s_rank = rank - (int)cum;
            s_count = c;
            break;
          }
          cum += c;
        }
      }
      __syncthreads();
      prefix |= (uint64_t)s_digit << shift;
      rank = s_rank;
      count = s_count;
    } while (shift > 0 && count > 1);
    // Gather the k - rank keys below the prefix in its fixed bits; the
    // rank + 1 remaining entries are the key of rank k: the one key that
    // shares the prefix (count 1), or copies of the full prefix (count > 1,
    // all 64 bits fixed: equal keys, which only missing keys can be).
    if (tid == 0) s_lt = 0;
    __syncthreads();
    const uint64_t ph = prefix >> shift;
    for (int i = tid; i < p_len; i += nt) {
      const uint64_t u = row[i];
      const uint64_t uh = u >> shift;
      if (uh < ph)
        buf[atomicAdd(&s_lt, 1u)] = u;
      else if (uh == ph && count == 1)
        s_t = u;
    }
    __syncthreads();
    const uint64_t t = count == 1 ? s_t : prefix;
    for (int i = (int)s_lt + tid; i < n2; i += nt)
      buf[i] = i < kk ? t : kMissing;
  }
  __syncthreads();

  // Bitonic sort of buf[0, n2), ascending.
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n2 / 2; i += nt) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const uint64_t a = buf[lo], c = buf[hi];
        if ((a > c) == asc) {
          buf[lo] = c;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int j = tid; j < k; j += nt) {
    const uint64_t u = buf[j];
    out_i[q * k + j] = key_id(u);
    out_s[q * k + j] = key_score(u);
  }
  if (tid == 0) {
    for (int w = 1; w < nt / 32; ++w) rm = fminf(rm, s_rem[w]);
    const float kplus = fminf(rm, key_score(buf[k]));
    const float err = __fmul_rn(coef, __fadd_rn(qnf[q], *pn_max_p));
    const float thr = __fadd_rn(key_score(buf[k - 1]), __fmul_rn(2.f, err));
    out_cert[q] = kplus >= thr ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// One chunk of n_rows queries from row0: the fold into pool (n_rows,
// (n_c / 128) * min(m, 128)) and rem (n_rows, n_c / 128; m < 128 only),
// then the selection into rows row0.. of the (n_q, k) outputs.  bf16
// selects the tier and the layouts of qx / px (see fold_kernel); qns and
// pns are the scoring norms, qnf the queries' f32 norms, pn_max the
// largest f32 norm of a real candidate.  n2 is a power of two at least
// k + 1; scratch, (n_rows, n2) keys, is used (and must be given) when n2
// exceeds kSmemSortKeys.  n_rows <= 65535 * 8, n_c a multiple of 128.
int mxu_select_split_launch(int bf16, const void* qx, int ldq,
                            const float* qns, const float* qnf,
                            const int* qid, const void* px, int ldp,
                            const float* pns, const int* cid,
                            const float* pn_max, int row0, int n_rows,
                            int n_c, int d, int k, int m, int exclude_self,
                            float coef, uint64_t* pool, float* rem,
                            uint64_t* scratch, int n2, int* out_i,
                            float* out_s, uint8_t* out_cert, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool in_smem = n2 <= kSmemSortKeys;
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? (size_t)n2 * sizeof(uint64_t) : 0;
  err = cudaFuncSetAttribute(select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  select_kernel<<<(unsigned)n_rows, kSelectThreads, smem, s>>>(
      pool, g * me, me < kBlock ? rem : nullptr, g, k, n2,
      in_smem ? nullptr : scratch, qnf, pn_max, coef, row0, out_i, out_s,
      out_cert);
  return (int)cudaGetLastError();
}

const char* mxu_select_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
