// The per-row fold of the brute route's selection kernels, shared by the
// f32 tier (mxu_select.cu) and the bf16 tier (mxu_select_bf16.cu): each
// query row folds the 64 scores of every step into its block list of m
// and running list of k under the TPU-KNN per-block rule of
// cuda_knearests_tpu/mxu/kernel.py _select_kernel (:59), keeps kplus, the
// smallest score left out anywhere, and writes its selection and
// certificate at the end.  Also the cp.async helpers both tiers stream
// with.
//
// Lists live in shared memory, entry j of row r at j * R + r (R rows a
// block), so that a warp's rows touch consecutive words.  Scores reach the
// fold column-major in a tile of row stride RS, finite or +inf (missing).
// ops/_build.py hashes this header into each including library's name.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // candidate slots per fold block (topk.BLOCK)
constexpr int kCols = 64;    // candidates per step

__device__ __forceinline__ bool key_less(float s, int i, float es, int ei) {
  return s < es || (s == es && i < ei);
}

// Sorted (score, id) list of `len` entries of row r, entry j at j * nr + r.
// Inserts (s, id), which must order before the last entry, and returns the
// score of the entry pushed out.
__device__ __forceinline__ float list_insert(float* ls, int* li, int len,
                                             int nr, int r, float s, int id) {
  const float out = ls[(len - 1) * nr + r];
  int p = len - 1;
  while (p > 0) {
    const float ps = ls[(p - 1) * nr + r];
    const int pi = li[(p - 1) * nr + r];
    if (key_less(ps, pi, s, id)) break;
    ls[p * nr + r] = ps;
    li[p * nr + r] = pi;
    --p;
  }
  ls[p * nr + r] = s;
  li[p * nr + r] = id;
  return out;
}

struct List {
  float* s;
  int* i;
  int len;
  float ws;  // last entry, in registers
  int wi;

  __device__ void init(int nr, int r) {
    for (int j = 0; j < len; ++j) {
      s[j * nr + r] = INFINITY;
      i[j * nr + r] = -1;
    }
    ws = INFINITY;
    wi = -1;
  }

  // Offer (s, id); the score of whatever is left out (the offer itself or
  // the entry it pushed out) lowers `out_min`.
  __device__ void offer(float sc, int id, int nr, int r, float& out_min) {
    if (key_less(sc, id, ws, wi)) {
      out_min = fminf(out_min, list_insert(s, i, len, nr, r, sc, id));
      ws = s[(len - 1) * nr + r];
      wi = i[(len - 1) * nr + r];
    } else {
      out_min = fminf(out_min, sc);
    }
  }
};

// Offer row r's 64 scores of this step (column j at ss[j * RS + r], id
// ti[j]) to list L.  One branch-free pass first: scores above L's last
// entry are left out (they lower out_min) and can never enter, since the
// last entry only falls; the finite rest are marked and offered after.
// Most steps mark none, so the pass's independent loads pipeline and the
// list is rarely touched.  The outcome does not depend on the order of
// the offers: the list keeps the smallest (score, id) keys, out_min the
// smallest score left out.
__device__ __forceinline__ void fold_step(List& L, const float* ss,
                                          const int* ti, int RS, int nr,
                                          int r, float& out_min) {
  uint32_t lo = 0, hi = 0;
  float rest = INFINITY;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float s = ss[j * RS + r];
    const bool in = s <= L.ws && s < INFINITY;
    if (j < 32) lo |= (uint32_t)in << j;
    else hi |= (uint32_t)in << (j - 32);
    rest = fminf(rest, in ? INFINITY : s);
  }
  out_min = fminf(out_min, rest);
  for (; lo; lo &= lo - 1) {
    const int j = __ffs(lo) - 1;
    L.offer(ss[j * RS + r], ti[j], nr, r, out_min);
  }
  for (; hi; hi &= hi - 1) {
    const int j = 32 + __ffs(hi) - 1;
    L.offer(ss[j * RS + r], ti[j], nr, r, out_min);
  }
}

// One row's fold state.  The lists take (k + m') * R scores and as many
// ids of shared memory from `base`, m' = m when the block list matters
// (m < k and m < 128) and 0 otherwise.
struct RowFold {
  List run, blk;
  bool direct;  // m >= k or m >= 128: every score goes to the running list
  int mb;       // block list length, 0 when direct
  float b1s, out_min;  // the block list when mb == 1; kplus
  int b1i;

  __device__ RowFold(float* base, int k, int m, int R)
      : direct(m >= k || m >= kBlock), b1s(INFINITY), out_min(INFINITY),
        b1i(-1) {
    mb = direct ? 0 : m;
    run = List{base, nullptr, k, 0.f, 0};
    run.i = reinterpret_cast<int*>(run.s + (size_t)k * R);
    blk = List{reinterpret_cast<float*>(run.i + (size_t)k * R), nullptr,
               mb == 1 ? 0 : mb, 0.f, 0};
    blk.i = reinterpret_cast<int*>(blk.s + (size_t)mb * R);
  }

  __device__ void init(int R, int r) {
    run.init(R, r);
    blk.init(R, r);
  }

  // Fold row r's 64 scores of the step whose first candidate is c0.
  __device__ __forceinline__ void step(const float* ss, const int* ti,
                                       int RS, int R, int r, int c0) {
    if (mb == 1) {
      // A block list of one lives in registers and takes this step's best
      // in one merge: the step's smallest score m1 (its column jm, two
      // interleaved chains for latency), its second smallest m2 (the
      // smallest of the rest, all left out), and on a tie for m1 the
      // lowest id among the tied.  No branch on the data, so the lanes of
      // a warp, which beat their block's best at different columns, stay
      // together.
      float m1a = INFINITY, m2a = INFINITY, m1b = INFINITY, m2b = INFINITY;
      int ja = -1, jb = -1;
#pragma unroll
      for (int j = 0; j < kCols; j += 2) {
        const float va = ss[j * RS + r], vb = ss[(j + 1) * RS + r];
        m2a = fminf(m2a, fmaxf(m1a, va));
        m2b = fminf(m2b, fmaxf(m1b, vb));
        ja = va < m1a ? j : ja;
        jb = vb < m1b ? j + 1 : jb;
        m1a = fminf(m1a, va);
        m1b = fminf(m1b, vb);
      }
      const float m1 = fminf(m1a, m1b);
      const float m2 = fminf(fminf(m2a, m2b), fmaxf(m1a, m1b));
      const int jm = m1b < m1a ? jb : ja;
      if (jm >= 0) {
        int id1 = ti[jm];
        if (m2 == m1) {  // tied for the smallest: the lowest id wins
          for (int j = 0; j < kCols; ++j)
            if (ss[j * RS + r] == m1) id1 = min(id1, ti[j]);
        }
        const bool lt = key_less(m1, id1, b1s, b1i);
        out_min = fminf(out_min, lt ? fminf(b1s, m2) : m1);
        b1s = lt ? m1 : b1s;
        b1i = lt ? id1 : b1i;
      }
    } else if (direct) {
      fold_step(run, ss, ti, RS, R, r, out_min);
    } else {
      fold_step(blk, ss, ti, RS, R, r, out_min);
    }
    if (!direct && (c0 + kCols) % kBlock == 0) {  // block ends: pool it
      if (mb == 1 && b1i >= 0) run.offer(b1s, b1i, R, r, out_min);
      b1s = INFINITY;
      b1i = -1;
      for (int e = 0; e < blk.len; ++e) {
        const int bi = blk.i[e * R + r];
        if (bi < 0) break;  // missing entries trail
        run.offer(blk.s[e * R + r], bi, R, r, out_min);
      }
      blk.init(R, r);
    }
  }

  // Row `row`'s selection and certificate: certified iff
  // kplus >= t + 2*B, t the k-th selected score, B = coef * (qn + pn_max).
  __device__ void finish(float coef, float qn, float pn_max, int64_t row,
                         int k, int R, int r, int* __restrict__ out_i,
                         float* __restrict__ out_s,
                         uint8_t* __restrict__ out_cert) const {
    const float err = __fmul_rn(coef, __fadd_rn(qn, pn_max));
    const float thr = __fadd_rn(run.ws, __fmul_rn(2.f, err));
    out_cert[row] = out_min >= thr ? 1 : 0;
    for (int j = 0; j < k; ++j) {
      out_s[row * k + j] = run.s[j * R + r];
      out_i[row * k + j] = run.i[j * R + r];
    }
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace
