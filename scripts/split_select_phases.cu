// Times the pieces of the split selection's direct arm
// (cuda_knearests_tpu_torch/csrc/mxu_select_split.cu) apart, on one GPU,
// at the shape of chip_smoke.py's gate-refused brute phase: 20,000 queries
// of 20,096 interleaved candidates (20,000 uniform points in [0, 1000)^3
// from a fixed LCG, 96 pads), d=3, k=1,800, the direct arm's grid (5,000
// blocks of 256 threads, 4 queries each).  Each piece runs as a kernel of
// its own, built from the source's own device code:
//   score    the scoring loop alone (every pair's key, summed);
//   pass 1   scoring + the 12-bit histogram of every key (a shared atomic
//            a pair), as the first histogram pass;
//   pass 2   scoring + the gather of the keys below the 12-bit bucket of
//            d2 = 77,000 (about the 1,800th neighbour's), as pass 2;
//   sort     the sort of four 2,048-key rows a block, two at a time (as
//            the direct arm sorts), and the output of 1,800 entries a row.
// Build and run from the root of a checkout (CUDA toolkit, sm_90a):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false \
//       -std=c++17 -o build/split_select_phases scripts/split_select_phases.cu
//   build/split_select_phases
// It prints the mean milliseconds of 5 launches of each piece after one.

#include "../cuda_knearests_tpu_torch/csrc/mxu_select_split.cu"

#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kN = 20000, kNc = 20096, kD = 3, kK = 1800, kN2 = 2048;
constexpr int kBlocks = kN / kDirectQ;

__device__ int g_out_i[kN * kK];
__device__ float g_out_s[kN * kK];
__device__ uint8_t g_cert[kN];

// The scoring loop's keys, summed (no histogram, no gather).
struct Sum {
  unsigned acc = 0;
  template <int C>
  __device__ __forceinline__ void operator()(const uint32_t (&hi)[kDirectQ][C],
                                             const uint32_t (&lo)[C],
                                             const bool (&valid)[C]) {
#pragma unroll
    for (int j = 0; j < kDirectQ; ++j)
#pragma unroll
      for (int i = 0; i < C; ++i) acc += valid[i] ? hi[j][i] ^ lo[i] : 0;
  }
};

template <int kPiece>
__global__ void __launch_bounds__(kThreads, 3)
    piece(const float* pT, const float* pn, const int* cid, uint32_t p32,
          unsigned* sink) {
  extern __shared__ uint64_t s_dyn[];
  __shared__ PassView view[kDirectQ];
  __shared__ unsigned long long n_app;
  __shared__ float s_qn[kDirectQ];
  __shared__ int s_self[kDirectQ];
  const int tid = threadIdx.x;
  float* s_q = reinterpret_cast<float*>(s_dyn);
  char* regions = reinterpret_cast<char*>(s_dyn) + 64;
  unsigned* hist = reinterpret_cast<unsigned*>(regions);
  uint64_t* rows = reinterpret_cast<uint64_t*>(regions);
  const int q0 = blockIdx.x * kDirectQ;
  if (tid < kDirectQ * kD) {
    const int j = tid / kD, ax = tid % kD;
    s_q[tid] = pT[ax * kNc + q0 + j];
  }
  if (tid < kDirectQ) {
    s_qn[tid] = pn[q0 + tid];
    s_self[tid] = q0 + tid;
    SelState s{0, 64, kK, 0, kHist, 0};
    if (kPiece == 2) s = SelState{(uint64_t)p32 << 32, 52, 0, 0, kGather, 0};
    make_view(view + tid, s);
  }
  if (tid == 0) n_app = 0;
  for (int i = tid; i < kDirectQ * kBins; i += kThreads) hist[i] = 0;
  __syncthreads();
  DirectSource<false, kD> src;
  src.px = pT;
  src.ldp = kNc;
  src.pn = pn;
  src.cid = cid;
  src.n_c = kNc;
  src.d = kD;
  src.excl = 1;
  src.s_q = s_q;
  src.s_qn = s_qn;
  src.s_self = s_self;
  unsigned res = 0;
  if (kPiece == 0) {
    Sum v;
    src.scan(v);
    res = v.acc;
  } else if (kPiece == 1) {
    Visit<kDirectQ> v{view, false, hist, rows, kBins, kN2, &n_app};
    src.scan(v);
    __syncthreads();
    res = hist[tid];
  } else if (kPiece == 2) {
    Visit<kDirectQ> v{view, true, hist, rows, kBins, kN2, &n_app};
    src.scan(v);
    __syncthreads();
    res = (unsigned)n_app;
  } else {
    for (int i = tid; i < kDirectQ * kN2; i += kThreads)
      rows[i] = (uint64_t)((i * 2654435761u) ^ blockIdx.x) << 20 | i;
    __syncthreads();
    const RowOut o{kK, 1.f, pn, pn, g_out_i, g_out_s, g_cert};
    const int half = tid / (kThreads / 2);
    for (int p = 0; p < kDirectQ; p += 2)
      sort_row_regs<16>(rows + (p + half) * kN2, kN2, q0 + p + half,
                        INFINITY, o, tid - half * (kThreads / 2),
                        kThreads / 2, true);
    res = (unsigned)rows[tid];
  }
  if (res == 0x12345678u) sink[blockIdx.x] = res;  // keeps the work alive
}

}  // namespace

int main() {
  std::vector<float> pT(kD * kNc, 0.f), pn(kNc, 0.f);
  std::vector<int> cid(kNc, -1);
  unsigned s = 1;
  for (int c = 0; c < kN; ++c) {  // stored order = interleaved: uniform
    for (int a = 0; a < kD; ++a) {
      s = s * 1664525u + 1013904223u;
      pT[a * kNc + c] = (s >> 8) * (1000.f / 16777216.f);
    }
    pn[c] = pT[c] * pT[c] + pT[kNc + c] * pT[kNc + c] +
            pT[2 * kNc + c] * pT[2 * kNc + c];
    cid[c] = c;
  }
  float *d_pT, *d_pn;
  int* d_cid;
  unsigned* d_sink;
  cudaMalloc(&d_pT, pT.size() * 4);
  cudaMalloc(&d_pn, kNc * 4);
  cudaMalloc(&d_cid, kNc * 4);
  cudaMalloc(&d_sink, kBlocks * 4);
  cudaMemcpy(d_pT, pT.data(), pT.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(d_pn, pn.data(), kNc * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(d_cid, cid.data(), kNc * 4, cudaMemcpyHostToDevice);
  const float t = 77000.f;
  unsigned bits;
  memcpy(&bits, &t, 4);
  const uint32_t p32 = (bits ^ 0x80000000u) & 0xfff00000u;
  const size_t smem = 64 + kDirectQ * kBins * 4;
  using Kernel = void (*)(const float*, const float*, const int*, uint32_t,
                          unsigned*);
  const Kernel kernels[] = {piece<0>, piece<1>, piece<2>, piece<3>};
  const char* names[] = {"score", "pass 1 (score + histogram)",
                         "pass 2 (score + gather)", "sort + output"};
  for (int i = 0; i < 4; ++i) {
    cudaFuncSetAttribute(kernels[i],
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    kernels[i]<<<kBlocks, kThreads, smem>>>(d_pT, d_pn, d_cid, p32, d_sink);
    cudaEventRecord(e0);
    for (int r = 0; r < 5; ++r)
      kernels[i]<<<kBlocks, kThreads, smem>>>(d_pT, d_pn, d_cid, p32,
                                              d_sink);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0;
    cudaEventElapsedTime(&ms, e0, e1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      printf("%s: %s\n", names[i], cudaGetErrorString(err));
      return 1;
    }
    printf("%-28s %.4f ms\n", names[i], ms / 5);
  }
  return 0;
}
