// B4: the F2 weighted pair co-occurrence C = X^T diag(w) X over one-hot rank
// rows: C[i, j] = sum_r w[r] * cnt_r(i) * cnt_r(j), full symmetric, with the
// diagonal equal to each item's support.
//
// Replaces the TPU kernel src/repro/kernels/cooccur/kernel.py:_cooc_kernel
// (cooccur_pallas), which built one-hot (rows x K) tiles in VMEM and
// contracted them on the MXU in fp32 — O(R*K^2) multiply-adds, exact only
// below 2^24.
//
// Bound on Hopper: bytes on paper (R*L int32 in, K*K int32 out), but the
// real cost is the R*L^2 atomic increments of the pair scatter — 268.6M on
// pumsb (49,046 rows x 74^2) — and their contention on the few hot pairs of
// dense data. That, not HBM, is what this kernel's time measures.
//
// Design: one thread per (row, column c1) slot; it walks the row's columns
// c2 and adds w[r] to C[v1, v2] for every valid pair, so each ordered pair
// (and the diagonal, c1 == c2) is counted exactly once per occurrence —
// duplicates within a row count cnt(i)*cnt(j) like the one-hot product.
// The matrix is privatised per block in shared memory when K*K int32 fits
// (K <= ~238), else threads add straight into global memory (L2 atomics).
// Integer atomics are exact and order-independent: bit-identical to the
// plain version, with no 2^24 bound.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kShared>
__global__ void cooc_kernel(const int* __restrict__ rows, const int* __restrict__ w, long long total,
                            int L, int K, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* C = kShared ? smem : out;
  const int KK = K * K;
  if (kShared) {
    for (int i = threadIdx.x; i < KK; i += blockDim.x) C[i] = 0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int v1 = rows[e];
    if (v1 < 0 || v1 >= K) continue;
    const long long r = e / L;
    const int wr = w[r];
    if (wr == 0) continue;
    const int* row = rows + r * L;
    int* crow = C + v1 * K;
    for (int c2 = 0; c2 < L; ++c2) {
      const int v2 = row[c2];
      if (v2 >= 0 && v2 < K) atomicAdd(&crow[v2], wr);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < KK; i += blockDim.x) {
      const int c = C[i];
      if (c != 0) atomicAdd(&out[i], c);
    }
  }
}

}  // namespace

// rows (R, L) int32 ranks (PAD = -1), w (R,) int32 -> out (K, K) int32.
extern "C" int cooccur_launch(const int* rows, const int* w, long long R, int L, int K, int* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)K * K * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long total = R * (long long)L;
  if (total == 0 || K == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  const size_t smem = (size_t)K * K * sizeof(int);
  const long long want = (total + kThreads * 4LL - 1) / (kThreads * 4LL);
  if (smem <= (size_t)optin) {
    long long per = (long long)(per_sm / (smem + 1024));
    per = per < 1 ? 1 : (per > 8 ? 8 : per);
    long long grid = want < sms * per ? want : sms * per;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(cooc_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    cooc_kernel<true><<<(unsigned)grid, kThreads, smem, s>>>(rows, w, total, L, K, out);
  } else {
    long long grid = want < sms * 16LL ? want : sms * 16LL;
    cooc_kernel<false><<<(unsigned)grid, kThreads, 0, s>>>(rows, w, total, L, K, out);
  }
  return (int)cudaGetLastError();
}
