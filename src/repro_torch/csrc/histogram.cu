// B3: the Job-1 weighted item histogram, out[k] = sum_r w[r] * #{c : rows[r, c] == k}.
//
// Replaces the TPU kernel src/repro/kernels/histogram/kernel.py:_hist_kernel
// (histogram_pallas), which compared every row tile against a tile of bin ids
// (a dense O(R*L*n_bins) compare: the TPU has no fast scatter).
//
// Bound on Hopper: bytes. The work is one read of rows (R*L int32) and w (R
// int32) and one write of n_bins int32; a scatter of R*L increments is far
// below any arithmetic peak. What can make it slower than that is atomic
// contention on popular bins (Zipf-skewed items on kosarak).
//
// Design: bins privatised per block in shared memory (41,270 bins * 4 B =
// 165 KB fits in the 227 KB a block may opt into), so increments are
// shared-memory atomics; one global atomicAdd per nonzero bin per block
// flushes them. A universe too large for shared memory scatters straight
// into global memory. Integer atomics are exact and order-independent, so
// the result is bit-identical to the plain version (int32, wrapping mod 2^32
// exactly as the reference's int32 sums do).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

template <bool kShared>
__global__ void hist_kernel(const int* __restrict__ rows, const int* __restrict__ w,
                            long long total, int L, int n_bins, int* __restrict__ out) {
  extern __shared__ int smem[];
  int* bins = kShared ? smem : out;
  if (kShared) {
    for (int i = threadIdx.x; i < n_bins; i += blockDim.x) bins[i] = 0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int v = rows[e];
    if (v >= 0 && v < n_bins) {
      const int wr = w[e / L];
      if (wr != 0) atomicAdd(&bins[v], wr);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_bins; i += blockDim.x) {
      const int c = bins[i];
      if (c != 0) atomicAdd(&out[i], c);
    }
  }
}

}  // namespace

// rows (R, L) int32 (PAD = -1), w (R,) int32 -> out (n_bins,) int32.
extern "C" int histogram_launch(const int* rows, const int* w, long long R, int L, int n_bins,
                                int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_bins * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long total = R * (long long)L;
  if (total == 0 || n_bins == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  const size_t smem = (size_t)n_bins * sizeof(int);
  const long long want = (total + kThreads * 16LL - 1) / (kThreads * 16LL);
  if (smem <= (size_t)optin) {
    // as many blocks as fit on the card at once: every extra block costs
    // one more flush of its nonzero bins
    long long per = smem ? (long long)(per_sm / (smem + 1024)) : 4;
    per = per < 1 ? 1 : (per > 4 ? 4 : per);
    long long grid = want < sms * per ? want : sms * per;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(hist_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    hist_kernel<true><<<(unsigned)grid, kThreads, smem, s>>>(rows, w, total, L, n_bins, out);
  } else {
    long long grid = want < sms * 8LL ? want : sms * 8LL;
    hist_kernel<false><<<(unsigned)grid, kThreads, 0, s>>>(rows, w, total, L, n_bins, out);
  }
  return (int)cudaGetLastError();
}
