// B1 and B2: the batched N-list intersection fused with its support.
//
//   out[b, i] = sum_j y_cnt[b, j] * [a_pre[b, i] < y_pre[b, j]] * [a_post[b, i] > y_post[b, j]]
//   sup[b]    = sum_i out[b, i]
//
// B1 replaces src/repro/kernels/nlist_intersect/kernel.py:_intersect_kernel
// (nlist_intersect_pallas); B2 replaces _intersect_es_kernel
// (nlist_intersect_pallas_es), the early-stop twin that, before each A tile
// of la_block slots, keeps a candidate alive only while
// support-so-far + A-count mass of the remaining tiles >= min_count, and
// zeroes the tiles of dead candidates (ref.nlist_intersect_masked_ref).
//
// The TPU kernels build the dense (La x Ly) subsume mask and contract it on
// the MXU in fp32: O(B*W^2) work, exact below 2^24 — a workaround for the
// TPU's slow gathers. Here the gather form is the design: within one item's
// N-list the PPC nodes form an antichain, so a Y code has at most one
// ancestor in A, and it can only be A[searchsorted(a_pre, y_pre) - 1]. One
// binary search, one post test and one int32 atomicAdd per Y code: O(B*W*log W),
// exact and order-independent, so bit-identical to the plain version.
//
// Bound on Hopper: bytes. Each candidate reads 5 (B2: 6) int32 rows of W and
// writes one; the log W probes hit shared memory. Layout: one block per
// candidate; its A pre/post rows and merged row live in shared memory
// (12*W bytes: 192 KB at W = 16384, inside the 227 KB opt-in). Wider lists
// run the same code on global memory. B2 computes the exact merged row,
// then one warp walks the tiles in order and the block zeroes everything
// from the first dead tile on; it saves no work yet over B1.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// block-wide sum; every thread gets the total
__device__ long long block_sum(long long v, long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  long long t = 0;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += scratch[i];
  return t;
}

template <bool kMasked>
__global__ void intersect_kernel(const int* __restrict__ a_pre, const int* __restrict__ a_post,
                                 const int* __restrict__ a_cnt, const int* __restrict__ y_pre,
                                 const int* __restrict__ y_post, const int* __restrict__ y_cnt,
                                 int La, int Ly, int la_block, long long min_count, int use_smem,
                                 int* __restrict__ out, int* __restrict__ sup) {
  extern __shared__ int smem[];
  __shared__ long long scratch[32];
  __shared__ int s_dead;
  const long long b = blockIdx.x;
  const int* ap = a_pre + b * La;
  const int* aq = a_post + b * La;
  const int* yp = y_pre + b * Ly;
  const int* yq = y_post + b * Ly;
  const int* yc = y_cnt + b * Ly;
  int* o = out + b * La;

  const int* sp;
  const int* sq;
  int* so;
  if (use_smem) {
    int* s_pre = smem;
    int* s_post = smem + La;
    so = smem + 2 * La;
    for (int i = threadIdx.x; i < La; i += blockDim.x) {
      s_pre[i] = ap[i];
      s_post[i] = aq[i];
      so[i] = 0;
    }
    sp = s_pre;
    sq = s_post;
  } else {
    for (int i = threadIdx.x; i < La; i += blockDim.x) o[i] = 0;
    sp = ap;
    sq = aq;
    so = o;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < Ly; j += blockDim.x) {
    const int c = yc[j];
    if (c == 0) continue;  // padding and zero-count codes add nothing
    const int v = yp[j];
    int lo = 0, hi = La;  // lo = #{i : a_pre[i] < v}
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sp[mid] < v) lo = mid + 1; else hi = mid;
    }
    const int idx = lo - 1;
    if (idx >= 0 && sq[idx] > yq[j]) atomicAdd(&so[idx], c);
  }
  __syncthreads();

  int dead = La;  // first slot of the first dead tile (La: none)
  if (kMasked) {
    const int* ac = a_cnt + b * La;
    long long mass = 0;
    for (int i = threadIdx.x; i < La; i += blockDim.x) mass += ac[i];
    const long long total = block_sum(mass, scratch);
    if (threadIdx.x < 32) {
      long long s = 0, prefix = 0;
      int d = La;
      for (int t0 = 0; t0 < La; t0 += la_block) {
        if (s + (total - prefix) < min_count) { d = t0; break; }
        const int end = t0 + la_block < La ? t0 + la_block : La;
        long long ts = 0, tm = 0;
        for (int i = t0 + (int)threadIdx.x; i < end; i += 32) { ts += so[i]; tm += ac[i]; }
        s += warp_sum(ts);
        prefix += warp_sum(tm);
      }
      if (threadIdx.x == 0) s_dead = d;
    }
    __syncthreads();
    dead = s_dead;
  }

  long long part = 0;
  for (int i = threadIdx.x; i < La; i += blockDim.x) {
    const int m = i < dead ? so[i] : 0;
    if (use_smem || i >= dead) o[i] = m;
    part += m;
  }
  const long long s = block_sum(part, scratch);
  if (threadIdx.x == 0) sup[b] = (int)s;
}

int launch(bool masked, const int* a_pre, const int* a_post, const int* a_cnt, const int* y_pre,
           const int* y_post, const int* y_cnt, long long B, int La, int Ly, int la_block,
           long long min_count, int* out, int* sup, void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t need = (size_t)3 * La * sizeof(int);
  // static shared memory (scratch, s_dead) comes out of the same budget
  const int use_smem = need + 512 <= (size_t)optin ? 1 : 0;
  const size_t smem = use_smem ? need : 0;
  auto kernel = masked ? intersect_kernel<true> : intersect_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)B, kThreads, smem, s>>>(a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, La, Ly,
                                             la_block, min_count, use_smem, out, sup);
  return (int)cudaGetLastError();
}

}  // namespace

// B1. a_pre, a_post (B, La); y_pre, y_post, y_cnt (B, Ly), all int32 and
// pre-ascending per row -> out (B, La) int32, sup (B,) int32.
extern "C" int nlist_intersect_launch(const int* a_pre, const int* a_post, const int* y_pre,
                                      const int* y_post, const int* y_cnt, long long B, int La,
                                      int Ly, int* out, int* sup, void* stream) {
  return launch(false, a_pre, a_post, nullptr, y_pre, y_post, y_cnt, B, La, Ly, La > 0 ? La : 1, 0,
                out, sup, stream);
}

// B2. B1's inputs plus a_cnt (B, La) int32, the liveness tile la_block and
// the threshold min_count (<= 0: every candidate stays alive, exactly B1).
extern "C" int nlist_intersect_es_launch(const int* a_pre, const int* a_post, const int* a_cnt,
                                         const int* y_pre, const int* y_post, const int* y_cnt,
                                         long long B, int La, int Ly, int la_block,
                                         long long min_count, int* out, int* sup, void* stream) {
  return launch(true, a_pre, a_post, a_cnt, y_pre, y_post, y_cnt, B, La, Ly, la_block, min_count,
                out, sup, stream);
}
