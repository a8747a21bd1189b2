// B1 and B2: the batched N-list intersection fused with its support, and the
// wave entry that gathers its operands by index.
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
// Both are one template here (kMasked); B1 is B2 without the liveness test.
//
// The TPU kernels build the dense (La x Ly) subsume mask and contract it on
// the MXU in fp32: O(B*W^2) work, exact below 2^24, and the caller gathers
// every operand row first because a BlockSpec cannot index by a table.
// Here the gather form is the design: within one item's N-list the PPC
// nodes form an antichain, so a Y code has at most one ancestor in A, and it
// can only be A[searchsorted(a_pre, y_pre) - 1]. int32 atomicAdd of the
// code's count onto that slot is exact and order-independent, so the result
// is bit-identical to the plain version.
//
// Bound on Hopper: bytes. A candidate reads its A pre/post rows (B2: and
// its A counts), the Y counts, and Y pre/post only where the count is
// nonzero, and writes one merged row; the log-depth probes hit shared memory.
//
// Design:
// - Gather fused: a block reads its candidate's rows in place, by the row
//   indices it is given (a_idx, y_idx, c_idx; null = row b). The miner's
//   wave passes the (3, K, W) N-list planes, the previous wave's states and
//   the wave's (parent, base, extension) index rows, and copies nothing.
//   Blocks b >= n_live (the wave's padding) write a zero row and support.
// - Tile-ordered merge: A and Y are both pre-ascending, so the Y codes whose
//   ancestor lies in A chunk [t0, t1) are one contiguous run, those with
//   a_pre[t0] < y_pre <= a_pre[t1]. The block first bounds both lists'
//   valid lengths with one round of NT strided probes (padding is a
//   suffix), then walks A's slots below the bound in chunks of SPT*NT
//   slots, keeping only the chunk's pre/post and merged row in shared
//   memory (12 bytes a slot; the liveness scan reads the chunk's A counts
//   from global memory, where the mass pass left them in cache), and
//   streams Y from where the last chunk stopped: 4*NT codes a step, counts
//   first and pre/post only where the count is nonzero, the run ending at
//   the first nonzero-count code past a_pre[t1]. Each chunk's merged slots
//   are written once; the rest of the row is written as zeros.
// - The padding contract at no extra load round: every chunk's Y run ends
//   below INT32_MAX, so a Y padding code (pre INT32_MAX) is always past the
//   run and merges nothing; no valid Y code can reach an A padding slot
//   (padding sorts last), so the merge needs no exact length. B2's mass
//   pass reads A's pre beside its counts and leaves padding out of the
//   mass T. The scan's D(p) still counts padding counts, but only at slots
//   p past the last valid one, where a dead tile zeroes only padding and
//   leaves the support whole: the answer is the plain version's.
// - Early stop that stops: with T = total A-count mass of the valid slots and
//   D(p) = sum_{i<p} (merged[i] - a_cnt[i]), the tile starting at p is
//   alive iff support-so-far + suffix mass >= min_count, i.e.
//   D(p) >= min_count - T. A block scan of D over the chunk checks every
//   la_block boundary in it (la_block may be 1); from the first dead one the
//   block writes zeros and reads nothing more, and the support stays the
//   sum of the slots before it — exactly the plain version's rule,
//   including a dead candidate's frozen partial support. A boundary that
//   opens a chunk is checked before the chunk is read.
// - Filling the card: one block per candidate, whose chain of chunks is
//   sequential (the liveness rule is). With many candidates (n_live >= 4 per
//   SM) blocks of 256 threads take 2,048-slot chunks (24 KB) at most 32
//   registers a thread, so mushroom's W = 2048 rows are one chunk and 8
//   blocks share an SM, both B1 and B2 (mushroom's 1,024 blocks are one
//   resident wave on 132 SMs); with fewer
//   (pumsb's level-2 wave has 1, kosarak's 215 against 132 SMs) blocks of
//   1,024 threads take 4,096-slot chunks, so each chain is at most 4 chunks
//   at W = 16384 and the SMs still hold 32 warps each. No W limit: shared
//   memory holds a chunk, never a row.
// The padding contract: a slot whose pre is INT32_MAX is padding, a suffix
// of each list (both lists pre-ascending before it). Whatever post and
// count a padding slot carries, it merges into no A slot, and under early
// stop its A count adds nothing to the liveness mass. So the result does
// not depend on the launch shape (NT, SPT), and it equals the plain
// versions' (ref.py, core/nlist.py:intersect_torch), which mask padding the
// same way.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kCodesPerThread = 4;  // Y codes a thread takes per stream step

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide sum; every thread gets the total
template <int NT>
__device__ long long block_sum(long long v, long long* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // scratch may still be read by an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  long long t = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) t += scratch[i];
  return t;
}

// An upper bound of a list's valid length, within one probe stride: padding
// (pre = INT32_MAX) is a suffix, so every slot from the first padded probe
// on is padding. One round of NT independent loads; the caller reduces.
template <int NT>
__device__ __forceinline__ int first_padded_probe(const int* pre, int n) {
  const int stride = (n + NT - 1) / NT;
  const int p = threadIdx.x * stride;
  return (p < n && pre[p] == INT_MAX) ? p : n;
}

// NT threads; a chunk of SPT*NT A slots. Blocks of 256 or fewer threads are
// held to 2048 / NT resident blocks' worth of registers.
template <bool kMasked, int NT, int SPT>
__global__ void __launch_bounds__(NT, NT <= 256 ? 2048 / NT : 1)
wave_kernel(const int* __restrict__ a_pre, const int* __restrict__ a_post,
            const int* __restrict__ a_cnt, const long long* __restrict__ a_idx,
            const int* __restrict__ y_pre, const int* __restrict__ y_post,
            const long long* __restrict__ y_idx, const int* __restrict__ y_cnt,
            const long long* __restrict__ c_idx, int La, int Ly, long long n_live,
            int la_block, long long min_count, int* __restrict__ out, int* __restrict__ sup) {
  constexpr int CH = SPT * NT;
  constexpr int NW = NT / 32;
  constexpr int YS = kCodesPerThread * NT;  // Y codes per stream step
  extern __shared__ int smem[];
  int* s_pre = smem;
  int* s_post = smem + CH;
  int* s_m = smem + 2 * CH;
  __shared__ long long scratch[NW];
  __shared__ long long s_scan[NW];
  __shared__ int s_first[2][NW];
  __shared__ int s_deadw[NW];
  __shared__ int s_len[2][NW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  int* o = out + b * La;
  if (b >= n_live) {
    for (int i = tid; i < La; i += NT) o[i] = 0;
    if (tid == 0) sup[b] = 0;
    return;
  }
  const long long ra = a_idx ? a_idx[b] : b;
  const long long ry = y_idx ? y_idx[b] : b;
  const long long rc = c_idx ? c_idx[b] : b;
  const int* ap = a_pre + ra * La;
  const int* aq = a_post + ra * La;
  const int* yp = y_pre + ry * Ly;
  const int* yq = y_post + ry * Ly;
  const int* yc = y_cnt + rc * Ly;

  // valid lengths (upper bounds): A's slots past na and Y's codes past ny
  // are padding, which merges nothing and weighs nothing (see the header)
  {
    const int pa = warp_min(first_padded_probe<NT>(ap, La));
    const int py = warp_min(first_padded_probe<NT>(yp, Ly));
    if (lane == 0) { s_len[0][warp] = pa; s_len[1][warp] = py; }
  }
  __syncthreads();
  int na = La, ny = Ly;
#pragma unroll
  for (int w = 0; w < NW; ++w) { na = min(na, s_len[0][w]); ny = min(ny, s_len[1][w]); }

  long long theta = 0;  // the tile at p is dead iff D(p) < theta
  const int* ac = nullptr;
  if (kMasked) {
    // the mass of A's valid slots: each count masked by its slot's pre,
    // both loaded unconditionally so that no load waits on another (a
    // branch or a second pass over the padded slots makes the 256-thread B2
    // spill registers)
    ac = a_cnt + ra * La;
    long long m = 0;
    for (int i = tid; i < na; i += NT) {
      const int c = ac[i], p = ap[i];
      m += c & -(int)(p != INT_MAX);
    }
    theta = min_count - block_sum<NT>(m, scratch);
  }

  long long D = 0;     // sum over the slots before t0 of (merged - cnt)
  long long part = 0;  // this thread's share of the support
  int j = 0;           // Y stream position
  int it = 0;          // Y stream steps, for the double-buffered s_first
  int t0 = 0;
  for (; t0 < na; t0 += CH) {
    if (kMasked && t0 % la_block == 0 && D < theta) break;  // dead before reading the chunk
    const int n = min(CH, na - t0);
    __syncthreads();  // the previous chunk's tiles have been written out
    for (int i = tid; i < n; i += NT) {
      s_pre[i] = ap[t0 + i];
      s_post[i] = aq[t0 + i];
      s_m[i] = 0;
    }
    // the run's end; below INT_MAX, so Y's padding codes lie past every run
    const int hi = min(t0 + n < na ? ap[t0 + n] : INT_MAX, INT_MAX - 1);
    __syncthreads();

    // merge the chunk's run of Y codes: it ends at the first nonzero-count
    // code past hi
    while (j < ny) {
      int c[kCodesPerThread], v[kCodesPerThread];
#pragma unroll
      for (int k = 0; k < kCodesPerThread; ++k) {
        const int jj = j + k * NT + tid;
        c[k] = jj < ny ? yc[jj] : 0;
      }
#pragma unroll
      for (int k = 0; k < kCodesPerThread; ++k) v[k] = c[k] ? yp[j + k * NT + tid] : 0;
      int beyond = YS;
#pragma unroll
      for (int k = 0; k < kCodesPerThread; ++k) {
        if (!c[k]) continue;
        if (v[k] > hi) {
          beyond = min(beyond, k * NT + tid);
          continue;
        }
        int lo = 0, h = n;  // lo = #{i : a_pre[t0 + i] < v}
        while (lo < h) {
          const int mid = (lo + h) >> 1;
          if (s_pre[mid] < v[k]) lo = mid + 1; else h = mid;
        }
        if (lo > 0 && s_post[lo - 1] > yq[j + k * NT + tid]) atomicAdd(&s_m[lo - 1], c[k]);
      }
      beyond = warp_min(beyond);
      int* sf = s_first[it & 1];
      if (lane == 0) sf[warp] = beyond;
      ++it;
      __syncthreads();
      int first = YS;
#pragma unroll
      for (int w = 0; w < NW; ++w) first = min(first, sf[w]);
      j += first;
      if (first < YS) break;
    }

    // write the chunk; with early stop, up to its first dead tile
    int dead = INT_MAX;  // first dead slot in this chunk, if any
    if (kMasked) {
      const int s0 = tid * SPT;
      const int* acc = ac + t0 + s0;  // this thread's A counts, cached
      long long ts = 0;
#pragma unroll
      for (int k = 0; k < SPT; ++k)
        if (s0 + k < n) ts += (long long)s_m[s0 + k] - acc[k];
      long long x = ts;  // inclusive warp scan
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (lane == 31) s_scan[warp] = x;
      __syncthreads();
      long long before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const long long s = s_scan[w];
        if (w < warp) before += s;
        total += s;
      }
      long long d = D + before + x - ts;  // D at slot t0 + s0
      int mine = INT_MAX;
#pragma unroll
      for (int k = 0; k < SPT; ++k) {
        if (s0 + k >= n) break;
        const int p = t0 + s0 + k;
        if (p % la_block == 0 && d < theta && mine == INT_MAX) mine = p;
        d += (long long)s_m[s0 + k] - acc[k];
      }
      mine = warp_min(mine);
      if (lane == 0) s_deadw[warp] = mine;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < NW; ++w) dead = min(dead, s_deadw[w]);
      D += total;
    }
    for (int i = tid; i < n; i += NT) {
      const int m = t0 + i < dead ? s_m[i] : 0;
      o[t0 + i] = m;
      part += m;
    }
    if (dead != INT_MAX) { t0 += n; break; }
  }
  for (int i = min(t0, na) + tid; i < La; i += NT) o[i] = 0;  // dead tiles and padding
  const long long s = block_sum<NT>(part, scratch);
  if (tid == 0) sup[b] = (int)s;
}

template <bool kMasked, int NT, int SPT>
int launch_t(const int* a_pre, const int* a_post, const int* a_cnt, const long long* a_idx,
             const int* y_pre, const int* y_post, const long long* y_idx, const int* y_cnt,
             const long long* c_idx, long long B, int La, int Ly, long long n_live,
             int la_block, long long min_count, int* out, int* sup, cudaStream_t s) {
  const size_t smem = (size_t)3 * SPT * NT * sizeof(int);
  auto kernel = wave_kernel<kMasked, NT, SPT>;
  // dynamic plus static shared memory above 48 KB needs the opt-in, which
  // holds for the current card only: a mesh over several cards opts in on each
  constexpr int kCards = 64;
  static bool opted_in[kCards] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem >= 32 * 1024 && (dev >= kCards || !opted_in[dev])) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kCards) opted_in[dev] = true;
  }
  kernel<<<(unsigned)B, NT, smem, s>>>(a_pre, a_post, a_cnt, a_idx, y_pre, y_post, y_idx, y_cnt,
                                       c_idx, La, Ly, n_live, la_block, min_count, out, sup);
  return (int)cudaGetLastError();
}

}  // namespace

// The one launcher of B1 (masked = 0) and B2 (masked = 1). Row b of the
// launch reads A row a_idx[b] of a_pre/a_post/a_cnt (La wide), Y row
// y_idx[b] of y_pre/y_post and row c_idx[b] of y_cnt (Ly wide); a null
// index array means row b. Writes out (B, La) int32 and sup (B,) int32;
// rows b >= n_live are zero. B2 takes a_cnt, la_block >= 1 and min_count.
extern "C" int nlist_wave_launch(const int* a_pre, const int* a_post, const int* a_cnt,
                                 const long long* a_idx, const int* y_pre, const int* y_post,
                                 const long long* y_idx, const int* y_cnt,
                                 const long long* c_idx, long long B, int La, int Ly,
                                 long long n_live, int masked, int la_block, long long min_count,
                                 int* out, int* sup, void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int sms = 0;  // asked once: a mesh's cards are of one model
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const bool many = n_live >= 4LL * sms;
  if (la_block < 1) la_block = 1;
#define REPRO_WAVE(M, NT, SPT)                                                                 \
  return launch_t<M, NT, SPT>(a_pre, a_post, a_cnt, a_idx, y_pre, y_post, y_idx, y_cnt, c_idx, \
                              B, La, Ly, n_live, la_block, min_count, out, sup, s)
  if (masked) {
    if (many) REPRO_WAVE(true, 256, 8);
    REPRO_WAVE(true, 1024, 4);
  }
  if (many) REPRO_WAVE(false, 256, 8);
  REPRO_WAVE(false, 1024, 4);
#undef REPRO_WAVE
}
