// B3: the Job-1 weighted item histogram, out[k] = sum_r w[r] * #{c : rows[r, c] == k}.
//
// Replaces the TPU kernel src/repro/kernels/histogram/kernel.py:_hist_kernel
// (histogram_pallas), which compared every row tile against a tile of bin ids
// (a dense O(R*L*n_bins) compare: the TPU has no fast scatter). As there, ids
// outside [0, n_bins) (PAD = -1 anywhere in a row) count nothing, a repeated
// item counts once per slot, and the sums are int32, wrapping mod 2^32.
//
// Bound on Hopper: bytes. The work is one read of every slot of rows (R*L
// int32: PAD may sit anywhere, so every slot is read) and of w (R int32) and
// one write of n_bins int32; one shared atomic per valid slot is far below
// any arithmetic peak. Rows are sets, and a warp's 32 consecutive slots span
// one to three rows, so its atomics rarely meet on one address even where an
// item is in most rows. What holds a streaming kernel below the HBM rate is
// the bytes each SM keeps in flight (about 26 KB at 3.35 TB/s and ~1 us of
// latency), and then the instructions each slot costs: at 47.5M slots, a
// handful more a slot is as much time as the bytes.
//
// Design: one persistent block of 1,024 threads per SM.
// - The bins are privatised in shared memory where they fit (kosarak's 41,270
//   bins: 165 KB of the 227 KB a block may use), incremented with shared
//   atomicAdd and flushed once at the end, one global atomicAdd per nonzero
//   bin per block (at most 132 per bin).
// - The rows stream through a ring of S stages in the shared memory the bins
//   leave free (kosarak: 2 stages of 31 KB; small universes up to 8): warp
//   0's first lane fills it with TMA 1-D bulk copies (cp.async.bulk,
//   completion counted in bytes on one mbarrier per stage), so whole tiles
//   are in flight whatever the register count; the other 31 warps consume,
//   each thread one or two 16-byte vectors of a tile, and hand the stage back
//   with one mbarrier arrive per warp, after a proxy fence (the copy engine
//   writes through the async proxy, the threads read through the generic
//   one). Fewer, larger tiles measured faster than more, smaller ones: each
//   hand-over waits for the slowest warp.
// - Tiles are runs of T slots (T a multiple of 4, so 16-byte sized) of the
//   flat R*L stream, dealt round robin to the blocks. Beside each tile the
//   same copy brings the weights of the rows it touches (an aligned run of
//   rows), so a valid slot costs one 32-bit multiply-shift division (its row
//   within the tile), one shared load and one shared atomic; a vector of four
//   PADs costs one test. Rows whose weights the stage does not hold (w not
//   16-byte aligned, the last R % 4 rows, tiles spanning over 1,024 rows) are
//   read through the read-only cache in a second instance of the loop.
// - A base pointer that is not 16-byte aligned (a view such as rows[1:] with
//   L odd) leaves up to 3 slots before the first aligned tile; they and the
//   slots after the last whole tile are read with scalar loads.
// - A universe too large for shared memory (above about 50K bins) streams the same
//   way with the bins in global memory and global atomics.
// Integer atomics are exact and order-free, so the result is bit-identical to
// the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kConsumers = kThreads - 32;  // warps 1..31
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 2 * kMaxStages * 8;  // full and empty mbarriers
constexpr int kMaxWeightRows = 1024;           // weights a stage holds

struct Params {
  long long total;    // R * L slots
  long long R;
  long long n_tiles;  // whole tiles after the head
  long long step_q;   // (gridDim.x * T) / L and % L: a block's advance, in rows
  unsigned step_r;    // and columns, from one of its tiles to its next
  unsigned div_m;     // n / L == (umulhi(n, div_m) + n) >> div_s for 32-bit n
  int div_s;
  int head;           // slots before the first 16-byte boundary (0..3)
  int L;
  int tile;           // T, slots per tile
  int stages;         // S
  int wcap;           // weights a stage holds (a multiple of 4; 0: none)
  int n_bins;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ unsigned fast_div(unsigned n, unsigned m, int s) {
  return static_cast<unsigned>(((unsigned long long)__umulhi(n, m) + n) >> s);
}

// The first slot of a block's current tile, as (row, column); the producer
// and every consumer walk it alike, tile by tile.
struct Cursor {
  long long row;
  unsigned col;
  __device__ Cursor(const Params& p, long long e0) {
    row = e0 / p.L;
    col = (unsigned)(e0 - row * p.L);
  }
  __device__ void next(const Params& p) {
    row += p.step_q;
    col += p.step_r;
    if (col >= (unsigned)p.L) {
      col -= p.L;
      ++row;
    }
  }
  // the rows [wa, wc) whose weights the stage holds: an aligned run of at
  // most wcap rows from the tile's first, none at or past R & ~3, so that
  // the copy is 16-byte sized and stays inside w; true when it covers every
  // row of the tile
  __device__ bool weights(const Params& p, long long& wa, long long& wc) const {
    const long long last = row + fast_div(col + p.tile - 1, p.div_m, p.div_s);
    wa = row & ~3LL;
    wc = min(min(wa + p.wcap, (last + 4) & ~3LL), p.R & ~3LL);
    if (wc < wa) wc = wa;
    return wc > last;
  }
};

template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
hist_kernel(const int* __restrict__ rows, const int* __restrict__ w, Params p,
            int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + kMaxStages;
  const int S = p.stages, T = p.tile;
  int* ring = reinterpret_cast<int*>(smem + kBarBytes);  // S tiles of T slots
  int* wring = ring + (size_t)S * T;                      // S runs of wcap weights
  int* bins = kShared ? wring + (size_t)S * p.wcap : out;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, b = blockIdx.x;
  const long long n_mine = b < p.n_tiles ? (p.n_tiles - 1 - b) / G + 1 : 0;
  const long long e0 = p.head + (long long)b * T;

  Cursor at(p, e0);
  // tile j of this block (its slots and their rows' weights) into stage j % S
  auto issue = [&](long long j) {
    const int s = (int)(j % S);
    const unsigned bar = smem_addr(&full[s]);
    long long wa, wc;
    at.weights(p, wa, wc);
    const unsigned bytes = (unsigned)T * 4u, wbytes = (unsigned)(wc - wa) * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(bytes + wbytes)
                 : "memory");
    bulk_copy(ring + (size_t)s * T, rows + p.head + (b + j * G) * (long long)T, bytes, bar);
    if (wbytes) bulk_copy(wring + (size_t)s * p.wcap, w + wa, wbytes, bar);
    at.next(p);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&full[s])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&empty[s])),
                   "r"(kConsumerWarps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first S tiles load while the bins are zeroed
  if (tid == 0)
    for (long long j = 0; j < n_mine && j < S; ++j) issue(j);
  if (kShared) {
    for (int i = tid; i < p.n_bins; i += kThreads) bins[i] = 0;
    __syncthreads();
  }

  if (warp == 0) {
    if (lane == 0) {
      for (long long j = S; j < n_mine; ++j) {
        mbar_wait(smem_addr(&empty[j % S]), (unsigned)((j / S - 1) & 1));
        issue(j);
      }
    }
    __syncwarp();
  } else {
    const int c = tid - 32, T4 = T / 4;
    for (long long j = 0; j < n_mine; ++j) {
      const int s = (int)(j % S);
      long long wa, wc;
      const bool covered = at.weights(p, wa, wc);
      mbar_wait(smem_addr(&full[s]), (unsigned)((j / S) & 1));
      const int4* tile4 = reinterpret_cast<const int4*>(ring + (size_t)s * T);
      const int* wt = wring + (size_t)s * p.wcap;
      // a vector with no valid id costs one test; a valid slot one division
      // (its row within the tile), one weight and one shared atomic
      auto consume = [&](auto all_in_stage) {
        for (int i4 = c; i4 < T4; i4 += kConsumers) {
          const int4 q = tile4[i4];
          const int v[4] = {q.x, q.y, q.z, q.w};
          bool any = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) any |= (unsigned)v[k] < (unsigned)p.n_bins;
          if (!any) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if ((unsigned)v[k] >= (unsigned)p.n_bins) continue;
            const unsigned d = fast_div(at.col + 4 * i4 + k, p.div_m, p.div_s);
            int wr;
            if constexpr (decltype(all_in_stage)::value) {
              wr = wt[(int)(at.row - wa) + (int)d];
            } else {
              const long long r = at.row + d;
              wr = r < wc ? wt[r - wa] : __ldg(w + r);
            }
            atomicAdd(&bins[v[k]], wr);
          }
        }
      };
      if (covered)
        consume(std::true_type{});
      else
        consume(std::false_type{});
      // the copy engine (async proxy) may refill the stage only after every
      // lane's reads of it (generic proxy) are done
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(&empty[s]))
                     : "memory");
      at.next(p);
    }
    // the misaligned head and the slots after the last whole tile
    const long long tail0 = p.head + p.n_tiles * T;
    const long long n_rest = p.head + (p.total - tail0);
    for (long long k = (long long)b * kConsumers + c; k < n_rest; k += (long long)G * kConsumers) {
      const long long e = k < p.head ? k : tail0 + (k - p.head);
      const int v = __ldg(rows + e);
      if ((unsigned)v < (unsigned)p.n_bins) atomicAdd(&bins[v], __ldg(w + e / p.L));
    }
  }

  if (kShared) {
    __syncthreads();
    for (int i = tid; i < p.n_bins; i += kThreads) {
      const int v = bins[i];
      if (v != 0) atomicAdd(&out[i], v);
    }
  }
}

}  // namespace

// rows (R, L) int32 (PAD = -1), w (R,) int32 -> out (n_bins,) int32. Needs
// rows and w only 4-byte aligned.
extern "C" int histogram_launch(const int* rows, const int* w, long long R, int L, int n_bins,
                                int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)n_bins * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const long long total = R * (long long)L;
  if (total == 0 || n_bins <= 0) return (int)cudaGetLastError();
  const uintptr_t addr = reinterpret_cast<uintptr_t>(rows);
  if ((addr & 3) != 0 || L >= (1 << 30)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);

  Params p{};
  p.total = total;
  p.R = R;
  p.L = L;
  p.n_bins = n_bins;
  p.head = (int)(((16 - (addr & 15)) & 15) / 4);
  if (p.head > total) p.head = (int)total;
  const long long body = total - p.head;
  const size_t hist = (size_t)n_bins * 4;
  const bool w_aligned = (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  // The tile: 2 x 992 vectors (31,744 bytes, two per consumer thread) where
  // the input gives every SM two of them and two stages fit beside the bins
  // (fewer, larger tiles pay fewer stage hand-overs), else 992 vectors.
  auto plan = [&](int t4) {
    p.tile = 4 * t4;
    const long long span = (p.tile - 1) / L + 2 + 3;  // rows a tile touches, aligned
    p.wcap = w_aligned ? (int)((span < kMaxWeightRows ? span : kMaxWeightRows) + 3) & ~3 : 0;
    return (size_t)p.tile * 4 + (size_t)p.wcap * 4;  // bytes a stage holds
  };
  size_t stage = plan(2 * kConsumers);
  if (body < 2LL * sms * p.tile || hist + kBarBytes + 2 * stage > (size_t)optin)
    stage = plan(kConsumers);
  const bool shared_bins = hist + kBarBytes + 2 * stage <= (size_t)optin;
  const size_t room = (size_t)optin - kBarBytes - (shared_bins ? hist : 0);
  long long S = (long long)(room / stage);
  S = S > kMaxStages ? kMaxStages : S;
  p.stages = (int)S;
  p.n_tiles = body / p.tile;
  long long grid = p.n_tiles < sms ? p.n_tiles : sms;
  if (grid < 1) grid = 1;
  const long long adv = grid * p.tile;
  p.step_q = adv / L;
  p.step_r = (unsigned)(adv % L);
  int s = 0;
  while ((1LL << s) < L) ++s;
  p.div_s = s;
  p.div_m = (unsigned)((((1ULL << 32) * ((1ULL << s) - (unsigned long long)L)) / L) + 1);

  const size_t smem = kBarBytes + (size_t)S * stage + (shared_bins ? hist : 0);
  auto launch = [&](auto kernel) -> int {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)grid, kThreads, smem, st>>>(rows, w, p, out);
    return (int)cudaGetLastError();
  };
  return shared_bins ? launch(hist_kernel<true>) : launch(hist_kernel<false>);
}
