// B4: the F2 weighted pair co-occurrence C = X^T diag(w) X over one-hot rank
// rows: C[i, j] = sum_r w[r] * cnt_r(i) * cnt_r(j), full symmetric, with the
// diagonal equal to each item's support.
//
// Replaces the TPU kernel src/repro/kernels/cooccur/kernel.py:_cooc_kernel
// (cooccur_pallas), which built one-hot (rows x K) tiles in VMEM and
// contracted them on the MXU in fp32 — exact only below 2^24.
//
// What bounds it on Hopper. The function reads R*L int32 ranks once and
// writes K*K int32; densely, the one-hot product is R*K^2/2 int8
// multiply-adds over the upper triangle. At the one-shot mines' shapes
// (pumsb K 292, kosarak K 57, mushroom K 68) the bytes bound it (kosarak's
// 190 MB of ranks). At wide K the product does: the reference's production
// rows (1,048,576 x 48, K 2,048) need 2.3e12 multiply-adds densely, 2.4 ms
// at the int8 tensor-core peak, against 0.07 ms for the bytes; a pumsb
// stream segment (12,262 x 74, K 7,104) 3.2e11. A design that builds each
// 128 x 128 output tile's operands from the raw ranks reads every rank once
// per tile (136 tiles at K 2,048, 1,596 at K 7,104) and zeroes 36 KB of
// shared memory per tile and 128 rows: that, not the product, was 95% of
// the time of the kernel this one replaces at those shapes.
//
// Design: read each rank once, build each output tile's operands from its
// own two item bands only, and skip the rows that touch neither.
// 1. cooc_bucket_kernel, one block per 128-row tile: stages the tile's ranks
//    in shared memory (16-byte loads) and, a warp a row, writes its valid
//    entries grouped by 128-item band, each packed as (row in tile << 7 |
//    item in band) in 16 bits, into the tile's own slot of the scratch
//    (128*L entries, so no global scan), with n_bands + 2 offsets a tile
//    (band starts, the end of the entries, the end of the list of rows that
//    take the scalar path) and, a band, the 128-bit mask of the rows that
//    touch it. Counts and cursors take one shared atomic per band a warp
//    (__match_any_sync). Rows that cannot take 0/1 bytes — a weight other
//    than 0 or 1, or an item repeated in the row, found when its bit in a
//    shared (row, item) bitmap is already set — are listed instead;
//    weight-0 rows are dropped. Per-band totals (entries, rows touching) go
//    to a small zeroed header; the last block to finish prices each tile
//    and places each product block's first tile. It also zeroes C.
// 2. cooc_wgmma_kernel, persistent (one block a SM): block b takes the
//    b-th equal share of the summed cost, as (tile, row-tile range) pieces,
//    so the band-0 tiles of a Zipf law, which hold most entries, are cut
//    into more pieces than the rare bands' tiles (the cost is fitted to the
//    blocks' clocks: tile_cost). A tile's k dimension runs only over the
//    rows that touch its rarer band Q (band 15 of 16 at production is
//    touched by a quarter of the rows): Σ over tiles of the kept rows is
//    52.8 R at production, not the 136 R a dense product runs.
//    - Every warp builds, 32 row tiles a round: the kept rows are packed
//      back to back across row tiles into 256-row stages, each row a k
//      index and each item a row of an item-major int8 one-hot operand in
//      wgmma's 128-byte-swizzled K-major layout (two 16 KB atoms of k an
//      operand). Threads take the round's entries as 16-byte vectors of 8
//      and set one byte per entry of band Q and per entry of the other band
//      whose row is kept (a table of each kept row's place); each item's
//      loads are issued before the previous item's bytes are written.
//      Building, not the product, sets the pace: at production the blocks
//      spend about 80% of their clocks in it and under 2% waiting for the
//      tensor cores.
//    - Warpgroups 1 and 2 run wgmma.mma_async m64n128k32 s32.s8.s8 on their
//      64 items of band I against the 128 of band J, ceil(k/32) steps a
//      stage, int32 accumulators in registers, asynchronously: the next
//      stage (two in all, 128 KB) is zeroed and built while it runs.
//      A stage's two operands are zeroed whole, 64 KB of 16-byte stores
//      (about 8% of a block's clocks at production), not byte by byte:
//      clearing only the bytes set needs each one listed in the build loop,
//      which sets the pace, and measured 4-5% slower at K 2,048 and 7,104.
//      Diagonal tiles use one operand for both.
//    - Epilogue, at a piece's end: one int32 atomicAdd per nonzero output
//      and its mirror (off-diagonal tiles), so C stays full and symmetric.
//    - The listed rows take an exact scalar path first: every ordered pair
//      of valid slots adds w[r] into C with an int32 atomic.
// 3. One band (K <= 128: kosarak, mushroom): there is one output tile and
//    each rank is read once already, so bucketing would only add its
//    traffic and two launches (it measured 0.29 ms on kosarak's rows, where
//    the whole kernel takes 0.14): cooc_band_kernel<64 or 128> builds the
//    tile's one-hot straight from the ranks and contracts it with mma.sync,
//    repeated items and weights through the same exact scalar path.
// Exactness: one-hot bytes are 0/1 (a row with a repeat never reaches
// them), accumulators int32, partial tiles and scalar pairs are added with
// int32 atomics: every sum is int32 mod 2^32 and order-free, so the result
// is bit-identical to the plain version (int64 sums cast to int32).
// Scratch (the wrapper's, torch.empty; K > 128 only): R*L*2 bytes of
// entries, ceil(R/128)*(n_bands+2)*4 of offsets, ceil(R/128)*n_bands*16 of
// masks, and a header of n_bands*16 + 8 + (n_tiles+1)*8 + (blocks+1)*4
// bytes, each part 256-byte aligned: cooccur_scratch_bytes, which the wrapper asks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;        // rows per row tile
constexpr int kBand = 128;        // items per band (an output tile's side)
constexpr int kStages = 2;
constexpr int kStageRows = 256;   // k rows a stage: two 128-byte swizzle atoms of k
constexpr int kOpBytes = kBand * kStageRows;  // one int8 operand: 32 KB
constexpr int kBatch = 32;        // row tiles a round of the build takes
constexpr int kV = 2;             // 16-byte entry loads in flight a thread
constexpr int kBucketThreads = 256;
constexpr int kGroupBands = 32;   // bands a repeat bitmap covers (64 KB)
constexpr int kProdThreads = 384; // every warp builds; warpgroups 1 and 2 run the product

__host__ __device__ inline size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

// the scratch's parts, in bytes from its start (cooccur_scratch_bytes)
struct Layout {
  size_t hdr_E, hdr_rows, done, hdr_end, plan, start, offs, masks, ent, total;
};

__host__ __device__ inline Layout layout(long long R, int L, int K, int blocks) {
  const long long nb = (K + kBand - 1) / kBand, n_rt = (R + kRows - 1) / kRows;
  const long long n_tiles = nb * (nb + 1) / 2;
  Layout s;
  s.hdr_E = 0;
  s.hdr_rows = 8 * nb;
  s.done = 16 * nb;
  s.hdr_end = 16 * nb + 8;
  s.plan = align256(s.hdr_end);
  s.start = s.plan + align256(8 * (n_tiles + 1));
  s.offs = s.start + align256(4 * ((long long)blocks + 1));
  s.masks = s.offs + align256(4 * n_rt * (nb + 2));
  s.ent = s.masks + align256(16 * n_rt * nb);
  s.total = s.ent + align256(2 * R * (long long)L + 16);  // + a vector read past the last slot
  return s;
}

// a tile's cost, in entries read, from a least-squares fit of the product
// blocks' clocks at the production, stream-segment and pumsb shapes
// (NVIDIA H100): a kept row (of the band fewer rows touch) costs as much as
// 21 entries, a row tile (its round's tables and kept-row places) 448
__device__ inline unsigned long long tile_cost(const unsigned long long* E, const unsigned long long* rows,
                                               int I, int J, long long n_rt) {
  if (E[I] == 0 || E[J] == 0) return 0;
  const unsigned long long rq = min(rows[I], rows[J]);
  return 21 * rq + E[I] + (I == J ? 0 : E[J]) + 448 * (unsigned long long)n_rt;
}

// ------------------------------------------------------------ bucketing pass
__global__ void __launch_bounds__(kBucketThreads)
cooc_bucket_kernel(const int* __restrict__ rows, const int* __restrict__ w, long long R, int L, int K,
                   int nb, long long n_rt, int blocks, bool staged, int* __restrict__ out,
                   unsigned char* __restrict__ scratch, Layout lay) {
  extern __shared__ __align__(16) unsigned s_dyn[];
  const int ng = min(nb, kGroupBands);
  int* s_rows = reinterpret_cast<int*>(s_dyn);                  // 128 * L when staged
  unsigned* bitmap = s_dyn + (staged ? kRows * L : 0);          // ng * 512 words
  int* s_cnt = reinterpret_cast<int*>(bitmap + ng * 512);       // nb
  unsigned* s_touch = reinterpret_cast<unsigned*>(s_cnt + nb);  // nb * 4
  __shared__ int s_w[kRows], s_irr[kRows];
  __shared__ int s_nirr, s_total, s_last, s_any_rep;

  unsigned long long* hdr_E = reinterpret_cast<unsigned long long*>(scratch + lay.hdr_E);
  unsigned long long* hdr_rows = reinterpret_cast<unsigned long long*>(scratch + lay.hdr_rows);
  unsigned* done = reinterpret_cast<unsigned*>(scratch + lay.done);
  int* offs = reinterpret_cast<int*>(scratch + lay.offs);
  uint4* masks = reinterpret_cast<uint4*>(scratch + lay.masks);
  unsigned short* ent = reinterpret_cast<unsigned short*>(scratch + lay.ent);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kBucketThreads / 32;
  const long long t = blockIdx.x;
  const long long r0 = t * kRows;
  const int nr = (int)min((long long)kRows, R - r0);
  const int* base = rows + r0 * L;
  unsigned short* slot = ent + r0 * L;

  // the tile's ranks into shared memory, 16-byte loads where the rows allow
  // (a tile starts 512*t*L bytes in: aligned whenever the rows are)
  if (staged) {
    const int n = nr * L;
    if ((reinterpret_cast<uintptr_t>(rows) & 15) == 0) {
      const int4* g4 = reinterpret_cast<const int4*>(base);
      int4* s4 = reinterpret_cast<int4*>(s_rows);
#pragma unroll 8
      for (int i = tid; i < (n >> 2); i += kBucketThreads) s4[i] = __ldg(g4 + i);
      for (int i = (n & ~3) + tid; i < n; i += kBucketThreads) s_rows[i] = __ldg(base + i);
    } else {
#pragma unroll 8
      for (int i = tid; i < n; i += kBucketThreads) s_rows[i] = __ldg(base + i);
    }
  }
  const int* src = staged ? s_rows : base;
  // zero C (the product kernel only adds into it)
  {
    const long long n = (long long)K * K, stride = (long long)gridDim.x * kBucketThreads;
    const long long n4 = n >> 2;
    int4* o4 = reinterpret_cast<int4*>(out);
    for (long long i = t * kBucketThreads + tid; i < n4; i += stride) o4[i] = make_int4(0, 0, 0, 0);
    for (long long i = 4 * n4 + t * kBucketThreads + tid; i < n; i += stride) out[i] = 0;
  }
  if (tid < kRows) {
    const int wr = tid < nr ? w[r0 + tid] : 0;
    s_w[tid] = wr;
    s_irr[tid] = wr != 0 && wr != 1;
  }
  for (int b = tid; b < nb; b += kBucketThreads) {
    s_cnt[b] = 0;
    s_touch[4 * b] = s_touch[4 * b + 1] = s_touch[4 * b + 2] = s_touch[4 * b + 3] = 0;
  }
  if (tid == 0) {
    s_nirr = 0;
    s_any_rep = 0;
  }

  // one pass over the weight-1 rows (a warp a row): count each band's
  // entries and the rows that touch it (one atomic per band a warp), and
  // find repeated items: a (row, item) bit already set in the bitmap. Bands
  // past the first 32 are checked for repeats in further passes.
  for (int g0 = 0; g0 < nb; g0 += kGroupBands) {
    const int gb = min(kGroupBands, nb - g0);
    uint4* z = reinterpret_cast<uint4*>(bitmap);
    for (int i = tid; i < gb * 128; i += kBucketThreads) z[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (int r = warp; r < nr; r += kWarps) {
      if (s_w[r] != 1) continue;
      for (int c0 = 0; c0 < L; c0 += 32) {
        const int c = c0 + lane;
        const int v = c < L ? src[r * L + c] : -1;
        const bool valid = (unsigned)v < (unsigned)K;
        const unsigned vm = __ballot_sync(0xffffffffu, valid);
        if (!valid) continue;
        const int band = v >> 7;
        if (g0 == 0) {
          const unsigned peers = __match_any_sync(vm, band);
          if (lane == __ffs(peers) - 1) {
            atomicAdd(&s_cnt[band], __popc(peers));
            atomicOr(&s_touch[4 * band + (r >> 5)], 1u << (r & 31));
          }
        }
        const int b = band - g0;
        if ((unsigned)b >= (unsigned)gb) continue;
        const unsigned bit = ((unsigned)b << 14) | ((unsigned)r << 7) | (unsigned)(v & 127);
        const unsigned m = 1u << (bit & 31);
        if (atomicOr(&bitmap[bit >> 5], m) & m) {
          s_irr[r] = 1;
          s_any_rep = 1;
        }
      }
    }
    __syncthreads();
  }
  // a weight-1 row with a repeat leaves the counts and the masks again
  if (s_any_rep) {
    for (int r = warp; r < nr; r += kWarps) {
      if (s_w[r] != 1 || !s_irr[r]) continue;
      for (int c = lane; c < L; c += 32) {
        const int v = src[r * L + c];
        if ((unsigned)v >= (unsigned)K) continue;
        atomicSub(&s_cnt[v >> 7], 1);
        atomicAnd(&s_touch[4 * (v >> 7) + (r >> 5)], ~(1u << (r & 31)));
      }
    }
    __syncthreads();
  }
  int* o = offs + t * (nb + 2);
  if (warp == 0) {  // exclusive scan of the band counts, 32 at a time
    int carry = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + lane;
      const int c = b < nb ? s_cnt[b] : 0;
      int x = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (b < nb) {
        o[b] = carry + x - c;
        s_cnt[b] = carry + x - c;  // now each band's write cursor
        if (c) atomicAdd(&hdr_E[b], (unsigned long long)c);
      }
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) {
      o[nb] = carry;
      s_total = carry;
    }
  }
  for (int b = tid; b < nb; b += kBucketThreads) {
    const uint4 m = make_uint4(s_touch[4 * b], s_touch[4 * b + 1], s_touch[4 * b + 2], s_touch[4 * b + 3]);
    masks[t * nb + b] = m;
    const int touched = __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
    if (touched) atomicAdd(&hdr_rows[b], (unsigned long long)touched);
  }
  __syncthreads();

  // write the entries at their bands' cursors (one atomic per band a warp);
  // the listed rows after them
  for (int r = warp; r < nr; r += kWarps) {
    if (s_w[r] != 1 || s_irr[r]) continue;
    for (int c0 = 0; c0 < L; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < L ? src[r * L + c] : -1;
      const bool valid = (unsigned)v < (unsigned)K;
      const unsigned vm = __ballot_sync(0xffffffffu, valid);
      if (!valid) continue;
      const int band = v >> 7;
      const unsigned peers = __match_any_sync(vm, band);
      const int leader = __ffs(peers) - 1;
      int pos = 0;
      if (lane == leader) pos = atomicAdd(&s_cnt[band], __popc(peers));
      pos = __shfl_sync(peers, pos, leader) + __popc(peers & ((1u << lane) - 1));
      slot[pos] = (unsigned short)((r << 7) | (v & 127));
    }
  }
  if (tid < kRows && s_irr[tid] && s_w[tid] != 0) {
    const int pos = atomicAdd(&s_nirr, 1);
    slot[s_total + pos] = (unsigned short)tid;
  }
  __syncthreads();
  if (tid == 0) o[nb + 1] = s_total + s_nirr;

  // the last block to finish prices the tiles and places the product blocks
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1u) == (unsigned)(n_rt - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long n_tiles = (long long)nb * (nb + 1) / 2;
  unsigned long long* plan = reinterpret_cast<unsigned long long*>(scratch + lay.plan);
  int* start = reinterpret_cast<int*>(scratch + lay.start);
  const volatile unsigned long long* vE = hdr_E;
  const volatile unsigned long long* vR = hdr_rows;
  // copy the totals into shared memory (the bitmap's room: 64 KB >= 16*nb
  // while nb <= 4096; beyond that read them where they are)
  unsigned long long* E = reinterpret_cast<unsigned long long*>(bitmap);
  unsigned long long* RT = E + nb;
  const bool in_smem = 16LL * nb <= (long long)ng * 512 * 4;
  if (in_smem) {
    for (int b = tid; b < nb; b += kBucketThreads) {
      E[b] = vE[b];
      RT[b] = vR[b];
    }
  }
  __syncthreads();
  if (!in_smem) {
    E = hdr_E;
    RT = hdr_rows;
  }
  // each thread prices one chunk of tiles (tile order: I-major over I <= J)
  const long long per = (n_tiles + kBucketThreads - 1) / kBucketThreads;
  const long long x0 = min(n_tiles, tid * per), x1 = min(n_tiles, x0 + per);
  int I = 0;
  long long rem = x0;
  while (I < nb && rem >= nb - I) { rem -= nb - I; ++I; }
  int J = I + (int)rem;
  unsigned long long sum = 0;
  {
    int i = I, j = J;
    for (long long x = x0; x < x1; ++x) {
      sum += tile_cost(E, RT, i, j, n_rt);
      if (++j == nb) { ++i; j = i; }
    }
  }
  __shared__ unsigned long long s_sum[kBucketThreads];
  s_sum[tid] = sum;
  __syncthreads();
  if (tid == 0) {  // exclusive prefix over the 256 chunks
    unsigned long long acc = 0;
    for (int i = 0; i < kBucketThreads; ++i) {
      const unsigned long long v = s_sum[i];
      s_sum[i] = acc;
      acc += v;
    }
    plan[n_tiles] = acc;
  }
  __syncthreads();
  const unsigned long long total = plan[n_tiles];
  unsigned long long p = s_sum[tid];
  for (long long x = x0; x < x1; ++x) {
    const unsigned long long c = tile_cost(E, RT, I, J, n_rt);
    plan[x] = p;
    // the blocks whose share starts inside this tile start here
    if (c) {
      long long b = (long long)(p * blocks / total);
      while (b < blocks && total * b / blocks < p) ++b;
      for (; b < blocks && total * b / blocks < p + c; ++b) start[b] = (int)x;
    }
    p += c;
    if (++J == nb) { ++I; J = I; }
  }
  if (tid == 0) start[blocks] = (int)n_tiles;
  if (total == 0)
    for (int b = tid; b < blocks; b += kBucketThreads) start[b] = (int)n_tiles;
}

// ---------------------------------------------------------- the product pass
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte (item, k) of an item-major operand in the 128-byte swizzle: 128
// bytes an item, 16-byte chunks XOR-ed with the item's low 3 bits
__device__ __forceinline__ int swz(int item, int k) {
  return item * 128 + ((((k >> 4) ^ item) & 7) << 4) + (k & 15);
}

// byte (item, k) of a stage's operand: k in two 128-byte atoms, 16 KB apart
__device__ __forceinline__ int op_off(int item, int k) { return (k >> 7) * (kBand * 128) + swz(item, k & 127); }

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]),
        "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
        "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous product's fence and wait
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

struct ProdShared {
  unsigned m[kBatch][4];      // band Q's row mask of each row tile in the round
  short prow[kBatch][kRows];  // each kept row's place in the round, -1: not kept
  int pos[kBatch], cnt[kBatch];  // a row tile's first kept row in the round, and its count
  int qb[kBatch], nq[kBatch], pb[kBatch], np[kBatch];  // entry ranges of bands Q and P
  int nvq[kBatch], vpre[kBatch + 1];  // 8-entry vectors of band Q, and before each row tile
  int n_round;
};

// one round of a product block's build: kept rows [pos, pos + take) of
// the round, to stage rows from the stage's fill; the 16-byte entry vectors
// [g0, min(g0 + kProdThreads * kV, g_hi)) of row tiles [ia, ib]
struct Item {
  int pos, take, g0, g_hi, ia, ib;
  bool valid;
};

// the item of rows [pos, pos + take): the row tiles they lie in, from the
// first of their vectors (every warp computes the same, from shared tables)
__device__ __forceinline__ Item chunk_item(const ProdShared& sh, int pos, int take, int nbt) {
  const int lane = threadIdx.x & 31;
  const bool hit = lane < nbt && sh.pos[lane] < pos + take && sh.pos[lane] + sh.cnt[lane] > pos;
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  Item it;
  it.pos = pos;
  it.take = take;
  it.ia = __ffs(hits) - 1;
  it.ib = 31 - __clz(hits);
  it.g0 = sh.vpre[it.ia];
  it.g_hi = sh.vpre[it.ib + 1];
  it.valid = true;
  return it;
}

__device__ __forceinline__ Item first_item(const ProdShared& sh, int N, int fill, int nbt) {
  if (N == 0) {
    Item it{};
    it.valid = false;
    return it;
  }
  return chunk_item(sh, 0, min(kStageRows - fill, N), nbt);
}

// the item after `it`: its next round, or the next chunk of rows (which
// starts a fresh stage when this one fills it)
__device__ __forceinline__ Item next_item(const ProdShared& sh, const Item& it, int N, int nbt) {
  if (!it.valid) return it;
  if (it.g0 + kProdThreads * kV < it.g_hi) {
    Item n = it;
    n.g0 += kProdThreads * kV;
    return n;
  }
  const int pos = it.pos + it.take;
  if (pos >= N) {
    Item n{};
    n.valid = false;
    return n;
  }
  // the previous chunk either filled its stage or ended the round
  return chunk_item(sh, pos, min(kStageRows, N - pos), nbt);
}

// issue an item's loads: thread tid takes vectors g0 + k * kProdThreads + tid
__device__ __forceinline__ void load_item(const ProdShared& sh, const Item& it, const unsigned short* ent,
                                          long long t0, int L, int tid, uint4 (&d)[kV], int (&ti)[kV]) {
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    const int g = it.g0 + k * kProdThreads + tid;
    d[k] = make_uint4(0, 0, 0, 0);
    ti[k] = it.ia;
    if (!it.valid || g >= it.g_hi) continue;
    int i = it.ia, hi = it.ib;  // the last row tile whose vectors start at or before g
    while (i < hi) {
      const int mid = (i + hi + 1) >> 1;
      if (sh.vpre[mid] <= g) i = mid; else hi = mid - 1;
    }
    ti[k] = i;
    const int f = g - sh.vpre[i], nvq = sh.nvq[i];
    const int vi = f < nvq ? (sh.qb[i] >> 3) + f : (sh.pb[i] >> 3) + (f - nvq);
    d[k] = reinterpret_cast<const uint4*>(ent + (t0 + i) * kRows * L)[vi];
  }
}

__global__ void __launch_bounds__(kProdThreads, 1)
cooc_wgmma_kernel(const int* __restrict__ rows, const int* __restrict__ w, long long R, int L, int K, int nb,
                  long long n_rt, int* __restrict__ out, const unsigned char* __restrict__ scratch, Layout lay) {
  extern __shared__ __align__(16) unsigned char p_dyn[];
  // kStages x (A, B), 1024-byte aligned for the swizzle (pointer arithmetic
  // on the shared array, so that the stores stay shared stores)
  unsigned char* ops = p_dyn + ((1024 - (smem_u32(p_dyn) & 1023)) & 1023);
  __shared__ ProdShared sh;
  __shared__ int s_irr_t[kProdThreads], s_n_irr_t;

  const unsigned long long* RT = reinterpret_cast<const unsigned long long*>(scratch + lay.hdr_rows);
  const unsigned long long* plan = reinterpret_cast<const unsigned long long*>(scratch + lay.plan);
  const int* start = reinterpret_cast<const int*>(scratch + lay.start);
  const int* offs = reinterpret_cast<const int*>(scratch + lay.offs);
  const uint4* masks = reinterpret_cast<const uint4*>(scratch + lay.masks);
  const unsigned short* ent = reinterpret_cast<const unsigned short*>(scratch + lay.ent);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long n_tiles = (long long)nb * (nb + 1) / 2;
  const int G = gridDim.x, b = blockIdx.x;
  const int cw = (warp >> 2) - 1;  // consumer warpgroup: -1 (none), 0: items 0-63 of band I, 1: 64-127

  // exact scalar path: the listed rows of this block's share of row tiles
  for (long long c0 = b; c0 < n_rt; c0 += (long long)G * kProdThreads) {
    const long long t = c0 + (long long)tid * G;
    if (tid == 0) s_n_irr_t = 0;
    __syncthreads();
    if (t < n_rt && offs[t * (nb + 2) + nb + 1] > offs[t * (nb + 2) + nb]) s_irr_t[atomicAdd(&s_n_irr_t, 1)] = tid;
    __syncthreads();
    for (int q = 0; q < s_n_irr_t; ++q) {
      const long long tt = c0 + (long long)s_irr_t[q] * G;
      const int* o = offs + tt * (nb + 2);
      const unsigned short* list = ent + tt * kRows * L + o[nb];
      const int n_list = o[nb + 1] - o[nb];
      for (int li = 0; li < n_list; ++li) {
        const long long rg = tt * kRows + list[li];
        const int wr = w[rg];
        const int* row = rows + rg * L;
        for (int p = tid; p < L * L; p += kProdThreads) {
          const int v1 = __ldg(row + p / L), v2 = __ldg(row + p % L);
          if ((unsigned)v1 < (unsigned)K && (unsigned)v2 < (unsigned)K) atomicAdd(&out[(long long)v1 * K + v2], wr);
        }
      }
    }
    __syncthreads();
  }

  // the block's share of the summed cost, as (tile, row-tile range) pieces
  const unsigned long long total = plan[n_tiles];
  const unsigned long long lo = total * b / G, hi = total * (b + 1) / G;
  long long x = start[b];
  int I = 0, J = 0;
  {
    long long rem = x;
    while (I < nb && rem >= nb - I) { rem -= nb - I; ++I; }
    J = I + (int)rem;
  }
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int cur = 0, fill = 0;  // the stage being filled, and its k rows
  unsigned dirty = 0;     // 2 bits a stage: its A, B hold bytes
  for (int i = tid; i < kStages * 2 * kOpBytes / 16; i += kProdThreads)
    reinterpret_cast<uint4*>(ops)[i] = make_uint4(0, 0, 0, 0);
  bool any = false;       // the accumulators hold a product
  // the filled stage goes to the tensor cores: every thread has written it
  // (proxy fence, barrier); the consumer warpgroups issue its product
  // asynchronously and wait for the previous stage's, so that the next
  // stage can be zeroed and built while this one's product runs
  auto flush = [&](bool diag) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (cw >= 0 && fill > 0) {
      const unsigned char* A = ops + cur * 2 * kOpBytes;
      const uint64_t da = make_desc(A + cw * 64 * 128);
      const uint64_t db = make_desc(diag ? A : A + kOpBytes);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const int ks = (fill + 31) >> 5;
      for (int k = 0; k < ks; ++k) {  // 32 bytes of k a step, 16 KB an atom (descriptor units of 16 bytes)
        const uint64_t off = (k >> 2) * (kBand * 128 / 16) + (k & 3) * 2;
        wgmma_m64n128k32(acc, da + off, db + off);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      any = true;
    }
    cur = (cur + 1) % kStages;
    fill = 0;
    __syncthreads();  // the previous use of the next stage is done
    const unsigned d = (dirty >> (2 * cur)) & 3;
    uint4* z = reinterpret_cast<uint4*>(ops + cur * 2 * kOpBytes);
    if (d & 1)
      for (int i = tid; i < kOpBytes / 16; i += kProdThreads) z[i] = make_uint4(0, 0, 0, 0);
    if (d & 2)
      for (int i = tid; i < kOpBytes / 16; i += kProdThreads) z[kOpBytes / 16 + i] = make_uint4(0, 0, 0, 0);
    dirty &= ~(3u << (2 * cur));
    __syncthreads();
  };

  while (x < n_tiles && total && plan[x] < hi) {
    const unsigned long long P0 = plan[x], c = plan[x + 1] - P0;
    const unsigned long long a = max(lo, P0), e = min(hi, P0 + c);
    const long long ta = c ? (long long)((a - P0) * (unsigned long long)n_rt / c) : 0;
    const long long tb = !c ? 0 : e == P0 + c ? n_rt : (long long)((e - P0) * (unsigned long long)n_rt / c);
    const bool diag = I == J;
    if (ta < tb) {
      const bool qj = RT[J] <= RT[I];
      const int Q = qj ? J : I, Pb = qj ? I : J;
      // band Q's bytes go to B when Q is J (diagonal: everything to A)
      const int q_op = diag ? 0 : (qj ? 1 : 0);
      for (long long t0 = ta; t0 < tb; t0 += kBatch) {
        const int nbt = (int)min((long long)kBatch, tb - t0);
        __syncthreads();  // the last round's tables are read
        if (warp == 0) {
          int n = 0, nv = 0;
          if (lane < nbt) {
            const long long t = t0 + lane;
            const uint4 m = masks[t * nb + Q];
            const int* o = offs + t * (nb + 2);
            const int qb = o[Q], nq = o[Q + 1] - qb;  // o[nb]: the end of the entries
            const int pb = diag ? 0 : o[Pb], np = diag ? 0 : o[Pb + 1] - pb;
            sh.m[lane][0] = m.x; sh.m[lane][1] = m.y; sh.m[lane][2] = m.z; sh.m[lane][3] = m.w;
            n = __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
            const int nvq = nq ? ((qb + nq + 7) >> 3) - (qb >> 3) : 0;
            nv = nvq + (np ? ((pb + np + 7) >> 3) - (pb >> 3) : 0);
            sh.qb[lane] = qb;
            sh.nq[lane] = nq;
            sh.pb[lane] = pb;
            sh.np[lane] = np;
            sh.nvq[lane] = nvq;
            sh.cnt[lane] = n;
          }
          int xs = n, xv = nv;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, xs, d), yv = __shfl_up_sync(0xffffffffu, xv, d);
            if (lane >= d) {
              xs += y;
              xv += yv;
            }
          }
          if (lane < nbt) {
            sh.pos[lane] = xs - n;
            sh.vpre[lane] = xv - nv;
          }
          if (lane == nbt - 1) sh.vpre[nbt] = xv;
          if (lane == 31) sh.n_round = xs;
        }
        __syncthreads();
        // each kept row's place in the round
        for (int q = tid; q < nbt * kRows; q += kProdThreads) {
          const int i = q >> 7, r = q & 127, wd = r >> 5;
          const unsigned word = sh.m[i][wd], bit = 1u << (r & 31);
          int before = __popc(word & (bit - 1));
          for (int k = 0; k < wd; ++k) before += __popc(sh.m[i][k]);
          sh.prow[i][r] = (word & bit) ? (short)(sh.pos[i] + before) : (short)-1;
        }
        __syncthreads();
        const int N = sh.n_round;
        // the round's work, one item at a time: an item is up to kV vectors
        // a thread of the kept rows [pos, pos + take) of the stage being
        // filled; each item's loads are issued before the previous item's
        // bytes are written, so their latency overlaps that work
        Item cur_it = first_item(sh, N, fill, nbt), nxt_it;
        uint4 d[kV], dn[kV];
        int ti[kV], tn[kV];
        load_item(sh, cur_it, ent, t0, L, tid, d, ti);
        while (cur_it.valid) {
          nxt_it = next_item(sh, cur_it, N, nbt);
          load_item(sh, nxt_it, ent, t0, L, tid, dn, tn);
          unsigned char* opQ = ops + cur * 2 * kOpBytes + q_op * kOpBytes;
          unsigned char* opP = ops + cur * 2 * kOpBytes + (1 - q_op) * kOpBytes;
#pragma unroll
          for (int k = 0; k < kV; ++k) {
            const int g = cur_it.g0 + k * kProdThreads + tid;
            if (g >= cur_it.g_hi) continue;  // a slot past the item's vectors (whole warps, mostly)
            const int i2 = ti[k];
            const int f = g - sh.vpre[i2], nvq = sh.nvq[i2];
            const bool isq = f < nvq;
            const int e_lo = isq ? sh.qb[i2] : sh.pb[i2], e_hi = e_lo + (isq ? sh.nq[i2] : sh.np[i2]);
            const int e_first = 8 * (isq ? (sh.qb[i2] >> 3) + f : (sh.pb[i2] >> 3) + (f - nvq));
            unsigned char* op = isq ? opQ : opP;
            const unsigned wv[4] = {d[k].x, d[k].y, d[k].z, d[k].w};
#pragma unroll
            for (int h = 0; h < 8; ++h) {
              const int v = (wv[h >> 1] >> (16 * (h & 1))) & 0x3FFF;
              const int p = sh.prow[i2][v >> 7] - cur_it.pos;  // a row not kept: < 0
              const int ee = e_first + h;
              if (ee >= e_lo && ee < e_hi && (unsigned)p < (unsigned)cur_it.take)
                op[op_off(v & 127, fill + p)] = 1;
            }
          }
          if (cur_it.g0 + kProdThreads * kV >= cur_it.g_hi) {  // the item ends its rows' chunk
            dirty |= (diag ? 1u : 3u) << (2 * cur);
            fill += cur_it.take;
            if (fill == kStageRows) flush(diag);
          }
          cur_it = nxt_it;
#pragma unroll
          for (int k = 0; k < kV; ++k) {
            d[k] = dn[k];
            ti[k] = tn[k];
          }
        }
      }
    }
    // the piece's end: its product into C
    if (ta < tb) {
      if (fill > 0) flush(diag);
      if (cw >= 0) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        if (any) {
          const int i0 = I * kBand, j0 = J * kBand;
          const int g = lane >> 2, t4 = lane & 3, wq = warp & 3;
#pragma unroll
          for (int j8 = 0; j8 < 16; ++j8)
#pragma unroll
            for (int c2 = 0; c2 < 4; ++c2) {
              const int v = acc[j8 * 4 + c2];
              if (!v) continue;
              const int i = i0 + cw * 64 + wq * 16 + g + (c2 >> 1) * 8;
              const int j = j0 + j8 * 8 + t4 * 2 + (c2 & 1);
              atomicAdd(&out[(long long)i * K + j], v);
              if (!diag) atomicAdd(&out[(long long)j * K + i], v);
            }
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0;
        fence_acc(acc);
      }
      any = false;
    }
    ++x;
    if (++J == nb) { ++I; J = I; }
  }
}

// ------------------------------------------- one band (K <= 128): no bucketing
// With one band there is one output tile and each rank is read once
// already, so the bucketing pass would only add its traffic and a launch:
// this kernel builds the tile's one-hot straight from the ranks.
constexpr int kPitch = kRows + 16;  // bytes per item row of a one-hot tile

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Marks element (item v, row r) in a one-hot tile; returns true when the bit
// was already set, i.e. the row repeats that item.
__device__ __forceinline__ bool mark(unsigned char* tile, int v, int r) {
  unsigned* word = reinterpret_cast<unsigned*>(tile + v * kPitch + (r & ~3));
  const unsigned bit = 1u << (8 * (r & 3));
  return (atomicOr(word, bit) & bit) != 0;
}

// one kTile x kTile output tile (K <= kTile); 2 x (kTile / 32) warps, each
// (kTile / 2) x 32.
template <int kTile>
__global__ void __launch_bounds__(kTile * 2)
cooc_band_kernel(const int* __restrict__ rows, const int* __restrict__ w, long long R, int L,
                 int K, long long rows_per_chunk, int* __restrict__ out) {
  constexpr int kThreads = kTile * 2;
  constexpr int MI = kTile / 32;  // m16 tiles per warp (warp rows kTile / 2)
  __shared__ __align__(16) unsigned char xi[kTile * kPitch];
  __shared__ int s_w[kRows];
  __shared__ int s_irr[kRows];   // 1: the row takes the scalar path
  __shared__ int s_list[kRows];  // those rows, listed once each
  __shared__ int s_nlist;

  const unsigned ni = K;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;

  int acc[MI][4][4];
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  // a row tile starts at row r0 = 128*t, i.e. 512*t*L bytes in: 16-byte
  // aligned whenever the rows are, whatever L is (pumsb's L = 74 leaves the
  // rows themselves only 8-byte aligned)
  const bool vec = (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  const long long c0 = (long long)blockIdx.x * rows_per_chunk;
  const long long c1 = min(R, c0 + rows_per_chunk);
  for (long long r0 = c0; r0 < c1; r0 += kRows) {
    const int nr = (int)min((long long)kRows, c1 - r0);
    const int* base = rows + r0 * L;
    if (tid == 0) s_nlist = 0;
    if (tid < kRows) {
      s_w[tid] = tid < nr ? w[r0 + tid] : 0;
      s_irr[tid] = 0;
    }
    {
      uint4* zi = reinterpret_cast<uint4*>(xi);
      for (int i = tid; i < kTile * kPitch / 16; i += kThreads) zi[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();

    // scatter: one thread per 4 elements of the tile's contiguous rows (16
    // bytes, coalesced; 4 loads in flight per thread), one shared atomicOr
    // per in-band element. A row's place comes from one division per vector,
    // and only when one of its elements is in band.
    const int n = nr * L;
    auto put4 = [&](int e, int4 q) {
      const int v[4] = {q.x, q.y, q.z, q.w};
      bool any = false;
#pragma unroll
      for (int k = 0; k < 4; ++k) any |= (unsigned)v[k] < ni;
      if (!any) return;
      int r = e / L, next = (r + 1) * L;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        while (e + k >= next) { ++r; next += L; }
        if (e + k >= n) break;
        if ((unsigned)v[k] >= ni) continue;
        const int wr = s_w[r];
        bool odd = wr != 1;  // weighted (w == 0 adds nothing) or repeated
        if (wr == 1) odd |= mark(xi, v[k], r);
        if (odd && wr != 0 && atomicExch(&s_irr[r], 1) == 0) s_list[atomicAdd(&s_nlist, 1)] = r;
      }
    };
    if (vec) {
      const int4* b4 = reinterpret_cast<const int4*>(base);
      const int n4 = n >> 2;  // whole vectors; the array's last tile may end mid-vector
      int q = tid;
      for (; q + 3 * kThreads < n4; q += 4 * kThreads) {
        int4 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = __ldg(b4 + q + u * kThreads);
#pragma unroll
        for (int u = 0; u < 4; ++u) put4(4 * (q + u * kThreads), x[u]);
      }
      for (; q < n4; q += kThreads) put4(4 * q, __ldg(b4 + q));
      for (int e = 4 * n4 + tid; e < n; e += kThreads) put4(e, make_int4(__ldg(base + e), -1, -1, -1));
    } else {
      for (int e = tid; e < n; e += kThreads) {
        const int x = __ldg(base + e);
        put4(e, make_int4(x, -1, -1, -1));
      }
    }
    __syncthreads();
    const int nlist = s_nlist;
    if (nlist) {
      // rows with a repeated item leave the byte tiles (the scalar path takes them)
      for (int q = tid; q < nlist * kTile; q += kThreads) {
        xi[(q % kTile) * kPitch + s_list[q / kTile]] = 0;
      }
      __syncthreads();
    }

    // C_tile += X^T_I . X_J over the row tile
#pragma unroll
    for (int ks = 0; ks < kRows; ks += 32) {
      int af[MI][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const unsigned char* p = xi + (wm * (kTile / 2) + mi * 16 + g) * kPitch + ks + t4 * 4;
        af[mi][0] = *reinterpret_cast<const int*>(p);
        af[mi][1] = *reinterpret_cast<const int*>(p + 8 * kPitch);
        af[mi][2] = *reinterpret_cast<const int*>(p + 16);
        af[mi][3] = *reinterpret_cast<const int*>(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const unsigned char* p = xi + (wn * 32 + nn * 8 + g) * kPitch + ks + t4 * 4;
        bf[nn][0] = *reinterpret_cast<const int*>(p);
        bf[nn][1] = *reinterpret_cast<const int*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) mma_s8(acc[mi][nn], af[mi], bf[nn]);
    }

    // exact scalar path: every ordered pair of valid slots of a listed row
    // adds w[r] straight into C, with int32 atomics
    for (int q = 0; q < nlist; ++q) {
      const int r = s_list[q];
      const int wr = s_w[r];
      const int* row = base + (long long)r * L;
      for (int p = tid; p < L * L; p += kThreads) {
        const unsigned d1 = __ldg(row + p / L), d2 = __ldg(row + p % L);
        if (d1 < ni && d2 < ni) atomicAdd(&out[(long long)d1 * K + d2], wr);
      }
    }
    __syncthreads();  // the tiles and s_list are reused by the next row tile
  }

  // epilogue: add the block's partial tile into C, staged through shared
  // memory 32 rows at a time, so that a warp's atomics hit 32 consecutive
  // words rather than 8 rows of a fragment
  constexpr int kEpi = 32, kStage = kTile + 1;  // odd pitch: conflict-free transpose
  int* stage = reinterpret_cast<int*>(xi);
  static_assert(kEpi * kStage * 4 <= kTile * kPitch, "a band fits in the I tile");
  for (int band = 0; band < kTile; band += kEpi) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int li = wm * (kTile / 2) + mi * 16 + g + (c >> 1) * 8 - band;
          const int lj = wn * 32 + nn * 8 + t4 * 2 + (c & 1);
          if (li >= 0 && li < kEpi) stage[li * kStage + lj] = acc[mi][nn][c];
        }
    __syncthreads();
    for (int q = tid; q < kEpi * kTile; q += kThreads) {
      const unsigned li = band + q / kTile, lj = q % kTile;
      const int v = stage[(q / kTile) * kStage + lj];
      if (li < ni && lj < ni && v != 0) atomicAdd(&out[(long long)li * K + lj], v);
    }
    __syncthreads();
  }
}

// what a launch asks of the current card once: settings such as the
// shared-memory opt-in hold for one card only, and a mesh runs B4 on each
constexpr int kCards = 64;

int current_card() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

template <int kTile>
int launch_band(const int* rows, const int* w, long long R, int L, int K, int* out, cudaStream_t s) {
  static int sms_of[kCards] = {}, per_sm_of[kCards] = {};
  const int dev = current_card();
  int sms = dev < kCards ? sms_of[dev] : 0, per_sm = dev < kCards ? per_sm_of[dev] : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cooc_band_kernel<kTile>, kTile * 2, 0);
    if (per_sm < 1) per_sm = 1;
    if (dev < kCards) sms_of[dev] = sms, per_sm_of[dev] = per_sm;
  }
  const long long row_tiles = (R + kRows - 1) / kRows;
  // one resident wave of blocks in all; a chunk is a whole number of row tiles
  long long chunks = (long long)per_sm * sms;
  chunks = chunks > row_tiles ? row_tiles : chunks;
  if (chunks > 65535) chunks = 65535;
  const long long rows_per_chunk = (row_tiles + chunks - 1) / chunks * kRows;
  chunks = (R + rows_per_chunk - 1) / rows_per_chunk;
  cooc_band_kernel<kTile><<<(unsigned)chunks, kTile * 2, 0, s>>>(rows, w, R, L, K, rows_per_chunk, out);
  return (int)cudaGetLastError();
}


constexpr size_t kProdSmem = (size_t)kStages * 2 * kOpBytes + 1024;

// the bucketing block's dynamic shared memory: the repeat bitmap, the
// band counts and masks, and the tile's ranks when they fit (L <= 96)
constexpr int kStageRanks = 48 * 1024;
bool bucket_staged(int L) { return (size_t)kRows * L * 4 <= (size_t)kStageRanks; }
size_t bucket_smem(int nb, int L) {
  return (size_t)min(nb, kGroupBands) * 512 * 4 + (size_t)nb * 20 + (bucket_staged(L) ? (size_t)kRows * L * 4 : 0);
}

int launch(const int* rows, const int* w, long long R, int L, int K, int* out, void* scratch,
           long long scratch_bytes, int blocks, void* stream, bool bucket_only) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 0 || L == 0 || K == 0 || K <= kBand) {
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)K * K * sizeof(int), s);
    if (err != cudaSuccess || R == 0 || L == 0 || K == 0 || bucket_only) return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
    // 64-item tiles while one covers K (kosarak's 57), else 128
    return K <= 64 ? launch_band<64>(rows, w, R, L, K, out, s) : launch_band<128>(rows, w, R, L, K, out, s);
  }
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const Layout lay = layout(R, L, K, blocks);
  if ((long long)lay.total > scratch_bytes) return (int)cudaErrorInvalidValue;
  const int nb = (K + kBand - 1) / kBand;
  const long long n_rt = (R + kRows - 1) / kRows;
  // the opt-in above 48 KB of dynamic shared memory, once a card and size
  static size_t bucket_set[kCards] = {};
  static bool prod_set[kCards] = {};
  const int dev = current_card();
  const size_t bs = bucket_smem(nb, L);
  if (bs > 48 * 1024 && (dev >= kCards || bs > bucket_set[dev])) {
    cudaError_t err = cudaFuncSetAttribute(cooc_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bs);
    if (err != cudaSuccess) return (int)err;
    if (dev < kCards) bucket_set[dev] = bs;
  }
  if (dev >= kCards || !prod_set[dev]) {
    cudaError_t err =
        cudaFuncSetAttribute(cooc_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kProdSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kCards) prod_set[dev] = true;
  }
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  cudaError_t err = cudaMemsetAsync(sc, 0, lay.hdr_end, s);
  if (err != cudaSuccess) return (int)err;
  cooc_bucket_kernel<<<(unsigned)n_rt, kBucketThreads, bs, s>>>(rows, w, R, L, K, nb, n_rt, blocks,
                                                                 bucket_staged(L), out, sc, lay);
  err = cudaGetLastError();
  if (err != cudaSuccess || bucket_only) return (int)err;
  cooc_wgmma_kernel<<<blocks, kProdThreads, kProdSmem, s>>>(rows, w, R, L, K, nb, n_rt, out, sc, lay);
  return (int)cudaGetLastError();
}

}  // namespace

// rows (R, L) int32 ranks (values outside [0, K) are padding), w (R,) int32
// -> out (K, K) int32. scratch: cooccur_scratch_bytes(R, L, K, blocks)
// bytes; blocks: the product kernel's persistent blocks (at most one a SM).
extern "C" int cooccur_launch(const int* rows, const int* w, long long R, int L, int K, int* out,
                              void* scratch, long long scratch_bytes, int blocks, void* stream) {
  return launch(rows, w, R, L, K, out, scratch, scratch_bytes, blocks, stream, false);
}

// bytes of scratch one launch needs: none for one band (K <= 128) or no rows
extern "C" long long cooccur_scratch_bytes(long long R, int L, int K, int blocks) {
  if (R == 0 || L == 0 || K <= kBand) return 0;
  return (long long)layout(R, L, K, blocks).total;
}

// dynamic shared memory of a launch's instances at (K, L), in bytes:
// which 0: the bucketing block, 1: the product block (0 when K <= 128)
extern "C" long long cooccur_smem_bytes(int K, int L, int which) {
  if (K <= kBand) return 0;
  return which == 0 ? (long long)bucket_smem((K + kBand - 1) / kBand, L) : (long long)kProdSmem;
}

// the bucketing pass alone (it also zeroes out), for timing it apart
extern "C" int cooccur_bucket_launch(const int* rows, const int* w, long long R, int L, int K, int* out,
                                     void* scratch, long long scratch_bytes, int blocks, void* stream) {
  return launch(rows, w, R, L, K, out, scratch, scratch_bytes, blocks, stream, true);
}
