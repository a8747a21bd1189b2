// B4: the F2 weighted pair co-occurrence C = X^T diag(w) X over one-hot rank
// rows: C[i, j] = sum_r w[r] * cnt_r(i) * cnt_r(j), full symmetric, with the
// diagonal equal to each item's support.
//
// Replaces the TPU kernel src/repro/kernels/cooccur/kernel.py:_cooc_kernel
// (cooccur_pallas), which built one-hot (rows x K) tiles in VMEM and
// contracted them on the MXU in fp32 — exact only below 2^24.
//
// Bound on Hopper: bytes. The function reads R*L int32 ranks once and writes
// K*K int32; the contraction is 2*R*K^2 int8 operations, far below the
// tensor cores' rate at these K.
//
// Design: the TPU kernel's one-hot product, on the int8 tensor cores.
// - Grid: (upper-triangular T x T output tiles, diagonal included) x (row
//   chunks), as many chunks as fill one resident wave of blocks. T = 64
//   while one tile covers K (kosarak's 57), else 128, so each rank is read
//   by few tiles (pumsb's K = 292: 6 tiles). A block owns item
//   bands I = [i0, i0+T) and J = [j0, j0+T) and walks its chunk in row
//   tiles of 128 rows.
// - Per row tile it zeroes item-major int8 tiles X^T_I[i][r], X^T_J[j][r]
//   (rows contiguous, pitch 144 bytes so the fragment loads hit 32 distinct
//   banks) and scatters the tile's ranks into them: the tile's rows are one
//   contiguous run, read as 16-byte vectors (a tile starts at row 128*t, so
//   it is 16-byte aligned whatever L is), 4 loads in flight per thread, one
//   shared atomicOr per in-band element. Zeroing costs 2*T*144 bytes of
//   shared stores per 128 rows, about what the scatter reads. The rows are
//   never materialised as (R, K).
// - C_tile += X^T_I . X_J with mma.sync.m16n8k32.row.col.s32.s8.s8.s32: both
//   operands are K-major in shared memory, each fragment register one 32-bit
//   load. 2 x T/32 warps, (T/2) x 32 outputs each, int32 accumulators in
//   registers.
// - Epilogue: one int32 atomicAdd per nonzero output element per block into
//   the zeroed output, and the mirrored element for off-diagonal tiles, so
//   C stays full and symmetric. The accumulators go through shared memory
//   32 rows at a time, so that each warp's atomics cover 32 consecutive
//   words: at mushroom's small R the atomics take a large share of the
//   time. Any K (max_f1 = 4096: 528 tiles of 128).
// Exactness outside the int8 range: a one-hot byte is 0 or 1, which holds a
// row only when w[r] == 1 and its in-band items are distinct. Any other row
// with w[r] != 0 and an in-band item (a weight, or a repeated item, found
// when atomicOr meets its own bit) is taken out of the byte tiles and sent
// through an exact scalar path in the same launch: its in-band ordered
// pairs add w[r] straight into C (and the mirror) with int32 atomics. Every
// sum is int32 mod 2^32 and order-free, so the result is bit-identical to
// the plain version (int64 sums cast to int32). The main path (w == 1,
// distinct ranks) never takes the scalar path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;          // rows per row tile: 4 mma k-steps of 32
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

// kTile x kTile output tiles; 2 x (kTile / 32) warps, each (kTile / 2) x 32.
template <int kTile>
__global__ void __launch_bounds__(kTile * 2)
cooc_mma_kernel(const int* __restrict__ rows, const int* __restrict__ w, long long R, int L,
                int K, int n_bands, long long rows_per_chunk, int* __restrict__ out) {
  constexpr int kThreads = kTile * 2;
  constexpr int MI = kTile / 32;  // m16 tiles per warp (warp rows kTile / 2)
  __shared__ __align__(16) unsigned char xi[kTile * kPitch];
  __shared__ __align__(16) unsigned char xj[kTile * kPitch];
  __shared__ int s_w[kRows];
  __shared__ int s_irr[kRows];   // 1: the row takes the scalar path
  __shared__ int s_list[kRows];  // those rows, listed once each
  __shared__ int s_nlist;

  // upper-triangular tile (ti <= tj) of blockIdx.x
  int ti = 0, rem = blockIdx.x;
  while (rem >= n_bands - ti) { rem -= n_bands - ti; ++ti; }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const unsigned ni = min(kTile, K - i0), nj = min(kTile, K - j0);
  const unsigned char* xb = diag ? xi : xj;  // the J operand

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
  const long long c0 = (long long)blockIdx.y * rows_per_chunk;
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
      uint4* zj = reinterpret_cast<uint4*>(xj);
      for (int i = tid; i < kTile * kPitch / 16; i += kThreads) {
        zi[i] = make_uint4(0, 0, 0, 0);
        if (!diag) zj[i] = make_uint4(0, 0, 0, 0);
      }
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
      for (int k = 0; k < 4; ++k)
        any |= (unsigned)(v[k] - i0) < ni || (unsigned)(v[k] - j0) < nj;
      if (!any) return;
      int r = e / L, next = (r + 1) * L;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        while (e + k >= next) { ++r; next += L; }
        if (e + k >= n) break;
        const unsigned di = (unsigned)(v[k] - i0), dj = (unsigned)(v[k] - j0);
        const bool in_i = di < ni, in_j = !diag && dj < nj;
        if (!in_i && !in_j) continue;
        const int wr = s_w[r];
        bool odd = wr != 1;  // weighted (w == 0 adds nothing) or repeated
        if (wr == 1) {
          if (in_i) odd |= mark(xi, di, r);
          if (in_j) odd |= mark(xj, dj, r);
        }
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
        const int r = s_list[q / kTile], v = q % kTile;
        xi[v * kPitch + r] = 0;
        if (!diag) xj[v * kPitch + r] = 0;
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
        const unsigned char* p = xb + (wn * 32 + nn * 8 + g) * kPitch + ks + t4 * 4;
        bf[nn][0] = *reinterpret_cast<const int*>(p);
        bf[nn][1] = *reinterpret_cast<const int*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) mma_s8(acc[mi][nn], af[mi], bf[nn]);
    }

    // exact scalar path: every in-band ordered pair of a listed row adds
    // w[r] straight into C (and its mirror), with int32 atomics
    for (int q = 0; q < nlist; ++q) {
      const int r = s_list[q];
      const int wr = s_w[r];
      const int* row = base + (long long)r * L;
      for (int p = tid; p < L * L; p += kThreads) {
        const unsigned d1 = (unsigned)(__ldg(row + p / L) - i0);
        const unsigned d2 = (unsigned)(__ldg(row + p % L) - j0);
        if (d1 < ni && d2 < nj) {
          atomicAdd(&out[(long long)(i0 + d1) * K + (j0 + d2)], wr);
          if (!diag) atomicAdd(&out[(long long)(j0 + d2) * K + (i0 + d1)], wr);
        }
      }
    }
    __syncthreads();  // the tiles and s_list are reused by the next row tile
  }

  // epilogue: add the block's partial tile (and its mirror) into C, staged
  // through shared memory 32 rows at a time, so that a warp's atomics hit
  // 32 consecutive words (and, for the mirror, 32 consecutive words of a
  // column's transpose) rather than 8 rows of a fragment
  constexpr int kBand = 32, kStage = kTile + 1;  // odd pitch: conflict-free transpose
  int* stage = reinterpret_cast<int*>(xi);
  static_assert(kBand * kStage * 4 <= kTile * kPitch, "a band fits in the I tile");
  for (int band = 0; band < kTile; band += kBand) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int li = wm * (kTile / 2) + mi * 16 + g + (c >> 1) * 8 - band;
          const int lj = wn * 32 + nn * 8 + t4 * 2 + (c & 1);
          if (li >= 0 && li < kBand) stage[li * kStage + lj] = acc[mi][nn][c];
        }
    __syncthreads();
    for (int q = tid; q < kBand * kTile; q += kThreads) {
      const unsigned li = band + q / kTile, lj = q % kTile;
      const int v = stage[(q / kTile) * kStage + lj];
      if (li < ni && lj < nj && v != 0) atomicAdd(&out[(long long)(i0 + li) * K + (j0 + lj)], v);
    }
    if (!diag) {
      for (int q = tid; q < kBand * kTile; q += kThreads) {
        const unsigned li = band + q % kBand, lj = q / kBand;
        const int v = stage[(q % kBand) * kStage + lj];
        if (li < ni && lj < nj && v != 0) atomicAdd(&out[(long long)(j0 + lj) * K + (i0 + li)], v);
      }
    }
    __syncthreads();
  }
}

template <int kTile>
int launch_t(const int* rows, const int* w, long long R, int L, int K, int* out, cudaStream_t s) {
  static int sms = 0, per_sm = 0;  // one card: asked once
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cooc_mma_kernel<kTile>, kTile * 2, 0);
    if (per_sm < 1) per_sm = 1;
  }
  const int n_bands = (K + kTile - 1) / kTile;
  const long long n_tiles = (long long)n_bands * (n_bands + 1) / 2;
  const long long row_tiles = (R + kRows - 1) / kRows;
  // one resident wave of blocks in all; a chunk is a whole number of row tiles
  long long chunks = ((long long)per_sm * sms + n_tiles - 1) / n_tiles;
  chunks = chunks > row_tiles ? row_tiles : chunks;
  if (chunks > 65535) chunks = 65535;
  const long long rows_per_chunk = (row_tiles + chunks - 1) / chunks * kRows;
  chunks = (R + rows_per_chunk - 1) / rows_per_chunk;
  dim3 grid((unsigned)n_tiles, (unsigned)chunks);
  cooc_mma_kernel<kTile><<<grid, kTile * 2, 0, s>>>(rows, w, R, L, K, n_bands, rows_per_chunk, out);
  return (int)cudaGetLastError();
}

}  // namespace

// rows (R, L) int32 ranks (values outside [0, K) are padding), w (R,) int32
// -> out (K, K) int32.
extern "C" int cooccur_launch(const int* rows, const int* w, long long R, int L, int K, int* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)K * K * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (R == 0 || L == 0 || K == 0) return (int)cudaGetLastError();
  // 64-item tiles while one covers K; above, 128-item tiles read each
  // element for fewer output tiles (pumsb's K = 292: 6 tiles, not 15)
  return K <= 64 ? launch_t<64>(rows, w, R, L, K, out, s) : launch_t<128>(rows, w, R, L, K, out, s);
}
