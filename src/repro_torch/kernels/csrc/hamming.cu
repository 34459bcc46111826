// K2 (dense all-pairs Hamming distance) and, below it, K6 (the fused
// Hamming threshold count), CUDA C++ for Hopper (sm_90a).
//
// K2 replaces the TPU kernel repro/kernels/hamming.py::hamming_dist_kernel
// (body _dist_kernel): dist[q, r] = sum_w popcount(q_w ^ r_w) for packed
// signatures (Q, nw) x (R, nw) -> (Q, R) int32, for any nw >= 1.
// Signatures arrive as int32 bit patterns of the uint32 words; XOR and
// popcount ignore the sign.
//
// Bound on this card: bytes. The (Q, R) int32 output is 4*Q*R bytes
// against 4*(Q+R)*nw bytes of input and 3*Q*R*nw integer operations, so
// writing the matrix is what takes the time: at the serving shape (64, 1)
// x (454,401, 1), 116.3 MB, 0.0353 ms at 3.35 TB/s. (Past a few words the
// popcounts, a quarter of the integer rate, take over.)
//
// Design. The matrix is written once, in 16-byte streaming stores
// (st.global.cs: the matrix is larger than the 50 MB L2 and nothing here
// reads it back). A thread owns a group of 4 consecutive columns of every
// query row in its tile. Row i starts at flat offset i*R, which is a
// multiple of 4 only when R is, so a row's groups are shifted by
// s = (i*R) mod 4 columns: group k of a tile covers columns
// c0 - s + 4k .. c0 - s + 4k + 3, whose flat offset is a multiple of 4. The
// thread keeps the words of the 8 references c0 + 4k - 4 .. c0 + 4k + 3 in
// registers (loaded once a tile), and per row takes the 4 that the row's
// shift selects (a warp-uniform switch over s, each case unrolled with
// constant register indices). Groups that cross a row's first or last
// column store only their columns, one word each. A tile's query words
// (up to 64 rows) sit in shared memory and are read as broadcasts. The
// grid is persistent: at most as many blocks as the card holds at once,
// each striding over (query tile, column tile) items, so no tail wave
// runs half empty. (Staging 8 rows in shared memory and writing each
// row's middle with one bulk copy, cp.async.bulk.global.shared::cta, was
// measured too: 20-25% slower at the 64-row serving batch, 0.5-3.4%
// faster at the dense join's 295-row emission tiles, so it went; PERF.md
// section 6.)
//
// Any nw: up to 8 words the words live in registers as a template
// constant. Past 8 words (f > 256) a chunked path adds the distances over
// chunks of 8 words: per chunk the 8 references' words of the chunk load
// into registers, and 4 query rows at a time add their popcounts into
// per-row accumulators for all 8 references; the row's shift then picks 4
// of them. Words past nw load as 0 and add nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int DT = 256;         // K2: threads a block
constexpr int GR = 4;           // K2: columns a thread a row: one int4
constexpr int RT = DT * GR;     // K2: columns a tile
constexpr int QT = 64;          // K2: query rows a tile
constexpr int WCH = 8;          // words a chunk past 8 words (K2 and K6)
constexpr int QB = 4;           // K2 chunked path: query rows a pass

// (i * R) mod 4: the shift of row i's 16-byte groups
__device__ __forceinline__ int row_shift(long long i, int R) {
  return static_cast<int>((i * R) & 3);
}

// The 4 distances of columns c0 - S + 4k + m (m = 0..3) from the words of
// references c0 + 4k - 4 + j (j = 0..7): j = 4 - S + m.
template <int NW, int S>
__device__ __forceinline__ int4 dists4(const uint32_t* qw,
                                       const uint32_t (&rw)[8][NW]) {
  int d[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    d[m] = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) d[m] += __popc(qw[w] ^ rw[4 - S + m][w]);
  }
  return make_int4(d[0], d[1], d[2], d[3]);
}

template <int S>
__device__ __forceinline__ int4 pick4(const int (&a)[8]) {
  return make_int4(a[4 - S], a[5 - S], a[6 - S], a[7 - S]);
}

// Columns col..col+3 of the row at flat offset base (base + col is a
// multiple of 4): one streaming 16-byte store when all four lie in
// [0, R), else a word for each that does.
__device__ __forceinline__ void store4(int32_t* __restrict__ out,
                                       long long base, int col, int R,
                                       int4 d) {
  if (col >= 0 && col + 3 < R) {
    __stcs(reinterpret_cast<int4*>(out + base + col), d);
    return;
  }
  const int v[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (col + m >= 0 && col + m < R) __stcs(out + base + col + m, v[m]);
}

template <int NW>
__global__ void __launch_bounds__(DT)
dist_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
            int32_t* __restrict__ out, int Q, int R, int nrt,
            long long items) {
  __shared__ uint32_t qs[QT * NW];
  const int k = threadIdx.x;
  int staged = -1;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int qt = static_cast<int>(it / nrt);
    const int c0 = static_cast<int>(it % nrt) * RT;
    const int q0 = qt * QT;
    const int nq = min(QT, Q - q0);
    if (qt != staged) {   // the same for every thread of the block
      __syncthreads();
      for (int x = k; x < nq * NW; x += DT)
        qs[x] = q[static_cast<long long>(q0) * NW + x];
      __syncthreads();
      staged = qt;
    }
    const int cg = c0 + GR * k;   // the group's first column at shift 0
    uint32_t rw[8][NW];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cg - 4 + j;
      const bool in = col >= 0 && col < R;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        rw[j][w] = in ? r[static_cast<long long>(col) * NW + w] : 0u;
    }
    for (int i = 0; i < nq; ++i) {
      const long long row = q0 + i;
      const int s = row_shift(row, R);
      const uint32_t* qw = qs + i * NW;
      int4 d;
      switch (s) {
        case 0: d = dists4<NW, 0>(qw, rw); break;
        case 1: d = dists4<NW, 1>(qw, rw); break;
        case 2: d = dists4<NW, 2>(qw, rw); break;
        default: d = dists4<NW, 3>(qw, rw); break;
      }
      store4(out, row * R, cg - s, R, d);
    }
  }
}

// nw > 8: distances added over chunks of WCH words, QB query rows a pass.
__global__ void __launch_bounds__(DT)
dist_wide_kernel(const uint32_t* __restrict__ q,
                 const uint32_t* __restrict__ r, int32_t* __restrict__ out,
                 int Q, int R, int nw, int nrt, long long items) {
  const int k = threadIdx.x;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int q0 = static_cast<int>(it / nrt) * QB;
    const int cg = static_cast<int>(it % nrt) * RT + GR * k;
    int acc[QB][8];
#pragma unroll
    for (int u = 0; u < QB; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[u][j] = 0;
    for (int c = 0; c < nw; c += WCH) {
      uint32_t rw[8][WCH];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cg - 4 + j;
        const bool in = col >= 0 && col < R;
#pragma unroll
        for (int x = 0; x < WCH; ++x)
          rw[j][x] = in && c + x < nw
                         ? r[static_cast<long long>(col) * nw + c + x] : 0u;
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int i = q0 + u;
        if (i >= Q) break;   // the same for every thread
        uint32_t qw[WCH];
#pragma unroll
        for (int x = 0; x < WCH; ++x)
          qw[x] = c + x < nw ? q[static_cast<long long>(i) * nw + c + x] : 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < WCH; ++x) acc[u][j] += __popc(qw[x] ^ rw[j][x]);
      }
    }
#pragma unroll
    for (int u = 0; u < QB; ++u) {
      const long long row = q0 + u;
      if (row >= Q) break;
      const int s = row_shift(row, R);
      int4 d;
      switch (s) {
        case 0: d = pick4<0>(acc[u]); break;
        case 1: d = pick4<1>(acc[u]); break;
        case 2: d = pick4<2>(acc[u]); break;
        default: d = pick4<3>(acc[u]); break;
      }
      store4(out, row * R, cg - s, R, d);
    }
  }
}

// As many blocks of ``kernel`` as the card holds at once, at most items.
int persistent_grid(const void* kernel, size_t smem, long long items,
                    int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DT,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long most = static_cast<long long>(sms) * max(per_sm, 1);
  *grid = static_cast<int>(min(items, most));
  return 0;
}

template <int NW>
int launch(const void* q, const void* r, void* out, int Q, int R,
           cudaStream_t stream) {
  auto kernel = dist_kernel<NW>;
  // column tiles cover [c0 - 3, c0 + RT): R + 3 columns reach every row
  const int nrt = (R + 3 + RT - 1) / RT;
  const long long items = static_cast<long long>((Q + QT - 1) / QT) * nrt;
  int grid = 0;
  int e = persistent_grid(reinterpret_cast<const void*>(kernel), 0, items,
                          &grid);
  if (e) return e;
  kernel<<<grid, DT, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, R, nrt, items);
  return static_cast<int>(cudaGetLastError());
}

int launch_wide(const void* q, const void* r, void* out, int Q, int R,
                int nw, cudaStream_t stream) {
  const int nrt = (R + 3 + RT - 1) / RT;
  const long long items = static_cast<long long>((Q + QB - 1) / QB) * nrt;
  int grid = 0;
  int e = persistent_grid(reinterpret_cast<const void*>(dist_wide_kernel), 0,
                          items, &grid);
  if (e) return e;
  dist_wide_kernel<<<grid, DT, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, R, nw, nrt, items);
  return static_cast<int>(cudaGetLastError());
}

// K6 — per-query count of references within Hamming distance d.
//
// Replaces the TPU kernel repro/kernels/hamming.py::hamming_count_kernel
// (body _count_kernel): count[q] = #{r : sum_w popcount(q_w ^ r_w) <= d}
// for (Q, nw) x (R, nw) -> (Q,) int32, any nw >= 1. The dense join
// (core/hamming.py threshold_pairs) takes its true pair count and
// per-query output offsets from it, so the (Q, R) distance matrix never
// has to exist whole.
//
// Bound on this card: operations. The output is 4*Q bytes and the inputs
// 4*(Q+R)*nw, against Q*R*nw popcounts (plus an XOR each and a compare and
// add per pair); __popc issues at a quarter of the integer ALU rate, so the
// popcount pipe sets the bound.
//
// What this design does about it: nothing is written but one counter per
// query. Each thread keeps one query's words in registers; a block streams
// tiles of RT reference rows through shared memory (every thread reads the
// same word: a broadcast, no bank conflict) and counts its hits in a
// register. The TPU kernel carried its sum across a sequential grid axis;
// here blocks run in any order, so the grid also splits R into chunks — when
// Q is small (a 64-query batch) that is what fills the SMs — and each
// (thread, chunk) adds its partial count with one atomicAdd. The wrapper
// zeroes the output first. No padding rows: the ragged tile is bounds-
// checked, so the reference wrapper's all-ones pad rows and their
// subtraction have no counterpart here. Past 8 words (f > 256) a chunked
// path takes sub-tiles of JT references: per chunk of 8 words the block
// stages the sub-tile's words of the chunk and each thread its query's
// chunk in registers, adding into one accumulator per reference; the
// compare runs once the chunks are summed.

constexpr int CT = 128;            // queries (threads) per block
constexpr int CRT = 256;           // reference rows per shared-memory tile
constexpr int JT = 32;             // references a sub-tile, chunked path
constexpr int TARGET_BLOCKS = 1056;  // 8 blocks on each of 132 SMs

template <int NW>
__global__ void __launch_bounds__(CT)
count_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
             int32_t* __restrict__ out, int Q, int R, int d, int chunk) {
  __shared__ uint32_t rs[CRT * NW];
  const long qi = static_cast<long>(blockIdx.x) * CT + threadIdx.x;
  const bool live = qi < Q;
  uint32_t qw[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) qw[w] = live ? q[qi * NW + w] : 0u;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(R, r0 + chunk);
  int count = 0;
  for (int t0 = r0; t0 < r1; t0 += CRT) {
    const int nt = min(CRT, r1 - t0);
    __syncthreads();               // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * NW; i += CT)
      rs[i] = r[static_cast<long>(t0) * NW + i];
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < nt; ++j) {
      int dist = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) dist += __popc(qw[w] ^ rs[j * NW + w]);
      count += dist <= d;
    }
  }
  if (live && count) atomicAdd(out + qi, count);
}

__global__ void __launch_bounds__(CT)
count_wide_kernel(const uint32_t* __restrict__ q,
                  const uint32_t* __restrict__ r, int32_t* __restrict__ out,
                  int Q, int R, int nw, int d, int chunk) {
  __shared__ uint32_t rs[JT * WCH];
  const long qi = static_cast<long>(blockIdx.x) * CT + threadIdx.x;
  const bool live = qi < Q;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(R, r0 + chunk);
  int count = 0;
  for (int t0 = r0; t0 < r1; t0 += JT) {
    const int nt = min(JT, r1 - t0);
    int acc[JT];
#pragma unroll
    for (int j = 0; j < JT; ++j) acc[j] = 0;
    for (int c = 0; c < nw; c += WCH) {
      __syncthreads();             // the previous chunk is consumed
      for (int x = threadIdx.x; x < JT * WCH; x += CT) {
        const int j = x / WCH, w = c + x % WCH;
        rs[x] = j < nt && w < nw ? r[static_cast<long>(t0 + j) * nw + w]
                                 : 0u;
      }
      __syncthreads();
      uint32_t qw[WCH];
#pragma unroll
      for (int x = 0; x < WCH; ++x)
        qw[x] = live && c + x < nw ? q[qi * nw + c + x] : 0u;
#pragma unroll
      for (int j = 0; j < JT; ++j)
#pragma unroll
        for (int x = 0; x < WCH; ++x) acc[j] += __popc(qw[x] ^ rs[j * WCH + x]);
    }
#pragma unroll
    for (int j = 0; j < JT; ++j) count += j < nt && acc[j] <= d;
  }
  if (live && count) atomicAdd(out + qi, count);
}

// The grid of K6: query blocks x chunks of R, about TARGET_BLOCKS in all.
dim3 count_grid(int Q, int R, int* chunk) {
  const int xb = (Q + CT - 1) / CT;
  const int tiles = (R + CRT - 1) / CRT;
  const int want = max(1, min(tiles, TARGET_BLOCKS / xb));
  *chunk = (tiles + want - 1) / want * CRT;
  return dim3(xb, (R + *chunk - 1) / *chunk);
}

template <int NW>
int launch_count(const void* q, const void* r, void* out, int Q, int R,
                 int d, cudaStream_t stream) {
  int chunk = 0;
  const dim3 grid = count_grid(Q, R, &chunk);
  count_kernel<NW><<<grid, CT, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, R, d, chunk);
  return static_cast<int>(cudaGetLastError());
}

int launch_count_wide(const void* q, const void* r, void* out, int Q, int R,
                      int nw, int d, cudaStream_t stream) {
  int chunk = 0;
  const dim3 grid = count_grid(Q, R, &chunk);
  count_wide_kernel<<<grid, CT, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, R, nw, d, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (Q, nw) x (R, nw) packed words -> (Q, R) int32 distances, any nw >= 1;
// out 16-byte aligned. Returns the CUDA error code of the launch.
extern "C" int hamming_dist(const void* q, const void* r, void* out, int Q,
                            int R, int nw, void* stream) {
  if (Q == 0 || R == 0) return 0;
  if (nw < 1 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 1: return launch<1>(q, r, out, Q, R, st);
    case 2: return launch<2>(q, r, out, Q, R, st);
    case 3: return launch<3>(q, r, out, Q, R, st);
    case 4: return launch<4>(q, r, out, Q, R, st);
    case 5: return launch<5>(q, r, out, Q, R, st);
    case 6: return launch<6>(q, r, out, Q, R, st);
    case 7: return launch<7>(q, r, out, Q, R, st);
    case 8: return launch<8>(q, r, out, Q, R, st);
    default: return launch_wide(q, r, out, Q, R, nw, st);
  }
}

// (Q, nw) x (R, nw) packed words -> (Q,) int32 counts of refs within
// Hamming distance d, ADDED to ``out`` (the caller zeroes it); any nw >= 1.
// Returns the CUDA error code of the launch.
extern "C" int hamming_count(const void* q, const void* r, void* out, int Q,
                             int R, int nw, int d, void* stream) {
  if (Q == 0 || R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nw) {
    case 1: return launch_count<1>(q, r, out, Q, R, d, st);
    case 2: return launch_count<2>(q, r, out, Q, R, d, st);
    case 3: return launch_count<3>(q, r, out, Q, R, d, st);
    case 4: return launch_count<4>(q, r, out, Q, R, d, st);
    case 5: return launch_count<5>(q, r, out, Q, R, d, st);
    case 6: return launch_count<6>(q, r, out, Q, R, d, st);
    case 7: return launch_count<7>(q, r, out, Q, R, d, st);
    case 8: return launch_count<8>(q, r, out, Q, R, d, st);
    default:
      if (nw < 1) return static_cast<int>(cudaErrorInvalidValue);
      return launch_count_wide(q, r, out, Q, R, nw, d, st);
  }
}
