// K2 (dense all-pairs Hamming distance) and, below it, K6 (the fused
// Hamming threshold count), CUDA C++ for Hopper (sm_90a).
//
// K2 replaces the TPU kernel repro/kernels/hamming.py::hamming_dist_kernel
// (body _dist_kernel): dist[q, r] = sum_w popcount(q_w ^ r_w) for packed
// signatures (Q, nw) x (R, nw) -> (Q, R) int32. Signatures arrive as int32
// bit patterns of the uint32 words; XOR and popcount ignore the sign.
//
// Bound on this card: bytes. The (Q, R) int32 output is 4*Q*R bytes
// against 4*(Q+R)*nw bytes of input and 3*Q*R*nw integer operations, so
// writing the matrix is what takes the time.
//
// What this design does about it: every input byte is read once per block
// and the output is written once, coalesced. Each thread keeps one
// reference row's nw words in registers, a tile of up to QT queries sits in
// shared memory (read as warp-wide broadcasts), and thread r of a warp
// writes column r of each query's row, so a warp stores 128 contiguous
// bytes. Fusing the top-k into this kernel, so the matrix is never written,
// is later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 64;   // queries per block
constexpr int NT = 256;  // threads (reference rows) per block

template <int NW>
__global__ void __launch_bounds__(NT)
hamming_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
               int32_t* __restrict__ out, int Q, int R) {
  __shared__ uint32_t qs[QT * NW];
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Q - q0);
  for (int i = threadIdx.x; i < nq * NW; i += NT)
    qs[i] = q[static_cast<long>(q0) * NW + i];
  __syncthreads();

  const long rid = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  if (rid >= R) return;
  uint32_t rw[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) rw[w] = r[rid * NW + w];
  for (int i = 0; i < nq; ++i) {
    int d = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) d += __popc(qs[i * NW + w] ^ rw[w]);
    out[static_cast<long>(q0 + i) * R + rid] = d;
  }
}

template <int NW>
int launch(const void* q, const void* r, void* out, int Q, int R,
           cudaStream_t stream) {
  const dim3 grid((R + NT - 1) / NT, (Q + QT - 1) / QT);
  hamming_kernel<NW><<<grid, NT, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, R);
  return static_cast<int>(cudaGetLastError());
}

// K6 — per-query count of references within Hamming distance d.
//
// Replaces the TPU kernel repro/kernels/hamming.py::hamming_count_kernel
// (body _count_kernel): count[q] = #{r : sum_w popcount(q_w ^ r_w) <= d}
// for (Q, nw) x (R, nw) -> (Q,) int32. The dense join (core/hamming.py
// threshold_pairs) takes its true pair count and per-query output offsets
// from it, so the (Q, R) distance matrix never has to exist whole.
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
// subtraction have no counterpart here.

constexpr int CT = 128;            // queries (threads) per block
constexpr int RT = 256;            // reference rows per shared-memory tile
constexpr int TARGET_BLOCKS = 1056;  // 8 blocks on each of 132 SMs

template <int NW>
__global__ void __launch_bounds__(CT)
count_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
             int32_t* __restrict__ out, int Q, int R, int d, int chunk) {
  __shared__ uint32_t rs[RT * NW];
  const long qi = static_cast<long>(blockIdx.x) * CT + threadIdx.x;
  const bool live = qi < Q;
  uint32_t qw[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) qw[w] = live ? q[qi * NW + w] : 0u;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(R, r0 + chunk);
  int count = 0;
  for (int t0 = r0; t0 < r1; t0 += RT) {
    const int nt = min(RT, r1 - t0);
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

template <int NW>
int launch_count(const void* q, const void* r, void* out, int Q, int R,
                 int d, cudaStream_t stream) {
  const int xb = (Q + CT - 1) / CT;
  const int tiles = (R + RT - 1) / RT;
  const int want = max(1, min(tiles, TARGET_BLOCKS / xb));
  const int chunk = (tiles + want - 1) / want * RT;
  const dim3 grid(xb, (R + chunk - 1) / chunk);
  count_kernel<NW><<<grid, CT, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, R, d, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (Q, nw) x (R, nw) packed words -> (Q, R) int32 distances; nw in 1..8.
// Returns the CUDA error code of the launch.
extern "C" int hamming_dist(const void* q, const void* r, void* out, int Q,
                            int R, int nw, void* stream) {
  if (Q == 0 || R == 0) return 0;
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// (Q, nw) x (R, nw) packed words -> (Q,) int32 counts of refs within
// Hamming distance d, ADDED to ``out`` (the caller zeroes it); nw in 1..8.
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
