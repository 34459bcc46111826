// K2 — dense all-pairs Hamming distance, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hamming.py::hamming_dist_kernel
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
