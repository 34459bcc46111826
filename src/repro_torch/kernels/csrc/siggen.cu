// K1 — fused SimHash accumulation, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/siggen.py::siggen_accumulate_kernel
// (body _siggen_kernel): for every shingle row s and codebook word w,
//
//     score[s, w] = rows[s] . cb[w]                (D = k*21 long dot)
//     V[s, :]    += [score >= T] * score * H[w, :]
//
// rows (S, D) int32 with |v| <= 11, cb (W, D) int8, H (W, f) int8 (+-1)
// -> V (S, f) int32. Both products are exact in int32.
//
// Bound on this card: operations. The function does 2*S*W*(D+f) integer
// operations on int8-exact values while it must move only
// S*(D+f)*4 + W*(D+f) bytes: ~1000 operations per byte at k=3, f=32,
// above the H100's int8 ridge (1979 TOP/s over 3.35 TB/s, ~590 per byte),
// so the int8 tensor cores bound it.
//
// What this design does about it: it keeps the (S, W) score matrix out of
// device memory, as the TPU kernel does in VMEM. One block owns a tile of
// BS shingle rows and loops over the codebook in BW-word tiles (the TPU's
// sequential grid axis j becomes this in-block loop, because Hopper blocks
// run in no order). The rows tile and each cb/H tile sit in shared memory,
// the thresholded (BS, BW) score tile in shared memory, and the (BS, f) V
// tile in registers. Most scores fall below T, and a score is uniform
// across a warp in the accumulation loop, so the skip is a uniform branch.
// The arithmetic runs on the CUDA cores (int32 IMAD): the int8 tensor-core
// form, and the one-hot shortcut (k table lookups instead of a D-long
// dot), are later work.
//
// Ragged edges: rows past S and words past W load as zero. A zero row or a
// zero word scores 0 < T and adds nothing — the padding of the reference
// wrapper (repro/kernels/ops.py::signatures_fused), exact for T >= 1,
// without copying the operands.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BS = 32;   // shingle rows per block
constexpr int BW = 64;   // codebook words per tile
constexpr int NT = 256;  // threads per block: 8 warps

template <int NW>  // f / 32
__global__ void __launch_bounds__(NT)
siggen_kernel(const int32_t* __restrict__ rows, const int8_t* __restrict__ cb,
              const int8_t* __restrict__ H, int32_t* __restrict__ out,
              int S, int D, int W, int T) {
  constexpr int F = NW * 32;
  extern __shared__ int32_t smem[];
  int32_t* rs = smem;                    // [BS][D]  rows tile
  int32_t* cbs = rs + BS * D;            // [D][BW]  codebook tile, transposed
  int32_t* sc = cbs + D * BW;            // [BS][BW] thresholded scores
  int8_t* hs = reinterpret_cast<int8_t*>(sc + BS * BW);  // [BW][F]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long row0 = static_cast<long>(blockIdx.x) * BS;

  for (int i = t; i < BS * D; i += NT) {
    const int r = i / D;
    const int d = i - r * D;
    rs[i] = (row0 + r < S) ? rows[(row0 + r) * D + d] : 0;
  }

  // score phase: thread scores word (t % BW) against rows (t / BW) + 4*i
  const int w_own = t % BW;
  const int r_grp = t / BW;
  // accumulate phase: warp owns rows warp + 8*i, lane owns columns
  // lane + 32*j of V
  int32_t acc[BS / 8][NW];
#pragma unroll
  for (int i = 0; i < BS / 8; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j) acc[i][j] = 0;

  for (int w0 = 0; w0 < W; w0 += BW) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = t; i < BW * D; i += NT) {
      const int w = i / D;
      const int d = i - w * D;
      cbs[d * BW + w] =
          (w0 + w < W) ? cb[static_cast<long>(w0 + w) * D + d] : 0;
    }
    for (int i = t; i < BW * F; i += NT) {
      const int w = i / F;
      hs[i] = (w0 + w < W) ? H[static_cast<long>(w0) * F + i] : 0;
    }
    __syncthreads();

    int32_t s[BS / 4];
#pragma unroll
    for (int i = 0; i < BS / 4; ++i) s[i] = 0;
    for (int d = 0; d < D; ++d) {
      const int32_t c = cbs[d * BW + w_own];
#pragma unroll
      for (int i = 0; i < BS / 4; ++i) s[i] += rs[(r_grp + 4 * i) * D + d] * c;
    }
#pragma unroll
    for (int i = 0; i < BS / 4; ++i)
      sc[(r_grp + 4 * i) * BW + w_own] = s[i] >= T ? s[i] : 0;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < BS / 8; ++i) {
      const int r = warp + 8 * i;
      for (int w = 0; w < BW; ++w) {
        const int32_t wt = sc[r * BW + w];
        if (wt) {
#pragma unroll
          for (int j = 0; j < NW; ++j) acc[i][j] += wt * hs[w * F + lane + 32 * j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < BS / 8; ++i) {
    const long row = row0 + warp + 8 * i;
    if (row < S) {
#pragma unroll
      for (int j = 0; j < NW; ++j) out[row * F + lane + 32 * j] = acc[i][j];
    }
  }
}

template <int NW>
int launch(const void* rows, const void* cb, const void* H, void* out, int S,
           int D, int W, int T, cudaStream_t stream) {
  constexpr int F = NW * 32;
  const size_t smem = sizeof(int32_t) * (BS * D + D * BW + BS * BW) + BW * F;
  auto kernel = siggen_kernel<NW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + BS - 1) / BS);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const int8_t*>(cb),
      static_cast<const int8_t*>(H), static_cast<int32_t*>(out), S, D, W, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// V (S, f) = sum_w [rows . cb_w >= T] (rows . cb_w) H_w. f must be a
// multiple of 32 up to 256; returns the CUDA error code of the launch.
extern "C" int siggen_accumulate(const void* rows, const void* cb,
                                 const void* H, void* out, int S, int D,
                                 int W, int f, int T, void* stream) {
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 32: return launch<1>(rows, cb, H, out, S, D, W, T, st);
    case 64: return launch<2>(rows, cb, H, out, S, D, W, T, st);
    case 96: return launch<3>(rows, cb, H, out, S, D, W, T, st);
    case 128: return launch<4>(rows, cb, H, out, S, D, W, T, st);
    case 160: return launch<5>(rows, cb, H, out, S, D, W, T, st);
    case 192: return launch<6>(rows, cb, H, out, S, D, W, T, st);
    case 224: return launch<7>(rows, cb, H, out, S, D, W, T, st);
    case 256: return launch<8>(rows, cb, H, out, S, D, W, T, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
