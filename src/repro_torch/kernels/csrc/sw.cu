// K3 — wavefront Smith-Waterman best score, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sw.py::wave_scores_kernel (body
// _wave_sw_kernel): the best local alignment score of each (query,
// reference) pair of a (B, Lq) x (B, Lr) int8 block (PAD = 20), swept by
// anti-diagonals, with linear gaps
//
//     h = max(h2s + s, 0, max(h1, h1s) + gap)
//
// or affine (Gotoh) gaps with zero-initialised E/F lanes
//
//     e = max(e1 + extend, h1 + open)
//     f = max(f1s + extend, h1s + open)
//     h = max(h2s + s, 0, e, f)
//
// where, for query row i on diagonal c (cell (i, c-i)), h1 = H[i, j-1],
// h1s = H[i-1, j], h2s = H[i-1, j-1]. Zero-initialised gap lanes are exact
// for H (repro/align/gotoh.py::_scan_affine explains why): a polluted E/F
// value is negative and never wins against H's 0 floor.
//
// Bound on this card: operations. Each DP cell costs ~6 (linear) or ~11
// (affine) int32 operations on the CUDA cores, while a pair moves only
// Lq + Lr bytes in and 4 bytes out.
//
// What this design does about it: all DP state stays in registers and the
// kernel moves nothing but the residues and the scores. One block scores
// one pair. Lanes are query rows: thread t owns the RPT consecutive rows
// t*RPT .. t*RPT+RPT-1 (Lq may exceed 1024 threads), each with its query
// residue in a register. A row's upper neighbour is the row before it in
// the same thread, except for the thread's first row, whose neighbour is
// the previous thread's last row: a __shfl_up_sync inside a warp and a
// double-buffered shared-memory slot across warps, with one __syncthreads
// per diagonal. The reference row and the 21x21 BLOSUM62 table (PAD row and
// column at the sentinel SENT, -100) sit in shared memory; the substitution
// score is looked up per cell, so the pre-skewed (nd, B, Lq) block the TPU
// path builds outside its kernel (repro/kernels/sw.py:186) never exists.
// Cells with j outside [0, Lr) are not computed. Lanes are int32. Packing
// several pairs per block and 16-bit SIMD lanes are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PADC = 20;  // PAD residue id
constexpr int NA = 21;    // alphabet + PAD
constexpr unsigned FULL = 0xffffffffu;

template <int RPT, bool AFFINE>
__global__ void wave_kernel(const int8_t* __restrict__ qs,
                            const int8_t* __restrict__ rs,
                            const int32_t* __restrict__ table,
                            int32_t* __restrict__ out, int Lq, int Lr,
                            int gap_open, int gap_extend) {
  extern __shared__ int8_t rrow[];  // [Lr] reference residues
  __shared__ int32_t tab[NA * NA];
  __shared__ int32_t xh[2][32];     // per-warp last-row H, by diagonal parity
  __shared__ int32_t xf[2][32];     // per-warp last-row F
  __shared__ int32_t red[32];

  const long b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  for (int j = t; j < Lr; j += blockDim.x) {
    const int v = rs[b * Lr + j];
    rrow[j] = (v >= 0 && v < PADC) ? v : PADC;
  }
  for (int i = t; i < NA * NA; i += blockDim.x) tab[i] = table[i];

  const int i0 = t * RPT;
  int qrow[RPT];  // query residue * NA, per owned row
  int h1[RPT], h2[RPT], e1[RPT], f1[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = i0 + k;
    const int v = i < Lq ? qs[b * Lq + i] : PADC;
    qrow[k] = ((v >= 0 && v < PADC) ? v : PADC) * NA;
    h1[k] = h2[k] = e1[k] = f1[k] = 0;
  }
  int up_h2 = 0;  // H of the row above the first owned row, diagonal c-2
  int best = 0;
  __syncthreads();

  const int nd = Lq + Lr - 1;
  for (int c = 0; c < nd; ++c) {
    const int p = c & 1;
    if (lane == 31) {
      xh[p][warp] = h1[RPT - 1];
      xf[p][warp] = f1[RPT - 1];
    }
    __syncthreads();
    int up_h1 = __shfl_up_sync(FULL, h1[RPT - 1], 1);
    int up_f1 = __shfl_up_sync(FULL, f1[RPT - 1], 1);
    if (lane == 0) {
      up_h1 = warp > 0 ? xh[p][warp - 1] : 0;
      up_f1 = warp > 0 ? xf[p][warp - 1] : 0;
    }
    // descending rows: row k reads row k-1's diagonal c-1 and c-2 values
    // before row k-1 overwrites them
#pragma unroll
    for (int k = RPT - 1; k >= 0; --k) {
      const int i = i0 + k;
      const int j = c - i;
      if (i < Lq && j >= 0 && j < Lr) {
        const int hu = k ? h1[k - 1] : up_h1;  // H[i-1, j]
        const int hd = k ? h2[k - 1] : up_h2;  // H[i-1, j-1]
        const int s = tab[qrow[k] + rrow[j]];
        int h;
        if (AFFINE) {
          const int fu = k ? f1[k - 1] : up_f1;  // F[i-1, j]
          const int e = max(e1[k] + gap_extend, h1[k] + gap_open);
          const int f = max(fu + gap_extend, hu + gap_open);
          h = max(max(hd + s, 0), max(e, f));
          e1[k] = e;
          f1[k] = f;
        } else {
          h = max(max(hd + s, 0), max(h1[k], hu) + gap_open);
        }
        h2[k] = h1[k];
        h1[k] = h;
        best = max(best, h);
      }
    }
    up_h2 = up_h1;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, off));
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (t == 0) {
    int m = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      m = max(m, red[w]);
    out[b] = m;
  }
}

template <int RPT>
int launch(const void* qs, const void* rs, const void* table, void* out,
           int B, int Lq, int Lr, int gap_open, int gap_extend, int affine,
           cudaStream_t stream) {
  const int rows_per_block = (Lq + RPT - 1) / RPT;
  const int nt = ((rows_per_block + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(Lr);
  auto kernel = affine ? wave_kernel<RPT, true> : wave_kernel<RPT, false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<B, nt, smem, stream>>>(
      static_cast<const int8_t*>(qs), static_cast<const int8_t*>(rs),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), Lq, Lr,
      gap_open, gap_extend);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (B, Lq) x (B, Lr) int8 residues -> (B,) int32 best local scores.
// table: (21*21,) int32 BLOSUM62 with the PAD row/column at the sentinel.
// Rows per thread grow in powers of two so a block never exceeds 256
// threads; Lq up to 8192. Returns the CUDA error code of the launch.
extern "C" int wave_scores(const void* qs, const void* rs, const void* table,
                           void* out, int B, int Lq, int Lr, int gap_open,
                           int gap_extend, int affine, void* stream) {
  if (B == 0) return 0;
  if (Lq < 1 || Lr < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int need = (Lq + 255) / 256;  // rows per thread at 256 threads
  if (need <= 1) return launch<1>(qs, rs, table, out, B, Lq, Lr, gap_open, gap_extend, affine, st);
  if (need <= 2) return launch<2>(qs, rs, table, out, B, Lq, Lr, gap_open, gap_extend, affine, st);
  if (need <= 4) return launch<4>(qs, rs, table, out, B, Lq, Lr, gap_open, gap_extend, affine, st);
  if (need <= 8) return launch<8>(qs, rs, table, out, B, Lq, Lr, gap_open, gap_extend, affine, st);
  if (need <= 16) return launch<16>(qs, rs, table, out, B, Lq, Lr, gap_open, gap_extend, affine, st);
  if (need <= 32) return launch<32>(qs, rs, table, out, B, Lq, Lr, gap_open, gap_extend, affine, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
