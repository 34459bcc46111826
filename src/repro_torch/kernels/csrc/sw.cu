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

// ---------------------------------------------------------------------------
// K4 — ungapped X-drop diagonal scan, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sw.py::ungapped_scores_kernel (body
// _ungapped_kernel): for each (query, reference) pair of a (B, Lq) x (B, Lr)
// int8 block, the best ungapped run along any diagonal, where cell (i, j)
// extends the run of (i-1, j-1),
//
//     c = cur + s[i, j]
//
// and the run restarts (cur = 0, run best = 0) when c <= 0 or when it fell
// more than x below its own best (rbest - c > x). A cell with PAD on either
// side restarts the run. The score is the max of c over all cells; x = 2^30
// is the no-drop limit the wrapper passes for x=None.
//
// Bound on this card: operations, about 5 int32 operations per real cell,
// while a pair moves Lq + Lr bytes in and 4 bytes out.
//
// What this design does about it: each diagonal's run is independent, so a
// thread walks whole diagonals with cur, rbest and best in registers and no
// barrier inside the walk. One block scores one pair; its residues and the
// 21x21 BLOSUM62 table sit in shared memory. The walk stops at the last
// non-PAD row and column of the pair (found by a block max first): cells
// past them are PAD, restart runs and cannot raise the best, so wave padding
// and all-PAD rows (score 0) cost next to nothing. Arithmetic is int32; the
// reference's int16 lanes for L <= 1024 are exact, so scores are the same.
// The TPU form's one-hot table select per row is not carried over.
//
// ---------------------------------------------------------------------------
// K7 — row-wave linear-gap Smith-Waterman best score (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sw.py::sw_scores_kernel (body
// _sw_kernel): the same function as K3 with linear gaps, by another
// algorithm. Row i of H follows from row i-1 in closed form:
//
//     a_j    = max(0, H[i-1, j-1] + s[i, j], H[i-1, j] + GAP)
//     H[i,j] = max_{t <= j} (a_t + c*t) - c*j,   c = -GAP
//
// a max-plus prefix scan along the row (PAD cells score -10^6).
//
// Bound on this card: operations, about 6 int32 operations per real cell.
//
// What this design does about it: one block scores one pair, threads over
// columns, each thread owning CPT consecutive columns of H in registers. Per
// query row a thread computes its a_j (the left neighbour of its first
// column comes from the thread before: a warp shuffle, or a shared slot
// across warps), scans its own columns, and a warp-shuffle scan plus one
// scan of the per-warp maxima in shared memory completes the block-wide
// inclusive max-scan: three barriers per row instead of the TPU form's
// log-doubling shifts. Rows and columns past the pair's last non-PAD
// residue are not computed: there H only decays (each cell at most a value
// of the rows or columns before it, minus 4), so the best is unchanged.
// ---------------------------------------------------------------------------

namespace {

constexpr int NEGS = -1000000;  // PAD-masked substitution score

// Max over the block of a non-negative value; every thread gets it.
__device__ int block_max(int v, int* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(FULL, v, off));
  __syncthreads();  // red may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = max(v, __shfl_xor_sync(FULL, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// Loads one pair's residues (anything outside the alphabet as PAD) and the
// BLOSUM62 table into shared memory; returns via lq/lr the extents up to the
// last non-PAD residue on each side.
__device__ void load_pair(const int8_t* __restrict__ qs,
                          const int8_t* __restrict__ rs,
                          const int32_t* __restrict__ table, int8_t* q,
                          int8_t* r, int32_t* tab, int* red, int Lq, int Lr,
                          int* lq, int* lr) {
  const long b = blockIdx.x;
  int eq = 0, er = 0;
  for (int i = threadIdx.x; i < Lq; i += blockDim.x) {
    const int v = qs[b * Lq + i];
    const int c = (v >= 0 && v < PADC) ? v : PADC;
    q[i] = static_cast<int8_t>(c);
    if (c != PADC) eq = i + 1;
  }
  for (int j = threadIdx.x; j < Lr; j += blockDim.x) {
    const int v = rs[b * Lr + j];
    const int c = (v >= 0 && v < PADC) ? v : PADC;
    r[j] = static_cast<int8_t>(c);
    if (c != PADC) er = j + 1;
  }
  for (int i = threadIdx.x; i < NA * NA; i += blockDim.x) tab[i] = table[i];
  *lq = block_max(eq, red);
  *lr = block_max(er, red);
}

__global__ void ungapped_kernel(const int8_t* __restrict__ qs,
                                const int8_t* __restrict__ rs,
                                const int32_t* __restrict__ table,
                                int32_t* __restrict__ out, int Lq, int Lr,
                                int x) {
  extern __shared__ int8_t res[];  // [Lq] query then [Lr] reference
  __shared__ int32_t tab[NA * NA];
  __shared__ int red[32];
  int8_t* q = res;
  int8_t* r = res + Lq;
  int lq, lr;
  load_pair(qs, rs, table, q, r, tab, red, Lq, Lr, &lq, &lr);

  int best = 0;
  const int nd = (lq > 0 && lr > 0) ? lq + lr - 1 : 0;
  for (int d = threadIdx.x; d < nd; d += blockDim.x) {
    const int k = d - (lq - 1);  // diagonal j - i
    int i = k < 0 ? -k : 0;
    int j = k < 0 ? 0 : k;
    int cur = 0, rbest = 0;
    for (; i < lq && j < lr; ++i, ++j) {
      const int qi = q[i];
      const int rj = r[j];
      const int c = (qi == PADC || rj == PADC) ? 0 : cur + tab[qi * NA + rj];
      if (c <= 0 || rbest - c > x) {
        cur = 0;
        rbest = 0;
      } else {
        cur = c;
        rbest = max(rbest, c);
        best = max(best, c);
      }
    }
  }
  best = block_max(best, red);
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

template <int CPT>
__global__ void rowwave_kernel(const int8_t* __restrict__ qs,
                               const int8_t* __restrict__ rs,
                               const int32_t* __restrict__ table,
                               int32_t* __restrict__ out, int Lq, int Lr,
                               int gap) {
  extern __shared__ int8_t res[];  // [Lq] query then [Lr] reference
  __shared__ int32_t tab[NA * NA];
  __shared__ int red[32];
  __shared__ int xh[32];    // per-warp last column of H[i-1, :]
  __shared__ int wsum[32];  // per-warp inclusive scan maxima
  int8_t* q = res;
  int8_t* r = res + Lq;
  int lq, lr;
  load_pair(qs, rs, table, q, r, tab, red, Lq, Lr, &lq, &lr);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int c = -gap;
  const int j0 = t * CPT;  // first owned column (0-based; H column j0 + 1)
  int rcol[CPT], h[CPT], v[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = j0 + k;
    rcol[k] = j < lr ? r[j] : PADC;
    h[k] = 0;
  }
  int best = 0;
  for (int i = 0; i < lq; ++i) {
    const int qi = q[i];
    if (lane == 31) xh[warp] = h[CPT - 1];
    __syncthreads();
    int left = __shfl_up_sync(FULL, h[CPT - 1], 1);  // H[i-1, j0]
    if (lane == 0) left = warp > 0 ? xh[warp - 1] : 0;
    // descending: column k reads the old H[i-1, j0+k] of column k-1
#pragma unroll
    for (int k = CPT - 1; k >= 0; --k) {
      const int j = j0 + k;
      if (j < lr) {
        const int diag = k ? h[k - 1] : left;
        const int s = (qi == PADC || rcol[k] == PADC)
                          ? NEGS : tab[qi * NA + rcol[k]];
        const int a = max(0, max(diag + s, h[k] + gap));
        v[k] = a + c * (j + 1);
      } else {
        v[k] = 0;  // past the pair: the scan's identity (every v > 0)
      }
    }
#pragma unroll
    for (int k = 1; k < CPT; ++k) v[k] = max(v[k], v[k - 1]);
    int ws = v[CPT - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, ws, off);
      if (lane >= off) ws = max(ws, o);
    }
    if (lane == 31) wsum[warp] = ws;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nw ? wsum[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL, w, off);
        if (lane >= off) w = max(w, o);
      }
      if (lane < nw) wsum[lane] = w;
    }
    __syncthreads();
    int pre = __shfl_up_sync(FULL, ws, 1);
    if (lane == 0) pre = 0;
    if (warp > 0) pre = max(pre, wsum[warp - 1]);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = j0 + k;
      if (j < lr) {
        h[k] = max(pre, v[k]) - c * (j + 1);
        best = max(best, h[k]);
      }
    }
  }
  best = block_max(best, red);
  if (t == 0) out[blockIdx.x] = best;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int CPT>
int launch_rowwave(const void* qs, const void* rs, const void* table,
                   void* out, int B, int Lq, int Lr, int gap,
                   cudaStream_t stream) {
  const int cols = (Lr + CPT - 1) / CPT;
  const int nt = ((cols + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(Lq) + Lr;
  int e = set_smem(reinterpret_cast<const void*>(rowwave_kernel<CPT>), smem);
  if (e) return e;
  rowwave_kernel<CPT><<<B, nt, smem, stream>>>(
      static_cast<const int8_t*>(qs), static_cast<const int8_t*>(rs),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), Lq,
      Lr, gap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: (B, Lq) x (B, Lr) int8 residues -> (B,) int32 best ungapped X-drop
// run scores. table: (21*21,) int32 BLOSUM62 (the PAD row/column is masked
// in the kernel). x: the X-drop margin (2^30 for none). 256 threads a block.
extern "C" int ungapped_scores(const void* qs, const void* rs,
                               const void* table, void* out, int B, int Lq,
                               int Lr, int x, void* stream) {
  if (B == 0) return 0;
  if (Lq < 1 || Lr < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(Lq) + Lr;
  int e = set_smem(reinterpret_cast<const void*>(ungapped_kernel), smem);
  if (e) return e;
  ungapped_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qs), static_cast<const int8_t*>(rs),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), Lq,
      Lr, x);
  return static_cast<int>(cudaGetLastError());
}

// K7: (B, Lq) x (B, Lr) int8 residues -> (B,) int32 row-wave linear-gap SW
// best scores. Columns per thread grow in powers of two so a block never
// exceeds 256 threads; Lr up to 8192.
extern "C" int sw_rowwave(const void* qs, const void* rs, const void* table,
                          void* out, int B, int Lq, int Lr, int gap,
                          void* stream) {
  if (B == 0) return 0;
  if (Lq < 1 || Lr < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int need = (Lr + 255) / 256;
  if (need <= 1) return launch_rowwave<1>(qs, rs, table, out, B, Lq, Lr, gap, st);
  if (need <= 2) return launch_rowwave<2>(qs, rs, table, out, B, Lq, Lr, gap, st);
  if (need <= 4) return launch_rowwave<4>(qs, rs, table, out, B, Lq, Lr, gap, st);
  if (need <= 8) return launch_rowwave<8>(qs, rs, table, out, B, Lq, Lr, gap, st);
  if (need <= 16) return launch_rowwave<16>(qs, rs, table, out, B, Lq, Lr, gap, st);
  if (need <= 32) return launch_rowwave<32>(qs, rs, table, out, B, Lq, Lr, gap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
