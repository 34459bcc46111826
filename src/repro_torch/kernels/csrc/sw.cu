// K3 — wavefront Smith-Waterman best score, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sw.py::wave_scores_kernel (body
// _wave_sw_kernel): the best local alignment score of each (query,
// reference) pair of a (B, Lq) x (B, Lr) int8 block (PAD = 20), with
// linear gaps
//
//     H[i,j] = max(H[i-1,j-1] + s, 0, max(H[i,j-1], H[i-1,j]) + gap)
//
// or affine (Gotoh) gaps with zero-initialised E/F lanes
//
//     E[i,j] = max(E[i,j-1] + extend, H[i,j-1] + open)
//     F[i,j] = max(F[i-1,j] + extend, H[i-1,j] + open)
//     H[i,j] = max(H[i-1,j-1] + s, 0, E[i,j], F[i,j])
//
// with H, E and F at 0 outside the matrix. Zero-initialised gap lanes are
// exact for H (repro/align/gotoh.py::_scan_affine explains why): a
// polluted E/F value is negative and never wins against H's 0 floor.
// PAD rows and columns score the sentinel SENT (-100) of
// gotoh.sentinel_table(), as in the plain twin.
//
// Bound on this card: operations. Each DP cell costs ~6 (linear) or ~11
// (affine) int32 operations, while a pair moves only Lq + Lr bytes in and
// 4 bytes out.
//
// Design. One warp scores one pair, WARPS pairs a block, and no block barrier
// runs in the DP (one, before it, shares the BLOSUM table). Lane t owns a
// strip of RPT consecutive query rows (RPT chosen by Lq, a template constant)
// and sweeps the reference columns skewed: lane t computes column j at step
// j + t, all RPT rows of it, with H[i,j-1] and E[i,j-1] of its rows in
// registers. At each step one __shfl_up_sync hands each lane's bottom-row H
// (and F) of the column it computed the step before to lane t+1, which
// computes that same column now: H[i-1,j] (and F[i-1,j]) of its first row.
// H[i-1,j-1] is the value the lane received one step earlier. Every lane
// computes at every step: a column outside the pair reads the PAD scores,
// which keep H at 0 before the matrix and only decay it after, so no lane
// branches. A query longer than 32 x RPT rows runs as successive strips of the
// same warp: lane 31 saves the strip's last-row H (and F) of every column, and
// lane 0 of the next strip reads them back in place of the shuffle (in shared
// memory, or in per-pair global scratch when the wrapper passes one). RPT is the smallest multiple of 4
// that makes one strip of Lq rows (at most 32, so up to 8 strips at
// Lq = 8192), and a strip sweeps lr + 31 steps at most.
//
// Substitution scores come from a per-strip query profile in shared memory:
// for each residue c, the RPT int8 scores of a lane's rows sit together, so
// one vector load fetches a lane's RPT scores of column j. The loads run ahead
// of the DP: step j loads the reference residue of column j + 2 from global
// memory and the scores of column j + 1 from the profile, so neither latency
// sits on the step's chain. Each cell is Hopper DPX instructions on int32
// lanes, with the recurrence regrouped so that one instruction per cell sits
// on the chain down a lane's rows:
//
//   linear: a = __viaddmax_s32_relu(H[i,j-1], gap, H[i-1,j-1] + s)
//           H = __viaddmax_s32(H[i-1,j], gap, a)
//   affine: E = __viaddmax_s32(E[i,j-1], extend, H[i,j-1] + open)
//           a = __vimax_s32_relu(H[i-1,j-1] + s, E)
//           F = __viaddmax_s32(F[i-1,j], max(extend, open), a[i-1] + open)
//           H = max(a, F)
//
// (F's form follows from H[i-1,j] = max(a[i-1], F[i-1,j]); the lane's
// first row takes F = __viaddmax_s32(F[i-1,j], extend, H[i-1,j] + open)
// from the shuffled values.) The _s16x2 forms are not used: every lane is
// int32, exact at any Lq, Lr the kernel takes.
//
// Each pair is trimmed to its last non-PAD residue on each side, found
// with one warp ballot per 32 residues: rows and columns past them are PAD
// and their cells only decay (each is at most a value of the rows or
// columns before it, less a gap or plus SENT), so the best is unchanged. A
// pair with no residue on a side writes 0 without entering the DP.
//
// Two regimes. Serving re-ranks ~640 pairs a launch: a warp per pair puts
// ~5 warps on every SM, and the kernel is throughput-bound on the cell
// chain. An all-pairs SW wave holds ~1 real pair of 56 on average: the
// padding slots exit after the ballot, and the critical path is the real
// pair's (lr + 31) x ceil(lq / (32 RPT)) warp steps of RPT cells, against
// one block barrier per anti-diagonal (Lq + Lr - 1 of them) in the
// previous design.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PADC = 20;  // PAD residue id
constexpr int NA = 21;    // alphabet + PAD
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;  // K3: pairs (warps) per block

__device__ __forceinline__ int residue(const int8_t* __restrict__ s,
                                       int i) {
  const int v = s[i];
  return (v >= 0 && v < PADC) ? v : PADC;
}

// The length of a warp's sequence s[0, L) up to its last non-PAD residue
// (0 if it has none), one ballot per 32 residues from the end; every lane
// gets it.
__device__ __forceinline__ int warp_extent(const int8_t* __restrict__ s,
                                           int L, int lane) {
  for (int base = ((L - 1) >> 5) << 5; base >= 0; base -= 32) {
    const int i = base + lane;
    const unsigned m = __ballot_sync(FULL, i < L && residue(s, i) != PADC);
    if (m) return base + 32 - __clz(static_cast<int>(m));
  }
  return 0;
}

// RPT int8 scores from 8-byte aligned shared memory into RPT/4 words.
template <int RPT>
__device__ __forceinline__ void load_scores(const int8_t* p, int* w) {
  if constexpr (RPT % 16 == 0) {
#pragma unroll
    for (int k = 0; k < RPT / 4; k += 4) {
      const int4 v = *reinterpret_cast<const int4*>(p + 4 * k);
      w[k] = v.x; w[k + 1] = v.y; w[k + 2] = v.z; w[k + 3] = v.w;
    }
  } else if constexpr (RPT % 8 == 0) {
#pragma unroll
    for (int k = 0; k < RPT / 4; k += 2) {
      const int2 v = *reinterpret_cast<const int2*>(p + 4 * k);
      w[k] = v.x; w[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < RPT / 4; ++k)
      w[k] = *reinterpret_cast<const int*>(p + 4 * k);
  }
}

// RPT/4 words of int8 scores into 8-byte aligned shared memory.
template <int RPT>
__device__ __forceinline__ void store_scores(int8_t* p, const int* w) {
  if constexpr (RPT % 16 == 0) {
#pragma unroll
    for (int k = 0; k < RPT / 4; k += 4)
      *reinterpret_cast<int4*>(p + 4 * k) =
          make_int4(w[k], w[k + 1], w[k + 2], w[k + 3]);
  } else if constexpr (RPT % 8 == 0) {
#pragma unroll
    for (int k = 0; k < RPT / 4; k += 2)
      *reinterpret_cast<int2*>(p + 4 * k) = make_int2(w[k], w[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < RPT / 4; ++k) *reinterpret_cast<int*>(p + 4 * k) = w[k];
  }
}

// byte k (a compile-time constant) of the packed scores, sign-extended
__device__ __forceinline__ int score_at(const int* w, int k) {
  return static_cast<int8_t>(w[k >> 2] >> (8 * (k & 3)));
}

// the low bytes of four ints packed into one word
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return static_cast<int>(__byte_perm(__byte_perm(a, b, 0x0040),
                                      __byte_perm(c, d, 0x0040), 0x5410));
}

template <int RPT, bool AFFINE>
__global__ void __launch_bounds__(WARPS * 32, 1)
wave_kernel(const int8_t* __restrict__ qs, const int8_t* __restrict__ rs,
            const int32_t* __restrict__ table, int32_t* __restrict__ out,
            int32_t* __restrict__ scratch, int B, int Lq, int Lr,
            int gap_open, int gap_extend, int buf_in_smem) {
  constexpr int ROWS = 32 * RPT;    // query rows of a strip
  constexpr int PROF = NA * ROWS;   // profile bytes of a warp
  constexpr int NBUF = AFFINE ? 2 : 1;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int32_t tab[NA * NA];
  for (int i = threadIdx.x; i < NA * NA; i += blockDim.x) tab[i] = table[i];
  __syncthreads();   // the only block barrier, before any pair's DP
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long b = static_cast<long>(blockIdx.x) * WARPS + warp;
  if (b >= B) return;
  const int8_t* q = qs + b * Lq;
  const int8_t* r = rs + b * Lr;
  const int lq = warp_extent(q, Lq, lane);
  const int lr = warp_extent(r, Lr, lane);
  if (lq == 0 || lr == 0) {
    if (lane == 0) out[b] = 0;
    return;
  }
  int8_t* prof = smem + warp * PROF;
  // the previous strip's last-row H (and F after it), by column
  int32_t* bh = buf_in_smem
      ? reinterpret_cast<int32_t*>(smem + WARPS * PROF) + warp * NBUF * Lr
      : scratch + b * NBUF * Lr;
  int32_t* bf = bh + Lr;
  const int gap = gap_open, open = gap_open, ext = gap_extend;
  const int fstep = max(gap_extend, gap_open);
  const int nstrips = (lq + ROWS - 1) / ROWS;
  int best = 0;
  for (int st = 0; st < nstrips; ++st) {
    const int base = st * ROWS;
    const int rows = min(ROWS, lq - base);
    const bool last = st == nstrips - 1;
    {  // the strip's query profile: lane t's RPT scores per residue c
      int qrow[RPT];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int row = base + lane * RPT + k;
        qrow[k] = (row < lq ? residue(q, row) : PADC) * NA;
      }
      for (int c = 0; c < NA; ++c) {
        int w[RPT / 4];
#pragma unroll
        for (int k = 0; k < RPT; k += 4)
          w[k >> 2] = pack4(tab[qrow[k] + c], tab[qrow[k + 1] + c],
                            tab[qrow[k + 2] + c], tab[qrow[k + 3] + c]);
        store_scores<RPT>(prof + (c * 32 + lane) * RPT, w);
      }
    }
    __syncwarp();
    int hl[RPT], el[RPT];   // H[i, j-1], E[i, j-1] of the lane's rows
#pragma unroll
    for (int k = 0; k < RPT; ++k) hl[k] = el[k] = 0;
    int bot_h = 0, bot_f = 0;  // the lane's last-row H, F of its column
    int prev_up = 0;           // H[first row - 1, j - 1]
    const int tlast = (rows - 1) / RPT;  // the last lane with a row
    const int steps = lr + tlast;
    // the reference runs ahead of the DP: step p loads the residue of
    // column j + 2 and the scores of column j + 1. Every lane computes at
    // every step: a column outside [0, lr) reads the PAD scores (SENT),
    // which leave H at 0 before the matrix and only decay after it, and
    // rows past lq are PAD rows, so the best is unchanged.
    auto rbyte = [&](int x) {
      return (x >= 0 && x < lr) ? static_cast<int>(r[x]) : PADC;
    };
    auto scores = [&](int raw) {
      const int c = (raw >= 0 && raw < PADC) ? raw : PADC;
      return prof + (c * 32 + lane) * RPT;
    };
    int raw1 = rbyte(1 - lane);
    int w[RPT / 4];
    load_scores<RPT>(scores(rbyte(-lane)), w);
    for (int p = 0; p < steps; ++p) {
      const int j = p - lane;
      const int raw2 = rbyte(j + 2);
      int wn[RPT / 4];
      load_scores<RPT>(scores(raw1), wn);
      int up_h = __shfl_up_sync(FULL, bot_h, 1);   // H[first row - 1, j]
      int up_f = AFFINE ? __shfl_up_sync(FULL, bot_f, 1) : 0;
      if (lane == 0) {
        const bool from_buf = st > 0 && j < lr;
        up_h = from_buf ? bh[j] : 0;
        if (AFFINE) up_f = from_buf ? bf[j] : 0;
      }
      int hd = prev_up;   // H[i-1, j-1]
      int h = up_h;       // H[i-1, j], then this row's H
      int f = up_f, a = 0, hprev = 0;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int s = score_at(w, k);
        if (AFFINE) {
          const int e = __viaddmax_s32(el[k], ext, hl[k] + open);
          f = k ? __viaddmax_s32(f, fstep, a + open)
                : __viaddmax_s32(f, ext, h + open);
          a = __vimax_s32_relu(hd + s, e);
          h = max(a, f);
          el[k] = e;
        } else {
          const int a0 = __viaddmax_s32_relu(hl[k], gap, hd + s);
          h = __viaddmax_s32(h, gap, a0);
        }
        hd = hl[k];
        hl[k] = h;
        if (k & 1) best = __vimax3_s32(best, hprev, h);
        hprev = h;
      }
      bot_h = h;
      bot_f = f;
      if (!last && lane == 31 && j >= 0 && j < lr) {
        bh[j] = h;
        if (AFFINE) bf[j] = f;
      }
#pragma unroll
      for (int k = 0; k < RPT / 4; ++k) w[k] = wn[k];
      raw1 = raw2;
      prev_up = up_h;
    }
    __syncwarp();
  }
  best = __reduce_max_sync(FULL, best);
  if (lane == 0) out[b] = best;
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int RPT>
int launch_wave(const int8_t* qs, const int8_t* rs, const int32_t* table,
                int32_t* out, int32_t* scratch, int B, int Lq, int Lr,
                int gap_open, int gap_extend, int affine,
                cudaStream_t stream) {
  const int strips = (Lq + 32 * RPT - 1) / (32 * RPT);
  const size_t prof = static_cast<size_t>(WARPS) * NA * 32 * RPT;
  const size_t buf = strips > 1 ? static_cast<size_t>(WARPS) * 4 * Lr *
                                      (affine ? 2 : 1) : 0;
  const int in_smem = scratch == nullptr;
  const size_t smem = prof + (in_smem ? buf : 0);
  auto kernel = affine ? wave_kernel<RPT, true> : wave_kernel<RPT, false>;
  int e = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e) return e;
  kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, smem, stream>>>(
      qs, rs, table, out, scratch, B, Lq, Lr, gap_open, gap_extend,
      in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: (B, Lq) x (B, Lr) int8 residues -> (B,) int32 best local scores.
// table: (21*21,) int32 BLOSUM62 with the PAD row/column at the sentinel.
// Rows per lane (RPT) is the smallest multiple of 4 whose 32-lane strip
// holds Lq rows, at most 32; Lq up to 8192 (8 strips). scratch: null to
// keep a multi-strip query's strip buffers in shared memory, else B x Lr
// (x2 affine) int32 in global memory for them;
// repro_torch/kernels/sw.py::wave_geometry decides which.
// Returns the CUDA error code of the launch.
extern "C" int wave_scores(const void* qs, const void* rs, const void* table,
                           void* out, int B, int Lq, int Lr, int gap_open,
                           int gap_extend, int affine, void* scratch,
                           void* stream) {
  if (B == 0) return 0;
  if (Lq < 1 || Lr < 1 || Lq > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  auto q = static_cast<const int8_t*>(qs);
  auto r = static_cast<const int8_t*>(rs);
  auto t = static_cast<const int32_t*>(table);
  auto o = static_cast<int32_t*>(out);
  auto s = static_cast<int32_t*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K3_LAUNCH(R)                                                       \
  if (Lq <= 32 * (R) || (R) == 32)                                         \
    return launch_wave<R>(q, r, t, o, s, B, Lq, Lr, gap_open, gap_extend,  \
                          affine, st);
  K3_LAUNCH(4) K3_LAUNCH(8) K3_LAUNCH(12) K3_LAUNCH(16)
  K3_LAUNCH(20) K3_LAUNCH(24) K3_LAUNCH(28) K3_LAUNCH(32)
#undef K3_LAUNCH
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
// (NO_XDROP) is the no-drop limit the wrapper passes for x=None.
//
// Bound on this card: operations, about 5 int32 operations per real cell,
// while a pair moves Lq + Lr bytes in and 4 bytes out.
//
// Design. One block scores one pair with min(1024, round32(Lq + Lr - 1))
// threads, so each thread walks one diagonal of the trimmed pair (a
// further one only past 1,024 diagonals) with cur and best in registers:
// its serial chain is at most min(lq, lr) cells. One pass loads the
// residues (anything outside the alphabet as PAD) into shared memory and
// finds both last non-PAD indices at once (warp max reductions, one
// barrier, every warp reducing the per-warp maxima again); a pair with no
// residue on a side writes 0 at once. Cells past the last residues are
// PAD, restart runs and cannot raise the best, so the walk stops there.
// The 21x21 BLOSUM62 table sits in shared memory with rows of 256 and its
// PAD row and column at NEGS (-10^6). The no-drop walk takes four cells a
// step: one word load per side (funnel-shifted to the diagonal's byte
// offset) gives four residues, one byte permute per cell the table index
// q * 256 + r, and no PAD branch: a thread issues 1.5 shared loads a cell
// instead of 3. The side arrays are PAD-filled a word past their ends, so
// a step may run past the diagonal's end into PAD cells, which restart
// runs and leave the best alone. A template specialises on the margin:
// for x >= NO_XDROP (the main path's x=None) a cell is
//
//     cur = __viaddmax_s32_relu(cur, s, 0);  best = max(best, cur)
//
// which is the restart rule when no drop can fire: a cell with c <= 0
// restarts at 0 and never raises the best, which is >= 0 (no run of
// BLOSUM62 scores over sequences the kernel takes falls 2^30 below its
// best). A finite x keeps the general rule. Arithmetic is int32; the
// reference's int16 lanes for L <= 1024 are exact, so scores are the
// same. The TPU form's one-hot table select per row is not carried over.
// ---------------------------------------------------------------------------

namespace {

constexpr int NEGS = -1000000;      // PAD-masked substitution score
constexpr int NO_XDROP = 1 << 30;   // kernels/ops.py::NO_XDROP

// Bytes of one side in shared memory: the sequence, then PAD up to a
// whole word and one word more, so a walk may read a word past its end.
__host__ __device__ constexpr int side_bytes(int L) {
  return ((L + 3) & ~3) + 8;
}

template <bool NODROP>
__global__ void ungapped_kernel(const int8_t* __restrict__ qs,
                                const int8_t* __restrict__ rs,
                                const int32_t* __restrict__ table,
                                int32_t* __restrict__ out, int Lq, int Lr,
                                int x) {
  // query then reference residues, each side_bytes() long
  extern __shared__ __align__(16) int8_t res[];
  __shared__ int32_t tab[NA * 256];  // [q * 256 + r]; 21 x 21 are used
  __shared__ int ext[2][32];         // per-warp extents, query, reference
  __shared__ int red[32];
  const long b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int qn = side_bytes(Lq), rn = side_bytes(Lr);
  int8_t* q = res;
  int8_t* r = res + qn;
  int eq = 0, er = 0;
  for (int i = t; i < qn; i += blockDim.x) {
    const int c = i < Lq ? residue(qs + b * Lq, i) : PADC;
    q[i] = static_cast<int8_t>(c);
    if (c != PADC) eq = i + 1;
  }
  for (int j = t; j < rn; j += blockDim.x) {
    const int c = j < Lr ? residue(rs + b * Lr, j) : PADC;
    r[j] = static_cast<int8_t>(c);
    if (c != PADC) er = j + 1;
  }
  for (int k = t; k < NA * NA; k += blockDim.x) {
    const int qi = k / NA, rj = k - qi * NA;
    tab[qi * 256 + rj] = (qi < PADC && rj < PADC) ? table[k] : NEGS;
  }
  eq = __reduce_max_sync(FULL, eq);
  er = __reduce_max_sync(FULL, er);
  if (lane == 0) {
    ext[0][warp] = eq;
    ext[1][warp] = er;
  }
  __syncthreads();
  const int lq = __reduce_max_sync(FULL, lane < nw ? ext[0][lane] : 0);
  const int lr = __reduce_max_sync(FULL, lane < nw ? ext[1][lane] : 0);
  if (lq == 0 || lr == 0) {
    if (t == 0) out[b] = 0;
    return;
  }

  int best = 0;
  const int nd = lq + lr - 1;
  for (int d = t; d < nd; d += blockDim.x) {
    const int k = d - (lq - 1);  // diagonal j - i
    const int i0 = k < 0 ? -k : 0;
    const int j0 = k < 0 ? 0 : k;
    const int n = min(lq - i0, lr - j0);
    int cur = 0;
    if (NODROP) {
      // four cells a step: each side's next four residues from two words
      // (funnel shift), the table index q * 256 + r from one byte permute.
      // Cells past n are PAD (trimmed tail or the fill), score NEGS and
      // leave best alone.
      const uint32_t* qw = reinterpret_cast<const uint32_t*>(q) + (i0 >> 2);
      const uint32_t* rw = reinterpret_cast<const uint32_t*>(r) + (j0 >> 2);
      const int qsh = 8 * (i0 & 3), rsh = 8 * (j0 & 3);
      uint32_t qlo = qw[0], rlo = rw[0];
      for (int c = 0; c < n; c += 4) {
        const uint32_t qhi = *++qw, rhi = *++rw;
        const uint32_t qa = __funnelshift_r(qlo, qhi, qsh);
        const uint32_t ra = __funnelshift_r(rlo, rhi, rsh);
        qlo = qhi;
        rlo = rhi;
        int h[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int idx = __byte_perm(ra, qa, m | (4 + m) << 4) & 0xffff;
          cur = __viaddmax_s32_relu(cur, tab[idx], 0);
          h[m] = cur;
        }
        best = __vimax3_s32(best, max(h[0], h[1]), max(h[2], h[3]));
      }
    } else {
      int rbest = 0;
      for (int c = 0; c < n; ++c) {
        const int v = cur + tab[q[i0 + c] * 256 + r[j0 + c]];
        if (v <= 0 || rbest - v > x) {
          cur = 0;
          rbest = 0;
        } else {
          cur = v;
          rbest = max(rbest, v);
          best = max(best, v);
        }
      }
    }
  }
  best = __reduce_max_sync(FULL, best);
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = __reduce_max_sync(FULL, lane < nw ? red[lane] : 0);
    if (lane == 0) out[b] = best;
  }
}

}  // namespace

// K4: (B, Lq) x (B, Lr) int8 residues -> (B,) int32 best ungapped X-drop
// run scores. table: (21*21,) int32 BLOSUM62 (the PAD row/column is masked
// in the kernel). x: the X-drop margin (2^30 for none).
// min(1024, round32(Lq + Lr - 1)) threads a block.
extern "C" int ungapped_scores(const void* qs, const void* rs,
                               const void* table, void* out, int B, int Lq,
                               int Lr, int x, void* stream) {
  if (B == 0) return 0;
  if (Lq < 1 || Lr < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(side_bytes(Lq)) + side_bytes(Lr);
  const long nd = static_cast<long>(Lq) + Lr - 1;
  const int nt = static_cast<int>(nd >= 1024 ? 1024 : ((nd + 31) / 32) * 32);
  auto kernel = x >= NO_XDROP ? ungapped_kernel<true>
                              : ungapped_kernel<false>;
  int e = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e) return e;
  kernel<<<B, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qs), static_cast<const int8_t*>(rs),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), Lq,
      Lr, x);
  return static_cast<int>(cudaGetLastError());
}

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
