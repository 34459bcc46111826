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
// that makes one strip of Lq rows, at most 32; past Lq = 1024 the strips
// repeat as often as the query needs (34 at titin's 34,350 residues), and
// a strip sweeps lr + 31 steps at most. Scores stay far inside int32: a
// cell is at most 11 (BLOSUM62's largest score) times min(Lq, Lr).
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
// holds Lq rows, at most 32; any Lq (ceil(Lq / 1024) strips past that).
// scratch: null to keep a multi-strip query's strip buffers in shared
// memory, else B x Lr (x2 affine) int32 in global memory for them;
// repro_torch/kernels/sw.py::wave_geometry decides which.
// Returns the CUDA error code of the launch.
extern "C" int wave_scores(const void* qs, const void* rs, const void* table,
                           void* out, int B, int Lq, int Lr, int gap_open,
                           int gap_extend, int affine, void* scratch,
                           void* stream) {
  if (B == 0) return 0;
  if (Lq < 1 || Lr < 1) return static_cast<int>(cudaErrorInvalidValue);
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
// K7 — row-wave linear-gap Smith-Waterman best score, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sw.py::sw_scores_kernel (body
// _sw_kernel): the same function as K3 with linear gaps, by another
// algorithm. Row i of H follows from row i-1 in closed form:
//
//     a_j    = max(0, H[i-1, j-1] + s[i, j], H[i-1, j] + GAP)
//     H[i,j] = max_{t <= j} (a_t + c*(t+1)) - c*(j+1),   c = -GAP
//
// a max-plus prefix scan along the row; a cell with PAD on either side
// takes no diagonal step (the twin's -10^6 score).
//
// Bound on this card: operations, about 6 int32 operations per real cell,
// while a pair moves Lq + Lr bytes in and 4 bytes out. An all-pairs SW wave
// holds ~1 real pair of 56, so a launch there costs one pair's serial
// chain of rows: the latency of a row, not the card's rate.
//
// Design. One warp scores one pair; a block holds 4, 2 or 1 pairs and its
// warps never wait on each other after the one block barrier that shares
// the BLOSUM table. Lane t owns CPT consecutive reference columns j0.. (CPT
// = ceil(Lr / 32) rounded up to a multiple of 4, at most 32; a template
// constant) and keeps H[i-1, :] of them in registers. Per query row the
// lane
//   1. forms a_j = max(0, H[i-1, j-1] + s, H[i-1, j] + GAP), one DPX
//      instruction a cell (__viaddmax_s32_relu), and keeps the best a_j
//      (__vimax3_s32: a row's best H is its best a_j); H[i-1, j0-1] of its
//      first column is the previous row's carry into it, which the lane
//      already holds, so no shuffle starts the row;
//   2. runs its own columns, v_k = max(v_{k-1} + GAP, a_k) (one DPX a
//      cell), whose last value plus c*(j+1) is its total in the scan's
//      offset domain, max_t (a_t + c*(t+1));
//   3. scans the 32 totals for the max over the lanes before it (four
//      independent __shfl_up_sync for lanes t-1..t-4, then three doubling
//      steps: four shuffle latencies on the row's chain, not six); that
//      max less c*j0 is the carry H[i, j0-1];
//   4. applies it, H[i, j] = max(carry - c*(j - j0 + 1), v), one DPX
//      instruction a cell (__viaddmax_s32), all cells at once.
// The row loop has no barrier, no shared-memory round trip of H and no
// block-wide reduction. The substitution scores come from a per-warp
// reference profile built once per pair from the block's BLOSUM table: for
// each residue a and lane t, the CPT int8 scores s(a, r_j) of t's columns
// side by side, so the row of q_i is CPT/4 words a lane, loaded one row
// ahead of the DP (the query residue two rows ahead). Cells are int32,
// exact at any length the kernel takes.
//
// PAD. Each pair is trimmed to its last non-PAD residue on each side (a
// warp ballot per 32 residues); a pair with no residue on a side writes 0
// at once. Columns past the trimmed reference, and PAD columns inside it,
// hold -128 in the profile. Past the end that is exact: such a cell never
// exceeds the best real cell before it (each of its terms is a predecessor
// less something), so those columns are computed and leave the best
// alone. Inside the pair a lane's bit mask of PAD columns, and a
// warp-uniform test of a PAD query row, replace a_j by max(0, H[i-1, j] +
// GAP): the twin's cell. A pair without inner PAD never takes that branch.
//
// Long references. Past Lr = 1024 (32 columns a lane) the warp sweeps each
// row in segments of 1024 columns, carrying the prefix max from one to the
// next; H[i-1, :] then sits in a per-warp shared buffer, and the diagonal
// of a lane's first column comes from the lane before (one
// __shfl_up_sync). A warp's buffer (the profile, 21 bytes a column, the H
// row and the PAD masks) fits the 227 KB of one block up to 8 segments
// (Lr = 8,192). Past that (a titin chain of 34,350 residues is 34
// segments) the whole buffer moves to per-pair global scratch that the
// wrapper allocates (25,728 bytes a segment), where it is read from L2,
// each segment's scores loaded one segment ahead so that L2's latency
// overlaps the segment before; 4 pairs a block, no dynamic shared memory.
// Shorter references keep the shared-memory kernels as they were. The
// launch geometry (CPT, segments, pairs a block, shared bytes, scratch
// bytes a pair) is repro_torch/kernels/sw.py::rowwave_geometry; the
// wrapper passes it in and this file checks it against its own.
// ---------------------------------------------------------------------------

namespace {

constexpr int RW_CPT_MAX = 32;      // columns a lane, at most
constexpr int RW_WARPS = 4;         // pairs a block, at most
constexpr int RW_PSENT = -128;      // profile score of a PAD or past-end column
// dynamic shared memory a block can use beside the static BLOSUM table
constexpr long RW_SMEM_MAX = 232448 - 4 * NA * NA;

// The geometry of rowwave_geometry (kernels/sw.py): columns a lane, row
// segments, pairs a block and dynamic shared bytes for a width of Lr.
struct RowwaveGeometry {
  int cpt, segs, ppb;
  long smem, scratch;   // dynamic shared bytes a block; global bytes a pair
                        // (0: all in shared memory)
};

__host__ __device__ inline long rw_warp_bytes(int cpt, int segs) {
  // the profile, and past one segment the H row and the PAD masks
  const long cols = 32L * cpt;
  return NA * cols * segs + (segs > 1 ? (4 * cols + 4 * 32) * segs : 0);
}

inline RowwaveGeometry rw_geometry(int Lr) {
  int cpt = RW_CPT_MAX;
  for (int c = 4; c < RW_CPT_MAX; c += 4)
    if (32 * c >= Lr) { cpt = c; break; }
  const int segs = (Lr + 32 * cpt - 1) / (32 * cpt);
  const long warp = rw_warp_bytes(cpt, segs);
  // past 8 segments one pair's buffer does not fit: per-pair scratch
  if (warp > RW_SMEM_MAX) return {cpt, segs, RW_WARPS, 0, warp};
  int ppb = 1;
  for (int p = RW_WARPS; p > 1; p >>= 1)
    if (p * warp <= RW_SMEM_MAX) { ppb = p; break; }
  return {cpt, segs, ppb, ppb * warp, 0};
}

// Builds the warp's reference profile for segments [0, nseg) of its pair:
// prof[((seg * NA + a) * 32 + lane) * CPT + k] = s(a, r_j) of column
// j = seg * 32 CPT + lane * CPT + k, RW_PSENT for a PAD column, a column
// past lr or a PAD query residue a. Returns the lane's bit mask of PAD
// columns inside [0, lr) of segment 0; with MULTI it stores each
// segment's mask to pm[seg * 32 + lane] and zeroes the H row.
template <int CPT, bool MULTI>
__device__ __forceinline__ uint32_t rw_profile(
    const int8_t* __restrict__ r, int lr, int nseg, const int32_t* tab,
    int8_t* prof, int32_t* hbuf, uint32_t* pm, int lane) {
  uint32_t mask0 = 0;
  for (int sg = 0; sg < nseg; ++sg) {
    int rc[CPT];
    uint32_t mask = 0;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = sg * 32 * CPT + lane * CPT + k;
      rc[k] = j < lr ? residue(r, j) : PADC;
      if (j < lr && rc[k] == PADC) mask |= 1u << k;
    }
    for (int a = 0; a < NA; ++a) {
      auto s = [&](int c) {
        return (a == PADC || c == PADC) ? RW_PSENT : tab[a * NA + c];
      };
      int w[CPT / 4];
#pragma unroll
      for (int k = 0; k < CPT; k += 4)
        w[k >> 2] = pack4(s(rc[k]), s(rc[k + 1]), s(rc[k + 2]), s(rc[k + 3]));
      store_scores<CPT>(prof + ((sg * NA + a) * 32 + lane) * CPT, w);
    }
    if (MULTI) {
      pm[sg * 32 + lane] = mask;
#pragma unroll
      for (int k = 0; k < CPT; ++k) hbuf[sg * 32 * CPT + lane * CPT + k] = 0;
    }
    if (sg == 0) mask0 = mask;
  }
  __syncwarp();
  return mask0;
}

// One row of one segment, steps 1-2, from H[i-1, :] at the lane's columns
// (h) and at the column before them (left), the scores w of residue qi and
// the lane's mask of PAD columns inside the pair: a_j = max(0, H[i-1, j-1]
// + s, H[i-1, j] + GAP) (one DPX instruction a cell), the best of them (the
// row's best H is its best a_j), and in v[k] the lane's own row,
// max over its columns t <= k of a_t - c*(k - t) (one DPX a cell).
template <int CPT>
__device__ __forceinline__ void rw_cells(const int* h, int left, const int* w,
                                         int gap, bool padrow, uint32_t mask,
                                         int* v, int& best) {
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    v[k] = __viaddmax_s32_relu(h[k], gap, (k ? h[k - 1] : left) + score_at(w, k));
  if (padrow || mask) {   // PAD cells take no diagonal step
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      if (padrow || (mask >> k & 1)) v[k] = max(h[k] + gap, 0);
  }
#pragma unroll
  for (int k = 0; k < CPT; k += 2) best = __vimax3_s32(best, v[k], v[k + 1]);
#pragma unroll
  for (int k = 1; k < CPT; ++k) v[k] = __viaddmax_s32(v[k - 1], gap, v[k]);
}

// Step 3: the max over the lanes before this one of their totals (0 for
// lane 0: every total is positive, so 0 is the scan's identity).
__device__ __forceinline__ int rw_exclusive_max(int total, int lane) {
  int y = 0;
#pragma unroll
  for (int d = 1; d <= 4; ++d) {
    const int o = __shfl_up_sync(FULL, total, d);
    if (lane >= d) y = max(y, o);
  }
#pragma unroll
  for (int d = 4; d < 32; d <<= 1)  // a lane below d gets its own y back
    y = max(y, __shfl_up_sync(FULL, y, d));
  return y;
}

// GMEM (MULTI only): the warp's buffer lives in per-pair global scratch.
template <int CPT, bool MULTI, bool GMEM>
__global__ void __launch_bounds__(RW_WARPS * 32, 1)
rowwave_kernel(const int8_t* __restrict__ qs, const int8_t* __restrict__ rs,
               const int32_t* __restrict__ table, int32_t* __restrict__ out,
               int8_t* __restrict__ scratch, int B, int Lq, int Lr, int gap,
               int segs) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int32_t tab[NA * NA];
  for (int i = threadIdx.x; i < NA * NA; i += blockDim.x) tab[i] = table[i];
  __syncthreads();   // the only block barrier, before any pair's DP
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long b = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  const int8_t* q = qs + b * Lq;
  const int8_t* r = rs + b * Lr;
  const int lq = warp_extent(q, Lq, lane);
  const int lr = warp_extent(r, Lr, lane);
  if (lq == 0 || lr == 0) {
    if (lane == 0) out[b] = 0;
    return;
  }
  constexpr int COLS = 32 * CPT;   // columns of a segment
  const int nseg = MULTI ? (lr + COLS - 1) / COLS : 1;
  const long pair_bytes = rw_warp_bytes(CPT, segs);
  int8_t* prof = GMEM ? scratch + b * pair_bytes : smem + warp * pair_bytes;
  int32_t* hbuf = reinterpret_cast<int32_t*>(prof + NA * COLS * segs);
  uint32_t* pm = reinterpret_cast<uint32_t*>(hbuf + COLS * segs);
  const uint32_t mask0 =
      rw_profile<CPT, MULTI>(r, lr, nseg, tab, prof, hbuf, pm, lane);
  auto row_scores = [&](int sg, int qi) {
    return prof + ((sg * NA + qi) * 32 + lane) * CPT;
  };
  auto qres = [&](int i) { return i < lq ? residue(q, i) : PADC; };

  const int c = -gap;
  const int cj0 = c * lane * CPT;       // c*j0, within the segment
  const int cend = cj0 + c * CPT;       // c*(last column + 1)
  int nck[CPT], h[CPT], v[CPT];         // -c*(k+1); H[i-1, :]; the run
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    nck[k] = -c * (k + 1);
    h[k] = 0;
  }
  int best = 0;
  int w[CPT / 4];
  if (!MULTI) {
    int left = 0;   // H[i-1, j0-1]
    int qi = qres(0), qn = qres(1);
    load_scores<CPT>(row_scores(0, qi), w);
    for (int i = 0; i < lq; ++i) {
      const int q2 = qres(i + 2);
      int wn[CPT / 4];
      load_scores<CPT>(row_scores(0, qn), wn);
      rw_cells<CPT>(h, left, w, gap, qi == PADC, mask0, v, best);
      left = rw_exclusive_max(v[CPT - 1] + cend, lane) - cj0;  // H[i, j0-1]
#pragma unroll
      for (int k = 0; k < CPT; ++k) h[k] = __viaddmax_s32(left, nck[k], v[k]);
#pragma unroll
      for (int k = 0; k < CPT / 4; ++k) w[k] = wn[k];
      qi = qn;
      qn = q2;
    }
  } else {
    if constexpr (GMEM) load_scores<CPT>(row_scores(0, qres(0)), w);
    for (int i = 0; i < lq; ++i) {
      const int qi = qres(i);
      int carry = 0;      // the prefix over the earlier segments
      int seg_left = 0;   // H[i-1, first column of the segment - 1]
      for (int sg = 0; sg < nseg; ++sg) {
        int wn[CPT / 4];
        if constexpr (GMEM) {   // from L2: the next segment's scores
          const bool more = sg + 1 < nseg;
          load_scores<CPT>(row_scores(more ? sg + 1 : 0,
                                      more ? qi : qres(i + 1)), wn);
        }
        int32_t* hs = hbuf + sg * COLS + lane * CPT;
#pragma unroll
        for (int k = 0; k < CPT; k += 4) {
          const int4 x = *reinterpret_cast<const int4*>(hs + k);
          h[k] = x.x; h[k + 1] = x.y; h[k + 2] = x.z; h[k + 3] = x.w;
        }
        if constexpr (!GMEM) load_scores<CPT>(row_scores(sg, qi), w);
        int left = __shfl_up_sync(FULL, h[CPT - 1], 1);
        if (lane == 0) left = seg_left;
        seg_left = __shfl_sync(FULL, h[CPT - 1], 31);
        rw_cells<CPT>(h, left, w, gap, qi == PADC, pm[sg * 32 + lane], v,
                      best);
        const int total = v[CPT - 1] + cend;
        // H[i, j0-1]: the max over the earlier segments and lanes
        const int hin = max(carry, rw_exclusive_max(total, lane)) - cj0;
        // the next segment's offsets start COLS columns later
        carry = max(carry, __reduce_max_sync(FULL, total)) - c * COLS;
#pragma unroll
        for (int k = 0; k < CPT; ++k) h[k] = __viaddmax_s32(hin, nck[k], v[k]);
#pragma unroll
        for (int k = 0; k < CPT; k += 4)
          *reinterpret_cast<int4*>(hs + k) =
              make_int4(h[k], h[k + 1], h[k + 2], h[k + 3]);
        if constexpr (GMEM) {
#pragma unroll
          for (int k = 0; k < CPT / 4; ++k) w[k] = wn[k];
        }
      }
    }
  }
  best = __reduce_max_sync(FULL, best);
  if (lane == 0) out[b] = best;
}

template <int CPT, bool MULTI, bool GMEM = false>
int launch_rowwave(const void* qs, const void* rs, const void* table,
                   void* out, void* scratch, int B, int Lq, int Lr, int gap,
                   const RowwaveGeometry& g, cudaStream_t stream) {
  auto kernel = rowwave_kernel<CPT, MULTI, GMEM>;
  int e = set_smem(reinterpret_cast<const void*>(kernel), g.smem);
  if (e) return e;
  kernel<<<(B + g.ppb - 1) / g.ppb, g.ppb * 32, g.smem, stream>>>(
      static_cast<const int8_t*>(qs), static_cast<const int8_t*>(rs),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out),
      static_cast<int8_t*>(scratch), B, Lq, Lr, gap, g.segs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7: (B, Lq) x (B, Lr) int8 residues -> (B,) int32 row-wave linear-gap SW
// best scores (gap < 0). table: (21*21,) int32 BLOSUM62 (PAD is masked in
// the kernel). cpt, segs, ppb, smem and scratch_bytes are
// rowwave_geometry(Lq, Lr) of repro_torch/kernels/sw.py, checked here
// against this file's own; any Lr. scratch: B x scratch_bytes of global
// memory when scratch_bytes > 0 (past 8 segments), else null. Returns the
// CUDA error code of the launch.
extern "C" int sw_rowwave(const void* qs, const void* rs, const void* table,
                          void* out, int B, int Lq, int Lr, int gap, int cpt,
                          int segs, int ppb, long smem, long scratch_bytes,
                          void* scratch, void* stream) {
  if (B == 0) return 0;
  if (Lq < 1 || Lr < 1 || gap >= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RowwaveGeometry g = rw_geometry(Lr);
  if (g.cpt != cpt || g.segs != segs || g.ppb != ppb || g.smem != smem ||
      g.scratch != scratch_bytes || (g.scratch > 0) != (scratch != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.scratch)
    return launch_rowwave<32, true, true>(qs, rs, table, out, scratch, B,
                                          Lq, Lr, gap, g, st);
  if (g.segs > 1)
    return launch_rowwave<32, true>(qs, rs, table, out, nullptr, B, Lq, Lr,
                                    gap, g, st);
#define K7_LAUNCH(C)                                                        \
  if (g.cpt == (C))                                                         \
    return launch_rowwave<C, false>(qs, rs, table, out, nullptr, B, Lq, Lr, \
                                    gap, g, st);
  K7_LAUNCH(4) K7_LAUNCH(8) K7_LAUNCH(12) K7_LAUNCH(16)
  K7_LAUNCH(20) K7_LAUNCH(24) K7_LAUNCH(28) K7_LAUNCH(32)
#undef K7_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
