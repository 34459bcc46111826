// table_sums — job 1's table route in one pass, CUDA C++ for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX reference's table route is plain jnp
// (repro/core/simhash.py signatures_table and feature_counts), which XLA
// fuses on the TPU. Its torch twin (repro_torch/kernels/ref.py
// table_sums_ref) builds an (N, S) int64 id tensor, gathers (N, S, f)
// int32 table rows into device memory, sums them and packs the signs in
// int64 shifts: 5.5 GB written and read again for one read set of 547,169
// x 81 residues at f = 32. This kernel keeps all of that in registers.
//
// For every sequence n of the padded int8 residues ids (N, L) and every
// shingle position p < S = L - k + 1, the word id is
//
//     id(p) = sum_j ids[n, p + j] * 20^(k-1-j),   j < k,
//
// sent to row W = 20^k of the table when the shingle is invalid: p + k >
// lengths[n], a residue >= 20, or id < 0 (a negative residue). Then
//
//     signatures:  V[n] = sum_p C[id(p)]  (C: (W + 1, f) int32),
//                  out[n] = the f sign bits V >= 0, 32 to an int32 word,
//                  bit j of word w = column 32 w + j (pack_bits' order);
//     counts:      out[n] = sum_p cnt[id(p)] mod 2^32  (cnt: (W + 1,)).
//
// Row W is the twin's zero row, but it is added wherever the twin adds it,
// so the kernel equals the twin on any table: the positions past a
// sequence's length add (S - npos) * C[W] at the end.
//
// Bound on this card: the table rows. At the benchmark's shape (k = 3,
// f = 32) the kernel reads 44 MB of residues and writes 2.2 MB, ~15 us of
// HBM; it gathers 43.2 M table rows of 128 B, 5.5 GB, from a 1 MB table
// that stays in L2 (and partly in L1). So the kernel is bound by the
// L2-to-SM rate of those gathers (chip_smoke.py states the measured rate).
//
// Design. One warp a sequence, 8 warps a block. The warp takes its
// shingles 32 at a time: lane s computes the id of shingle base + s in
// registers from k byte loads of the sequence's row (a warp's loads of one
// j fall in one 32 B span). Then the warp walks those ids: each is
// broadcast by __shfl_sync and lane j loads word j of the row, one
// coalesced 128 B read a shingle and 32 columns; U rows are loaded before
// any is added, so U * NW reads a warp are in flight. A lane owns NW
// columns (a block's slice of f: blockIdx.y picks it, for f > 256 several).
// The sums stay in registers, and the signs of each 32-column group are
// one __ballot_sync: the word as it stands. Positions past a sequence's
// length are never walked (the padding of short reads costs nothing).
//
// The accumulator follows the table: the wrapper passes wide = 1 unless
// max|C| * S < 2^31, where no partial sum of at most S entries leaves
// int32; wide sums in int64, which S < 2^31 entries of |C| < 2^31 cannot
// leave. Either way every sum, and so every sign, is the twin's exactly.
// Counts sum in uint32, which is the twin's int64 sum cast to int32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads a block: 8 warps, a sequence each
constexpr int WARPS = NT / 32;
constexpr int ALPHA = 20;        // residues that form a word
constexpr int NW_MAX = 8;        // signature words a lane's slice, at most
constexpr unsigned FULL = 0xffffffffu;

// Positions of sequence n that lie inside its length: min(S, len - k + 1)
// clamped at 0; the length itself is clamped into [0, L] first.
__device__ __forceinline__ int inside(const int32_t* lens, long n, int L,
                                      int k, int S) {
  const int len = min(max(lens[n], 0), L);
  return max(0, min(S, len - k + 1));
}

// The table row of the shingle at pos (pos + k <= L): its word id, or W
// when a residue is >= 20 or the id is negative, as the twin decides.
__device__ __forceinline__ int word_row(const int8_t* seq, int pos, int k,
                                        int W) {
  int id = 0;
  bool ok = true;
  for (int j = 0; j < k; ++j) {
    const int r = __ldg(seq + pos + j);
    ok &= r < ALPHA;
    id = id * ALPHA + r;
  }
  return ok && id >= 0 ? id : W;
}

template <int NW, typename Acc>
__global__ void __launch_bounds__(NT)
signatures_kernel(const int8_t* __restrict__ ids,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ table,
                  int32_t* __restrict__ out, int N, int L, int k, int W,
                  int nw) {
  constexpr int U = NW >= 8 ? 1 : 8 / NW;   // rows a walk step loads
  const int lane = threadIdx.x & 31;
  const long n = static_cast<long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;                       // the whole warp
  const int w0 = blockIdx.y * NW;           // the slice's first word
  const int nws = min(NW, nw - w0);         // its words
  const int ld = 32 * nw;
  const int S = max(L - k + 1, 0);
  const int npos = inside(lens, n, L, k, S);
  const int8_t* seq = ids + n * L;
  const int32_t* col = table + 32 * w0 + lane;

  Acc acc[NW];
#pragma unroll
  for (int c = 0; c < NW; ++c) acc[c] = 0;

  for (int base = 0; base < npos; base += 32) {
    const int cnt = min(32, npos - base);   // shingles of this step
    const int mine = lane < cnt ? word_row(seq, base + lane, k, W) : W;
    for (int s = 0; s < cnt; s += U) {
      int32_t v[U][NW];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = __shfl_sync(FULL, mine, (s + u) & 31);
        const bool take = s + u < cnt;      // the same in every lane
#pragma unroll
        for (int c = 0; c < NW; ++c)
          v[u][c] = take && c < nws
                        ? __ldg(col + static_cast<long>(r) * ld + 32 * c)
                        : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < NW; ++c) acc[c] += v[u][c];
    }
  }

  // the positions past the length, each row W in the twin
  const int rest = S - npos;
  uint32_t word = 0;
#pragma unroll
  for (int c = 0; c < NW; ++c) {
    if (c < nws) {
      if (rest)
        acc[c] += static_cast<Acc>(rest) *
                  __ldg(col + static_cast<long>(W) * ld + 32 * c);
      const uint32_t b = __ballot_sync(FULL, acc[c] >= 0);
      if (lane == c) word = b;
    }
  }
  if (lane < nws) out[n * nw + w0 + lane] = static_cast<int32_t>(word);
}

__global__ void __launch_bounds__(NT)
counts_kernel(const int8_t* __restrict__ ids, const int32_t* __restrict__ lens,
              const int32_t* __restrict__ table, int32_t* __restrict__ out,
              int N, int L, int k, int W) {
  const int lane = threadIdx.x & 31;
  const long n = static_cast<long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (n >= N) return;
  const int S = max(L - k + 1, 0);
  const int npos = inside(lens, n, L, k, S);
  const int8_t* seq = ids + n * L;
  uint32_t acc = 0;
  for (int pos = lane; pos < npos; pos += 32)
    acc += static_cast<uint32_t>(__ldg(table + word_row(seq, pos, k, W)));
  acc = __reduce_add_sync(FULL, acc);
  if (lane == 0)
    out[n] = static_cast<int32_t>(
        acc + static_cast<uint32_t>(S - npos) *
                  static_cast<uint32_t>(__ldg(table + W)));
}

template <int NW>
int launch_signatures(const void* ids, const void* lens, const void* table,
                      void* out, int N, int L, int k, int W, int nw, int wide,
                      cudaStream_t stream) {
  const dim3 grid((N - 1) / WARPS + 1, (nw - 1) / NW + 1);   // N >= 1
  const auto* i8 = static_cast<const int8_t*>(ids);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* tb = static_cast<const int32_t*>(table);
  auto* o = static_cast<int32_t*>(out);
  if (wide)
    signatures_kernel<NW, long long><<<grid, NT, 0, stream>>>(
        i8, ln, tb, o, N, L, k, W, nw);
  else
    signatures_kernel<NW, int><<<grid, NT, 0, stream>>>(i8, ln, tb, o, N, L,
                                                        k, W, nw);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int N, int L, int k, int W) {
  int w = 1;
  for (int j = 0; j < k; ++j) w *= ALPHA;
  return N >= 0 && L >= 0 && k >= 1 && k <= 5 && W == w;
}

}  // namespace

// Packed signatures out (N, nw) int32 of ids (N, L) int8 (contiguous),
// lens (N,) int32 and the contribution table (W + 1, 32 nw) int32, W =
// 20^k, k <= 5. wide: sum in int64 (the wrapper's accumulator_bits).
// Returns the CUDA error code of the launch.
extern "C" int table_signatures(const void* ids, const void* lens,
                                const void* table, void* out, int N, int L,
                                int k, int W, int nw, int wide,
                                void* stream) {
  if (!valid_shape(N, L, k, W) || nw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nw == 1)
    return launch_signatures<1>(ids, lens, table, out, N, L, k, W, nw, wide, st);
  if (nw == 2)
    return launch_signatures<2>(ids, lens, table, out, N, L, k, W, nw, wide, st);
  if (nw <= 4)
    return launch_signatures<4>(ids, lens, table, out, N, L, k, W, nw, wide, st);
  return launch_signatures<NW_MAX>(ids, lens, table, out, N, L, k, W, nw,
                                   wide, st);
}

// Per-sequence sums out (N,) int32 (mod 2^32) of the count table (W + 1,)
// int32 over the shingles of ids (N, L) int8 with lens (N,) int32.
extern "C" int table_counts(const void* ids, const void* lens,
                            const void* table, void* out, int N, int L, int k,
                            int W, void* stream) {
  if (!valid_shape(N, L, k, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  counts_kernel<<<(N - 1) / WARPS + 1, NT, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ids), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(table), static_cast<int32_t*>(out), N, L, k,
      W);
  return static_cast<int>(cudaGetLastError());
}
