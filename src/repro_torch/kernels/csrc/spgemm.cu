// K5 — upper-mask SpGEMM pair emission, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spgemm.py::upper_pairs_kernel (body
// _upper_kernel). Each band row g of a band-stacked bucket slab (offsets
// (G, U+1), entry ids (G, E), int32) is the CSR of a sequence x bucket
// incidence matrix A; the kernel emits the strict upper triangle of AᵀA:
// every unordered within-bucket pair once, entry-major, as (min, max) ids,
// into a (G, cap, 2) int32 buffer with -1 past the band's true count.
//
// Bound on this card: bytes — writing G*cap*8 bytes of pairs (at myva
// scale, 2 bands x 4,194,304 slots: 67 MB, 0.0206 ms at 3.35 TB/s). The
// offsets and ids are read a few times over, from L2.
//
// Design: work per bucket, not per entry. Entry-major slot order within a
// band is bucket-major, and row-major over each bucket's triangle, so a
// bucket of n entries owns n(n-1)/2 consecutive slots from its base:
//
//   bucket b in [0, U]: entries [o[b-1], o[b]) (b = 0: [0, o[0]), the
//   entries the reference's searchsorted puts before the first bucket)
//   n_b = o[b] - o[b-1],  base_b = sum_{c < b} n_c (n_c - 1) / 2  (int64:
//   band totals reach 2.6e7 at Swiss-Prot scale)
//   slot s: b = the last bucket with base_b <= s, t = s - base_b,
//   i = the largest row with F(i) = i (2n - 1 - i) / 2 <= t (closed form
//   in double, checked by one correction step each way), j = i + 1 +
//   t - F(i): pair (ids[o[b-1] + i], ids[o[b-1] + j]).
//
// Padded slabs stay inert: padded offsets repeat the end, so their
// buckets are empty, and entries past o[U] own nothing.
//
// Three launches. Scan pass 1 sums n(n-1)/2 over chunks of 1,024 buckets,
// a block a chunk; pass 2, a block a chunk again, adds the sums of the
// chunks before its own (reduce-then-scan) and scans its chunk (warp
// shuffles, then the warps' sums), writing each bucket's base and, in the
// last chunk, the band's total. At myva scale that is 37 blocks a band
// where the previous design ran one block a band over 189 tiles of
// entries with a binary search each. The emission gives each block 1,024
// consecutive slots: two threads binary-search the buckets of its first
// and last slot once, the block stages the bases in between in shared
// memory (2,048 at most, else it reads them from L2), and each slot then
// takes a short search in that range, the triangle's closed form and one
// 8-byte streaming store, coalesced across the warp. Blocks wholly past
// the total only write -1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_T = 1024;              // buckets a scan block
constexpr int EMIT_T = 256;               // threads an emission block
constexpr int SPB = 4 * EMIT_T;           // slots an emission block
constexpr int SHB = 2048;                 // bases staged in shared memory

// entries [start, start + n) of bucket b of a band's offsets o
__device__ __forceinline__ void bucket_span(const int32_t* __restrict__ o,
                                            int b, int* start, int* n) {
  const int lo = b ? o[b - 1] : 0;
  *start = lo;
  *n = max(o[b] - lo, 0);
}

__device__ __forceinline__ long long bucket_pairs(const int32_t* o, int b) {
  int start, n;
  bucket_span(o, b, &start, &n);
  return static_cast<long long>(n) * (n - 1) / 2;
}

// The block's sum of v (every thread gets it); ws holds 32 partials.
__device__ __forceinline__ long long block_sum(long long v, long long* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  __syncthreads();   // ws is free
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  long long s = 0;
  for (int w = 0; w < nw; ++w) s += ws[w];
  return s;
}

// Pass 1: the pairs of each chunk of SCAN_T buckets.
__global__ void __launch_bounds__(SCAN_T)
chunk_sum_kernel(const int32_t* __restrict__ offs, int U1,
                 long long* __restrict__ csum) {
  __shared__ long long ws[32];
  const int g = blockIdx.y;
  const int32_t* o = offs + static_cast<long long>(g) * U1;
  const int b = blockIdx.x * SCAN_T + threadIdx.x;
  const long long v = b < U1 ? bucket_pairs(o, b) : 0;
  const long long s = block_sum(v, ws);
  if (threadIdx.x == 0) csum[static_cast<long long>(g) * gridDim.x +
                             blockIdx.x] = s;
}

// Pass 2: each bucket's base (exclusive prefix of the pairs) and the band's
// total.
__global__ void __launch_bounds__(SCAN_T)
chunk_scan_kernel(const int32_t* __restrict__ offs, int U1,
                  const long long* __restrict__ csum,
                  long long* __restrict__ base, long long* __restrict__ total) {
  __shared__ long long ws[32];
  const int g = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int32_t* o = offs + static_cast<long long>(g) * U1;
  const long long* cs = csum + static_cast<long long>(g) * gridDim.x;
  long long before = 0;   // the chunks before this one
  for (int c = t; c < static_cast<int>(blockIdx.x); c += SCAN_T) before += cs[c];
  before = block_sum(before, ws);
  const int b = blockIdx.x * SCAN_T + t;
  const long long v = b < U1 ? bucket_pairs(o, b) : 0;
  long long x = v;   // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long n = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += n;
  }
  __syncthreads();   // ws is free
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nw ? ws[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long n = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += n;
    }
    if (lane < nw) ws[lane] = w;
  }
  __syncthreads();
  const long long incl = before + x + (warp ? ws[warp - 1] : 0);
  if (b < U1) base[static_cast<long long>(g) * U1 + b] = incl - v;
  if (blockIdx.x == gridDim.x - 1 && t == 0) total[g] = before + ws[nw - 1];
}

// The last bucket in [lo, hi] whose base is <= s (base[lo] <= s).
__device__ __forceinline__ int last_base_le(const long long* bs, int lo,
                                            int hi, long long s) {
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bs[mid] <= s) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Pass 3: one slot a thread at a time, SPB consecutive slots a block.
__global__ void __launch_bounds__(EMIT_T)
emit_kernel(const int32_t* __restrict__ offs, int U1,
            const int32_t* __restrict__ ids, int E,
            const long long* __restrict__ base,
            const long long* __restrict__ total, long long cap,
            int2* __restrict__ out) {
  __shared__ long long sb[SHB];
  __shared__ int range[2];
  const int g = blockIdx.y;
  const int32_t* o = offs + static_cast<long long>(g) * U1;
  const int32_t* id = ids + static_cast<long long>(g) * E;
  const long long* bs = base + static_cast<long long>(g) * U1;
  int2* dst = out + static_cast<long long>(g) * cap;
  const long long T = total[g];
  const long long s0 = static_cast<long long>(blockIdx.x) * SPB;
  const long long s1 = min(s0 + SPB, cap);
  const long long t1 = min(s1, T);   // slots below t1 hold pairs
  const int2 none = make_int2(-1, -1);
  if (s0 >= t1) {
    for (long long s = s0 + threadIdx.x; s < s1; s += EMIT_T)
      __stcs(dst + s, none);
    return;
  }
  if (threadIdx.x < 2)
    range[threadIdx.x] =
        last_base_le(bs, 0, U1 - 1, threadIdx.x ? t1 - 1 : s0);
  __syncthreads();
  const int b0 = range[0];
  const int nb = range[1] - b0 + 1;
  const bool staged = nb <= SHB;
  if (staged)
    for (int x = threadIdx.x; x < nb; x += EMIT_T) sb[x] = bs[b0 + x];
  __syncthreads();
  const long long* sbase = staged ? sb : bs + b0;
  for (long long s = s0 + threadIdx.x; s < s1; s += EMIT_T) {
    if (s >= T) {
      __stcs(dst + s, none);
      continue;
    }
    const int k = last_base_le(sbase, 0, nb - 1, s);
    const long long t = s - sbase[k];
    int start, n;
    bucket_span(o, b0 + k, &start, &n);
    const long long m = 2LL * n - 1;
    auto F = [m](long long i) { return i * (m - i) / 2; };
    // (2n - 1)^2 - 8t lies in (0, 2^64) for any n < 2^31: exact unsigned
    const unsigned long long disc =
        static_cast<unsigned long long>(m) * static_cast<unsigned long long>(m)
        - 8ull * static_cast<unsigned long long>(t);
    long long i = static_cast<long long>(
        floor((static_cast<double>(m) - sqrt(static_cast<double>(disc))) *
              0.5));
    i -= F(i) > t;
    i += F(i + 1) <= t;
    const long long j = i + 1 + (t - F(i));
    const int a = id[start + i];
    const int c = id[start + j];
    __stcs(dst + s, make_int2(min(a, c), max(a, c)));
  }
}

}  // namespace

// offs (G, U1) int32, ids (G, E) int32 -> out (G, cap, 2) int32, 8-byte
// aligned. base (G, U1), csum (G, ceil(U1 / 1024)) and total (G,) int64 are
// scratch the caller allocates. The offsets of each band are a CSR: non-
// decreasing, at most E (padding repeats the end). Returns the CUDA error
// code of the launches.
extern "C" int upper_pairs(const void* offs, const void* ids, void* base,
                           void* csum, void* total, void* out, int G, int U1,
                           int E, long long cap, void* stream) {
  if (G == 0 || cap == 0) return 0;
  if (U1 < 1 || E < 1 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = (U1 + SCAN_T - 1) / SCAN_T;
  const auto* o = static_cast<const int32_t*>(offs);
  auto* cs = static_cast<long long*>(csum);
  auto* bs = static_cast<long long*>(base);
  auto* tot = static_cast<long long*>(total);
  chunk_sum_kernel<<<dim3(nch, G), SCAN_T, 0, st>>>(o, U1, cs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_scan_kernel<<<dim3(nch, G), SCAN_T, 0, st>>>(o, U1, cs, bs, tot);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (cap + SPB - 1) / SPB;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  emit_kernel<<<dim3(static_cast<unsigned>(blocks), G), EMIT_T, 0, st>>>(
      o, U1, static_cast<const int32_t*>(ids), E, bs, tot, cap,
      static_cast<int2*>(out));
  return static_cast<int>(cudaGetLastError());
}
