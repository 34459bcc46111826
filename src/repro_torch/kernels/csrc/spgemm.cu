// K5 — upper-mask SpGEMM pair emission, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/spgemm.py::upper_pairs_kernel (body
// _upper_kernel). Each band row g of a band-stacked bucket slab (offsets
// (G, U+1), entry ids (G, E), int32) is the CSR of a sequence x bucket
// incidence matrix A; the kernel emits the strict upper triangle of AᵀA:
// every unordered within-bucket pair once, entry-major, as (min, max) ids,
// into a (G, cap, 2) int32 buffer with -1 past the band's true count.
//
//   cnt[p] = max(end(b(p)) - 1 - p, 0)  b(p): the bucket owning entry p,
//                                       end(b) = offsets[min(b + 1, U)]
//   exc    = exclusive prefix sum of cnt (int64: band totals reach 2.6e7
//            at Swiss-Prot scale and must not wrap)
//   slot s < total: p = the last entry with exc[p] <= s,
//                   pair (ids[p], ids[p + 1 + s - exc[p]])
//
// Padded slabs are inert: padded offsets repeat the end, so padded entries
// own nothing.
//
// Bound on this card: bytes — writing G*cap*8 bytes of pairs, against a
// few binary-search steps per slot that mostly hit L2.
//
// What this design does about it: two passes instead of the TPU form's
// (U+1, E) comparison block and log-doubling scans (at myva scale, U+1 =
// 37,166 and E = 192,987, that block cannot exist). Pass 1, one block per
// band, walks the band's entries in tiles of the block's width: each
// thread binary-searches its entry's bucket, and a warp-shuffle scan plus
// a scan of the per-warp sums gives the int64 exclusive prefix, carried
// from tile to tile. Pass 2, a grid over (slot blocks, bands), has each
// thread binary-search its slot's owning entry in the prefix (1.5 MB per
// band at myva scale, resident in L2) and store one 8-byte pair, so the
// stores are coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 1024;
constexpr int EMIT_THREADS = 256;

__global__ void upper_scan_kernel(const int32_t* __restrict__ offs, int U1,
                                  int E, long long* __restrict__ exc,
                                  long long* __restrict__ total) {
  __shared__ long long wsum[32];
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int32_t* o = offs + static_cast<long long>(g) * U1;
  long long* ex = exc + static_cast<long long>(g) * E;
  const int U = U1 - 1;
  long long carry = 0;
  for (int base = 0; base < E; base += blockDim.x) {
    const int p = base + t;
    long long c = 0;
    if (p < E) {
      int lo = 0, hi = U1;  // first offset > p
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (o[mid] <= p) lo = mid + 1; else hi = mid;
      }
      const int b1 = min(max(lo, 0), U);  // owning bucket + 1, clamped
      const long long end = o[b1];
      c = end - 1 - p;
      if (c < 0) c = 0;
    }
    long long v = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long n = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += n;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      long long w = lane < nw ? wsum[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const long long n = __shfl_up_sync(FULL, w, off);
        if (lane >= off) w += n;
      }
      if (lane < nw) wsum[lane] = w;
    }
    __syncthreads();
    const long long incl = v + (warp ? wsum[warp - 1] : 0) + carry;
    if (p < E) ex[p] = incl - c;
    carry += wsum[nw - 1];
    __syncthreads();  // wsum is rewritten by the next tile
  }
  if (t == 0) total[g] = carry;
}

__global__ void upper_emit_kernel(const int32_t* __restrict__ ids, int E,
                                  const long long* __restrict__ exc,
                                  const long long* __restrict__ total,
                                  long long cap, int2* __restrict__ out) {
  const int g = blockIdx.y;
  const int32_t* id = ids + static_cast<long long>(g) * E;
  const long long* ex = exc + static_cast<long long>(g) * E;
  const long long T = total[g];
  int2* o = out + static_cast<long long>(g) * cap;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < cap; s += stride) {
    if (s >= T) {
      o[s] = make_int2(-1, -1);
      continue;
    }
    int lo = 0, hi = E;  // first entry with exc > s
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ex[mid] <= s) lo = mid + 1; else hi = mid;
    }
    const int p = min(max(lo - 1, 0), E - 1);
    long long q = p + 1 + (s - ex[p]);
    q = q < 0 ? 0 : (q > E - 1 ? E - 1 : q);
    const int a = id[p];
    const int b = id[q];
    o[s] = make_int2(min(a, b), max(a, b));
  }
}

}  // namespace

// offs (G, U1) int32, ids (G, E) int32 -> out (G, cap, 2) int32. exc
// (G, E) int64 and total (G,) int64 are scratch the caller allocates.
// Returns the CUDA error code of the launches.
extern "C" int upper_pairs(const void* offs, const void* ids, void* exc,
                           void* total, void* out, int G, int U1, int E,
                           long long cap, void* stream) {
  if (G == 0 || cap == 0) return 0;
  if (U1 < 1 || E < 1 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  upper_scan_kernel<<<G, SCAN_THREADS, 0, st>>>(
      static_cast<const int32_t*>(offs), U1, E,
      static_cast<long long*>(exc), static_cast<long long*>(total));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  long long blocks = (cap + EMIT_THREADS - 1) / EMIT_THREADS;
  if (blocks > (1 << 16)) blocks = 1 << 16;
  dim3 grid(static_cast<unsigned>(blocks), G);
  upper_emit_kernel<<<grid, EMIT_THREADS, 0, st>>>(
      static_cast<const int32_t*>(ids), E,
      static_cast<const long long*>(exc),
      static_cast<const long long*>(total), cap, static_cast<int2*>(out));
  return static_cast<int>(cudaGetLastError());
}
