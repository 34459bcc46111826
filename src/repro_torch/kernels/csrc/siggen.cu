// K1 — fused SimHash accumulation, CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/siggen.py::siggen_accumulate_kernel
// (body _siggen_kernel): for every shingle row s and codebook word w,
//
//     score[s, w] = rows[s] . cb[w]                (D = k*21 long dot)
//     V[s, :]    += [score >= T] * score * H[w, :]
//
// rows (S, D) int32, cb (W, D) int8, H (W, f) int8 -> V (S, f) int32.
//
// Bound on this card: the int8 tensor cores. The function does
// 2*S*W*(D+f) operations on values that fit int8 on its path (the rows
// hold BLOSUM62 scores in [-4, 11], cb is one-hot, H is +-1, and a kept
// score is at most 44 for k <= 4) while it must move S*(D+f)*4 + W*(D+f)
// bytes: ~1000 operations a byte at k=3, f=32, above the H100's int8 ridge
// (1979 TOP/s over 3.35 TB/s, ~590 a byte). Next after the tensor cores
// comes the threshold between the two products, which touches each of the
// S*W scores on the CUDA cores.
//
// Design. A block owns BS shingle rows (128, or 64 for f > 64): 4 warps of
// 16*MT rows. The TPU kernel's sequential grid axis over the codebook
// becomes a loop over tiles of BW = 128 words. The rows are staged once as
// int8 (D zero-padded to Dp, a multiple of 32) and held as mma A fragments
// in registers for the whole loop. The cb tile (BW x Dp) and the H tile
// (f x BW) of the next word tile load with cp.async while the block works
// on the current one: double-buffered shared memory, one block barrier a
// tile. Per 32-word chunk a warp runs product 1 as mma.sync m16n8k32
// s8.s8.s32 with its accumulators started at -T, so they end at
// score - T; narrows them to bytes (byte_perm); takes each byte's sign
// (prmt sign replicate); and forms the kept scores four at a time,
//
//     P = bytes(score - T),  M = sign(P),  kept = (P & ~M) + (T & ~M)
//
// which are product 2's A fragment as they stand: the m16n8 accumulators
// of a chunk's four n8 tiles sit where the m16n8k32 A fragment wants them
// once the chunk's 32 words are taken in the order slot_word()
// (repro_torch/kernels/siggen.py), and the wrapper lays H out in that
// order (f x words), as FlashAttention-2 hands P to its second product. So
// the thresholded score tile never leaves registers, and V stays in int32
// accumulators until it is written once.
//
// Exactness for every input the wrapper takes. The byte form is exact when
// every row value of a block and its scores fit: |row| <= 127 and
// |score| + T <= 128, so score - T fits a byte and a kept score is at most
// 127. Each block checks this once, from its rows' largest |value| times
// the largest L1 norm of a codebook word (one number the wrapper computes
// on the card): on the path 11 * k + T <= 57. A block whose bound leaves
// the byte form runs an exact int32 path on the CUDA cores over the
// original operands (a warp a row, a lane a word, V in shared memory); so
// does every block when D > 128. No value wraps: V is exact wherever scores and V fit
// int32, as in the twin.
//
// Wide signatures. A launch computes one slice of at most 256 columns of
// V (8 n8 pairs of accumulators a warp is what the registers hold): for
// f > 256 the wrapper launches once a 256-column slice of H, each launch
// writing its columns of V with the row stride ld of the whole V. Product
// 1 and the threshold are then repeated once a slice: ceil(f / 256) times
// the first product's work, for widths the paper does not use.
//
// Ragged edges: rows past S stage as zero; the wrapper's copy of cb and H
// in the tensor-core layout (a few hundred KB) ends in zero words up to the
// word tile. A zero row or word scores 0 < T and adds nothing (T >= 1).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;          // threads a block: 4 warps
constexpr int WARPS = NT / 32;
constexpr int BW = 128;          // codebook words a tile
constexpr int PADB = 16;         // row padding of the shared tiles (bytes),
                                 // so ldmatrix rows fall in distinct banks
constexpr int KS_MAX = 4;        // D up to 128 on the tensor cores
constexpr unsigned FULL = 0xffffffffu;

// The geometry of siggen_geometry (kernels/siggen.py): rows a block and
// dynamic shared bytes for (Dp, f).
__host__ __device__ constexpr int rows_per_block(int f) {
  return WARPS * 16 * (f <= 64 ? 2 : 1);
}
__host__ __device__ constexpr long smem_bytes(int dp, int f) {
  return static_cast<long>(rows_per_block(f)) * (dp + PADB) +
         2L * BW * (dp + PADB) + 2L * f * (BW + PADB);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16x8 int32) += a (16x32 int8, row) . b (32x8 int8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the low bytes of four ints in one word
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// 0xff in each byte of x that is negative, else 0 (prmt, sign replicate)
__device__ __forceinline__ uint32_t sign_bytes(uint32_t x) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(m) : "r"(x), "r"(0), "r"(0xba98));
  return m;
}

// The exact path: V rows [row0, row0 + nrows) on the CUDA cores, int32
// over the original operands; a warp takes a row, its lanes take words and
// sum into the row's V in shared memory (vs: WARPS x f ints).
__device__ void exact_rows(const int32_t* __restrict__ rows,
                           const int8_t* __restrict__ cb,
                           const int8_t* __restrict__ H,
                           int32_t* __restrict__ out, long row0, int nrows,
                           int S, int D, int W, int f, int ld, int T,
                           int32_t* vs) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t* v = vs + warp * f;
  for (int r = warp; r < nrows && row0 + r < S; r += WARPS) {
    const long row = row0 + r;
    for (int n = lane; n < f; n += 32) v[n] = 0;
    __syncwarp();
    const int32_t* x = rows + row * D;
    for (int w = lane; w < W; w += 32) {
      const int8_t* c = cb + static_cast<long>(w) * D;
      int s = 0;
      for (int d = 0; d < D; ++d) s += x[d] * c[d];
      if (s >= T) {
        const int8_t* h = H + static_cast<long>(w) * ld;
        for (int n = 0; n < f; ++n) atomicAdd(&v[n], s * h[n]);
      }
    }
    __syncwarp();
    for (int n = lane; n < f; n += 32) out[row * ld + n] = v[n];
    __syncwarp();
  }
}

template <int NW, int KS>   // f = 32 NW, Dp = 32 KS
__global__ void __launch_bounds__(NT, 1)
siggen_kernel(const int32_t* __restrict__ rows, const int8_t* __restrict__ cb,
              const int8_t* __restrict__ H, const int8_t* __restrict__ cbp,
              const int8_t* __restrict__ htp,
              const int32_t* __restrict__ cb_l1, int32_t* __restrict__ out,
              int S, int D, int W, int Wp, int ld, int T) {
  constexpr int F = 32 * NW;
  constexpr int DP = 32 * KS;
  constexpr int MT = F <= 64 ? 2 : 1;   // m16 row tiles a warp
  constexpr int BS = rows_per_block(F);
  constexpr int RS = DP + PADB;         // row stride of the rows and cb tiles
  constexpr int HS = BW + PADB;         // row stride of the H tile
  constexpr int NF = F / 8;             // n8 tiles of V
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* xs = smem;                    // [BS][RS]      the rows, int8
  int8_t* cbs = xs + BS * RS;           // [2][BW][RS]   codebook tiles
  int8_t* hts = cbs + 2 * BW * RS;      // [2][F][HS]    H tiles, f x words
  __shared__ unsigned amax_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long row0 = static_cast<long>(blockIdx.x) * BS;
  const int ntile = Wp / BW;

  // one word tile of cb and H into buffer buf, 16 bytes a copy
  auto load_tile = [&](int tile, int buf) {
    const int8_t* csrc = cbp + static_cast<long>(tile) * BW * DP;
    int8_t* cdst = cbs + buf * BW * RS;
    for (int i = tid; i < BW * DP / 16; i += NT) {
      const int w = i / (DP / 16), c = i % (DP / 16);
      cp_async16(cdst + w * RS + c * 16, csrc + w * DP + c * 16);
    }
    const int8_t* hsrc = htp + static_cast<long>(tile) * BW;
    int8_t* hdst = hts + buf * F * HS;
    for (int i = tid; i < F * BW / 16; i += NT) {
      const int n = i / (BW / 16), c = i % (BW / 16);
      cp_async16(hdst + n * HS + c * 16,
                 hsrc + static_cast<long>(n) * Wp + c * 16);
    }
    cp_commit();
  };
  if (ntile > 0) load_tile(0, 0);

  // the rows as int8, zero past S and past D; their largest |value|
  if (tid == 0) amax_s = 0;
  __syncthreads();
  unsigned amax = 0;
  for (int i = tid; i < BS * DP; i += NT) {
    const int r = i / DP, d = i % DP;
    int v = 0;
    if (d < D && row0 + r < S) v = rows[(row0 + r) * D + d];
    amax = max(amax, v < 0 ? 0u - static_cast<unsigned>(v)
                           : static_cast<unsigned>(v));
    xs[r * RS + d] = static_cast<int8_t>(v);
  }
  amax = __reduce_max_sync(FULL, amax);
  if (lane == 0) atomicMax(&amax_s, amax);
  __syncthreads();
  const unsigned long long bound =
      static_cast<unsigned long long>(amax_s) * static_cast<unsigned>(*cb_l1);
  if (amax_s > 127 || bound + T > 128) {   // outside the byte form
    cp_wait_all();
    exact_rows(rows, cb, H, out, row0, BS, S, D, W, F, ld, T,
               reinterpret_cast<int32_t*>(smem));
    return;
  }

  // product 1's A fragments: the warp's rows, held for the whole loop
  const int wrow = warp * 16 * MT;
  uint32_t af[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldsm_x4(xs + (wrow + mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS
                  + ks * 32 + 16 * (lane >> 4), af[mt][ks]);

  int acc[MT][NF][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NF; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0;
  const uint32_t tv = 0x01010101u * static_cast<uint32_t>(T);

  for (int tile = 0; tile < ntile; ++tile) {
    const int buf = tile & 1;
    cp_wait_all();     // this tile's copies (the only ones in flight)
    __syncthreads();   // ...seen by all; the other buffer's readers done
    if (tile + 1 < ntile) load_tile(tile + 1, buf ^ 1);
    const int8_t* cbt = cbs + buf * BW * RS;
    const int8_t* htt = hts + buf * F * HS;
#pragma unroll 1
    for (int ch = 0; ch < BW / 32; ++ch) {
      // product 1: score - T of the warp's rows x the chunk's 32 words
      int sc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[mt][j][e] = -T;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {   // n8 tiles 2jp and 2jp + 1
          uint32_t b[4];
          ldsm_x4(cbt + (ch * 32 + 8 * (2 * jp + (lane >> 4)) + (lane & 7))
                            * RS + ks * 32 + 16 * ((lane >> 3) & 1), b);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_s8(sc[mt][2 * jp], af[mt][ks], b[0], b[1]);
            mma_s8(sc[mt][2 * jp + 1], af[mt][ks], b[2], b[3]);
          }
        }
      // threshold and narrow in registers: product 2's A fragments
      uint32_t a2[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int(&s)[4][4] = sc[mt];
        a2[mt][0] = pack4(s[0][0], s[0][1], s[1][0], s[1][1]);
        a2[mt][1] = pack4(s[0][2], s[0][3], s[1][2], s[1][3]);
        a2[mt][2] = pack4(s[2][0], s[2][1], s[3][0], s[3][1]);
        a2[mt][3] = pack4(s[2][2], s[2][3], s[3][2], s[3][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t keep = ~sign_bytes(a2[mt][e]);
          a2[mt][e] = (a2[mt][e] & keep) + (tv & keep);
        }
      }
      // product 2: V += kept . H, the chunk's words in slot_word order
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {  // n8 tiles 2np and 2np + 1
        uint32_t b[4];
        ldsm_x4(htt + (8 * (2 * np + (lane >> 4)) + (lane & 7)) * HS
                    + ch * 32 + 16 * ((lane >> 3) & 1), b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_s8(acc[mt][2 * np], a2[mt], b[0], b[1]);
          mma_s8(acc[mt][2 * np + 1], a2[mt], b[2], b[3]);
        }
      }
    }
  }

  // V: accumulator (g, 2t..2t+1) and (g+8, 2t..2t+1) of each n8 tile
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const long r = row0 + wrow + mt * 16 + g;
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      const int col = 8 * n + 2 * t4;
      if (r < S)
        *reinterpret_cast<int2*>(out + r * ld + col) =
            make_int2(acc[mt][n][0], acc[mt][n][1]);
      if (r + 8 < S)
        *reinterpret_cast<int2*>(out + (r + 8) * ld + col) =
            make_int2(acc[mt][n][2], acc[mt][n][3]);
    }
  }
}

// D > 128: every block on the exact path.
__global__ void __launch_bounds__(NT)
siggen_exact_kernel(const int32_t* __restrict__ rows,
                    const int8_t* __restrict__ cb,
                    const int8_t* __restrict__ H, int32_t* __restrict__ out,
                    int S, int D, int W, int f, int ld, int T) {
  extern __shared__ __align__(16) int32_t vs[];
  const int bs = rows_per_block(f);
  exact_rows(rows, cb, H, out, static_cast<long>(blockIdx.x) * bs, bs, S, D,
             W, f, ld, T, vs);
}

template <int NW, int KS>
int launch(const void* rows, const void* cb, const void* H, const void* cbp,
           const void* htp, const void* cb_l1, void* out, int S, int D,
           int W, int Wp, int ld, int T, cudaStream_t stream) {
  constexpr int F = 32 * NW;
  const long smem = smem_bytes(32 * KS, F);
  auto kernel = siggen_kernel<NW, KS>;
  // always: the static bytes count against the 48 KB default too
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bs = rows_per_block(F);
  kernel<<<(S + bs - 1) / bs, NT, smem, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const int8_t*>(cb),
      static_cast<const int8_t*>(H), static_cast<const int8_t*>(cbp),
      static_cast<const int8_t*>(htp), static_cast<const int32_t*>(cb_l1),
      static_cast<int32_t*>(out), S, D, W, Wp, ld, T);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_ks(int ks, const void* rows, const void* cb, const void* H,
              const void* cbp, const void* htp, const void* cb_l1, void* out,
              int S, int D, int W, int Wp, int ld, int T,
              cudaStream_t stream) {
  switch (ks) {
    case 2: return launch<NW, 2>(rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, stream);
    case 3: return launch<NW, 3>(rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, stream);
    case 4: return launch<NW, 4>(rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// V (S, f) = sum_w [rows . cb_w >= T] (rows . cb_w) H_w for one slice of
// f <= 256 columns (a multiple of 32) of a wider V: H (W, .) and out
// (S, .) have rows of ld >= f columns and point at the slice's first
// column. T >= 1. cbp (Wp, dp) and htp (f, Wp) int8 (the slice's rows) and
// cb_l1 (1,) int32 are the wrapper's tensor-core layout of cb and H
// (repro_torch/kernels/siggen.py::siggen_operands); dp and smem are its
// siggen_geometry, checked here. dp = 0: D > 128, the exact path only
// (cbp, htp and cb_l1 unused). Returns the CUDA error code of the launch.
extern "C" int siggen_accumulate(const void* rows, const void* cb,
                                 const void* H, const void* cbp,
                                 const void* htp, const void* cb_l1,
                                 void* out, int S, int D, int W, int Wp,
                                 int f, int ld, int T, int dp, long smem,
                                 void* stream) {
  if (S == 0) return 0;
  if (f % 32 || f < 32 || f > 256 || ld < f || T < 1 || D < 0 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > 32 * KS_MAX) {
    const long want = static_cast<long>(WARPS) * f * 4;
    if (dp != 0 || smem != want) return static_cast<int>(cudaErrorInvalidValue);
    const int bs = rows_per_block(f);
    siggen_exact_kernel<<<(S + bs - 1) / bs, NT, want, st>>>(
        static_cast<const int32_t*>(rows), static_cast<const int8_t*>(cb),
        static_cast<const int8_t*>(H), static_cast<int32_t*>(out), S, D, W,
        f, ld, T);
    return static_cast<int>(cudaGetLastError());
  }
  const int ks = D <= 64 ? 2 : (D + 31) / 32;
  if (dp != 32 * ks || smem != smem_bytes(dp, f) || Wp % BW || Wp < W)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (f / 32) {
    case 1: return launch_ks<1>(ks, rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, st);
    case 2: return launch_ks<2>(ks, rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, st);
    case 3: return launch_ks<3>(ks, rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, st);
    case 4: return launch_ks<4>(ks, rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, st);
    case 5: return launch_ks<5>(ks, rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, st);
    case 6: return launch_ks<6>(ks, rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, st);
    case 7: return launch_ks<7>(ks, rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, st);
    case 8: return launch_ks<8>(ks, rows, cb, H, cbp, htp, cb_l1, out, S, D, W, Wp, ld, T, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
