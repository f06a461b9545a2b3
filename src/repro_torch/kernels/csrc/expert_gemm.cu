// Grouped expert GEMMs for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernels of src/repro/kernels/expert_gemm.py:
//   * repro_expert_gate_up_wgmma / repro_expert_gate_up  (K1) -- the first
//       half of _expert_ffn_kernel: h[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e]),
//       f32 accumulation, rounded to x's dtype (where
//       kernels/ref.py::expert_ffn_ref rounds h).
//   * repro_grouped_matmul_wgmma / repro_grouped_matmul  (K2) --
//       _grouped_matmul_kernel, and the down projection h @ wd of the expert
//       FFN: (E,C,K)@(E,K,N)->(E,C,N), f32 accumulation, output in x's dtype.
//
// Why two kernels: the Pallas FFN keeps a (block_c, D) f32 accumulator
// resident across its sequential F loop.  At D = 2048 that is 1 MiB
// (2 MiB at Mixtral's D = 4096) against 227 KB of shared memory per block,
// and CUDA blocks cannot carry a sum from one block to the next.  So the FFN
// is split in two with h materialised in the working dtype.
//
// What bounds them on an H100: at decode capacity (a few tokens per expert)
// both are bound by the expert weight bytes (E*3*D*F*2 B per MoE layer); at
// prefill capacity (hundreds of rows) by tensor-core operations, and at a
// mostly empty prefill buffer by the zeros written to its dead rows.  Every
// design skips capacity tiles past each expert's routed count (rows
// counts[e]..C are written as zeros, no weight bytes read for them).
//
// K2's bf16 design where TMA can address the operands (K % 8 == 0 and
// N % 8 == 0; every served shape): gemm_wgmma_kernel, warp-specialised.
//   * A persistent grid (one block per SM) walks the live tiles only: each
//     block reads counts on the device, counts every expert's live 128-row
//     (64-row at decode) tiles, and takes every gridDim-th tile of that
//     list, so no block is launched for a dead tile and the host never reads
//     counts.  An early-exit grid would launch E * C / BM * N / BN blocks at
//     a 200 KB shared-memory footprint each, most of them only to write
//     zeros (131,072 at the serve_long buffer).
//   * One producer warp keeps a ring of 4 (prefill) or 8 (decode) stages of
//     A (BM x 64) and B (64 x BN) tiles in flight through TMA, completing
//     on mbarriers; the other three producer warps write the zeros of every
//     expert's dead rows while the products run.
//   * Consumer warpgroups (two of 64 rows at prefill, one at decode) run
//     wgmma m64nBNk16 from 128-byte-swizzled shared memory: A K-major, B
//     (the weights, N contiguous) MN-major through the transpose bit;
//     setmaxnreg moves registers from the producer to them.  The f32
//     accumulators are rounded to bf16 and stored directly.
//   * Tiles: 128 x 256 x 64 at prefill; at decode (C <= 64) 64 x 128 x 64
//     with one consumer warpgroup, so each weight tile is read once per
//     expert and no half-empty 128-row tile is issued.
// K1's bf16 design on the same shapes (D % 8 == 0 and F % 8 == 0):
// gate_up_wgmma_kernel, the same body with two B operands.  Each stage's B
// tile holds BN / 128 boxes of wg and as many of wu at the same columns, so
// one wgmma m64nBNk16 computes the gate and up halves of BN / 2 columns of h
// together, in the same 48 KB stage, 4-stage ring and 128 accumulator
// registers a thread as K2 (64-column halves at decode); the epilogue pairs
// each gate column with its up column and writes silu(g) * u, rounded once
// to bf16.  The live-tile walk, the zero-writing producer warps and the
// decode configuration are K2's.
// The first design stays for everything else: gemm_bf16_kernel (64 x 64 x
// 32 WMMA tiles, a 3-stage cp.async ring; <true> gated for K1) for bf16
// shapes TMA cannot take, gemm_f32_kernel (SIMT, exact to f32) for f32.
//
// Shapes that are not tile multiples (C, N, K) are masked, never padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// ---------------------------------------------------------------- bf16 path
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int STAGES = 3;             // cp.async ring depth
constexpr int TC_THREADS = 128;       // 4 warps in a 2x2 grid of 32x32 tiles
constexpr int LDA = BK + 8;           // smem leading dims (bf16 elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;           // epilogue staging (f32 elements)
constexpr int A_STAGE = BM * LDA;     // elements per stage
constexpr int B_STAGE = BK * LDB;
constexpr int AB_BYTES = STAGES * (A_STAGE + 2 * B_STAGE) * 2;
constexpr int C_BYTES = 2 * BM * LDC * 4;
constexpr int TC_SMEM = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.0f + expf(-g)) * u;
}

__device__ __forceinline__ int live_rows(const int* counts, int e, int C) {
  if (counts == nullptr) return C;
  int c = counts[e];
  return c < 0 ? 0 : (c < C ? c : C);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;        // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage 8 consecutive bf16 values of one row into shared memory, zero where
// the row is dead or the column is past `cols`.  With `vec` (cols % 8 == 0
// and 16-byte aligned rows) a vector is wholly in or out and goes by
// cp.async; otherwise element by element.
__device__ __forceinline__ void load8(bf16* dst, const bf16* base, const bf16* row_ptr,
                                      int col, int cols, bool row_ok, bool vec) {
  if (vec) {
    const bool ok = row_ok && col < cols;
    cp_async16(dst, ok ? row_ptr + col : base, ok);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dst[j] = (row_ok && col + j < cols) ? row_ptr[col + j] : __float2bfloat16(0.0f);
  }
}

template <bool GATED>
__global__ void __launch_bounds__(TC_THREADS)
gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                 const bf16* __restrict__ w1, bf16* __restrict__ out,
                 const int* __restrict__ counts, int C, int K, int N) {
  __shared__ __align__(128) unsigned char smem[TC_SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);                 // [STAGES][A_STAGE]
  bf16* Bs0 = As + STAGES * A_STAGE;                          // [STAGES][B_STAGE]
  bf16* Bs1 = Bs0 + STAGES * B_STAGE;
  float* Cs0 = reinterpret_cast<float*>(smem);
  float* Cs1 = Cs0 + BM * LDC;

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int rows = live_rows(counts, e, C);
  bf16* o = out + (size_t)e * C * N;
  const bool vec_out = (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(out) & 15) == 0);

  if (m0 >= rows) {  // every row of this tile is past the routed count
    for (int v = tid; v < BM * BN / 8; v += TC_THREADS) {
      int r = v / (BN / 8), c = n0 + (v % (BN / 8)) * 8;
      if (m0 + r >= C) continue;
      bf16* dst = o + (size_t)(m0 + r) * N;
      if (vec_out && c + 8 <= N) {
        *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
      } else {
        for (int j = 0; j < 8; ++j)
          if (c + j < N) dst[c + j] = __float2bfloat16(0.0f);
      }
    }
    return;
  }

  const bf16* xa = x + (size_t)e * C * K;
  const bf16* wa = w0 + (size_t)e * K * N;
  const bf16* wb = GATED ? w1 + (size_t)e * K * N : nullptr;
  const bool vec_a = (K % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
  const bool vec_b = (N % 8 == 0) && ((reinterpret_cast<uintptr_t>(w0) & 15) == 0) &&
                     (!GATED || (reinterpret_cast<uintptr_t>(w1) & 15) == 0);

  // issue the loads of K-tile `kt` into ring stage `st`
  auto load_tile = [&](int st, int kt) {
    const int k0 = kt * BK;
    bf16* as = As + st * A_STAGE;
    bf16* bs0 = Bs0 + st * B_STAGE;
    bf16* bs1 = Bs1 + st * B_STAGE;
#pragma unroll
    for (int it = 0; it < BM * BK / 8 / TC_THREADS; ++it) {
      int v = tid + it * TC_THREADS;
      int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      int gr = m0 + r;
      load8(as + r * LDA + c, xa, xa + (size_t)gr * K, k0 + c, K, gr < rows, vec_a);
    }
#pragma unroll
    for (int it = 0; it < BK * BN / 8 / TC_THREADS; ++it) {
      int v = tid + it * TC_THREADS;
      int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      int gk = k0 + r;
      load8(bs0 + r * LDB + c, wa, wa + (size_t)gk * N, n0 + c, N, gk < K, vec_b);
      if (GATED)
        load8(bs1 + r * LDB + c, wb, wb + (size_t)gk * N, n0 + c, N, gk < K, vec_b);
    }
  };

  const int warp = tid / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0[2][2], acc1[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc0[i][j], 0.0f);
      if (GATED) wmma::fill_fragment(acc1[i][j], 0.0f);
    }

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {   // prologue: fill the ring
    if (st < nk) load_tile(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();               // tile kt has landed
    __syncthreads();                           // ...for every thread, and the
    const int pre = kt + STAGES - 1;           // stage refilled next is idle
    if (pre < nk) load_tile(pre % STAGES, pre);
    cp_async_commit();
    const int st = kt % STAGES;
    const bf16* as = As + st * A_STAGE;
    const bf16* bs0 = Bs0 + st * B_STAGE;
    const bf16* bs1 = Bs1 + st * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, bs0 + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc0[i][j], a[i], b, acc0[i][j]);
        if (GATED) {
          wmma::load_matrix_sync(b, bs1 + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc1[i][j], a[i], b, acc1[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                             // the ring is reused below

  // epilogue: stage the f32 tile(s) in shared memory, then write rounded
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs0 + (wm + 16 * i) * LDC + wn + 16 * j, acc0[i][j], LDC,
                              wmma::mem_row_major);
      if (GATED)
        wmma::store_matrix_sync(Cs1 + (wm + 16 * i) * LDC + wn + 16 * j, acc1[i][j], LDC,
                                wmma::mem_row_major);
    }
  __syncthreads();
  for (int v = tid; v < BM * BN / 8; v += TC_THREADS) {
    int r = v / (BN / 8), cl = (v % (BN / 8)) * 8;
    int gr = m0 + r, c = n0 + cl;
    if (gr >= C) continue;
    const bool live = gr < rows;
    __align__(16) bf16 vals[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y = 0.0f;
      if (live) {
        y = GATED ? silu_mul(Cs0[r * LDC + cl + j], Cs1[r * LDC + cl + j])
                  : Cs0[r * LDC + cl + j];
      }
      vals[j] = __float2bfloat16(y);
    }
    bf16* dst = o + (size_t)gr * N;
    if (vec_out && c + 8 <= N) {
      *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(vals);
    } else {
      for (int j = 0; j < 8; ++j)
        if (c + j < N) dst[c + j] = vals[j];
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int FM = 64, FN = 64, FK = 16;
constexpr int F_THREADS = 256;        // 16x16 threads, 4x4 outputs each

template <bool GATED>
__global__ void __launch_bounds__(F_THREADS)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                const float* __restrict__ w1, float* __restrict__ out,
                const int* __restrict__ counts, int C, int K, int N) {
  __shared__ float As[FK][FM + 4];
  __shared__ float Bs0[FK][FN + 4];
  __shared__ float Bs1[GATED ? FK : 1][FN + 4];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int rows = live_rows(counts, e, C);
  float* o = out + (size_t)e * C * N;

  if (m0 >= rows) {
    for (int v = tid; v < FM * FN; v += F_THREADS) {
      int gr = m0 + v / FN, c = n0 + v % FN;
      if (gr < C && c < N) o[(size_t)gr * N + c] = 0.0f;
    }
    return;
  }

  const float* xa = x + (size_t)e * C * K;
  const float* wa = w0 + (size_t)e * K * N;
  const float* wb = GATED ? w1 + (size_t)e * K * N : nullptr;
  float acc0[4][4] = {}, acc1[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int it = 0; it < FM * FK / F_THREADS; ++it) {
      int v = tid + it * F_THREADS;
      int r = v / FK, c = v % FK;
      int gr = m0 + r, gk = k0 + c;
      As[c][r] = (gr < rows && gk < K) ? xa[(size_t)gr * K + gk] : 0.0f;
    }
#pragma unroll
    for (int it = 0; it < FK * FN / F_THREADS; ++it) {
      int v = tid + it * F_THREADS;
      int r = v / FN, c = v % FN;
      int gk = k0 + r, gc = n0 + c;
      bool ok = gk < K && gc < N;
      Bs0[r][c] = ok ? wa[(size_t)gk * N + gc] : 0.0f;
      if (GATED) Bs1[r][c] = ok ? wb[(size_t)gk * N + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b0[j] = Bs0[kk][tx * 4 + j];
        if (GATED) b1[j] = Bs1[kk][tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc0[i][j] = fmaf(a[i], b0[j], acc0[i][j]);
          if (GATED) acc1[i][j] = fmaf(a[i], b1[j], acc1[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gr = m0 + ty * 4 + i;
    if (gr >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int c = n0 + tx * 4 + j;
      if (c >= N) continue;
      float y = 0.0f;
      if (gr < rows) y = GATED ? silu_mul(acc0[i][j], acc1[i][j]) : acc0[i][j];
      o[(size_t)gr * N + c] = y;
    }
  }
}

template <bool GATED>
int launch(const void* x, const void* w0, const void* w1, void* out, const int* counts,
           int E, int C, int K, int N, int is_bf16, cudaStream_t stream) {
  if (E <= 0 || C <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    dim3 grid((N + BN - 1) / BN, (C + BM - 1) / BM, E);
    gemm_bf16_kernel<GATED><<<grid, TC_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w0),
        static_cast<const bf16*>(w1), static_cast<bf16*>(out), counts, C, K, N);
  } else {
    dim3 grid((N + FN - 1) / FN, (C + FM - 1) / FM, E);
    gemm_f32_kernel<GATED><<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w0),
        static_cast<const float*>(w1), static_cast<float*>(out), counts, C, K, N);
  }
  return (int)cudaGetLastError();
}


// ------------------------------------------------------ bf16 wgmma path (K2)
constexpr int WG_BK = 64;             // one 128-byte swizzle row of bf16
constexpr int WG_MAX_E = 1024;        // experts the tile list has room for
constexpr int WG_RING_BYTES = 200 * 1024;

// K1's decode configuration touches only the live rows of its tiles (a
// decode tile is mostly dead capacity rows): A in 16-row boxes, as many as
// hold live rows, and an epilogue that stores live rows only, while the
// zero-writing warps write every dead row.  K2 loads whole BM-row boxes
// and its epilogue writes the dead rows of a live tile.
template <int NWG, bool GATED>
constexpr bool kLiveRows = GATED && NWG == 1;

template <int NWG, int BN>
struct WgCfg {
  static constexpr int BM = 64 * NWG;                  // one warpgroup per 64 rows
  static constexpr int THREADS = 128 * (NWG + 1);      // consumers, then the producer WG
  static constexpr int A_BYTES = BM * WG_BK * 2;
  static constexpr int B_BYTES = WG_BK * BN * 2;       // BN / 64 boxes of 64 x 64
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGES_FIT = WG_RING_BYTES / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT > 8 ? 8 : STAGES_FIT;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 + (WG_MAX_E + 1) * 4;
};

__device__ __forceinline__ int routed_rows(const int* counts, int e, int C) {
  return counts == nullptr ? C : min(max(counts[e], 0), C);
}

// The body of K2's and K1's wgmma kernels.  grid: min(SMs, E * ceil(C/BM)
// * ceil(N/ON)) persistent blocks.  amap: x (E, C, K) as 3-D (K, C, E), box
// (64, BM, 1); bmap (and bmap2): w (E, K, N) as (N, K, E), box (64, 64, 1);
// all bf16 with 128-byte swizzle.  GATED (K1): N is h's width F, and each
// stage's B tile is BN / 128 boxes of wg (bmap) then as many of wu (bmap2)
// at the same columns, so one wgmma m64nBNk16 computes the gate and up
// columns of ON = BN / 2 outputs together and the epilogue writes
// silu(gate) * up.  Otherwise (K2) ON = BN.
template <int NWG, int BN, bool GATED>
__device__ __forceinline__ void wgmma_body(const CUtensorMap* amap, const CUtensorMap* bmap,
                                           const CUtensorMap* bmap2, bf16* __restrict__ out,
                                           const int* __restrict__ counts, int E, int C,
                                           int K, int N) {
  using CF = WgCfg<NWG, BN>;
  constexpr int BM = CF::BM, STAGES = CF::STAGES, NB = BN / 64;
  constexpr int ON = GATED ? BN / 2 : BN;              // output columns of a tile
  constexpr bool LIVE_ROWS = kLiveRows<NWG, GATED>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * CF::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  int* prefix = reinterpret_cast<int*>(empty + STAGES);   // live m-tiles of experts < e

  const int tid = threadIdx.x;
  if (tid == 0) {
    int acc = 0;
    for (int e = 0; e < E; ++e) {
      prefix[e] = acc;
      acc += (routed_rows(counts, e, C) + BM - 1) / BM;
    }
    prefix[E] = acc;
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NWG * 4);           // every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int NT = (N + ON - 1) / ON;
  const int total = prefix[E] * NT;                    // live tiles, n fastest
  const int nk = (K + WG_BK - 1) / WG_BK;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;

  if (wg == NWG) {                                     // ---- producer warpgroup
    if constexpr (NWG > 1) hopper::setmaxnreg_dec<40>();
    if (warp == 0) {
      if (lane == 0) {
        int e = 0;
        uint32_t it = 0;
        for (int t = blockIdx.x; t < total; t += gridDim.x) {
          const int mg = t / NT, n0 = (t % NT) * ON;
          while (prefix[e + 1] <= mg) ++e;
          const int m0 = (mg - prefix[e]) * BM;
          // trimmed: only the 16-row boxes that hold live rows (the rows
          // after them keep stale data and come out as written zeros)
          const int a_rows =
              LIVE_ROWS ? min(BM, (routed_rows(counts, e, C) - m0 + 15) / 16 * 16) : BM;
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % STAGES;
            hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            unsigned char* st = smem + s * CF::STAGE_BYTES;
            hopper::mbar_arrive_expect_tx(&full[s], a_rows * WG_BK * 2 + CF::B_BYTES);
            if constexpr (LIVE_ROWS) {
              for (int r = 0; r < a_rows; r += 16)             // 2 KB, 1024-aligned
                hopper::tma_load_3d(st + r * WG_BK * 2, amap, &full[s], kt * WG_BK, m0 + r, e);
            } else {
              hopper::tma_load_3d(st, amap, &full[s], kt * WG_BK, m0, e);
            }
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const bool second = GATED && j >= NB / 2;   // wu's boxes follow wg's
              hopper::tma_load_3d(st + CF::A_BYTES + j * 8192, second ? bmap2 : bmap,
                                  &full[s], n0 + 64 * (GATED ? j % (NB / 2) : j),
                                  kt * WG_BK, e);
            }
          }
        }
      }
    } else {
      // warps 1-3: zeros for every expert's rows past its last live tile
      // (the consumers zero the dead rows inside a live tile), or with
      // LIVE_ROWS for every dead row
      const int zt = tid % 128 - 32, nz = 96;
      const uint4 zero = make_uint4(0, 0, 0, 0);
      for (int e = 0; e < E; ++e) {
        const int r0 =
            LIVE_ROWS ? routed_rows(counts, e, C) : min((prefix[e + 1] - prefix[e]) * BM, C);
        uint4* base = reinterpret_cast<uint4*>(out + ((size_t)e * C + r0) * N);
        const size_t nvec = (size_t)(C - r0) * N / 8;
        for (size_t v = (size_t)blockIdx.x * nz + zt; v < nvec; v += (size_t)gridDim.x * nz)
          base[v] = zero;
      }
    }
  } else {                                             // ---- consumer warpgroup wg
    if constexpr (NWG > 1) hopper::setmaxnreg_inc<232>();
    float acc[BN / 2];
    int e = 0;
    uint32_t it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const int mg = t / NT, n0 = (t % NT) * ON;
      while (prefix[e + 1] <= mg) ++e;
      const int m0 = (mg - prefix[e]) * BM;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* a = smem + s * CF::STAGE_BYTES + wg * 64 * 128;
        const unsigned char* b = smem + s * CF::STAGE_BYTES + CF::A_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          const uint64_t da = hopper::desc_sw128(a + kk * 32, 16, 1024);
          const uint64_t db = hopper::desc_sw128(b + kk * 2048, 8192, 1024);
          if constexpr (BN == 256)
            hopper::wgmma_m64n256k16_ss<1>(acc, da, db, (kt | kk) != 0);
          else
            hopper::wgmma_m64n128k16_ss<1>(acc, da, db, (kt | kk) != 0);
        }
        hopper::wgmma_commit();
        hopper::fence_regs(acc);
        if (kt > 0) {                                  // the previous stage is read
          hopper::wgmma_wait<1>();
          if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);

      // epilogue: thread (warp, lane) holds rows 16 warp + lane / 4 (+ 8) and
      // columns 8 j + 2 (lane % 4) (+ 1) of its warpgroup's 64 x BN tile;
      // gated, column c < ON is gate and c + ON up of output column c
      const int rows = routed_rows(counts, e, C);
      bf16* o = out + (size_t)e * C * N;
      const int r_base = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < ON / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        if (col >= N) continue;                        // N % 8 == 0: col + 1 < N too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_base + 8 * h;
          if (r >= (LIVE_ROWS ? rows : C)) continue;
          float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
          if constexpr (GATED) {
            y0 = silu_mul(y0, acc[4 * (j + ON / 8) + 2 * h]);
            y1 = silu_mul(y1, acc[4 * (j + ON / 8) + 2 * h + 1]);
          }
          const bool live = r < rows;
          *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r * N + col) =
              __floats2bfloat162_rn(live ? y0 : 0.0f, live ? y1 : 0.0f);
        }
      }
    }
  }
}

// K2: out (E, C, N) = x (E, C, K) @ w (E, K, N)
template <int NWG, int BN>
__global__ void __launch_bounds__(WgCfg<NWG, BN>::THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap, bf16* __restrict__ out,
                  const int* __restrict__ counts, int E, int C, int K, int N) {
  wgmma_body<NWG, BN, false>(&amap, &bmap, &bmap, out, counts, E, C, K, N);
}

// K1: h (E, C, F) = silu(x @ wg) * (x @ wu); x (E, C, D), wg/wu (E, D, F)
template <int NWG, int BN>
__global__ void __launch_bounds__(WgCfg<NWG, BN>::THREADS, 1)
gate_up_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap umap, bf16* __restrict__ h,
                     const int* __restrict__ counts, int E, int C, int D, int F) {
  wgmma_body<NWG, BN, true>(&amap, &gmap, &umap, h, counts, E, C, D, F);
}

// K2 (w2 null) or K1 (GATED: w = wg, w2 = wu, N = F) through wgmma_body.
template <int NWG, int BN, bool GATED>
int launch_wgmma(const void* x, const void* w, const void* w2, void* out, const int* counts,
                 int E, int C, int K, int N, cudaStream_t stream) {
  using CF = WgCfg<NWG, BN>;
  constexpr int ON = GATED ? BN / 2 : BN;
  static bool smem_set = false;                        // once per instantiation
  if (!smem_set) {
    cudaError_t err;
    if constexpr (GATED)
      err = cudaFuncSetAttribute(gate_up_wgmma_kernel<NWG, BN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, CF::SMEM);
    else
      err = cudaFuncSetAttribute(gemm_wgmma_kernel<NWG, BN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, CF::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  CUtensorMap amap, bmap, bmap2;
  const uint64_t adims[3] = {(uint64_t)K, (uint64_t)C, (uint64_t)E};
  const uint64_t astr[2] = {(uint64_t)K * 2, (uint64_t)C * K * 2};
  const uint32_t abox[3] = {64, kLiveRows<NWG, GATED> ? 16u : (uint32_t)CF::BM, 1};
  const uint64_t bdims[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)E};
  const uint64_t bstr[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t bbox[3] = {64, 64, 1};
  if (!hopper_host::make_map_bf16(&amap, x, 3, adims, astr, abox) ||
      !hopper_host::make_map_bf16(&bmap, w, 3, bdims, bstr, bbox) ||
      (GATED && !hopper_host::make_map_bf16(&bmap2, w2, 3, bdims, bstr, bbox)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)E * ((C + CF::BM - 1) / CF::BM) * ((N + ON - 1) / ON);
  const int grid = (int)(tiles < hopper_host::sm_count() ? tiles : hopper_host::sm_count());
  if constexpr (GATED)
    gate_up_wgmma_kernel<NWG, BN><<<grid, CF::THREADS, CF::SMEM, stream>>>(
        amap, bmap, bmap2, static_cast<bf16*>(out), counts, E, C, K, N);
  else
    gemm_wgmma_kernel<NWG, BN><<<grid, CF::THREADS, CF::SMEM, stream>>>(
        amap, bmap, static_cast<bf16*>(out), counts, E, C, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// h (E, C, F) = silu(x @ wg) * (x @ wu); x (E, C, D), wg/wu (E, D, F).
// counts (E,) int32 or null: rows >= counts[e] are written as zeros.
int repro_expert_gate_up(const void* x, const void* wg, const void* wu, void* h,
                         const int* counts, int E, int C, int D, int F, int is_bf16,
                         void* stream) {
  return launch<true>(x, wg, wu, h, counts, E, C, D, F, is_bf16,
                      static_cast<cudaStream_t>(stream));
}

// out (E, C, N) = x (E, C, K) @ w (E, K, N); counts as above.  The first
// design: WMMA tiles (bf16) or SIMT (f32), any K and N.
int repro_grouped_matmul(const void* x, const void* w, void* out, const int* counts,
                         int E, int C, int K, int N, int is_bf16, void* stream) {
  return launch<false>(x, w, nullptr, out, counts, E, C, K, N, is_bf16,
                       static_cast<cudaStream_t>(stream));
}

// The same in bf16 through gemm_wgmma_kernel.  Needs K % 8 == 0, N % 8 == 0
// (TMA's 16-byte strides), 16-byte-aligned bases and E <= 1024; returns
// cudaErrorInvalidValue for anything else, never another design.
int repro_grouped_matmul_wgmma(const void* x, const void* w, void* out, const int* counts,
                               int E, int C, int K, int N, void* stream) {
  if (E <= 0 || C <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 || E > WG_MAX_E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 64) return launch_wgmma<1, 128, false>(x, w, nullptr, out, counts, E, C, K, N, s);
  return launch_wgmma<2, 256, false>(x, w, nullptr, out, counts, E, C, K, N, s);
}

// K1's bf16 design where TMA can address x, wg and wu (D % 8 == 0,
// F % 8 == 0, 16-byte-aligned bases, E <= 1024): h = silu(x @ wg) * (x @ wu)
// through gate_up_wgmma_kernel; cudaErrorInvalidValue for anything else,
// never another design.
int repro_expert_gate_up_wgmma(const void* x, const void* wg, const void* wu, void* h,
                               const int* counts, int E, int C, int D, int F, void* stream) {
  if (E <= 0 || C <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 || E > WG_MAX_E)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 64) return launch_wgmma<1, 128, true>(x, wg, wu, h, counts, E, C, D, F, s);
  return launch_wgmma<2, 256, true>(x, wg, wu, h, counts, E, C, D, F, s);
}

}  // extern "C"
