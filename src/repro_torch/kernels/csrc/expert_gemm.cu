// Grouped expert GEMMs for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernels of src/repro/kernels/expert_gemm.py:
//   * repro_expert_gate_up  (K1) -- the first half of _expert_ffn_kernel:
//       h[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e]), f32 accumulation,
//       rounded to x's dtype (where kernels/ref.py::expert_ffn_ref rounds h).
//   * repro_grouped_matmul  (K2) -- _grouped_matmul_kernel, and the down
//       projection h @ wd of the expert FFN: (E,C,K)@(E,K,N)->(E,C,N),
//       f32 accumulation, output in x's dtype.
//
// Why two kernels: the Pallas FFN keeps a (block_c, D) f32 accumulator
// resident across its sequential F loop.  At D = 2048 that is 1 MiB
// (2 MiB at Mixtral's D = 4096) against 227 KB of shared memory per block,
// and CUDA blocks cannot carry a sum from one block to the next.  So the FFN
// is split in two with h materialised in the working dtype.
//
// What bounds them on an H100: at decode capacity (a few tokens per expert)
// both are bound by the expert weight bytes (E*3*D*F*2 B per MoE layer); at
// prefill capacity (hundreds of rows) by tensor-core operations.  The design
// reads each weight tile once per 64-row capacity tile, skips capacity tiles
// past each expert's routed count (rows counts[e]..C are written as zeros, no
// weight bytes read for them), keeps a 3-stage cp.async ring of A/B tiles in
// flight while the tensor cores work on the oldest, and runs bf16 products
// through WMMA (mma.sync) with f32 accumulators.  f32 inputs take a SIMT FMA
// path so f32 results stay exact to f32 rounding (no TF32).  wgmma, TMA and
// persistent scheduling are later work.
//
// Shapes that are not tile multiples (C, N, K) are masked, never padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// out (E, C, N) = x (E, C, K) @ w (E, K, N); counts as above.
int repro_grouped_matmul(const void* x, const void* w, void* out, const int* counts,
                         int E, int C, int K, int N, int is_bf16, void* stream) {
  return launch<false>(x, w, nullptr, out, counts, E, C, K, N, is_bf16,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
