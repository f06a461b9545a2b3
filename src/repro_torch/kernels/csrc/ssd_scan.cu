// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan_pallas (body _ssd_kernel),
// the sequence mixer of every SSM layer's prefill.  Per chunk of Q positions
// and per head, with dA = dt * A:
//   cum_i = sum_{k <= i} dA_k                      (f64, see below)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i H                      (H: the state entering the chunk)
//   H    <- H exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
// B and C are (B, S, ns), shared by every head; x and y (B, S, nh, hp); the
// state H (ns, hp) is f32.  The decay L = exp(cum_i - cum_j) is only ever
// taken of the difference, and only for j <= i (masked before the exp):
// exp(-cum_j) alone overflows over a 256-long chunk.  cum is summed in f64
// and each difference rounded to f32: at |cum| in the thousands (A down to
// -16) f32 prefix sums would lose about 1e-4 of the exponent.  The plain
// version (kernels/ref.py::ssd_scan_ref) does the same.
//
// Per-row lengths of a right-padded batch, and a last chunk shorter than Q
// (S not a multiple of Q), are padding: positions p >= len are never read
// (x, B, C and dt count as zero there, so the state is the state at len),
// their y rows are written as zeros, and chunks wholly past len are skipped.
// A block's work depends only on its own (row, head), so a row's y and state
// are bit-identical whatever B, S or the other rows are.
//
// What bounds it on an H100 at the Mamba2-370M serve shape (nh 32, hp 64,
// ns 128, Q 256): device-memory bytes.  Per token and layer it must read x
// (nh*hp bf16), B and C (2*ns bf16) and dt (nh f32) and write y: about 8.8 KB,
// 2.6 ns at 3.35 TB/s, against about 1.6 MFLOP of causal-half work (C B^T,
// M x, C H and the state update), 1.6 ns at the bf16 tensor-core peak.  The
// same work in f32 outside the tensor cores (67 TFLOP/s) takes 24 ns a
// token, so whether a kernel reaches the tensor cores decides its speed.
//
// The bf16 design ("mma", ssd_mma_kernel), every served shape: one block of
// eight warps per (head, batch row), the chunk loop inside the block.
//   * The chunk's C, B and x go to shared memory in bf16 by 16-byte cp.async
//     (positions past len zero-filled, never read), in XOR-swizzled rows so
//     the eight rows an ldmatrix reads hit distinct banks, and are read from
//     device memory once a chunk (the first design staged B_j and x_j again
//     for every i-tile and the state update, widened to f32).  x has two
//     buffers: x of chunk c + 1 loads under all of chunk c; C of chunk c + 1
//     loads under chunk c's state update; only B's (and dt's) load is
//     exposed.  227 KB at the serve shape, all a block may have: one block
//     an SM.
//   * All four products run on the tensor cores as mma.sync m16n8k16, bf16
//     operands with f32 accumulators.  Each warp takes two 16-row i-tiles,
//     t and 15 - t at Q 256, so the causal work is even across warps.  Per
//     i-tile: C_i's fragments are loaded once and kept in registers; C_i H
//     (H as bf16 terms in shared memory) starts the accumulator, scaled by
//     exp(cum_i); each 16-wide j-tile at or below the diagonal forms
//     C_i B_j^T in registers, applies the mask, L and dt_j to the
//     accumulator fragment, repacks it as the A operand of M x_j (the
//     FlashAttention-2 P V pattern: M never goes to shared memory) and adds
//     M x_j.  The state update H <- H exp(cum_last) + B^T (w o x) reads B^T
//     through ldmatrix.trans; each warp keeps its tile of the f32 state in
//     registers across chunks and writes it as bf16 terms for the next
//     chunk's C H.
//   * Rounding: C B^T is exact (bf16 x bf16 into f32).  The three f32
//     operands enter as two bf16 terms hi = bf16(v), lo = bf16(v - hi), two
//     mma each (about 16 significant bits): M of M x, the state H of C H and
//     the state update's w_j x_j.  On an H100 80GB HBM3 at the serve shape
//     (tools/ssd_scan_variants.py), one rounding of H moved y rows by 0.28
//     of their peak (H is close to a sum of few B_j x_j^T, and C_i . B_j
//     cancels); of w x, the state by 3.8e-3 of its peak (hi + lo: 7.4e-6);
//     of M, y by 0.0087 (hi + lo: 0.0078, the output's own bf16 rounding),
//     and by 0.0140 on the serve path's own inputs, against 6% of the
//     kernel's time.  kernels/ref.py::ssd_scan_mma_ref mirrors it.
//   * mma.sync rather than wgmma: the bound is bytes (the tensor-core work
//     is below the byte time even with C B^T recomputed per head), 16-row
//     fragments fit every chunk down to 32 and the smoke shapes (hp 32,
//     ns 16), where wgmma's 64-row tiles do not, and the mask and decay are
//     applied to M in registers between the two products.
//   * C B^T is recomputed by every head (a block owns one head).  A block
//     that takes several heads of one row would share it.
// The first design stays for f32 (exact to f32) and as the yardstick
// (repro_ssd_scan): one block of 256 threads per (head, row), the f32 state
// in shared memory, 64 x 64 causal tiles over j-tiles <= i-tile, every
// product SIMT f32 (bf16 inputs widened when staged), about 133 KB of shared
// memory at the serve shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;   // a 16 x 16 thread grid over every tile
constexpr int MAXQ = 256;      // largest chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }

template <int NS, int HP, int T>
struct Smem {
  static constexpr int LDS = NS + 1;   // staged B/C rows (odd: column walks spread banks)
  static constexpr int LDM = T + 1;    // M rows
  static constexpr int H = NS * HP;
  static constexpr int CS = T * LDS;
  static constexpr int BS = T * LDS;
  static constexpr int XS = T * HP;
  static constexpr int MS = T * LDM;
  static constexpr int FLOATS = H + CS + BS + XS + MS + 2 * MAXQ;   // + dt, w
  static constexpr int BYTES = MAXQ * 8 + FLOATS * 4;              // cum (f64) first
};

// Stage rows [p0, p0 + T) of one batch row's (S, NS) B or C into a padded
// f32 tile; rows at or past len are zeros and never read.
template <int NS, int T, typename In>
__device__ __forceinline__ void stage_bc(float* dst, const In* __restrict__ src, int p0,
                                         int len, int tid) {
  for (int e = tid; e < T * NS; e += THREADS) {
    const int r = e / NS, s = e - r * NS;
    const int p = p0 + r;
    dst[r * (NS + 1) + s] = p < len ? to_f(src[(size_t)p * NS + s]) : 0.0f;
  }
}

// Stage rows [p0, p0 + T) of one (batch row, head)'s x (row stride `stride`).
template <int HP, int T, typename In>
__device__ __forceinline__ void stage_x(float* dst, const In* __restrict__ src,
                                        size_t stride, int p0, int len, int tid) {
  for (int e = tid; e < T * HP; e += THREADS) {
    const int r = e / HP, q = e - r * HP;
    const int p = p0 + r;
    dst[r * HP + q] = p < len ? to_f(src[(size_t)p * stride + q]) : 0.0f;
  }
}

// grid (nh, B), block THREADS, dynamic smem Smem<NS, HP, T>::BYTES.
template <int NS, int HP, int T, typename In>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const In* __restrict__ x, const In* __restrict__ Bm,
                const In* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A, const int* __restrict__ lengths,
                In* __restrict__ y, float* __restrict__ hout, int S, int nh, int Q) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using SM = Smem<NS, HP, T>;
  constexpr int LDS = SM::LDS, LDM = SM::LDM;
  constexpr int RT = T / 16;     // tile rows (and M columns) per thread
  constexpr int PC = HP / 16;    // hp columns per thread
  constexpr int SR = NS / 16;    // state rows per thread
  double* cum = reinterpret_cast<double*>(smem_raw);
  float* Hs = reinterpret_cast<float*>(cum + MAXQ);
  float* Cs = Hs + SM::H;
  float* Bs = Cs + SM::CS;
  float* Xs = Bs + SM::BS;
  float* Ms = Xs + SM::XS;
  float* dts = Ms + SM::MS;
  float* ws = dts + MAXQ;

  const int h = blockIdx.x;
  const int b = gridDim.y - 1 - blockIdx.y;   // last rows (a wave's longest) first
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  int len = lengths == nullptr ? S : lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const float a = A[h];
  const size_t xstride = (size_t)nh * HP;
  const In* xb = x + (size_t)b * S * xstride + (size_t)h * HP;
  In* yb = y + (size_t)b * S * xstride + (size_t)h * HP;
  const In* Bb = Bm + (size_t)b * S * NS;
  const In* Cb = Cm + (size_t)b * S * NS;
  const float* dtb = dt + (size_t)b * S * nh + h;

  for (int e = tid; e < NS * HP; e += THREADS) Hs[e] = 0.0f;

  const int n_live = (len + Q - 1) / Q;
  for (int c = 0; c < n_live; ++c) {
    const int c0 = c * Q;
    __syncthreads();                 // the last chunk's readers of dt, cum, H are done
    if (tid < Q) {
      const int p = c0 + tid;
      dts[tid] = p < len ? dtb[(size_t)p * nh] : 0.0f;
    }
    __syncthreads();
    if (tid < 32) {                  // warp 0: f64 prefix sums of dA = dt * A
      const int per = Q / 32;        // each lane sums a run, then a warp scan
      double run = 0.0;
      for (int k = 0; k < per; ++k) {
        run += (double)(dts[tid * per + k] * a);
        cum[tid * per + k] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const double off = incl - run;
      for (int k = 0; k < per; ++k) cum[tid * per + k] += off;
    }
    __syncthreads();
    const double cum_last = cum[Q - 1];

    // ---- y, one T-row tile at a time ----
    for (int i0 = 0; i0 < Q; i0 += T) {
      if (c0 + i0 >= len) {          // block-uniform: rows wholly past len
        for (int e = tid; e < T * HP; e += THREADS) {
          const int p = c0 + i0 + e / HP;
          if (p < S) store_f(yb + (size_t)p * xstride + e % HP, 0.0f);
        }
        continue;
      }
      stage_bc<NS, T>(Cs, Cb, c0 + i0, len, tid);
      __syncthreads();
      float acc[RT][PC];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < PC; ++q) acc[r][q] = 0.0f;
      // inter-chunk term: exp(cum_i) * C_i H
#pragma unroll 4
      for (int s = 0; s < NS; ++s) {
        float cv[RT], hv[PC];
#pragma unroll
        for (int r = 0; r < RT; ++r) cv[r] = Cs[(ty + 16 * r) * LDS + s];
#pragma unroll
        for (int q = 0; q < PC; ++q) hv[q] = Hs[s * HP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int q = 0; q < PC; ++q) acc[r][q] = fmaf(cv[r], hv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float e = expf((float)cum[i0 + ty + 16 * r]);
#pragma unroll
        for (int q = 0; q < PC; ++q) acc[r][q] *= e;
      }
      // intra-chunk term over j-tiles at or below the diagonal
      for (int j0 = 0; j0 <= i0; j0 += T) {
        stage_bc<NS, T>(Bs, Bb, c0 + j0, len, tid);
        stage_x<HP, T>(Xs, xb, xstride, c0 + j0, len, tid);
        __syncthreads();
        float cb[RT][RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int k = 0; k < RT; ++k) cb[r][k] = 0.0f;
#pragma unroll 4
        for (int s = 0; s < NS; ++s) {
          float cv[RT], bv[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) cv[r] = Cs[(ty + 16 * r) * LDS + s];
#pragma unroll
          for (int k = 0; k < RT; ++k) bv[k] = Bs[(tx + 16 * k) * LDS + s];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int k = 0; k < RT; ++k) cb[r][k] = fmaf(cv[r], bv[k], cb[r][k]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int k = 0; k < RT; ++k) {
            const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * k;
            float m = 0.0f;          // masked before the exp: j > i never exponentiated
            if (j <= i) m = cb[r][k] * expf((float)(cum[i] - cum[j])) * dts[j];
            Ms[(ty + 16 * r) * LDM + tx + 16 * k] = m;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < T; ++j) {
          float mv[RT], xv[PC];
#pragma unroll
          for (int r = 0; r < RT; ++r) mv[r] = Ms[(ty + 16 * r) * LDM + j];
#pragma unroll
          for (int q = 0; q < PC; ++q) xv[q] = Xs[j * HP + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int q = 0; q < PC; ++q) acc[r][q] = fmaf(mv[r], xv[q], acc[r][q]);
        }
        __syncthreads();             // B, x and M tiles are refilled next
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int p = c0 + i0 + ty + 16 * r;
        if (p >= S) continue;
        const bool live = p < len;
#pragma unroll
        for (int q = 0; q < PC; ++q)
          store_f(yb + (size_t)p * xstride + tx + 16 * q, live ? acc[r][q] : 0.0f);
      }
    }

    // ---- state update: H <- H exp(cum_last) + sum_j w_j B_j x_j^T ----
    for (int j = tid; j < Q; j += THREADS)
      ws[j] = expf((float)(cum_last - cum[j])) * dts[j];
    const float decay = expf((float)cum_last);
    float hacc[SR][PC];
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int q = 0; q < PC; ++q) hacc[r][q] = 0.0f;
    __syncthreads();
    for (int j0 = 0; j0 < Q && c0 + j0 < len; j0 += T) {   // tiles past len add 0
      stage_bc<NS, T>(Bs, Bb, c0 + j0, len, tid);
      stage_x<HP, T>(Xs, xb, xstride, c0 + j0, len, tid);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < T; ++j) {
        const float w = ws[j0 + j];
        float xv[PC];
#pragma unroll
        for (int q = 0; q < PC; ++q) xv[q] = Xs[j * HP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < SR; ++r) {
          const float bw = w * Bs[j * LDS + ty + 16 * r];
#pragma unroll
          for (int q = 0; q < PC; ++q) hacc[r][q] = fmaf(bw, xv[q], hacc[r][q]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        float* hv = Hs + (ty + 16 * r) * HP + tx + 16 * q;   // this thread's own entry
        *hv = *hv * decay + hacc[r][q];
      }
  }

  // rows of the chunks wholly past len (skipped) are zeros
  const int p_done = n_live * Q;
  if (p_done < S) {
    for (size_t e = tid; e < (size_t)(S - p_done) * HP; e += THREADS) {
      const int p = p_done + (int)(e / HP);
      store_f(yb + (size_t)p * xstride + e % HP, 0.0f);
    }
  }
  __syncthreads();
  float* hb = hout + ((size_t)b * nh + h) * NS * HP;
  for (int e = tid; e < NS * HP; e += THREADS) hb[e] = Hs[e];
}

template <int NS, int HP, int T, typename In>
int launch(const void* x, const void* Bm, const void* Cm, const float* dt, const float* A,
           const int* lengths, void* y, float* state, int Bt, int S, int nh, int Q,
           cudaStream_t stream) {
  using SM = Smem<NS, HP, T>;
  static bool smem_set = false;               // once per instantiation
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<NS, HP, T, In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SM::BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid(nh, Bt);
  ssd_scan_kernel<NS, HP, T, In><<<grid, THREADS, SM::BYTES, stream>>>(
      static_cast<const In*>(x), static_cast<const In*>(Bm), static_cast<const In*>(Cm),
      dt, A, lengths, static_cast<In*>(y), state, S, nh, Q);
  return (int)cudaGetLastError();
}

template <int NS, int HP, typename In>
int launch_t(const void* x, const void* Bm, const void* Cm, const float* dt,
             const float* A, const int* lengths, void* y, float* state, int Bt, int S,
             int nh, int Q, cudaStream_t s) {
  if (Q == 32) return launch<NS, HP, 32, In>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, Q, s);
  return launch<NS, HP, 64, In>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, Q, s);
}

template <int NS, typename In>
int launch_hp(const void* x, const void* Bm, const void* Cm, const float* dt,
              const float* A, const int* lengths, void* y, float* state, int Bt, int S,
              int nh, int hp, int Q, cudaStream_t s) {
  switch (hp) {
    case 32: return launch_t<NS, 32, In>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, Q, s);
    case 64: return launch_t<NS, 64, In>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename In>
int launch_ns(const void* x, const void* Bm, const void* Cm, const float* dt,
              const float* A, const int* lengths, void* y, float* state, int Bt, int S,
              int nh, int hp, int ns, int Q, cudaStream_t s) {
  switch (ns) {
    case 16: return launch_hp<16, In>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, hp, Q, s);
    case 64: return launch_hp<64, In>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, hp, Q, s);
    case 128: return launch_hp<128, In>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, hp, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------ bf16 mma.sync design
constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = MMA_WARPS * 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;     // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) as two packed bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// a packed bf16 pair (x0, x1) times (w0, w1) in f32, split as hi + lo
__device__ __forceinline__ void scale_split(uint32_t xp, float w0, float w1, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xp));
  split_bf16(xf.x * w0, xf.y * w1, hi, lo);
}

// A bf16 tile of rows of W elements in 16-byte chunks, chunk ch of row r
// stored at ch ^ ((r / RPL) & MASK): the eight rows an ldmatrix reads (at
// one chunk column) fall in distinct 16-byte bank groups at every width.
template <int W>
struct Swz {
  static constexpr int CPR = W / 8;                 // chunks a row
  static constexpr int RPL = CPR >= 8 ? 1 : 8 / CPR; // rows a 128-byte line
  static constexpr int MASK = (CPR >= 8 ? 8 : CPR) - 1;
  __device__ static __forceinline__ int at(int r, int col) {
    return r * W + ((((col >> 3) ^ ((r / RPL) & MASK))) << 3) + (col & 7);
  }
};

// The f32 state's tiles: WM x WN warps, each owning MT x NT m16n8 tiles
// (rows s, columns p) in registers across chunks.
template <int NS, int HP>
struct StateTiles {
  static constexpr int NM = NS / 16, NN = HP / 8;
  static constexpr int WM = NM >= 2 ? 2 : 1;
  static constexpr int WN = NN < MMA_WARPS / WM ? NN : MMA_WARPS / WM;
  static constexpr int MT = NM / WM, NT = NN / WN;
  static_assert(MT * WM == NM && NT * WN == NN && (NT == 1 || NT == 2), "state tiling");
};

// bytes of dynamic shared memory at chunk Q: cum (f64), dt (f32), C and B,
// two x buffers, the state as two bf16 terms (232,448 bytes, all a block
// may have, at Q 256, ns 128, hp 64)
template <int NS, int HP>
constexpr int mma_smem_bytes(int Q) {
  return 12 * Q + 4 * Q * (NS + HP) + 4 * NS * HP;
}

// Stage rows [p0, p0 + Q) of a (S, W)-strided bf16 array (row stride
// `stride`) into a swizzled tile; rows at or past len are zero-filled.
template <int W>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, size_t stride, int p0,
                                           int Q, int len, int tid) {
  constexpr int CPR = W / 8;
  for (int e = tid; e < Q * CPR; e += MMA_THREADS) {
    const int r = e / CPR, ch = e % CPR;
    const bool ok = p0 + r < len;
    cp_async16(dst + Swz<W>::at(r, ch * 8), ok ? src + (size_t)(p0 + r) * stride + ch * 8 : src,
               ok);
  }
}

__device__ __forceinline__ void stage_dt(float* dst, const float* src, int nh, int p0, int Q,
                                         int len, int tid) {
  for (int r = tid; r < Q; r += MMA_THREADS) {
    const bool ok = p0 + r < len;
    cp_async4(dst + r, ok ? src + (size_t)(p0 + r) * nh : src, ok);
  }
}

// rows [r0, r1) of one (batch row, head)'s y as zeros, 16 bytes a store
template <int HP>
__device__ __forceinline__ void zero_rows(bf16* yb, size_t stride, int r0, int r1, int t,
                                          int nt) {
  constexpr int CH = HP / 8;
  for (int e = t; e < (r1 - r0) * CH; e += nt) {
    const int r = r0 + e / CH, ch = e % CH;
    *reinterpret_cast<uint4*>(yb + (size_t)r * stride + ch * 8) = make_uint4(0, 0, 0, 0);
  }
}

// y of the chunk's 16-row i-tile t, by one warp: C_i H (when `inter`; H
// as bf16 terms Hh + Hl) scaled by exp(cum_i), plus M x_j over j-tiles <= t.  yc is y at the
// chunk's first position; rows past lc (the chunk's live positions) are
// written as zeros, rows at or past `rows` (the end of S) not at all.
template <int NS, int HP>
__device__ __forceinline__ void y_tile(int t, bool inter, const bf16* Cs, const bf16* Bs,
                                       const bf16* Xc, const bf16* Hh, const bf16* Hl,
                                       const double* cum,
                                       const float* dts, bf16* yc, size_t stride, int lc,
                                       int rows, int lane) {
  constexpr int KS = NS / 16, NP = HP / 8;
  using SN = Swz<NS>;
  using SH = Swz<HP>;
  const int g = lane >> 2, t4 = lane & 3;
  const int i0 = 16 * t;
  if (i0 >= lc) {
    zero_rows<HP>(yc, stride, i0, min(i0 + 16, rows), lane, 32);
    return;
  }
  // ldmatrix lane addresses: a non-transposed A tile, a B tile of two
  // n8-tiles stored n-major, and a B tile stored k-major (read transposed)
  const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8, a_c = (lane >> 4) * 8;
  const int n_r = (lane & 7) + (lane >> 4) * 8, n_c = ((lane >> 3) & 1) * 8;
  uint32_t ca[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(ca[ks], Cs + SN::at(i0 + a_r, 16 * ks + a_c));
  float acc[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  if (inter) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n2 = 0; n2 < NP / 2; ++n2) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4_trans(bh, Hh + SH::at(16 * ks + a_r, 16 * n2 + a_c));
        ldmatrix_x4_trans(bl, Hl + SH::at(16 * ks + a_r, 16 * n2 + a_c));
        mma_bf16(acc[2 * n2], ca[ks], bh[0], bh[1]);
        mma_bf16(acc[2 * n2 + 1], ca[ks], bh[2], bh[3]);
        mma_bf16(acc[2 * n2], ca[ks], bl[0], bl[1]);
        mma_bf16(acc[2 * n2 + 1], ca[ks], bl[2], bl[3]);
      }
    }
    const float e0 = expf((float)cum[i0 + g]), e1 = expf((float)cum[i0 + g + 8]);
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }
  }
  const double ci0 = cum[i0 + g], ci1 = cum[i0 + g + 8];
  for (int jt = 0; jt <= t; ++jt) {
    const int j0 = 16 * jt;
    // C_i B_j^T over ns, even and odd k-steps in separate accumulators (two
    // chains of mma half as long: 3.4% of the kernel at the serve shape)
    float cb[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    float cb_odd[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bb[4];
      ldmatrix_x4(bb, Bs + SN::at(j0 + n_r, 16 * ks + n_c));
      float(*dst)[4] = (ks & 1) ? cb_odd : cb;
      mma_bf16(dst[0], ca[ks], bb[0], bb[1]);
      mma_bf16(dst[1], ca[ks], bb[2], bb[3]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[n][e] += cb_odd[n][e];
    // M = (C_i B_j^T) o L o dt_j in registers, masked before the exp on the
    // diagonal tile, repacked as the A operand of M x_j in two bf16 terms
    uint32_t ma[4], ml[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int j = j0 + 8 * n + 2 * t4;
      const double cj0 = cum[j], cj1 = cum[j + 1];
      const float d0 = dts[j], d1 = dts[j + 1];
      float l00 = (float)(ci0 - cj0), l01 = (float)(ci0 - cj1);
      float l10 = (float)(ci1 - cj0), l11 = (float)(ci1 - cj1);
      if (jt == t) {
        const int r0 = i0 + g, r1 = i0 + g + 8;
        if (j > r0) l00 = -INFINITY;
        if (j + 1 > r0) l01 = -INFINITY;
        if (j > r1) l10 = -INFINITY;
        if (j + 1 > r1) l11 = -INFINITY;
      }
      split_bf16(cb[n][0] * expf(l00) * d0, cb[n][1] * expf(l01) * d1, ma[2 * n], ml[2 * n]);
      split_bf16(cb[n][2] * expf(l10) * d0, cb[n][3] * expf(l11) * d1, ma[2 * n + 1], ml[2 * n + 1]);
    }
#pragma unroll
    for (int n2 = 0; n2 < NP / 2; ++n2) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, Xc + SH::at(j0 + a_r, 16 * n2 + a_c));
      mma_bf16(acc[2 * n2], ma, bb[0], bb[1]);
      mma_bf16(acc[2 * n2 + 1], ma, bb[2], bb[3]);
      mma_bf16(acc[2 * n2], ml, bb[0], bb[1]);
      mma_bf16(acc[2 * n2 + 1], ml, bb[2], bb[3]);
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + g + 8 * hf;
    if (i >= rows) continue;
    const bool live = i < lc;
    bf16* yr = yc + (size_t)i * stride + 2 * t4;
#pragma unroll
    for (int n = 0; n < NP; ++n)
      *reinterpret_cast<uint32_t*>(yr + 8 * n) =
          live ? pack_bf16(acc[n][2 * hf], acc[n][2 * hf + 1]) : 0u;
  }
}

// grid (nh, B), block MMA_THREADS, dynamic smem mma_smem_bytes<NS, HP>(Q).
template <int NS, int HP>
__global__ void __launch_bounds__(MMA_THREADS, 1)
ssd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
               const bf16* __restrict__ Cm, const float* __restrict__ dt,
               const float* __restrict__ A, const int* __restrict__ lengths,
               bf16* __restrict__ y, float* __restrict__ hout, int S, int nh, int Q) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using ST = StateTiles<NS, HP>;
  using SN = Swz<NS>;
  using SH = Swz<HP>;
  double* cum = reinterpret_cast<double*>(smem_raw);
  float* dts = reinterpret_cast<float*>(cum + Q);
  bf16* Cs = reinterpret_cast<bf16*>(dts + Q);
  bf16* Bs = Cs + Q * NS;
  bf16* Xs = Bs + Q * NS;                     // two x buffers
  bf16* Hh = Xs + 2 * Q * HP;                 // the state entering the chunk,
  bf16* Hl = Hh + NS * HP;                    // as bf16 terms Hh + Hl

  const int h = blockIdx.x;
  const int b = gridDim.y - 1 - blockIdx.y;   // last rows (a wave's longest) first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  int len = lengths == nullptr ? S : lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const float a = A[h];
  const size_t xstride = (size_t)nh * HP;
  const bf16* xb = x + (size_t)b * S * xstride + (size_t)h * HP;
  bf16* yb = y + (size_t)b * S * xstride + (size_t)h * HP;
  const bf16* Bb = Bm + (size_t)b * S * NS;
  const bf16* Cb = Cm + (size_t)b * S * NS;
  const float* dtb = dt + (size_t)b * S * nh + h;

  // this warp's tile of the f32 state (none for warps past WM x WN)
  const bool s_warp = warp < ST::WM * ST::WN;
  const int s0 = (warp / ST::WN) * ST::MT * 16, p0 = (warp % ST::WN) * ST::NT * 8;
  float hacc[ST::MT][ST::NT][4];
#pragma unroll
  for (int m = 0; m < ST::MT; ++m)
#pragma unroll
    for (int n = 0; n < ST::NT; ++n) hacc[m][n][0] = hacc[m][n][1] = hacc[m][n][2] = hacc[m][n][3] = 0.0f;

  const int n_live = (len + Q - 1) / Q;
  if (n_live > 0) {
    stage_rows<NS>(Cs, Cb, NS, 0, Q, len, tid);
    stage_rows<NS>(Bs, Bb, NS, 0, Q, len, tid);
    stage_dt(dts, dtb, nh, 0, Q, len, tid);
    stage_rows<HP>(Xs, xb, xstride, 0, Q, len, tid);
    cp_async_commit();
  }
  for (int c = 0; c < n_live; ++c) {
    const int c0 = c * Q;
    const int lc = min(Q, len - c0);          // live positions of this chunk
    const bool more = c + 1 < n_live;
    const bf16* Xc = Xs + (c & 1) * Q * HP;
    if (more) {                               // x of the next chunk, under this one
      stage_rows<HP>(Xs + ((c + 1) & 1) * Q * HP, xb, xstride, c0 + Q, Q, len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                          // this chunk's C, B, x, dt have landed
    if (warp == 0) {                          // f64 prefix sums of dA = dt * A
      const int per = Q / 32;                 // each lane sums a run, then a warp scan
      double run = 0.0;
      for (int k = 0; k < per; ++k) {
        run += (double)(dts[lane * per + k] * a);
        cum[lane * per + k] = run;
      }
      double incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const double off = incl - run;
      for (int k = 0; k < per; ++k) cum[lane * per + k] += off;
    }
    __syncthreads();
    const double cum_last = cum[Q - 1];

    // ---- y: i-tiles t and 2 MMA_WARPS - 1 - t of each warp ----
    const int QT = Q / 16;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      const int t = pass == 0 ? warp : 2 * MMA_WARPS - 1 - warp;
      if (t < QT)
        y_tile<NS, HP>(t, c > 0, Cs, Bs, Xc, Hh, Hl, cum, dts, yb + (size_t)c0 * xstride,
                       xstride, lc, S - c0, lane);
    }
    __syncthreads();                          // C and the bf16 H are free
    if (more) {
      stage_rows<NS>(Cs, Cb, NS, c0 + Q, Q, len, tid);
      cp_async_commit();
    }

    // ---- state: H <- H exp(cum_last) + B^T (w o x), w o x as hi + lo ----
    if (s_warp) {
      const float decay = expf((float)cum_last);
#pragma unroll
      for (int m = 0; m < ST::MT; ++m)
#pragma unroll
        for (int n = 0; n < ST::NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[m][n][e] *= decay;
      const int a_r = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int n_r = (lane & 7) + (lane >> 4) * 8, n_c = ((lane >> 3) & 1) * 8;
      const int nk = (lc + 15) / 16;          // j-tiles past lc add zero
      for (int kt = 0; kt < nk; ++kt) {
        const int j0 = 16 * kt, j = j0 + 2 * t4;
        const float w0 = expf((float)(cum_last - cum[j])) * dts[j];
        const float w1 = expf((float)(cum_last - cum[j + 1])) * dts[j + 1];
        const float w2 = expf((float)(cum_last - cum[j + 8])) * dts[j + 8];
        const float w3 = expf((float)(cum_last - cum[j + 9])) * dts[j + 9];
        uint32_t xf[2 * ST::NT];
        if constexpr (ST::NT == 2) {
          ldmatrix_x4_trans(xf, Xc + SH::at(j0 + a_r, p0 + (lane >> 4) * 8));
        } else {
          ldmatrix_x2_trans(xf, Xc + SH::at(j0 + a_r, p0));
        }
        uint32_t bh[ST::NT][2], bl[ST::NT][2];
#pragma unroll
        for (int n = 0; n < ST::NT; ++n) {
          scale_split(xf[2 * n], w0, w1, bh[n][0], bl[n][0]);
          scale_split(xf[2 * n + 1], w2, w3, bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int m = 0; m < ST::MT; ++m) {
          uint32_t af[4];
          ldmatrix_x4_trans(af, Bs + SN::at(j0 + n_r, s0 + 16 * m + n_c));
#pragma unroll
          for (int n = 0; n < ST::NT; ++n) {
            mma_bf16(hacc[m][n], af, bh[n][0], bh[n][1]);
            mma_bf16(hacc[m][n], af, bl[n][0], bl[n][1]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < ST::MT; ++m)
#pragma unroll
        for (int n = 0; n < ST::NT; ++n) {
          const int s = s0 + 16 * m + g, p = p0 + 8 * n + 2 * t4;
          uint32_t hi, lo;
          split_bf16(hacc[m][n][0], hacc[m][n][1], hi, lo);
          *reinterpret_cast<uint32_t*>(Hh + SH::at(s, p)) = hi;
          *reinterpret_cast<uint32_t*>(Hl + SH::at(s, p)) = lo;
          split_bf16(hacc[m][n][2], hacc[m][n][3], hi, lo);
          *reinterpret_cast<uint32_t*>(Hh + SH::at(s + 8, p)) = hi;
          *reinterpret_cast<uint32_t*>(Hl + SH::at(s + 8, p)) = lo;
        }
    }
    __syncthreads();                          // B, x and dt are free, H written
    if (more) {
      stage_rows<NS>(Bs, Bb, NS, c0 + Q, Q, len, tid);
      stage_dt(dts, dtb, nh, c0 + Q, Q, len, tid);
      cp_async_commit();
    }
  }

  zero_rows<HP>(yb, xstride, n_live * Q < S ? n_live * Q : S, S, tid, MMA_THREADS);
  if (s_warp) {
    float* hb = hout + ((size_t)b * nh + h) * NS * HP;
#pragma unroll
    for (int m = 0; m < ST::MT; ++m)
#pragma unroll
      for (int n = 0; n < ST::NT; ++n) {
        const int s = s0 + 16 * m + g, p = p0 + 8 * n + 2 * t4;
        *reinterpret_cast<float2*>(hb + (size_t)s * HP + p) = make_float2(hacc[m][n][0], hacc[m][n][1]);
        *reinterpret_cast<float2*>(hb + (size_t)(s + 8) * HP + p) =
            make_float2(hacc[m][n][2], hacc[m][n][3]);
      }
  }
}

template <int NS, int HP>
int launch_mma(const void* x, const void* Bm, const void* Cm, const float* dt, const float* A,
               const int* lengths, void* y, float* state, int Bt, int S, int nh, int Q,
               cudaStream_t stream) {
  const int smem = mma_smem_bytes<NS, HP>(Q);
  static int smem_set = 0;                    // per instantiation: the limit set
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_mma_kernel<NS, HP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  ssd_mma_kernel<NS, HP><<<dim3(nh, Bt), MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      dt, A, lengths, static_cast<bf16*>(y), state, S, nh, Q);
  return (int)cudaGetLastError();
}

template <int NS>
int mma_hp(const void* x, const void* Bm, const void* Cm, const float* dt, const float* A,
           const int* lengths, void* y, float* state, int Bt, int S, int nh, int hp, int Q,
           cudaStream_t s) {
  switch (hp) {
    case 32: return launch_mma<NS, 32>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, Q, s);
    case 64: return launch_mma<NS, 64>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// y (B, S, nh, hp) in x's type and the final state (B, nh, ns, hp) f32 of
// the SSD chunked scan over x (B, S, nh, hp), B and C (B, S, ns), dt (B, S,
// nh) f32 and A (nh,) f32, at a fixed chunk; positions at or past
// lengths[b] (lengths may be null) and past S are padding; the first
// (SIMT) design, f32 or bf16.  Supported: hp in {32, 64}, ns in {16, 64,
// 128}, chunk in {32, 64, 128, 256}; every tensor contiguous.
int repro_ssd_scan(const void* x, const void* Bm, const void* Cm, const float* dt,
                   const float* A, const int* lengths, void* y, float* state, int Bt,
                   int S, int nh, int hp, int ns, int chunk, int is_bf16, void* stream) {
  if (Bt <= 0 || S <= 0 || nh <= 0 || Bt > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (chunk != 32 && chunk != 64 && chunk != 128 && chunk != 256) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_ns<bf16>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, hp, ns, chunk, s);
  }
  return launch_ns<float>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, hp, ns, chunk, s);
}


// The bf16 mma design: the same function for bf16 x, B, C and y (16-byte
// aligned), hp in {32, 64}, ns in {16, 64, 128}, chunk in {32, 64, 128, 256}.
int repro_ssd_scan_mma(const void* x, const void* Bm, const void* Cm, const float* dt,
                       const float* A, const int* lengths, void* y, float* state, int Bt,
                       int S, int nh, int hp, int ns, int chunk, void* stream) {
  if (Bt <= 0 || S <= 0 || nh <= 0 || Bt > 65535) return (int)cudaErrorInvalidValue;
  if (chunk != 32 && chunk != 64 && chunk != 128 && chunk != 256) {
    return (int)cudaErrorInvalidValue;
  }
  if (!aligned16(x) || !aligned16(Bm) || !aligned16(Cm) || !aligned16(y)) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 16: return mma_hp<16>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, hp, chunk, s);
    case 64: return mma_hp<64>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, hp, chunk, s);
    case 128: return mma_hp<128>(x, Bm, Cm, dt, A, lengths, y, state, Bt, S, nh, hp, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
