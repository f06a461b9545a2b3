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
//
// What bounds it on an H100 at the Mamba2-370M serve shape (nh 32, hp 64,
// ns 128, Q 256): device-memory bytes.  Per token and layer it must read x
// (nh*hp bf16), B and C (2*ns bf16) and dt (nh f32) and write y: about 8.8 KB,
// 2.6 ns at 3.35 TB/s, against about 1.6 MFLOP of causal-half work (CB, M x,
// C H and the state update), 1.6 ns at the bf16 tensor-core peak.  The same
// work in f32 outside the tensor cores (67 TFLOP/s) takes 24 ns a token, so
// whether a kernel reaches the tensor cores decides its speed.
//
// The design, simple first: one block of 256 threads per (head, batch row).
// A loop inside the block takes the place of the Pallas grid's sequential
// chunk axis and carries H (ns x hp f32, 32 KB at ns 128, hp 64) in shared
// memory from chunk to chunk; nothing carries over between blocks.  Inside
// a chunk the Q x Q work is tiled in T x T tiles (T = 64, or 32 at Q = 32)
// over j-tiles <= i-tile only: for each i-tile, C_i is staged once, the
// inter-chunk term C_i H starts the accumulators, and each j-tile stages B_j
// and x_j, forms M = (C_i B_j^T) o L o dt_j in shared memory and adds M x_j.
// Then the state update walks the chunk's j-tiles once more.  Every product
// is SIMT f32 (the reference's own arithmetic; bf16 inputs are widened when
// staged), each thread owning a 4 x 4 (or smaller) register tile, with
// padded shared-memory rows so that column walks hit distinct banks.
// Shared memory is about 133 KB at the serve shape, above the 48 KB default:
// the launch raises the kernel's dynamic limit first.
//
// Filling the 132 SMs: B x nh blocks (4096 at 128 rows, but only 32 at one
// row, a quarter of the card).  The chunk axis stays sequential; the lever
// for small micro-batches is splitting hp (each state column is independent)
// over more blocks.  Rows are scheduled last first (a ragged wave's longest).
// Next steps, in order: CB = C B^T on the tensor cores (bf16 inputs, exact
// products; it is about 40% of the work and recomputed by every head), one
// CB per chunk shared by the heads, then M x, C H and the state update on
// the tensor cores with a bf16 operand, wgmma and TMA.

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

}  // namespace

extern "C" {

// y (B, S, nh, hp) in x's type and the final state (B, nh, ns, hp) f32 of
// the SSD chunked scan over x (B, S, nh, hp), B and C (B, S, ns), dt (B, S,
// nh) f32 and A (nh,) f32, at a fixed chunk; positions at or past
// lengths[b] (lengths may be null) and past S are padding.  Supported: hp
// in {32, 64}, ns in {16, 64, 128}, chunk in {32, 64, 128, 256}; every
// tensor contiguous.
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

}  // extern "C"
