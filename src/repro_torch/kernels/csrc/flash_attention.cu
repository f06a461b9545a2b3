// Causal GQA flash attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (body
// _flash_kernel), the prefill attention of every layer, together with what
// the JAX dispatcher adds around it:
//   * GQA without the repeat: query head h reads KV head h / G (the JAX
//     wrapper in kernels/ops.py copies every KV head G times instead);
//   * a sliding window: key j is visible to query i iff i - window < j <= i
//     (window 0: no lower limit), as models/attention.py's naive and
//     sliding-window attention define it;
//   * per-row lengths of a right-padded batch: keys j >= lengths[b] are
//     masked, and output rows i >= lengths[b] are written as zeros (they are
//     never read), so query blocks wholly past lengths[b] do no work.
// Scale hd**-0.5, f32 running max / sum / accumulator, output in q's dtype.
//
// What bounds it on an H100 at the serve shapes: tensor-core operations.
// QK^T and PV are 4 * H * hd FLOPs for every visible (query, key) pair,
// about 4 * H * hd * sum_b L_b^2 / 2 over a ragged batch, at 989 TFLOP/s in
// bf16; each of q, k, v and out is read or written once (O(S) bytes against
// O(S^2) operations), far under the 295 FLOP/byte ridge once L is in the
// hundreds.
//
// The design (bf16): one block of four warps per (query head, batch row,
// 64-row query block); each warp owns 16 query rows.  A loop inside the
// block takes the place of the Pallas grid's sequential KV axis and walks
// 64-key K/V tiles only from the first tile the window reaches to the tile
// holding the block's last live row (the diagonal), the Pallas kernel's
// pl.when skip; a warp also skips the tiles wholly above its own diagonal or
// below its window.  K/V tiles are staged in shared memory by a two-stage
// cp.async double buffer (the next tile loads while the tensor cores work on
// this one); QK^T and PV run as mma.sync m16n8k16 (bf16 in, f32 accumulate)
// with ldmatrix operand loads, and the probabilities go from the score
// accumulators straight into PV's A operand in registers (rounded to bf16
// there, as the reference rounds them to v's dtype).  Masking runs only on
// tiles that cross the diagonal, the window edge or lengths[b].  Query
// blocks are scheduled heaviest (last) first, so the causal tail does not
// straggle.  Shared memory: Q 64 x (hd+8) plus two stages of K and V, 85 KB
// at hd 128, above the 48 KB default: the launch raises the function's
// dynamic shared-memory limit first.  wgmma, TMA and split-Q scheduling of
// ragged waves are later work.
//
// f32 inputs take a SIMT path (one warp per query row, lanes split hd, the
// decode kernel's online softmax), since mma has no exact f32 product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;           // query rows per block, 16 per warp
constexpr int BKV = 64;          // keys per K/V tile
constexpr int NWARP = 4;
constexpr int THREADS = NWARP * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;           // padded row: ldmatrix rows hit distinct banks
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BKV * LD;
  static constexpr int BYTES = (Q_ELEMS + 4 * KV_ELEMS) * 2;   // Q, 2 stages of K and V
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;     // 0 source bytes: the 16 bytes are zero-filled
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
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// Stage rows [r0, r0 + 64) of a (rows, HD) slab with row stride `stride`
// elements into shared memory; rows at or past `limit` are zero-filled and
// never read from device memory.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, size_t stride, int r0,
                                          int limit, int tid) {
  constexpr int CH = HD / 8;                  // 16-byte chunks per row
  constexpr int LD = Smem<HD>::LD;
#pragma unroll
  for (int c = tid; c < 64 * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const int gr = r0 + r;
    const bool ok = gr < limit;
    cp_async16(sm + r * LD + col, ok ? g + (size_t)gr * stride + col : g, ok);
  }
}

// grid (H, B, ceil(S / BQ)), block THREADS, dynamic smem Smem<HD>::BYTES.
// q/out (B, S, H, HD); k/v (B, S, K, HD); lengths (B,) or null.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ lengths,
                  bf16* __restrict__ out, int S, int H, int K, int window,
                  float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using SM = Smem<HD>;
  constexpr int LD = SM::LD;
  constexpr int NT = BKV / 8;                 // score n-tiles per warp
  constexpr int OT = HD / 8;                  // output n-tiles per warp
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + SM::Q_ELEMS;                // [2][KV_ELEMS]
  bf16* Vs = Ks + 2 * SM::KV_ELEMS;           // [2][KV_ELEMS]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest blocks first
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int len = lengths == nullptr ? S : lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  const size_t qstride = (size_t)H * HD, kvstride = (size_t)K * HD;
  bf16* ob = out + ((size_t)b * S * H + h) * HD;

  if (q0 >= len) {                            // every row past the sequence
    constexpr int CH = HD / 8;
    const int rows = min(BQ, S - q0);
    for (int c = tid; c < rows * CH; c += THREADS) {
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + c / CH) * qstride + (c % CH) * 8) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int q_last = min(q0 + BQ, len) - 1;   // last live row of the block
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kb_lo = kv_lo / BKV, kb_hi = q_last / BKV + 1;

  const bf16* qg = q + ((size_t)b * S * H + h) * HD;
  const bf16* kg = k + ((size_t)b * S * K + kh) * HD;
  const bf16* vg = v + ((size_t)b * S * K + kh) * HD;

  load_tile<HD>(Qs, qg, qstride, q0, len, tid);
  load_tile<HD>(Ks, kg, kvstride, kb_lo * BKV, len, tid);
  load_tile<HD>(Vs, vg, kvstride, kb_lo * BKV, len, tid);
  cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  const int row_w = q0 + warp * 16;           // the warp's first row
  const int rows_w[2] = {row_w + g, row_w + g + 8};
  const bool warp_live = row_w <= q_last;

  float o[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int st = (kb - kb_lo) & 1;
    if (kb + 1 < kb_hi) {                     // the other stage is free: every
      const int n0 = (kb + 1) * BKV;          // warp passed the last barrier
      load_tile<HD>(Ks + (st ^ 1) * SM::KV_ELEMS, kg, kvstride, n0, len, tid);
      load_tile<HD>(Vs + (st ^ 1) * SM::KV_ELEMS, vg, kvstride, n0, len, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                       // this tile (and Q) have landed
    __syncthreads();

    const int k0 = kb * BKV;
    // warp-uniform skips: tile wholly above this warp's diagonal, or wholly
    // older than its last row's window
    const bool skip = !warp_live || k0 > row_w + 15 ||
                      (window > 0 && k0 + BKV - 1 <= row_w - window);
    if (!skip) {
      const bf16* ks = Ks + st * SM::KV_ELEMS;
      const bf16* vs = Vs + st * SM::KV_ELEMS;
      float s[NT][4];
#pragma unroll
      for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bb[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bb, ks + key * LD + kk + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], a, bb[0], bb[1]);
          mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
        }
      }
      const bool need_mask = k0 + BKV - 1 > row_w || k0 + BKV > len ||
                             (window > 0 && k0 <= row_w + 15 - window);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][e] * scale_log2;
          if (need_mask) {
            const int j = k0 + i * 8 + t4 * 2 + (e & 1);
            const int r = rows_w[e >> 1];
            const bool ok = j <= r && j < len && (window <= 0 || r - j < window);
            x = ok ? x : -INFINITY;
          }
          s[i][e] = x;
        }
      }
      // online softmax over this tile, two rows per thread (g and g + 8);
      // the four threads of a quad share a row
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < NT; ++i) mx = fmaxf(mx, fmaxf(s[i][2 * rr], s[i][2 * rr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rr], mx);
        const float m_use = m_new == -INFINITY ? 0.0f : m_new;
        corr[rr] = exp2f(m[rr] - m_use);
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          s[i][2 * rr] = exp2f(s[i][2 * rr] - m_use);
          s[i][2 * rr + 1] = exp2f(s[i][2 * rr + 1] - m_use);
          sum += s[i][2 * rr] + s[i][2 * rr + 1];
        }
        l[rr] = l[rr] * corr[rr] + sum;       // per-thread partial, summed at the end
        m[rr] = m_new;
      }
#pragma unroll
      for (int i = 0; i < OT; ++i) {
        o[i][0] *= corr[0];
        o[i][1] *= corr[0];
        o[i][2] *= corr[1];
        o[i][3] *= corr[1];
      }
      // O += P V: the score tiles of keys 16c..16c+15 are PV's A operand
#pragma unroll
      for (int c = 0; c < BKV / 16; ++c) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
        a[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
        a[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        a[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
        const int key = c * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vs + key * LD + dp * 16 + ((lane >> 4) << 3));
          mma_bf16(o[2 * dp], a, bb[0], bb[1]);
          mma_bf16(o[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();                          // this stage is refilled next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = rows_w[rr];
    if (r >= S) continue;                     // past the last partial block
    const float inv = (r < len && sum > 0.0f) ? 1.0f / sum : 0.0f;   // rows past
    bf16* orow = ob + (size_t)r * qstride;                            // len: zeros
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(orow + i * 8 + t4 * 2) =
          __floats2bfloat162_rn(o[i][2 * rr] * inv, o[i][2 * rr + 1] * inv);
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int F32_UNROLL = 4;                 // keys in flight per warp

// grid (H, B, ceil(S / NWARP)), block THREADS: one query row per warp,
// lanes split hd (EPL = HD / 32 contiguous elements each).
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ out, int S, int H, int K, int window, float scale) {
  constexpr int EPL = HD / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = (gridDim.z - 1 - blockIdx.z) * NWARP + warp;   // heaviest first
  if (i >= S) return;
  const int kh = h / (H / K);
  int len = lengths == nullptr ? S : lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  float* orow = out + (((size_t)b * S + i) * H + h) * HD + lane * EPL;
  if (i >= len) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) orow[e] = 0.0f;
    return;
  }
  const int j_lo = window > 0 ? max(0, i - window + 1) : 0;
  const int j_hi = i + 1;                     // i < len: every key <= i is live

  const float* qrow = q + (((size_t)b * S + i) * H + h) * HD + lane * EPL;
  float qr[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qr[e] = qrow[e];
  const size_t kvstride = (size_t)K * HD;
  const float* kb = k + ((size_t)b * S * K + kh) * HD + lane * EPL;
  const float* vb = v + ((size_t)b * S * K + kh) * HD + lane * EPL;

  float m = -INFINITY, l = 0.0f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.0f;
  for (int j0 = j_lo; j0 < j_hi; j0 += F32_UNROLL) {
    float kr[F32_UNROLL][EPL], vr[F32_UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < F32_UNROLL; ++u) {
      if (j0 + u < j_hi) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kr[u][e] = kb[(size_t)(j0 + u) * kvstride + e];
          vr[u][e] = vb[(size_t)(j0 + u) * kvstride + e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < F32_UNROLL; ++u) {
      if (j0 + u >= j_hi) break;              // warp-uniform
      float d = 0.0f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qr[e], kr[u][e], d);
      const float sc = warp_sum(d) * scale;
      const float m_new = fmaxf(m, sc);
      const float corr = expf(m - m_new);
      const float p = expf(sc - m_new);
      l = l * corr + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vr[u][e], acc[e] * corr);
      m = m_new;
    }
  }
  const float inv = 1.0f / l;
#pragma unroll
  for (int e = 0; e < EPL; ++e) orow[e] = acc[e] * inv;
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const int* lengths, void* out,
                int B, int S, int H, int K, int window, cudaStream_t stream) {
  static bool smem_set = false;               // once per instantiation
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bf16_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<HD>::BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid(H, B, (S + BQ - 1) / BQ);
  const float scale_log2 = LOG2E / sqrtf((float)HD);
  flash_bf16_kernel<HD><<<grid, THREADS, Smem<HD>::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lengths, static_cast<bf16*>(out), S, H, K, window,
      scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const int* lengths, void* out,
               int B, int S, int H, int K, int window, cudaStream_t stream) {
  dim3 grid(H, B, (S + NWARP - 1) / NWARP);
  flash_f32_kernel<HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, static_cast<float*>(out), S, H, K, window,
      1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, S, H, hd) = causal softmax(q k^T * hd**-0.5) v per query head,
// query head h reading KV head h / (H / K); keys limited to
// i - window < j <= i (window > 0) and j < lengths[b] (lengths non-null);
// rows i >= lengths[b] written as zeros.  Supported: H / K in {1, 2, 4, 8},
// hd in {32, 64, 128} (32: the smoke configs); q, k, v, out contiguous and
// 16-byte aligned.
int repro_flash_attention(const void* q, const void* k, const void* v, const int* lengths,
                          void* out, int B, int S, int H, int K, int hd, int window,
                          int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  const int G = H / K;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  // grid limits: y (B) and z (query blocks of 64 rows, or of 4 in f32)
  if (B > 65535 || S > 65535 * (is_bf16 ? BQ : NWARP)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (hd) {
      case 32: return launch_bf16<32>(q, k, v, lengths, out, B, S, H, K, window, s);
      case 64: return launch_bf16<64>(q, k, v, lengths, out, B, S, H, K, window, s);
      case 128: return launch_bf16<128>(q, k, v, lengths, out, B, S, H, K, window, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32: return launch_f32<32>(q, k, v, lengths, out, B, S, H, K, window, s);
    case 64: return launch_f32<64>(q, k, v, lengths, out, B, S, H, K, window, s);
    case 128: return launch_f32<128>(q, k, v, lengths, out, B, S, H, K, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
