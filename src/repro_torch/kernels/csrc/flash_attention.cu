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
//     never read), so query blocks wholly past lengths[b] do no work;
//   * a query offset (the suffix prefill of a prefix-cache hit): the Sq
//     queries are absolute positions q_offset .. q_offset + Sq - 1 of the
//     Sk = q_offset + Sq keys, as the reference's naive_attention(q_offset=)
//     defines them.  Every mask, tile range and length test above runs on
//     absolute positions; only the query and output rows are addressed
//     relative to the first query.  q_offset = 0 is the plain prefill.
// Scale hd**-0.5, f32 running max / sum / accumulator, output in q's dtype.
//
// What bounds it on an H100 at the serve shapes: tensor-core operations.
// QK^T and PV are 4 * H * hd FLOPs for every visible (query, key) pair,
// about 4 * H * hd * sum_b L_b^2 / 2 over a ragged batch, at 989 TFLOP/s in
// bf16; each of q, k, v and out is read or written once (O(S) bytes against
// O(S^2) operations), far under the 295 FLOP/byte ridge once L is in the
// hundreds.
//
// The bf16 design at hd 64 and 128 (every full-size config K4 serves):
// flash_wgmma_kernel, warp-specialised for Hopper.
//   * Work items of (query head, batch row, 128-row query block), numbered
//     heaviest (last) block first, walked by a persistent grid (one block
//     per SM takes every gridDim-th item), so the next item's loads overlap
//     this one's last products and epilogue, and a short-prompt wave (B32
//     S256: 1024 items of two to four K/V tiles) pays no block launch per
//     item.  GQA without the repeat: query head h reads KV head h / G.  The
//     G query heads of one KV head are neighbouring items and read the same
//     K/V tiles through L2 (1.8 MB a (row, KV head) at S 3584); the kernel
//     is bound by tensor-core operations, not by those reads, so one item
//     per query head keeps the work fine-grained for ragged waves.
//   * A producer warp loads each item's Q (double-buffered) and its 64-key
//     K/V tiles into a four-stage ring by TMA (4-D tensor maps straight over
//     (B, S, heads, hd): no transpose, no copy; a 256-byte hd-128 row is two
//     128-byte-swizzled boxes), completing on mbarriers.  A lone producer
//     warp (288 threads a block) keeps the consumers' S, O and P of a 64 x
//     64 tile at hd 128 within the 168 registers ptxas gives a thread.
//   * Two consumer warpgroups of 64 query rows each: S = Q K^T as wgmma
//     m64n64k16 (A = Q and B = K, both K-major in shared memory), the online
//     softmax in registers (exp2 of one FMA per score, f32 running max and
//     sum), then O += P V as wgmma with P from registers (rounded to bf16,
//     as the reference rounds the probabilities to v's dtype) and V MN-major
//     through the transpose bit.  Each warpgroup pipelines its tiles as
//     FlashAttention-3 does: tile i's QK^T and tile i-1's PV are issued back
//     to back, and tile i's softmax runs while that PV is still on the
//     tensor cores; a warp whose running max did not move skips the O
//     rescale.  The two warpgroups are not ordered against each other (no
//     ping-pong).  A warpgroup skips tiles wholly above its diagonal or
//     below its window; masking runs only on tiles that cross the diagonal,
//     the window edge or lengths[b].
// Keys at or past lengths[b] get probability exactly 0, so (finite) padded
// K/V rows change no live output bit.
//
// The first design stays for hd 32 (the smoke configs) and as the yardstick
// (repro_flash_attention): one block of four warps per (query head, batch
// row, 64-row query block); each warp owns 16 query rows.  A loop inside the
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
// dynamic shared-memory limit first.
//
// f32 inputs take a SIMT path (one warp per query row, lanes split hd, the
// decode kernel's online softmax), since mma has no exact f32 product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
// q/out (B, S, H, HD); k/v (B, q_offset + S, K, HD); lengths (B,) or null.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ lengths,
                  bf16* __restrict__ out, int S, int q_offset, int H, int K, int window,
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
  const int a0 = q_offset + q0;               // the block's first absolute position
  const int Sk = q_offset + S;
  const int kh = h / (H / K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int len = lengths == nullptr ? Sk : lengths[b];
  len = len < 0 ? 0 : (len > Sk ? Sk : len);

  const size_t qstride = (size_t)H * HD, kvstride = (size_t)K * HD;
  bf16* ob = out + ((size_t)b * S * H + h) * HD;

  if (a0 >= len) {                            // every row past the sequence
    constexpr int CH = HD / 8;
    const int rows = min(BQ, S - q0);
    for (int c = tid; c < rows * CH; c += THREADS) {
      *reinterpret_cast<uint4*>(ob + (size_t)(q0 + c / CH) * qstride + (c % CH) * 8) =
          make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int q_last = min(a0 + BQ, len) - 1;   // last live row of the block
  const int kv_lo = window > 0 ? max(0, a0 - window + 1) : 0;
  const int kb_lo = kv_lo / BKV, kb_hi = q_last / BKV + 1;

  const bf16* qg = q + ((size_t)b * S * H + h) * HD;
  const bf16* kg = k + ((size_t)b * Sk * K + kh) * HD;
  const bf16* vg = v + ((size_t)b * Sk * K + kh) * HD;

  load_tile<HD>(Qs, qg, qstride, q0, len - q_offset, tid);
  load_tile<HD>(Ks, kg, kvstride, kb_lo * BKV, len, tid);
  load_tile<HD>(Vs, vg, kvstride, kb_lo * BKV, len, tid);
  cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  const int row_w = a0 + warp * 16;           // the warp's first row (absolute)
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
    if (r - q_offset >= S) continue;          // past the last partial block
    const float inv = (r < len && sum > 0.0f) ? 1.0f / sum : 0.0f;   // rows past
    bf16* orow = ob + (size_t)(r - q_offset) * qstride;               // len: zeros
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
                 float* __restrict__ out, int S, int q_offset, int H, int K, int window,
                 float scale) {
  constexpr int EPL = HD / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = (gridDim.z - 1 - blockIdx.z) * NWARP + warp;   // heaviest first
  if (i >= S) return;
  const int ia = q_offset + i;                // the row's absolute position
  const int Sk = q_offset + S;
  const int kh = h / (H / K);
  int len = lengths == nullptr ? Sk : lengths[b];
  len = len < 0 ? 0 : (len > Sk ? Sk : len);
  float* orow = out + (((size_t)b * S + i) * H + h) * HD + lane * EPL;
  if (ia >= len) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) orow[e] = 0.0f;
    return;
  }
  const int j_lo = window > 0 ? max(0, ia - window + 1) : 0;
  const int j_hi = ia + 1;                    // ia < len: every key <= ia is live

  const float* qrow = q + (((size_t)b * S + i) * H + h) * HD + lane * EPL;
  float qr[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qr[e] = qrow[e];
  const size_t kvstride = (size_t)K * HD;
  const float* kb = k + ((size_t)b * Sk * K + kh) * HD + lane * EPL;
  const float* vb = v + ((size_t)b * Sk * K + kh) * HD + lane * EPL;

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
                int B, int S, int q_offset, int H, int K, int window, cudaStream_t stream) {
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
      static_cast<const bf16*>(v), lengths, static_cast<bf16*>(out), S, q_offset, H, K,
      window, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const int* lengths, void* out,
               int B, int S, int q_offset, int H, int K, int window, cudaStream_t stream) {
  dim3 grid(H, B, (S + NWARP - 1) / NWARP);
  flash_f32_kernel<HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, static_cast<float*>(out), S, q_offset, H, K,
      window, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}


// ------------------------------------------------------ bf16 wgmma path (K4)
constexpr int WQ = 128;          // query rows per work item: two consumer warpgroups of 64
constexpr int WKV = 64;          // keys per K/V tile
constexpr int WSTAGES = 4;       // K/V ring depth (Q is double-buffered beside it)
constexpr int W_THREADS = 288;   // consumer warpgroups 0 and 1, then the producer warp

template <int HD>
struct WgSmem {
  static constexpr int NB = HD / 64;            // 128-byte boxes per row
  static constexpr int Q_BOX = WQ * 128;        // one box of Q: 128 rows x 64 columns
  static constexpr int KV_BOX = WKV * 128;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;  // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BYTES = 1024 + 2 * Q_BYTES + WSTAGES * STAGE_BYTES + (2 * WSTAGES + 4) * 8;
};

// One work item: query head h, batch row b, query rows q0 .. q0 + WQ - 1
// (absolute positions a0 = q_offset + q0 ..); items are numbered heaviest
// (last query block) first.  len is in absolute positions.
struct Item {
  int h, b, q0, a0, len, kb_lo, ntiles;
};

__device__ __forceinline__ Item item_of(int w, const int* lengths, int S, int q_offset, int H,
                                        int B, int window) {
  const int NQ = (S + WQ - 1) / WQ;
  const int Sk = q_offset + S;
  Item it;
  it.h = w % H;
  it.b = (w / H) % B;
  it.q0 = (NQ - 1 - w / (H * B)) * WQ;
  it.a0 = q_offset + it.q0;
  int len = lengths == nullptr ? Sk : lengths[it.b];
  it.len = len < 0 ? 0 : (len > Sk ? Sk : len);
  it.kb_lo = it.ntiles = 0;
  if (it.a0 < it.len) {
    const int q_last = min(it.a0 + WQ, it.len) - 1;   // last live row
    const int kv_lo = window > 0 ? max(0, it.a0 - window + 1) : 0;
    it.kb_lo = kv_lo / WKV;
    it.ntiles = q_last / WKV + 1 - it.kb_lo;
  }
  return it;
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&p)[4], uint64_t db) {
  if constexpr (HD == 128)
    hopper::wgmma_m64n128k16_rs<1>(o, p, db, 1);
  else
    hopper::wgmma_m64n64k16_rs<1>(o, p, db, 1);
}

// A persistent grid of min(SMs, items) blocks of W_THREADS; block c takes
// items c, c + gridDim.x, ...  Dynamic smem WgSmem<HD>::BYTES.  qmap over
// q (B, S, H, HD) as 4-D (HD, H, S, B), box (64, 1, WQ, 1); kmap / vmap over
// k / v (B, Sk, K, HD) as (HD, K, Sk, B), box (64, 1, WKV, 1), Sk = q_offset
// + S.  Q boxes are addressed by query row, K/V boxes by absolute key.
template <int HD>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const int* __restrict__ lengths,
                   bf16* __restrict__ out, int B, int S, int q_offset, int H, int K,
                   int window, float scale_log2) {
  using SM = WgSmem<HD>;
  constexpr int NB = SM::NB, NT = WKV / 8, OT = HD / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* KVs = Qs + 2 * SM::Q_BYTES;    // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(KVs + WSTAGES * SM::STAGE_BYTES);
  uint64_t* empty = full + WSTAGES;
  uint64_t* qfull = empty + WSTAGES;            // [2]
  uint64_t* qempty = qfull + 2;                 // [2]

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);          // every consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&qfull[s], 1);
      hopper::mbar_init(&qempty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int n_items = H * B * ((S + WQ - 1) / WQ);
  const int G = H / K;
  const int warp = tid / 32, lane = tid % 32;

  if (warp == 8) {                              // ---- producer warp
    if (lane == 0) {
      uint32_t it = 0, qi = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
        const Item t = item_of(w, lengths, S, q_offset, H, B, window);
        if (t.ntiles == 0) continue;            // rows past the sequence: no loads
        const int qs = qi & 1;
        hopper::mbar_wait(&qempty[qs], ((qi >> 1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&qfull[qs], SM::Q_BYTES);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          hopper::tma_load_4d(Qs + qs * SM::Q_BYTES + c * SM::Q_BOX, &qmap, &qfull[qs], 64 * c,
                              t.h, t.q0, t.b);
        ++qi;
        for (int i = 0; i < t.ntiles; ++i, ++it) {
          const int s = it % WSTAGES;
          hopper::mbar_wait(&empty[s], ((it / WSTAGES) & 1) ^ 1);
          unsigned char* st = KVs + s * SM::STAGE_BYTES;
          const int k0 = (t.kb_lo + i) * WKV;
          hopper::mbar_arrive_expect_tx(&full[s], SM::STAGE_BYTES);
#pragma unroll
          for (int c = 0; c < NB; ++c) {
            hopper::tma_load_4d(st + c * SM::KV_BOX, &kmap, &full[s], 64 * c, t.h / G, k0, t.b);
            hopper::tma_load_4d(st + SM::KV_BYTES + c * SM::KV_BOX, &vmap, &full[s], 64 * c,
                                t.h / G, k0, t.b);
          }
        }
      }
    }
  } else {                                      // ---- consumer warpgroup wg
    const int wg = warp / 4, wq = warp % 4;
    const int g = lane >> 2, t4 = lane & 3;
    const size_t qstride = (size_t)H * HD;
    uint32_t it = 0, qi = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
      const Item t = item_of(w, lengths, S, q_offset, H, B, window);
      const int rw0 = t.a0 + wg * 64;           // the warpgroup's first row (absolute)
      bf16* ob = out + ((size_t)t.b * S * H + t.h) * HD;
      if (t.ntiles == 0) {                      // every row past the sequence
        constexpr int CH = HD / 8;
        const int rl0 = t.q0 + wg * 64;         // ... as a query row
        const int rows = max(0, min(64, S - rl0));
        for (int c = tid % 128; c < rows * CH; c += 128)
          *reinterpret_cast<uint4*>(ob + (size_t)(rl0 + c / CH) * qstride + (c % CH) * 8) =
              make_uint4(0, 0, 0, 0);
        continue;
      }
      const int q_last = min(t.a0 + WQ, t.len) - 1;
      const int rows_t[2] = {rw0 + wq * 16 + g, rw0 + wq * 16 + g + 8};
      const int qs = qi & 1;
      const unsigned char* qsm = Qs + qs * SM::Q_BYTES + wg * 8192;   // this warpgroup's rows
      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.0f, 0.0f};
      float sc[WKV / 2];
      uint32_t p[WKV / 16][4];
      float corr[2];

      // the warpgroup's live tiles i_lo .. i_hi - 1: tiles wholly above its
      // diagonal (or all, past lengths[b]) and wholly older than its first
      // row's window are only waited for and released, to keep the ring's
      // phases
      const uint32_t base = it;
      const int i_hi = rw0 <= q_last ? min(t.ntiles, (rw0 + 63) / WKV + 1 - t.kb_lo) : 0;
      int i_lo = 0;
      while (window > 0 && i_lo < i_hi && (t.kb_lo + i_lo) * WKV + WKV - 1 <= rw0 - window)
        ++i_lo;
      auto stage = [&](int i) { return (int)((base + i) % WSTAGES); };
      auto wait_tile = [&](int i) {
        hopper::mbar_wait(&full[stage(i)], ((base + i) / WSTAGES) & 1);
      };
      auto release = [&](int i) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[stage(i)]);
      };
      auto issue_s = [&](int i) {                // S = Q K_i^T, 64 x WKV
        const unsigned char* ks = KVs + stage(i) * SM::STAGE_BYTES;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = kk / 4, c16 = kk % 4;   // box, 16-column slice in it
          const uint64_t da = hopper::desc_sw128(qsm + c * SM::Q_BOX + c16 * 32, 16, 1024);
          const uint64_t db = hopper::desc_sw128(ks + c * SM::KV_BOX + c16 * 32, 16, 1024);
          hopper::wgmma_m64n64k16_ss<0>(sc, da, db, kk > 0);
        }
        hopper::wgmma_commit();
      };
      auto issue_pv = [&](int i) {               // O = O * corr + P V_i
        // a warp whose rows kept their running max skips the rescale (a
        // product by 1.0): past the first tiles of a row that is most tiles
        if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
          for (int j = 0; j < OT; ++j) {
            o[4 * j] *= corr[0];
            o[4 * j + 1] *= corr[0];
            o[4 * j + 2] *= corr[1];
            o[4 * j + 3] *= corr[1];
          }
        }
        const unsigned char* vs = KVs + stage(i) * SM::STAGE_BYTES + SM::KV_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < WKV / 16; ++c)
          wgmma_pv<HD>(o, p[c], hopper::desc_sw128(vs + c * 2048, SM::KV_BOX, 1024));
        hopper::wgmma_commit();
      };
      // mask and online softmax of tile i's scores in place (two rows per
      // thread, g and g + 8; the four threads of a quad share a row); corr
      // rescales O before the tile's PV.  The running max m is kept in
      // log2 units (scores times scale_log2); since the scale is positive,
      // the max of the raw scores times it is the max of the scaled ones, and
      // exp2(s * scale_log2 - m) is one FMA and one exp2 per score.
      auto softmax = [&](int i) {
        const int k0 = (t.kb_lo + i) * WKV;
        const bool need_mask = k0 + WKV - 1 > rw0 || k0 + WKV > t.len ||
                               (window > 0 && k0 <= rw0 + 63 - window);
        if (need_mask) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + j * 8 + t4 * 2 + (e & 1);
              const int r = rows_t[e >> 1];
              const bool ok = col <= r && col < t.len && (window <= 0 || r - col < window);
              sc[4 * j + e] = ok ? sc[4 * j + e] : -INFINITY;
            }
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * rr], sc[4 * j + 2 * rr + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[rr], mx * scale_log2);
          const float m_use = m_new == -INFINITY ? 0.0f : m_new;
          corr[rr] = exp2f(m[rr] - m_use);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            sc[4 * j + 2 * rr] = exp2f(fmaf(sc[4 * j + 2 * rr], scale_log2, -m_use));
            sc[4 * j + 2 * rr + 1] = exp2f(fmaf(sc[4 * j + 2 * rr + 1], scale_log2, -m_use));
            sum += sc[4 * j + 2 * rr] + sc[4 * j + 2 * rr + 1];
          }
          l[rr] = l[rr] * corr[rr] + sum;       // per-thread partial, summed at the end
          m[rr] = m_new;
        }
      };
      // the probabilities, rounded to bf16, as PV's A operand: keys
      // 16c..16c+15 are the c-th k16 fragment (the m16n8k16 layout)
      auto take_p = [&]() {
#pragma unroll
        for (int c = 0; c < WKV / 16; ++c) {
          p[c][0] = pack_bf16(sc[8 * c], sc[8 * c + 1]);
          p[c][1] = pack_bf16(sc[8 * c + 2], sc[8 * c + 3]);
          p[c][2] = pack_bf16(sc[8 * c + 4], sc[8 * c + 5]);
          p[c][3] = pack_bf16(sc[8 * c + 6], sc[8 * c + 7]);
        }
      };

      hopper::mbar_wait(&qfull[qs], (qi >> 1) & 1);
      for (int i = 0; i < i_lo; ++i) {
        wait_tile(i);
        release(i);
      }
      if (i_lo < i_hi) {
        // Software pipeline (FlashAttention-3's intra-warpgroup overlap): the
        // tensor cores run tile i's QK^T and tile i-1's PV back to back while
        // this warpgroup waits only for QK^T, so the softmax of tile i runs
        // beside the PV still in flight.  O is rescaled between the two
        // issues and P is rebuilt only once both products have retired, so
        // no register of a product in flight is written.
        wait_tile(i_lo);
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
        issue_s(i_lo);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        softmax(i_lo);                            // O is zero: corr is harmless
        take_p();
        for (int i = i_lo + 1; i < i_hi; ++i) {
          wait_tile(i);
          hopper::fence_regs(sc);
          hopper::fence_regs(o);
          hopper::wgmma_fence();
          issue_s(i);
          issue_pv(i - 1);
          hopper::wgmma_wait<1>();                // S_i is in; PV_{i-1} may run on
          hopper::fence_regs(sc);
          softmax(i);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(o);
          release(i - 1);
          take_p();
        }
        hopper::fence_regs(o);
        issue_pv(i_hi - 1);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        release(i_hi - 1);
      }
      for (int i = max(i_hi, i_lo); i < t.ntiles; ++i) {
        wait_tile(i);
        release(i);
      }
      it = base + t.ntiles;
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&qempty[qs]);   // every S of this item is done
      ++qi;

#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float sum = l[rr];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int r = rows_t[rr];
        if (r - q_offset >= S) continue;        // past the last partial block
        const float inv = (r < t.len && sum > 0.0f) ? 1.0f / sum : 0.0f;   // rows past
        bf16* orow = ob + (size_t)(r - q_offset) * qstride;                 // len: zeros
#pragma unroll
        for (int j = 0; j < OT; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + t4 * 2) =
              __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
        }
      }
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const int* lengths, void* out,
                 int B, int S, int q_offset, int H, int K, int window, cudaStream_t stream) {
  using SM = WgSmem<HD>;
  static bool smem_set = false;               // once per instantiation
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_wgmma_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SM::BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  CUtensorMap qm, km, vm;
  const uint64_t qd[4] = {HD, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t qs[3] = {HD * 2, (uint64_t)H * HD * 2, (uint64_t)S * H * HD * 2};
  const uint32_t qb[4] = {64, 1, WQ, 1};
  const uint64_t Sk = (uint64_t)q_offset + S;
  const uint64_t kd[4] = {HD, (uint64_t)K, Sk, (uint64_t)B};
  const uint64_t ks[3] = {HD * 2, (uint64_t)K * HD * 2, Sk * K * HD * 2};
  const uint32_t kb[4] = {64, 1, WKV, 1};
  if (!hopper_host::make_map_bf16(&qm, q, 4, qd, qs, qb) ||
      !hopper_host::make_map_bf16(&km, k, 4, kd, ks, kb) ||
      !hopper_host::make_map_bf16(&vm, v, 4, kd, ks, kb))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)H * B * ((S + WQ - 1) / WQ);
  const int grid = (int)(items < hopper_host::sm_count() ? items : hopper_host::sm_count());
  const float scale_log2 = LOG2E / sqrtf((float)HD);
  flash_wgmma_kernel<HD><<<grid, W_THREADS, SM::BYTES, stream>>>(
      qm, km, vm, lengths, static_cast<bf16*>(out), B, S, q_offset, H, K, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, S, H, hd) = causal softmax(q k^T * hd**-0.5) v per query head,
// query head h reading KV head h / (H / K) of k, v (B, q_offset + S, K, hd);
// query row r is absolute position i = q_offset + r; keys limited to
// i - window < j <= i (window > 0) and j < lengths[b] (lengths non-null);
// rows with i >= lengths[b] written as zeros.  Supported: H / K in {1, 2, 4,
// 8}, hd in {32, 64, 128} (32: the smoke configs); q, k, v, out contiguous
// and 16-byte aligned.
int repro_flash_attention(const void* q, const void* k, const void* v, const int* lengths,
                          void* out, int B, int S, int H, int K, int hd, int window,
                          int q_offset, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || q_offset < 0 ||
      (long long)q_offset + S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  // grid limits: y (B) and z (query blocks of 64 rows, or of 4 in f32)
  if (B > 65535 || S > 65535 * (is_bf16 ? BQ : NWARP)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (hd) {
      case 32: return launch_bf16<32>(q, k, v, lengths, out, B, S, q_offset, H, K, window, s);
      case 64: return launch_bf16<64>(q, k, v, lengths, out, B, S, q_offset, H, K, window, s);
      case 128:
        return launch_bf16<128>(q, k, v, lengths, out, B, S, q_offset, H, K, window, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32: return launch_f32<32>(q, k, v, lengths, out, B, S, q_offset, H, K, window, s);
    case 64: return launch_f32<64>(q, k, v, lengths, out, B, S, q_offset, H, K, window, s);
    case 128: return launch_f32<128>(q, k, v, lengths, out, B, S, q_offset, H, K, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same in bf16 through flash_wgmma_kernel, hd in {64, 128}; returns
// cudaErrorInvalidValue for anything else (or a shape TMA cannot map),
// never another design.
int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                const int* lengths, void* out, int B, int S, int H, int K,
                                int hd, int window, int q_offset, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || q_offset < 0 ||
      (long long)q_offset + S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
  if (G != 1 && G != 2 && G != 4 && G != 8) return (int)cudaErrorInvalidValue;
  if ((long long)H * B * ((S + WQ - 1) / WQ) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_wgmma<64>(q, k, v, lengths, out, B, S, q_offset, H, K, window, s);
    case 128: return launch_wgmma<128>(q, k, v, lengths, out, B, S, q_offset, H, K, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
