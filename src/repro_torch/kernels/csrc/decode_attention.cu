// GQA decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces src/repro/kernels/decode_attention.py::_decode_attn_kernel: one
// new query per sequence against a (B, S, K, hd) KV cache, the G = H/K query
// heads of a KV head computed together, online softmax in f32, scale
// hd**-0.5.  Unlike the Pallas kernel's scalar position, each row b has its
// own pos[b] (the engine decodes ragged slots): the n = min(pos[b] + 1, S)
// slots 0..n-1 are valid (under a sliding-window ring pos >= S makes every
// slot valid), and a row with pos[b] < 0 has none and writes zeros.
//
// What bounds it on an H100: the KV bytes of the valid slots (each K and V
// element is read once and used for G query heads), far below the tensor
// cores' operation rate.  So the work has to be spread over enough blocks
// to keep the card's memory busy, and the per-slot instruction chain of a
// SIMT online softmax must stay short of the memory time.
//
// The bf16 design at hd 64 and 128 (every served shape): split-KV.
//   * Each row's slots are cut into splits of split_len (256) slots by slot
//     index alone, ceil(S / split_len) of them; one block of four warps per
//     (split, KV head, row).  The partition never depends on pos (on the
//     device: no host sync), on B or on the SM count, so a row's output is
//     bit-identical whatever the micro-batch around it (the static and
//     continuous schedulers form different micro-batches and must give the
//     same tokens).  A block whose split starts at or past n returns at
//     once and reads nothing.
//   * A row whose n valid slots fit one split (every row of a short cache)
//     is finished by that one block.  Otherwise each of its nv splits
//     writes its partial softmax state (running max m, sum l, unnormalised
//     accumulator) to f32 scratch and takes an int32 ticket; the nv-th
//     arrival merges the row's partials by log-sum-exp in split order and
//     resets the ticket to zero.  The atomic only counts arrivals, so the
//     sums do not depend on which block merges.  One launch: a second merge
//     kernel cost more than the first design's whole time at the serve
//     span (0.0229 against 0.0196 ms on an H100 80GB HBM3 at 700 W).
//   * Inside a block, the split's 32-slot K/V tiles go to shared memory by
//     16-byte cp.async in a three-stage ring (slots past n zero-filled,
//     never read): 52 KB at hd 128, four blocks an SM.  S = Q K^T runs as
//     mma.sync m16n8k16 with the G query heads in M (padded to 16 with zero
//     rows) and the slots in N; every warp computes the whole score tile
//     (the tensor cores are idle here) so the four warps agree on the
//     tile's max without a barrier, and each warp then takes a quarter of
//     hd for O += P V.  One max and one rescale per tile, not one per slot.
//     32-slot tiles in three stages beat 64-slot tiles in two by 20% at the
//     serve span and lose 1% at span 3648 (the same card).
//   * The probabilities go into PV as two bf16 terms, P = P_hi + P_lo
//     (P_hi = bf16(P), P_lo = bf16(P - P_hi)): about 16 significant bits,
//     P's error below 2**-17 of P, against the first design's f32 P (the
//     output is rounded to bf16, 2**-9, in the end).
// The first design stays for f32 (exact to f32), hd 32 (the smoke configs)
// and as the yardstick (repro_decode_attention): one block per (b, kv-head),
// four warps striding over the valid slots only, each lane holding hd/32
// contiguous elements of a K/V row so a warp reads a whole row in one
// coalesced request; four slots are loaded per step to keep loads in
// flight.  Each warp keeps its own running max/sum/accumulator per query
// head; the four partial states merge by log-sum-exp in shared memory.
//
// The paged variant (K3p, repro_decode_attention_paged[_split]) is the same
// two designs reading K and V through a page table instead of a (B, S, K, hd)
// cache: slot s of row b sits at offset s % pt of frame frames[b, s / pt],
// which indexes the device pool's P + 1 frames (the last is the null frame)
// and then the frames of the layer's host pool that the stream window copied
// to the device.  The address is worked out per slot for each 16-byte load,
// so any page size works; everything else -- the split partition, the tiles,
// the order of every sum -- is K3's, so K3p's output is bit-identical to
// K3's on the gathered contiguous copy of the same slots.
//
// Numerics: the first design keeps the probabilities in f32 through the PV
// product.  The JAX attn_decode (models/attention.py) casts them to the
// cache dtype first, so the two agree exactly in f32 and differ by bf16
// rounding in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NW = 4;        // warps per block
constexpr int UNROLL = 4;    // slots in flight per warp

template <typename T, int EPL>
struct Vec;

template <> struct Vec<float, 1> {
  __device__ static void load(const float* p, float* o) { o[0] = *p; }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};
template <> struct Vec<float, 2> {
  __device__ static void load(const float* p, float* o) {
    float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <> struct Vec<float, 4> {
  __device__ static void load(const float* p, float* o) {
    float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<bf16, 1> {
  __device__ static void load(const bf16* p, float* o) { o[0] = __bfloat162float(*p); }
  __device__ static void store(bf16* p, const float* v) { *p = __float2bfloat16(v[0]); }
};
template <> struct Vec<bf16, 2> {
  __device__ static void load(const bf16* p, float* o) {
    float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = t.x; o[1] = t.y;
  }
  __device__ static void store(bf16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};
template <> struct Vec<bf16, 4> {
  __device__ static void load(const bf16* p, float* o) {
    uint2 t = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  __device__ static void store(bf16* p, const float* v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned int*>(&a);
    t.y = *reinterpret_cast<const unsigned int*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Where the K and V of one slot live.  at(b, s, off) gives the K and V
// pointers of slot s of row b, `off` elements into the slot (KV head and
// column); a slot is K * HD elements (`stride`).
template <typename T>
struct ContigKV {                          // a (B, S, K, HD) cache
  const T* k;
  const T* v;
  int S;
  size_t stride;
  __device__ __forceinline__ const T* base() const { return k; }
  __device__ __forceinline__ void at(int b, int s, size_t off, const T*& kp,
                                     const T*& vp) const {
    const size_t o = ((size_t)b * S + s) * stride + off;
    kp = k + o;
    vp = v + o;
  }
};

template <typename T>
struct PagedKV {                           // a page table over two frame sets
  const T* pk;                             // the device pool, (p1, pt, K, HD)
  const T* pv;
  const T* ek;                             // the window's frames, (., pt, K, HD)
  const T* ev;
  const int* frames;                       // (rows, pages): < p1 the pool, else
  int pages, pt, p1;                       //   frame f - p1 of the window
  size_t stride;
  __device__ __forceinline__ const T* base() const { return pk; }
  __device__ __forceinline__ void at(int b, int s, size_t off, const T*& kp,
                                     const T*& vp) const {
    const int pg = s / pt;
    const int f = __ldg(frames + (size_t)b * pages + pg);
    const size_t slot = (size_t)(s - pg * pt);
    if (f < p1) {
      const size_t o = ((size_t)f * pt + slot) * stride + off;
      kp = pk + o;
      vp = pv + o;
    } else {
      const size_t o = ((size_t)(f - p1) * pt + slot) * stride + off;
      kp = ek + o;
      vp = ev + o;
    }
  }
};

// grid (K, B), block NW*32.  q/out (B, H, hd); the K/V slots through `kv`
// (S of them per row); pos (B,).
template <typename T, int G, int EPL, class KV>
__global__ void __launch_bounds__(NW * 32)
decode_attn_kernel(const T* __restrict__ q, const KV kv, const int* __restrict__ pos,
                   T* __restrict__ out, int S, int K, float scale) {
  constexpr int HD = EPL * 32;
  __shared__ float sm_m[NW][G];
  __shared__ float sm_l[NW][G];
  __shared__ float sm_acc[NW][G][HD];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int H = K * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = pos[b];
  const int n = p < 0 ? 0 : (p + 1 < S ? p + 1 : S);   // valid slots 0..n-1

  float qr[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
    Vec<T, EPL>::load(q + ((size_t)b * H + kh * G + g) * HD + lane * EPL, qr[g]);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.0f;
  }

  const size_t off = (size_t)kh * HD + lane * EPL;       // this lane's columns

  for (int base = warp; base < n; base += NW * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      int s = base + u * NW;
      if (s < n) {
        const T *kp, *vp;
        kv.at(b, s, off, kp, vp);
        Vec<T, EPL>::load(kp, kr[u]);
        Vec<T, EPL>::load(vp, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * NW >= n) break;                    // warp-uniform
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) d = fmaf(qr[g][i], kr[u][i], d);
        const float sc = warp_sum(d) * scale;
        const float m_new = fmaxf(m[g], sc);
        const float corr = expf(m[g] - m_new);
        const float pe = expf(sc - m_new);
        l[g] = l[g] * corr + pe;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] = fmaf(pe, vr[u][i], acc[g][i] * corr);
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) sm_acc[warp][g][lane * EPL + i] = acc[g][i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * HD; idx += NW * 32) {
    const int g = idx / HD, d = idx % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.0f, A = 0.0f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (sm_m[w][g] == -INFINITY) continue;
        const float f = expf(sm_m[w][g] - M);
        L += sm_l[w][g] * f;
        A += sm_acc[w][g][d] * f;
      }
    }
    float y = M == -INFINITY ? 0.0f : A / fmaxf(L, 1e-30f);
    Vec<T, 1>::store(out + ((size_t)b * H + kh * G + g) * HD + d, &y);
  }
}

template <typename T, int G, class KV>
int dispatch_hd(const void* q, const KV& kv, const int* pos, void* out, int B, int K, int S,
                int hd, cudaStream_t stream) {
  dim3 grid(K, B);
  const float scale = 1.0f / sqrtf((float)hd);
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32: decode_attn_kernel<T, G, 1, KV><<<grid, NW * 32, 0, stream>>>(qt, kv, pos, ot, S, K, scale); break;
    case 64: decode_attn_kernel<T, G, 2, KV><<<grid, NW * 32, 0, stream>>>(qt, kv, pos, ot, S, K, scale); break;
    case 128: decode_attn_kernel<T, G, 4, KV><<<grid, NW * 32, 0, stream>>>(qt, kv, pos, ot, S, K, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, class KV>
int dispatch_g(const void* q, const KV& kv, const int* pos, void* out, int B, int G, int K,
               int S, int hd, cudaStream_t stream) {
  switch (G) {
    case 1: return dispatch_hd<T, 1>(q, kv, pos, out, B, K, S, hd, stream);
    case 2: return dispatch_hd<T, 2>(q, kv, pos, out, B, K, S, hd, stream);
    case 4: return dispatch_hd<T, 4>(q, kv, pos, out, B, K, S, hd, stream);
    case 8: return dispatch_hd<T, 8>(q, kv, pos, out, B, K, S, hd, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// --------------------------------------------------- bf16 split-KV design
constexpr int TILE = 32;                  // slots per K/V tile
constexpr int KV_STAGES = 3;              // depth of the cp.async ring
constexpr int SPLIT_WARPS = 4;
constexpr int SPLIT_THREADS = SPLIT_WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

template <int HD>
struct SplitSmem {
  static constexpr int LD = HD + 8;       // padded row: ldmatrix rows hit distinct banks
  static constexpr int TILE_ELEMS = TILE * LD;
  static constexpr int BYTES = KV_STAGES * 2 * TILE_ELEMS * 2;   // K and V per stage
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;            // 0 source bytes: the 16 bytes are zero-filled
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

// (x0, x1) as two packed bf16 pairs hi + lo: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Stage slots [s0, s0 + TILE) of one (row, KV head)'s K and V into shared
// memory; slots at or past n are zero-filled and never read.
template <int HD, class KV>
__device__ __forceinline__ void stage_tile(bf16* ks, bf16* vs, const KV& kv, int b,
                                           size_t off, int s0, int n, int tid) {
  constexpr int CH = HD / 8;              // 16-byte chunks per slot
  constexpr int LD = SplitSmem<HD>::LD;
#pragma unroll
  for (int c = tid; c < TILE * CH; c += SPLIT_THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = s0 + r < n;
    const bf16 *kp = nullptr, *vp = nullptr;
    if (ok) kv.at(b, s0 + r, off + col, kp, vp);
    cp_async16(ks + r * LD + col, ok ? kp : kv.base(), ok);
    cp_async16(vs + r * LD + col, ok ? vp : kv.base(), ok);
  }
}

// grid (nsplit, K, B), block SPLIT_THREADS, dynamic smem SplitSmem<HD>::BYTES
// (or the merge's 2 G nsplit + G floats where that is more).
// q/out (B, H, HD); the K/V slots through `kv` (S of them per row); pos
// (B,).  Block (split, kh, b)
// computes split `split` of the G query heads of KV head kh in row b.  A row
// whose n valid slots fill nv = ceil(n / split_len) splits: with nv == 1 the
// one block writes out directly; otherwise each of the nv blocks writes its
// partial state, acc (B, H, nsplit, HD) and ml (B, H, nsplit) = {max of the
// scores times scale * log2(e), sum of exp2(score - max)}, and takes a
// ticket (B, K) int32, zero between launches; the nv-th arrival merges the
// row's partials by log-sum-exp in split order and resets the ticket.
// Splits at or past n return at once (split 0 writes zeros when n == 0).
template <int G, int HD, class KV>
__global__ void __launch_bounds__(SPLIT_THREADS)
decode_split_kernel(const bf16* __restrict__ q, const KV kv, const int* __restrict__ pos,
                    bf16* __restrict__ out, float* __restrict__ acc_part,
                    float2* __restrict__ ml_part, int* __restrict__ tickets, int S, int K,
                    int split_len, float scale_log2) {
  static_assert(HD == 64 || HD == 128, "the split design is built for hd 64 and 128");
  static_assert(G <= 8, "the G query heads fill rows 0..7 of mma's 16");
  static_assert(TILE % 16 == 0 && KV_STAGES >= 2, "whole k16 steps, a real ring");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using SM = SplitSmem<HD>;
  constexpr int LD = SM::LD;
  constexpr int NT = TILE / 8;            // score n-tiles of 8 slots
  constexpr int WCOLS = HD / SPLIT_WARPS; // columns of O a warp owns
  constexpr int OT = WCOLS / 8;           // its O n-tiles
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [KV_STAGES][TILE_ELEMS]
  bf16* Vs = Ks + KV_STAGES * SM::TILE_ELEMS;     // [KV_STAGES][TILE_ELEMS]

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x, H = K * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;       // mma fragment row and column pair
  const int p = pos[b];
  const int n = p < 0 ? 0 : (p + 1 < S ? p + 1 : S);
  const int s0 = split * split_len;
  const size_t head0 = (size_t)b * H + kh * G;  // this block's first (row, head)
  if (s0 >= n) {                                // nothing of this split is valid
    if (n == 0 && split == 0)
      for (int i = tid; i < G * HD; i += SPLIT_THREADS) out[head0 * HD + i] = __float2bfloat16(0.0f);
    return;
  }
  const int nv = (n + split_len - 1) / split_len;
  const int s_end = min(s0 + split_len, n);
  const int ntiles = (s_end - s0 + TILE - 1) / TILE;
  const size_t off = (size_t)kh * HD;           // this KV head's columns

#pragma unroll
  for (int st = 0; st < KV_STAGES - 1; ++st) {  // prologue: fill the ring
    if (st < ntiles)
      stage_tile<HD>(Ks + st * SM::TILE_ELEMS, Vs + st * SM::TILE_ELEMS, kv, b, off,
                     s0 + st * TILE, n, tid);
    cp_async_commit();
  }

  // Q as mma's A operand: row g is query head g; rows G..15 are zero
  uint32_t qa[HD / 16][2];
  {
    const bf16* qr = q + (head0 + (g < G ? g : 0)) * HD + 2 * t4;
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      qa[t][0] = g < G ? *reinterpret_cast<const uint32_t*>(qr + 16 * t) : 0u;
      qa[t][1] = g < G ? *reinterpret_cast<const uint32_t*>(qr + 16 * t + 8) : 0u;
    }
  }

  float o[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m = -INFINITY;                          // row g's running max (scaled, log2)
  float l = 0.0f;                               // this thread's share of its sum

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<KV_STAGES - 2>();             // tile i has landed
    __syncthreads();                            // ...for all, and tile i - 1 is done
    const int pre = i + KV_STAGES - 1;          // refill the stage tile i - 1 used
    if (pre < ntiles) {
      const int st = pre % KV_STAGES;
      stage_tile<HD>(Ks + st * SM::TILE_ELEMS, Vs + st * SM::TILE_ELEMS, kv, b, off,
                     s0 + pre * TILE, n, tid);
    }
    cp_async_commit();
    const bf16* ks = Ks + (i % KV_STAGES) * SM::TILE_ELEMS;
    const bf16* vs = Vs + (i % KV_STAGES) * SM::TILE_ELEMS;
    const int t0 = s0 + i * TILE;

    // S = Q K^T over the tile's slots, the whole tile in every warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      const uint32_t a[4] = {qa[t][0], 0u, qa[t][1], 0u};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bb, ks + key * LD + 16 * t + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // one max and one rescale for the tile (rows 8..15 are padding: only
    // s[.][0..1], row g, are used)
    const bool need_mask = t0 + TILE > s_end;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask && t0 + j * 8 + 2 * t4 + e >= s_end) x = -INFINITY;
        s[j][e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    const float corr = exp2f(m - m_use);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - m_use);
      s[j][1] = exp2f(s[j][1] - m_use);
      sum += s[j][0] + s[j][1];
    }
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int i2 = 0; i2 < OT; ++i2) {
      o[i2][0] *= corr;
      o[i2][1] *= corr;
    }
    // O += P V on this warp's WCOLS columns, P as hi + lo bf16 terms
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * c][0], s[2 * c][1], hi[0], lo[0]);
      split_bf16(s[2 * c + 1][0], s[2 * c + 1][1], hi[2], lo[2]);
      hi[1] = hi[3] = lo[1] = lo[3] = 0u;
      const int key = c * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vs + key * LD + warp * WCOLS + dp * 16 + ((lane >> 4) << 3));
        mma_bf16(o[2 * dp], hi, bb[0], bb[1]);
        mma_bf16(o[2 * dp + 1], hi, bb[2], bb[3]);
        mma_bf16(o[2 * dp], lo, bb[0], bb[1]);
        mma_bf16(o[2 * dp + 1], lo, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();

  l += __shfl_xor_sync(FULL, l, 1);
  l += __shfl_xor_sync(FULL, l, 2);
  const int col = warp * WCOLS + 2 * t4;
  if (nv == 1) {                                // the row's only split: normalise
    if (g < G) {
      bf16* orow = out + (head0 + g) * HD + col;
#pragma unroll
      for (int i = 0; i < OT; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
            __floats2bfloat162_rn(o[i][0] / l, o[i][1] / l);
    }
    return;
  }
  if (g < G) {
    const size_t ph = (head0 + g) * nsplit + split;
#pragma unroll
    for (int i = 0; i < OT; ++i)
      *reinterpret_cast<float2*>(acc_part + ph * HD + col + 8 * i) =
          make_float2(o[i][0], o[i][1]);
    if (warp == 0 && t4 == 0) ml_part[ph] = make_float2(m, l);
  }
  // the ticket: the row's last split to arrive merges (atomics count
  // arrivals only; every sum is taken in split order)
  __shared__ int last;
  __threadfence();                              // this block's partials, device-wide
  __syncthreads();
  if (tid == 0) last = atomicAdd(&tickets[(size_t)b * K + kh], 1) == nv - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each split's weight exp2(m - M) and each head's sum L first, in shared
  // memory (the ring is free), so the accumulator loads below are independent
  float* fac = reinterpret_cast<float*>(smem_raw);  // [G][nv] m, then weights
  float* sl = fac + G * nv;                        // [G][nv] l
  float* sL = sl + G * nv;                         // [G]
  for (int idx = tid; idx < G * nv; idx += SPLIT_THREADS) {
    const float2 e = __ldcg(&ml_part[(head0 + idx / nv) * nsplit + idx % nv]);
    fac[idx] = e.x;
    sl[idx] = e.y;
  }
  __syncthreads();
  if (tid < G) {
    float M = -INFINITY, L = 0.0f;
    for (int sp = 0; sp < nv; ++sp) M = fmaxf(M, fac[tid * nv + sp]);
    for (int sp = 0; sp < nv; ++sp) {
      const float f = exp2f(fac[tid * nv + sp] - M);
      fac[tid * nv + sp] = f;
      L += sl[tid * nv + sp] * f;
    }
    sL[tid] = L;
  }
  __syncthreads();
  for (int idx = tid; idx < G * HD; idx += SPLIT_THREADS) {
    const int h = idx / HD, d = idx % HD;
    const float* a = acc_part + (head0 + h) * nsplit * HD + d;
    float A = 0.0f;
#pragma unroll 4
    for (int sp = 0; sp < nv; ++sp) A += __ldcg(a + (size_t)sp * HD) * fac[h * nv + sp];
    out[(head0 + h) * HD + d] = __float2bfloat16(A / sL[h]);
  }
  if (tid == 0) tickets[(size_t)b * K + kh] = 0;  // zero for the next launch
}

template <int G, int HD, class KV>
int launch_split(const void* q, const KV& kv, const int* pos, void* out, float* part,
                 int* tickets, int B, int K, int S, int split_len, cudaStream_t stream) {
  const int nsplit = (S + split_len - 1) / split_len;
  const int H = K * G;
  // the ring, or the merge's 2 G nsplit + G floats where that is more
  const size_t merge_bytes = (size_t)(2 * nsplit + 1) * G * sizeof(float);
  const int smem = (int)(merge_bytes > SplitSmem<HD>::BYTES ? merge_bytes : SplitSmem<HD>::BYTES);
  static int smem_set = 0;                      // per instantiation: the limit set
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(decode_split_kernel<G, HD, KV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  float2* ml = reinterpret_cast<float2*>(part + (size_t)B * H * nsplit * HD);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  decode_split_kernel<G, HD, KV><<<dim3(nsplit, K, B), SPLIT_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), kv, pos, static_cast<bf16*>(out), part, ml, tickets, S, K,
      split_len, scale_log2);
  return (int)cudaGetLastError();
}

template <class KV>
int split_dispatch(const void* q, const KV& kv, const int* pos, void* out, float* part,
                   int* tickets, int B, int H, int K, int S, int hd, int split_len,
                   cudaStream_t s) {
  if (B <= 0 || K <= 0 || S <= 0 || H % K != 0 || split_len <= 0 || split_len % TILE)
    return (int)cudaErrorInvalidValue;
  const int G = H / K;
#define REPRO_SPLIT_HD(GG)                                                                   \
  switch (hd) {                                                                             \
    case 64: return launch_split<GG, 64>(q, kv, pos, out, part, tickets, B, K, S, split_len, s); \
    case 128: return launch_split<GG, 128>(q, kv, pos, out, part, tickets, B, K, S, split_len, s); \
    default: return (int)cudaErrorInvalidValue;                                              \
  }
  switch (G) {
    case 1: REPRO_SPLIT_HD(1)
    case 2: REPRO_SPLIT_HD(2)
    case 4: REPRO_SPLIT_HD(4)
    case 8: REPRO_SPLIT_HD(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_SPLIT_HD
}

template <typename T>
ContigKV<T> contig(const void* k, const void* v, int S, int K, int hd) {
  return ContigKV<T>{static_cast<const T*>(k), static_cast<const T*>(v), S, (size_t)K * hd};
}

template <typename T>
PagedKV<T> paged(const void* pk, const void* pv, const void* ek, const void* ev,
                 const int* frames, int pages, int pt, int p1, int K, int hd) {
  return PagedKV<T>{static_cast<const T*>(pk), static_cast<const T*>(pv),
                    static_cast<const T*>(ek), static_cast<const T*>(ev), frames, pages, pt, p1,
                    (size_t)K * hd};
}

}  // namespace

extern "C" {

// out (B, H, hd) = softmax(q k^T * hd**-0.5 over slots <= pos[b]) v; the
// first design.  Supported: H / K in {1, 2, 4, 8}, hd in {32, 64, 128}.
int repro_decode_attention(const void* q, const void* k, const void* v, const int* pos,
                           void* out, int B, int H, int K, int S, int hd, int is_bf16,
                           void* stream) {
  if (B <= 0 || K <= 0 || S <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  return is_bf16 ? dispatch_g<bf16>(q, contig<bf16>(k, v, S, K, hd), pos, out, B, G, K, S, hd, s)
                 : dispatch_g<float>(q, contig<float>(k, v, S, K, hd), pos, out, B, G, K, S, hd, s);
}

// The bf16 split-KV design: the same function for hd in {64, 128}.  `part`
// is f32 scratch of B * H * ceil(S / split_len) * (hd + 2) floats (the
// partials); `tickets` is B * K int32, zero before the launch and zero again
// after it (the kernel resets what it uses); split_len is a multiple of the
// 32-slot tile.
int repro_decode_attention_split(const void* q, const void* k, const void* v, const int* pos,
                                 void* out, float* part, int* tickets, int B, int H, int K,
                                 int S, int hd, int split_len, void* stream) {
  return split_dispatch(q, contig<bf16>(k, v, S, K, hd), pos, out, part, tickets, B, H, K, S,
                        hd, split_len, static_cast<cudaStream_t>(stream));
}

// K3p, the first design: the n rows' slots through a page table.  pk/pv
// (p1, pt, K, hd) the device pool, ek/ev the window's frames (null when no
// frame index reaches them), frames (n, pages) int32, span the slots of a
// row (pages * pt or fewer).
int repro_decode_attention_paged(const void* q, const void* pk, const void* pv, const void* ek,
                                 const void* ev, const int* frames, const int* pos, void* out,
                                 int n, int H, int K, int span, int hd, int pt, int pages,
                                 int p1, int is_bf16, void* stream) {
  if (n <= 0 || K <= 0 || span <= 0 || H % K != 0 || pt <= 0 || pages * pt < span)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  return is_bf16
             ? dispatch_g<bf16>(q, paged<bf16>(pk, pv, ek, ev, frames, pages, pt, p1, K, hd),
                                pos, out, n, G, K, span, hd, s)
             : dispatch_g<float>(q, paged<float>(pk, pv, ek, ev, frames, pages, pt, p1, K, hd),
                                 pos, out, n, G, K, span, hd, s);
}

// K3p, the split design (bf16, hd 64/128): as repro_decode_attention_split
// with the slots through the page table as in repro_decode_attention_paged.
int repro_decode_attention_paged_split(const void* q, const void* pk, const void* pv,
                                       const void* ek, const void* ev, const int* frames,
                                       const int* pos, void* out, float* part, int* tickets,
                                       int n, int H, int K, int span, int hd, int pt, int pages,
                                       int p1, int split_len, void* stream) {
  if (pt <= 0 || pages * pt < span) return (int)cudaErrorInvalidValue;
  return split_dispatch(q, paged<bf16>(pk, pv, ek, ev, frames, pages, pt, p1, K, hd), pos, out,
                        part, tickets, n, H, K, span, hd, split_len,
                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
