// GQA decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces src/repro/kernels/decode_attention.py::_decode_attn_kernel: one
// new query per sequence against a (B, S, K, hd) KV cache, the G = H/K query
// heads of a KV head computed together, online softmax in f32, scale
// hd**-0.5.  Unlike the Pallas kernel's scalar position, each row b has its
// own pos[b] (the engine decodes ragged slots): slot s is valid iff
// s <= pos[b].
//
// What bounds it on an H100: the KV bytes of the valid slots (each K and V
// element is read once and used for G query heads), far below the tensor
// cores' operation rate.  The design: one block per (b, kv-head), four warps
// striding over the valid slots only (slots past pos[b] are never read),
// each lane holding hd/32 contiguous elements of a K/V row so a warp reads a
// whole row in one coalesced request; four slots are loaded per step to keep
// loads in flight.  Each warp keeps its own running max/sum/accumulator per
// query head; the four partial states merge by log-sum-exp in shared memory.
// Split-KV across blocks (for long caches at small batch) is later work.
//
// Numerics: the probabilities stay in f32 through the PV product.  The JAX
// attn_decode (models/attention.py) casts them to the cache dtype first, so
// the two agree exactly in f32 and differ by bf16 rounding in bf16.  A row
// with no valid slot (pos[b] < 0) writes zeros.

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

// grid (K, B), block NW*32.  q/out (B, H, hd); k/v (B, S, K, hd); pos (B,).
template <typename T, int G, int EPL>
__global__ void __launch_bounds__(NW * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos,
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

  const size_t row_stride = (size_t)K * HD;             // one slot
  const T* kb = k + (size_t)b * S * row_stride + (size_t)kh * HD + lane * EPL;
  const T* vb = v + (size_t)b * S * row_stride + (size_t)kh * HD + lane * EPL;

  for (int base = warp; base < n; base += NW * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      int s = base + u * NW;
      if (s < n) {
        Vec<T, EPL>::load(kb + (size_t)s * row_stride, kr[u]);
        Vec<T, EPL>::load(vb + (size_t)s * row_stride, vr[u]);
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

template <typename T, int G>
int dispatch_hd(const void* q, const void* k, const void* v, const int* pos, void* out,
                int B, int K, int S, int hd, cudaStream_t stream) {
  dim3 grid(K, B);
  const float scale = 1.0f / sqrtf((float)hd);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  switch (hd) {
    case 32: decode_attn_kernel<T, G, 1><<<grid, NW * 32, 0, stream>>>(qt, kt, vt, pos, ot, S, K, scale); break;
    case 64: decode_attn_kernel<T, G, 2><<<grid, NW * 32, 0, stream>>>(qt, kt, vt, pos, ot, S, K, scale); break;
    case 128: decode_attn_kernel<T, G, 4><<<grid, NW * 32, 0, stream>>>(qt, kt, vt, pos, ot, S, K, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_g(const void* q, const void* k, const void* v, const int* pos, void* out,
               int B, int G, int K, int S, int hd, cudaStream_t stream) {
  switch (G) {
    case 1: return dispatch_hd<T, 1>(q, k, v, pos, out, B, K, S, hd, stream);
    case 2: return dispatch_hd<T, 2>(q, k, v, pos, out, B, K, S, hd, stream);
    case 4: return dispatch_hd<T, 4>(q, k, v, pos, out, B, K, S, hd, stream);
    case 8: return dispatch_hd<T, 8>(q, k, v, pos, out, B, K, S, hd, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (B, H, hd) = softmax(q k^T * hd**-0.5 over slots <= pos[b]) v.
// Supported: H / K in {1, 2, 4, 8}, hd in {32, 64, 128}.
int repro_decode_attention(const void* q, const void* k, const void* v, const int* pos,
                           void* out, int B, int H, int K, int S, int hd, int is_bf16,
                           void* stream) {
  if (B <= 0 || K <= 0 || S <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / K;
  return is_bf16 ? dispatch_g<bf16>(q, k, v, pos, out, B, G, K, S, hd, s)
                 : dispatch_g<float>(q, k, v, pos, out, B, G, K, S, hd, s);
}

}  // extern "C"
