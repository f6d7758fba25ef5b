// Flash-decoding attention for one SJD window over one layer of the stacked
// KV cache, for Hopper (sm_90a).
//
// Replaces: sjd_tpu/ops/decode_attention.py, _flash_decode_kernel (called
// through decode_attention()). Same function: the layer is selected inside
// the kernel from `layer` and the strides; int8 K/V rows are dequantized
// by their per-(row, head) bf16 scales (scores = (q . k_int8) * s_k / sqrt(D),
// out = sum_j p_j * s_v[j] * v_int8[j]), or a bf16 cache is read with no
// scales; the mask is col <= cache_end[s] + row / group and valid[s, col];
// GQA folds the group into W * group query rows per KV head; the softmax is
// an f32 online softmax; rows past cache_end + W are never loaded.
//
// Masking uses the finite -FLT_MAX of the TPU kernel, not -inf: a tile that
// is wholly masked for a row then adds exp(0) terms that the next live
// tile's correction exp(m_prev - m_new) = 0 wipes out, where -inf would give
// exp(-inf - -inf) = NaN.
//
// What bounds it on the H100: bytes. One call must read the live prefix of
// one layer, (cache_end + W) * Hkv * D bytes each of K and V in int8 plus
// their scales: at the main path's 768px shapes (S=2, Hkv=32, D=128, ~2400
// live rows) about 40 MB, 12 us at 3.35 TB/s, against ~0.1 GFLOP, which is
// nothing for the card. This first version is simple, not fast: one block of
// 256 threads per (query-row group of 16, KV head, sample) walks the live
// prefix in 32-row tiles, dequantizing K and V into padded shared memory
// (no bank conflicts on the dot products) and keeping the running max, sum
// and the 16 x D accumulator in registers. At S=2, Hkv=32 that is only 64
// blocks for 132 SMs and no overlap of loads with math; splitting the prefix
// over more blocks (split-K with a merge pass), cp.async or TMA double
// buffering and tensor-core dots are the later work PERF.md lists.
//
// C interface (ctypes): sjd_decode_attention(...) returns cudaGetLastError().

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;     // query rows (of W * group) per block
constexpr int kTile = 32;     // cache rows per tile
constexpr int kThreads = 256; // kRows x 16 lanes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// reduce over the 16 lanes that share one query row (a half warp)
__device__ __forceinline__ float half_warp_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o, 16));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o, 16));
  return v;
}

// grid: (ceil(W * group / kRows), Hkv, S); block: kThreads.
template <typename KV, bool kQuant, int D>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q,      // [S, W, H, D]
    const KV* __restrict__ k,                 // [S, NL, L, Hkv, D]
    const KV* __restrict__ v,
    const __nv_bfloat16* __restrict__ ks,     // [S, NL, L, Hkv] (kQuant only)
    const __nv_bfloat16* __restrict__ vs,
    const int32_t* __restrict__ cache_end,    // [S]
    const uint8_t* __restrict__ valid,        // [S, L] (bool)
    __nv_bfloat16* __restrict__ out,          // [S, W, H, D]
    int W, int H, int Hkv, int NL, int L, int layer) {
  constexpr int kPerLane = D / 16;            // output dims per thread
  constexpr int kElemsPerVec = 16 / sizeof(KV);
  constexpr int kVecsPerRow = D / kElemsPerVec;
  __shared__ float qs[kRows][D + 1];
  __shared__ float kt[kTile][D + 1];
  __shared__ float vt[kTile][D];
  __shared__ float pt[kRows][kTile + 1];
  __shared__ float ksc[kTile];
  __shared__ float vsc[kTile];
  __shared__ int col_ok[kTile];

  const int s = blockIdx.z;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int group = H / Hkv;
  const int GW = W * group;
  const int tid = threadIdx.x;
  const int row = tid >> 4;   // query row within the block
  const int lane = tid & 15;  // lane within the row's half warp
  const int qrow = r0 + row;
  const bool row_live = qrow < GW;
  const int w = row_live ? qrow / group : 0;
  const int g = row_live ? qrow % group : 0;
  const int ce = cache_end[s];
  const float sqrt_d = sqrtf((float)D);

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int rr = e / D, d = e % D, qr = r0 + rr;
    float x = 0.f;
    if (qr < GW) {
      const int ww = qr / group, gg = qr % group;
      x = __bfloat162float(q[(((size_t)s * W + ww) * H + h * group + gg) * D + d]);
    }
    qs[rr][d] = x;
  }

  const size_t row0 = ((size_t)s * NL + layer) * L;  // cache row of (s, layer, 0)
  const int n_live = min(ce + W, L);
  float m = -FLT_MAX;
  float l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < n_live; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed; qs is written
    for (int e = tid; e < kTile * kVecsPerRow; e += kThreads) {
      const int rr = e / kVecsPerRow, cv = e % kVecsPerRow, col = t0 + rr;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
      if (col < L) {
        const size_t off = ((row0 + col) * Hkv + h) * D + (size_t)cv * kElemsPerVec;
        kraw = *reinterpret_cast<const uint4*>(k + off);
        vraw = *reinterpret_cast<const uint4*>(v + off);
      }
      const KV* kx = reinterpret_cast<const KV*>(&kraw);
      const KV* vx = reinterpret_cast<const KV*>(&vraw);
#pragma unroll
      for (int i = 0; i < kElemsPerVec; ++i) {
        kt[rr][cv * kElemsPerVec + i] = to_f(kx[i]);
        vt[rr][cv * kElemsPerVec + i] = to_f(vx[i]);
      }
    }
    if (tid < kTile) {
      const int col = t0 + tid;
      const bool in = col < L;
      col_ok[tid] = in && valid[(size_t)s * L + col];
      float kscale = 1.f, vscale = 1.f;
      if (kQuant && in) {
        kscale = __bfloat162float(ks[(row0 + col) * Hkv + h]);
        vscale = __bfloat162float(vs[(row0 + col) * Hkv + h]);
      }
      ksc[tid] = __fdiv_rn(kscale, sqrt_d);
      vsc[tid] = vscale;
    }
    __syncthreads();

    float sc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = lane + 16 * j;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qs[row][d], kt[c][d], dot);
      const bool keep = col_ok[c] && (t0 + c <= ce + w);
      sc[j] = keep ? __fmul_rn(dot, ksc[c]) : -FLT_MAX;
    }
    const float m_new = fmaxf(m, half_warp_max(fmaxf(sc[0], sc[1])));
    const float p0 = expf(__fsub_rn(sc[0], m_new));
    const float p1 = expf(__fsub_rn(sc[1], m_new));
    const float corr = expf(__fsub_rn(m, m_new));
    l = __fadd_rn(__fmul_rn(l, corr), half_warp_sum(__fadd_rn(p0, p1)));
    m = m_new;
    pt[row][lane] = __fmul_rn(p0, vsc[lane]);
    pt[row][lane + 16] = __fmul_rn(p1, vsc[lane + 16]);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int d = lane + 16 * j;
      float a = __fmul_rn(acc[j], corr);
#pragma unroll 8
      for (int c = 0; c < kTile; ++c) a = fmaf(pt[row][c], vt[c][d], a);
      acc[j] = a;
    }
  }

  if (row_live) {
    const float inv_l = 1.f / fmaxf(l, 1e-37f);
    const size_t obase = (((size_t)s * W + w) * H + h * group + g) * D;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      out[obase + lane + 16 * j] = __float2bfloat16_rn(__fmul_rn(acc[j], inv_l));
    }
  }
}

template <typename KV, bool kQuant, int D>
void launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
            const void* cache_end, const void* valid, void* out, int S, int W, int H,
            int Hkv, int NL, int L, int layer, cudaStream_t stream) {
  const int GW = W * (H / Hkv);
  const dim3 grid((GW + kRows - 1) / kRows, Hkv, S);
  flash_decode_kernel<KV, kQuant, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int32_t*>(cache_end),
      static_cast<const uint8_t*>(valid), static_cast<__nv_bfloat16*>(out), W, H, Hkv, NL,
      L, layer);
}

}  // namespace

// quantized != 0: k/v are int8 with bf16 scales; else k/v are bf16 and the
// scale pointers are ignored. head_dim must be 64 or 128 (checked by the
// Python wrapper; anything else returns cudaErrorInvalidValue).
extern "C" int sjd_decode_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* cache_end, const void* valid, void* out,
    int S, int W, int H, int Hkv, int D, int NL, int L, int layer, int quantized,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized && D == 128) {
    launch<int8_t, true, 128>(q, k, v, ks, vs, cache_end, valid, out, S, W, H, Hkv, NL, L, layer, st);
  } else if (quantized && D == 64) {
    launch<int8_t, true, 64>(q, k, v, ks, vs, cache_end, valid, out, S, W, H, Hkv, NL, L, layer, st);
  } else if (!quantized && D == 128) {
    launch<__nv_bfloat16, false, 128>(q, k, v, ks, vs, cache_end, valid, out, S, W, H, Hkv, NL, L, layer, st);
  } else if (!quantized && D == 64) {
    launch<__nv_bfloat16, false, 64>(q, k, v, ks, vs, cache_end, valid, out, S, W, H, Hkv, NL, L, layer, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
