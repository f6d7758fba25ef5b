// Fused per-layer attention epilogue for the SJD decode window, for Hopper
// (sm_90a): per-head qk LayerNorm -> split-half RoPE -> symmetric int8 KV
// quantization, in one launch.
//
// Replaces: sjd_tpu/ops/fused_epilogue.py, _epilogue_kernel (called through
// fused_epilogue()). Same arithmetic, same cast points: the norm output and
// the RoPE output are each rounded to bf16 before the next step, the int8
// code is round-half-even of x / scale clipped to +-127, and the scale
// (amax / 127, floored at 1e-8) is stored as bf16.
//
// What bounds it on the H100: neither bytes nor operations. At the main
// path's shapes (S=2, T=16, Hq=Hkv=32, D=128) it reads ~0.8 MB and writes
// ~0.4 MB, a fraction of a microsecond at 3.35 TB/s; the launch itself
// costs more. The design therefore spends nothing on bandwidth tricks: one
// block per (sample-row, head) keeps the D values of one head in registers
// (thread i holds elements i and i + D/2, the pair RoPE rotates together),
// reductions are a warp shuffle plus one shared-memory step, and every
// output is written once. Every multiply and add uses the _rn intrinsics so
// that nvcc cannot contract them into fused multiply-adds: the plain PyTorch
// version rounds after each operation, and so does this kernel.
//
// C interface (ctypes): sjd_fused_epilogue(...) returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 128;  // head_dim <= 256
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf(const __nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sum (kMax=false) or max (kMax=true) over the whole block. Every thread of
// the block must call it; inactive threads pass the identity (0 for both:
// the max is taken over absolute values).
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = kMax ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // red[] may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < n_warps; ++i) r = kMax ? fmaxf(r, red[i]) : __fadd_rn(r, red[i]);
  return r;
}

// grid: (S * T, Hq + 2 * Hkv); block: D / 2 threads rounded up to a warp.
// blockIdx.y picks the head: [0, Hq) query heads, then Hkv key heads, then
// Hkv value heads.
__global__ void epilogue_kernel(
    const __nv_bfloat16* __restrict__ qp,   // [S*T, Hq*D]
    const __nv_bfloat16* __restrict__ kp,   // [S*T, Hkv*D]
    const __nv_bfloat16* __restrict__ vp,   // [S*T, Hkv*D]
    const __nv_bfloat16* __restrict__ qns,  // [Hq, D] or null (no qk-norm)
    const __nv_bfloat16* __restrict__ qnb,
    const __nv_bfloat16* __restrict__ kns,  // [Hkv, D] or null
    const __nv_bfloat16* __restrict__ knb,
    const float* __restrict__ cos_t,        // [S*T, D]
    const float* __restrict__ sin_t,
    __nv_bfloat16* __restrict__ q_out,      // [S*T, Hq, D]
    void* __restrict__ k_out,               // [S*T, Hkv, D] int8 or bf16
    void* __restrict__ v_out,
    __nv_bfloat16* __restrict__ ks_out,     // [S*T, Hkv] (quantize only)
    __nv_bfloat16* __restrict__ vs_out,
    int Hq, int Hkv, int D, int qk_norm, int quantize, float eps) {
  __shared__ float red[kMaxThreads / 32];
  const int row = blockIdx.x;
  const int hh = blockIdx.y;
  const int half = D / 2;
  const int i = threadIdx.x;
  const bool act = i < half;

  int kind, h, heads;
  const __nv_bfloat16* src;
  if (hh < Hq) {
    kind = 0; h = hh; heads = Hq; src = qp;
  } else if (hh < Hq + Hkv) {
    kind = 1; h = hh - Hq; heads = Hkv; src = kp;
  } else {
    kind = 2; h = hh - Hq - Hkv; heads = Hkv; src = vp;
  }
  const size_t base = ((size_t)row * heads + h) * D;  // same for input and output
  float a = act ? bf(src[base + i]) : 0.f;
  float b = act ? bf(src[base + i + half]) : 0.f;

  if (kind < 2) {
    if (qk_norm) {
      const __nv_bfloat16* sc = (kind == 0 ? qns : kns) + (size_t)h * D;
      const __nv_bfloat16* bi = (kind == 0 ? qnb : knb) + (size_t)h * D;
      const float mean = __fdiv_rn(block_reduce<false>(__fadd_rn(a, b), red), (float)D);
      const float da = __fsub_rn(a, mean);
      const float db = __fsub_rn(b, mean);
      const float sq = act ? __fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db)) : 0.f;
      const float var = __fdiv_rn(block_reduce<false>(sq, red), (float)D);
      const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
      if (act) {
        a = round_bf16(__fadd_rn(__fmul_rn(__fmul_rn(da, inv), bf(sc[i])), bf(bi[i])));
        b = round_bf16(__fadd_rn(__fmul_rn(__fmul_rn(db, inv), bf(sc[i + half])),
                                 bf(bi[i + half])));
      }
    }
    if (act) {
      const float* c = cos_t + (size_t)row * D;
      const float* s = sin_t + (size_t)row * D;
      const float ra = __fadd_rn(__fmul_rn(a, c[i]), __fmul_rn(-b, s[i]));
      const float rb = __fadd_rn(__fmul_rn(b, c[i + half]), __fmul_rn(a, s[i + half]));
      a = round_bf16(ra);
      b = round_bf16(rb);
    }
  }

  if (kind == 0) {
    if (act) {
      q_out[base + i] = __float2bfloat16_rn(a);
      q_out[base + i + half] = __float2bfloat16_rn(b);
    }
    return;  // kind is uniform over the block: no thread is left at a barrier
  }

  if (quantize) {
    const float amax = block_reduce<true>(act ? fmaxf(fabsf(a), fabsf(b)) : 0.f, red);
    const float scale = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    int8_t* out = static_cast<int8_t*>(kind == 1 ? k_out : v_out);
    if (act) {
      const float qa = fminf(fmaxf(rintf(__fdiv_rn(a, scale)), -127.f), 127.f);
      const float qb = fminf(fmaxf(rintf(__fdiv_rn(b, scale)), -127.f), 127.f);
      out[base + i] = (int8_t)qa;
      out[base + i + half] = (int8_t)qb;
    }
    if (i == 0) {
      __nv_bfloat16* so = kind == 1 ? ks_out : vs_out;
      so[(size_t)row * Hkv + h] = __float2bfloat16_rn(scale);
    }
  } else if (act) {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(kind == 1 ? k_out : v_out);
    out[base + i] = __float2bfloat16_rn(a);
    out[base + i + half] = __float2bfloat16_rn(b);
  }
}

}  // namespace

extern "C" int sjd_fused_epilogue(
    const void* qp, const void* kp, const void* vp,
    const void* qns, const void* qnb, const void* kns, const void* knb,
    const void* cos_t, const void* sin_t,
    void* q_out, void* k_out, void* v_out, void* ks_out, void* vs_out,
    int S, int T, int Hq, int Hkv, int D, int qk_norm, int quantize, float eps,
    void* stream) {
  const int threads = ((D / 2 + 31) / 32) * 32;
  const dim3 grid(S * T, Hq + 2 * Hkv);
  epilogue_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qp), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const __nv_bfloat16*>(qns),
      static_cast<const __nv_bfloat16*>(qnb), static_cast<const __nv_bfloat16*>(kns),
      static_cast<const __nv_bfloat16*>(knb), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<__nv_bfloat16*>(q_out), k_out, v_out,
      static_cast<__nv_bfloat16*>(ks_out), static_cast<__nv_bfloat16*>(vs_out),
      Hq, Hkv, D, qk_norm, quantize, eps);
  return (int)cudaGetLastError();
}
