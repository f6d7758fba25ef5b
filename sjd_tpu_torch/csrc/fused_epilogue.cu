// Fused per-layer attention epilogue for the SJD decode window, for Hopper
// (sm_90a): per-head qk LayerNorm -> split-half RoPE -> symmetric int8 KV
// quantization, with K, V and their scales written straight into one layer
// of the stacked KV cache, in one launch.
//
// Replaces: sjd_tpu/ops/fused_epilogue.py, _epilogue_kernel (called through
// fused_epilogue()), followed by sjd_tpu/models/transformer.py's
// write_kv_layer. Same arithmetic, same cast points: the norm output and
// the RoPE output are each rounded to bf16 before the next step, the int8
// code is round-half-even of x / scale clipped to +-127, and the scale
// (amax * fl32(1/127), floored at 1e-8: XLA folds the reference's
// amax / 127 into that multiply) is stored as bf16. Window row t of sample
// s goes to cache row start + t of layer `layer`, where start follows
// jax.lax.dynamic_update_slice: c = cache_end[s], plus L if negative, then
// clamped to [0, L - T]. No other row is touched.
//
// What bounds it on the H100: neither bytes nor operations, but its fixed
// cost. At the main path's shapes (S=2, T=16, Hq=Hkv=32, D=128) it reads
// ~0.85 MB and writes ~0.53 MB, 0.41 us at 3.35 TB/s, and does ~2.6 MFLOP;
// a launch and one pass of dependent loads, shuffles and stores cost more.
// So the design keeps the path from the first load to the last store short
// and spends nothing on tiling:
//
// - One warp per (sample-row, head), kWarps = 4 warps per block: 96 heads
//   of a row make 24 blocks of 128 threads, 768 blocks in all. 4 warps
//   were faster than 8, 16 or 32 (PERF.md section 6).
// - Registers. Lane l holds elements [lV, lV + V) and [D/2 + lV, D/2 + lV
//   + V) of its head, V = D / 64: RoPE's partner pairs stay in one lane,
//   and for D = 128 each half is one 4-byte bf16x2 load (a warp reads 128
//   contiguous bytes per half). D = 100 (LlamaGen GPT-3B) does not divide
//   by 64, and its partners are (j, j + 50): there lane l holds the pairs
//   (j, j + 50) for j = l and j = l + 32 < 50 (lanes 18..31 hold one
//   pair), loaded one bf16 at a time, since a 200-byte head row keeps no
//   word of a lane aligned. The empty slot adds 0 to the sums and the amax
//   and stores nothing.
// - Reductions. Mean, variance and amax are five __shfl_xor_sync steps
//   each. Every lane ends with the same value (the butterfly adds the same
//   two numbers in each lane), so there is no shared memory and no
//   __syncthreads anywhere in the kernel.
// - cos/sin. A warp reads its row's values for its own elements once, as
//   float2 for D = 128.
// - Stores. int8 codes go out as 2-byte pairs and bf16 as bf16x2, straight
//   into the cache rows; lane 0 writes the scale. q is the only fresh
//   output, and nothing is read back to be scattered.
//
// Every multiply and add uses the _rn intrinsics so that nvcc cannot
// contract them into fused multiply-adds: the plain PyTorch version rounds
// after each operation, and so does this kernel.
//
// C interface (ctypes): sjd_fused_epilogue(...) returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // heads per block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = 1.f / 127.f;  // correctly rounded, as XLA folds it

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sum (kMax=false) or max (kMax=true) over the warp; every lane gets it.
template <bool kMax>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFull, v, o);
    v = kMax ? fmaxf(v, w) : __fadd_rn(v, w);
  }
  return v;
}

// V consecutive values at p, widened to f32 (V = 2: one 4-byte load).
template <int V>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float (&x)[V]) {
  if constexpr (V == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[V]) {
  if constexpr (V == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
    *p = __float2bfloat16_rn(x[0]);
  }
}

// x holds integral values in [-127, 127].
template <int V>
__device__ __forceinline__ void store_i8(int8_t* p, const float (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<char2*>(p) = make_char2((signed char)x[0], (signed char)x[1]);
  } else {
    *p = (int8_t)x[0];
  }
}

// The elements lane `lane` holds of a D-wide head: slot i is element
// off(lane, i) of the first half and off(lane, i) + D / 2 of the second.
// D % 64 == 0: V = D / 64 consecutive slots, loaded as words; else
// (D = 100) slot i is lane + 32 i, live while it is below D / 2.
template <int D>
struct LaneMap {
  static constexpr bool kStrided = D % 64 != 0;
  static constexpr int V = kStrided ? (D / 2 + 31) / 32 : D / 64;
  static __device__ __forceinline__ int off(int lane, int i) {
    return kStrided ? lane + 32 * i : lane * V + i;
  }
  static __device__ __forceinline__ bool live(int lane, int i) {
    return !kStrided || lane + 32 * i < D / 2;
  }
};

// a half's V values for this lane (0 in an empty slot), widened to f32
template <int D, typename T>
__device__ __forceinline__ void load_half(const T* p, int lane, float (&x)[LaneMap<D>::V]) {
  using M = LaneMap<D>;
  if constexpr (M::kStrided) {
#pragma unroll
    for (int i = 0; i < M::V; ++i) {
      x[i] = 0.f;
      if (M::live(lane, i)) {
        if constexpr (sizeof(T) == 4) {
          x[i] = p[M::off(lane, i)];
        } else {
          x[i] = __bfloat162float(p[M::off(lane, i)]);
        }
      }
    }
  } else if constexpr (sizeof(T) == 4) {
    load_f32<M::V>(p + lane * M::V, x);
  } else {
    load_bf16<M::V>(p + lane * M::V, x);
  }
}

template <int D>
__device__ __forceinline__ void store_half_bf16(__nv_bfloat16* p, int lane,
                                                const float (&x)[LaneMap<D>::V]) {
  using M = LaneMap<D>;
  if constexpr (M::kStrided) {
#pragma unroll
    for (int i = 0; i < M::V; ++i)
      if (M::live(lane, i)) p[M::off(lane, i)] = __float2bfloat16_rn(x[i]);
  } else {
    store_bf16<M::V>(p + lane * M::V, x);
  }
}

template <int D>
__device__ __forceinline__ void store_half_i8(int8_t* p, int lane,
                                              const float (&x)[LaneMap<D>::V]) {
  using M = LaneMap<D>;
  if constexpr (M::kStrided) {
#pragma unroll
    for (int i = 0; i < M::V; ++i)
      if (M::live(lane, i)) p[M::off(lane, i)] = (int8_t)x[i];
  } else {
    store_i8<M::V>(p + lane * M::V, x);
  }
}

// grid: (ceil((Hq + 2 * Hkv) / kWarps), S * T); block: kWarps warps.
// Warp w of block x takes head x * kWarps + w of its row: [0, Hq) query
// heads, then Hkv key heads, then Hkv value heads.
template <int D>
__global__ void __launch_bounds__(kWarps * 32) epilogue_kernel(
    const __nv_bfloat16* __restrict__ qp,   // [S*T, Hq*D]
    const __nv_bfloat16* __restrict__ kp,   // [S*T, Hkv*D]
    const __nv_bfloat16* __restrict__ vp,   // [S*T, Hkv*D]
    const __nv_bfloat16* __restrict__ qns,  // [Hq, D] or null (no qk-norm)
    const __nv_bfloat16* __restrict__ qnb,
    const __nv_bfloat16* __restrict__ kns,  // [Hkv, D] or null
    const __nv_bfloat16* __restrict__ knb,
    const float* __restrict__ cos_t,        // [S*T, D]
    const float* __restrict__ sin_t,
    const int* __restrict__ cache_end,      // [S]
    __nv_bfloat16* __restrict__ q_out,      // [S*T, Hq, D]
    void* __restrict__ k_cache,             // [S, NL, L, Hkv, D] int8 or bf16
    void* __restrict__ v_cache,
    __nv_bfloat16* __restrict__ k_scale,    // [S, NL, L, Hkv], null: bf16 cache
    __nv_bfloat16* __restrict__ v_scale,
    int T, int Hq, int Hkv, int NL, int L, int layer, int qk_norm, float eps) {
  using M = LaneMap<D>;
  constexpr int V = M::V;
  constexpr int kHalf = D / 2;
  const int lane = threadIdx.x & 31;
  const int hh = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int row = blockIdx.y;  // s * T + t
  if (hh >= Hq + 2 * Hkv) return;  // whole warps: no shuffle is left short

  int kind, h, heads;
  const __nv_bfloat16* src;
  if (hh < Hq) {
    kind = 0; h = hh; heads = Hq; src = qp;
  } else if (hh < Hq + Hkv) {
    kind = 1; h = hh - Hq; heads = Hkv; src = kp;
  } else {
    kind = 2; h = hh - Hq - Hkv; heads = Hkv; src = vp;
  }
  const int smp = row / T;

  // Every global load is issued here, before the first shuffle: at these
  // sizes the kernel's time is its chain of dependent memory latencies.
  const __nv_bfloat16* x = src + ((size_t)row * heads + h) * D;
  float a[V], b[V];  // this lane's slots of the first and the second half
  load_half<D>(x, lane, a);
  load_half<D>(x + kHalf, lane, b);
  float ca[V], cb[V], sa[V], sb[V];  // cos, sin (q and k heads)
  float na[V], nb[V], ma[V], mb[V];  // norm scale, bias (with qk_norm)
  if (kind < 2) {
    const float* c = cos_t + (size_t)row * D;
    const float* s = sin_t + (size_t)row * D;
    load_half<D>(c, lane, ca);
    load_half<D>(c + kHalf, lane, cb);
    load_half<D>(s, lane, sa);
    load_half<D>(s + kHalf, lane, sb);
    if (qk_norm) {
      const __nv_bfloat16* sc = (kind == 0 ? qns : kns) + (size_t)h * D;
      const __nv_bfloat16* bi = (kind == 0 ? qnb : knb) + (size_t)h * D;
      load_half<D>(sc, lane, na);
      load_half<D>(sc + kHalf, lane, nb);
      load_half<D>(bi, lane, ma);
      load_half<D>(bi + kHalf, lane, mb);
    }
  }
  const int end = kind > 0 ? cache_end[smp] : 0;

  if (kind < 2) {
    if (qk_norm) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) sum = __fadd_rn(__fadd_rn(sum, a[i]), b[i]);
      const float mean = __fdiv_rn(warp_reduce<false>(sum), (float)D);
      float da[V], db[V], sq = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        da[i] = __fsub_rn(a[i], mean);
        db[i] = __fsub_rn(b[i], mean);
        if (M::live(lane, i))
          sq = __fadd_rn(__fadd_rn(sq, __fmul_rn(da[i], da[i])), __fmul_rn(db[i], db[i]));
      }
      const float var = __fdiv_rn(warp_reduce<false>(sq), (float)D);
      const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
      for (int i = 0; i < V; ++i) {
        a[i] = round_bf16(__fadd_rn(__fmul_rn(__fmul_rn(da[i], inv), na[i]), ma[i]));
        b[i] = round_bf16(__fadd_rn(__fmul_rn(__fmul_rn(db[i], inv), nb[i]), mb[i]));
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float ra = __fadd_rn(__fmul_rn(a[i], ca[i]), __fmul_rn(-b[i], sa[i]));
      const float rb = __fadd_rn(__fmul_rn(b[i], cb[i]), __fmul_rn(a[i], sb[i]));
      a[i] = round_bf16(ra);
      b[i] = round_bf16(rb);
    }
  }

  if (kind == 0) {
    __nv_bfloat16* out = q_out + ((size_t)row * Hq + h) * D;
    store_half_bf16<D>(out, lane, a);
    store_half_bf16<D>(out + kHalf, lane, b);
    return;
  }

  // the cache row: dynamic_update_slice's rule for the window's start (the
  // wrapper checks T <= L)
  const int start = min(max(end < 0 ? end + L : end, 0), L - T);
  const size_t crow = ((size_t)smp * NL + layer) * L + start + (row - smp * T);
  const size_t dst = (crow * Hkv + h) * D;
  if (k_scale != nullptr) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) m = fmaxf(m, fmaxf(fabsf(a[i]), fabsf(b[i])));
    const float scale = fmaxf(__fmul_rn(warp_reduce<true>(m), kInv127), 1e-8f);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      a[i] = fminf(fmaxf(rintf(__fdiv_rn(a[i], scale)), -127.f), 127.f);
      b[i] = fminf(fmaxf(rintf(__fdiv_rn(b[i], scale)), -127.f), 127.f);
    }
    int8_t* out = static_cast<int8_t*>(kind == 1 ? k_cache : v_cache) + dst;
    store_half_i8<D>(out, lane, a);
    store_half_i8<D>(out + kHalf, lane, b);
    if (lane == 0) (kind == 1 ? k_scale : v_scale)[crow * Hkv + h] = __float2bfloat16_rn(scale);
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(kind == 1 ? k_cache : v_cache) + dst;
    store_half_bf16<D>(out, lane, a);
    store_half_bf16<D>(out + kHalf, lane, b);
  }
}

}  // namespace

// k_scale == v_scale == null selects a bf16 cache, else an int8 one. The
// launch goes to `device` (the tensors' card) on `stream`; the thread's
// current device is restored afterwards. Returns a CUDA error code.
extern "C" int sjd_fused_epilogue(
    const void* qp, const void* kp, const void* vp,
    const void* qns, const void* qnb, const void* kns, const void* knb,
    const void* cos_t, const void* sin_t, const void* cache_end,
    void* q_out, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    int S, int T, int Hq, int Hkv, int D, int NL, int L, int layer,
    int qk_norm, float eps, int device, void* stream) {
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  const dim3 grid((Hq + 2 * Hkv + kWarps - 1) / kWarps, S * T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SJD_EPILOGUE_ARGS                                                              \
  static_cast<const __nv_bfloat16*>(qp), static_cast<const __nv_bfloat16*>(kp),        \
      static_cast<const __nv_bfloat16*>(vp), static_cast<const __nv_bfloat16*>(qns),   \
      static_cast<const __nv_bfloat16*>(qnb), static_cast<const __nv_bfloat16*>(kns),  \
      static_cast<const __nv_bfloat16*>(knb), static_cast<const float*>(cos_t),        \
      static_cast<const float*>(sin_t), static_cast<const int*>(cache_end),            \
      static_cast<__nv_bfloat16*>(q_out), k_cache, v_cache,                            \
      static_cast<__nv_bfloat16*>(k_scale), static_cast<__nv_bfloat16*>(v_scale), T,   \
      Hq, Hkv, NL, L, layer, qk_norm, eps
  if (D == 128) {
    epilogue_kernel<128><<<grid, kWarps * 32, 0, st>>>(SJD_EPILOGUE_ARGS);
    err = cudaGetLastError();
  } else if (D == 100) {
    epilogue_kernel<100><<<grid, kWarps * 32, 0, st>>>(SJD_EPILOGUE_ARGS);
    err = cudaGetLastError();
  } else if (D == 64) {
    epilogue_kernel<64><<<grid, kWarps * 32, 0, st>>>(SJD_EPILOGUE_ARGS);
    err = cudaGetLastError();
  } else {
    err = cudaErrorInvalidValue;
  }
#undef SJD_EPILOGUE_ARGS
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
