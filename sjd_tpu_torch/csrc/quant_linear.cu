// Quantized-weight products for Hopper (sm_90a): W4A16/W8A16 (K1,
// quant_linear_a16) and W4A8/W8A8 (K2, quant_linear_a8).
//
// Replaces: no Pallas kernel. The JAX package leaves these products to
// XLA's dot inside linear_multi (sjd_tpu/models/transformer.py:457-495),
// with the s4 -> bf16 (or s4 -> s8) convert fused into the operand read.
// Here the convert is inside the product as well: the packed bytes are read
// as they are, once, and widened in registers.
//
//   K1: y[M, N] = bf16( f32( x[M, K] bf16 . int->bf16(q)[N, K]^T ) * s[N] )
//   K2: y[M, N] = bf16( f32( int32 xq[M, K] . q[N, K]^T ) * xs[M] * s[N] )
//
// q is int8 [N, K] or packed int4 [N, K/2] (split-half nibbles: byte column
// j holds column j in its low nibble and column j + K/2 in its high one).
//
// What bounds it on the H100. At the decode path's M = 32 the weights are
// all the bytes: a 4096 x 4096 projection is 8.4 MB in int4, 2.5 us at
// 3.35 TB/s, against 1.07 GFLOP, 1.1 us at the bf16 tensor cores' dense
// peak. At M = 64 the operations double and mma.sync, below wgmma's peak,
// may bind instead. What the design does about it:
//
// - Weights straight from the packed bytes. A block owns 64 weight rows
//   (16 per warp) and 32 activation rows; a chunk is 64 bytes of each
//   weight row. One 16-byte read of a row feeds 16 columns at k and, for
//   int4, 16 at k + K/2, so the activation tile holds both places.
// - A cp.async ring, kStages chunks deep, for the weight and activation
//   tiles, so that the next chunks' bytes are in flight while one is
//   multiplied (at one or two blocks per SM the ring is what keeps enough
//   bytes in flight to approach the memory rate).
// - Tensor cores through mma.sync: K1 on m16n8k16 bf16 with f32 sums (the
//   int -> bf16 convert is exact: an int4 nibble becomes 136 + v by a bit
//   pattern, minus 136; an int8 code goes through an exact f32); K2 on
//   m16n8k32 s8 with s32 sums, exact, int4 nibbles widened to int8 as
//   16 * v (one mask), the sum shifted right by 4 at the end.
// - Filling the card. The K range is split over gridDim.z; the split count
//   depends on N, K and the bits only (sjd_quant_linear_splits), never on
//   M, and each split's rows are summed in one fixed order. So a row of y
//   is bit-identical whatever M is (the batcher's promise: a request's
//   tokens do not depend on the batch width). With more than one split each
//   block writes f32 (K1) or int32 (K2) partials to a scratch the caller
//   allocates, and reduce_splits_kernel adds them in split order and applies
//   the scales.
// - The k order inside an mma is permuted alike in both operands so that
//   each thread reads consecutive bytes; shared-memory rows are padded so
//   that the 16-byte fragment reads of a quarter warp hit distinct banks.
//
// C interface (ctypes): sjd_quant_linear(...) returns cudaGetLastError();
// sjd_quant_linear_splits(N, K, bits) returns the split count, which sizes
// the caller's scratch. The kernels launch on the given stream and allocate
// nothing.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsN = 4;  // warps along N, 16 weight rows each
constexpr int kWarpsK = 2;  // warps along K: warp group kk takes chunk kk of a stage
constexpr int kThreads = 32 * kWarpsN * kWarpsK;
constexpr int kBN = 16 * kWarpsN;  // weight rows per block
constexpr int kBM = 32;            // activation rows per block (two m16 tiles)
constexpr int kChunk = 64;         // weight bytes per row per chunk
constexpr int kStages = 4;  // stages of kWarpsK chunks in the cp.async ring
constexpr int kTargetBlocks = 264;  // two blocks per SM of the 132
constexpr int kMaxSplits = 8;
constexpr int kMinChunksPerSplit = 4;
constexpr int kReduceThreads = 256;

template <int kBits, bool kA8>
struct Tile {
  static constexpr int kHalves = kBits == 4 ? 2 : 1;  // int4: columns k and k + K/2
  static constexpr int kXBytes = kA8 ? 1 : 2;         // int8 or bf16 activations
  static constexpr int kXHalfBytes = kChunk * kXBytes;
  static constexpr int kXRowBytes = kHalves * kXHalfBytes;
  // padding: a quarter warp's 16-byte reads (two rows, four threads each)
  // land on distinct banks
  static constexpr int kXStride = kA8 ? (kXRowBytes == 128 ? 192 : 64) : kXRowBytes + 16;
  // one chunk: its activation tile, then its weight tile; a stage holds
  // kWarpsK consecutive chunks
  static constexpr int kXSub = kBM * kXStride;
  static constexpr int kSubBytes = kXSub + kBN * kChunk;
  static constexpr int kStageBytes = kWarpsK * kSubBytes;
  static constexpr int kRing = kStages * kStageBytes;
  // the warp groups' sums, merged at the end: [kWarpsK - 1][kWarpsN][32 lanes][16]
  static constexpr int kRed = (kWarpsK - 1) * kWarpsN * 32 * 16 * 4;
  static constexpr int kSmem = kRing > kRed ? kRing : kRed;
  static constexpr int kXPieces = kBM * kXRowBytes / 16;  // per chunk
  static constexpr int kWPieces = kBN * kChunk / 16;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a (16x32, row) . b (32x8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the low nibbles (hi = false) or high nibbles of the bytes of w as bf16x2
// pairs (bytes 0, 1) and (bytes 2, 3), exactly: nibble v (two's complement)
// becomes the bf16 bit pattern of 136 + v, then 136 is subtracted
__device__ __forceinline__ void nibbles_to_bf16(uint32_t w, bool hi, uint32_t& p01,
                                                uint32_t& p23) {
  const uint32_t u = hi ? (w >> 4) : w;
  const uint32_t a = (__byte_perm(u, 0, 0x4140) & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t b = (__byte_perm(u, 0, 0x4342) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  const __nv_bfloat162 ra = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a), off);
  const __nv_bfloat162 rb = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), off);
  p01 = *reinterpret_cast<const uint32_t*>(&ra);
  p23 = *reinterpret_cast<const uint32_t*>(&rb);
}

// four int8 codes -> bf16x2 pairs (bytes 0, 1) and (bytes 2, 3), exactly:
// byte b becomes the f32 2^23 + (b ^ 0x80), minus 2^23 + 128, whose upper
// half is the bf16 value
__device__ __forceinline__ void int8_to_bf16(uint32_t w, uint32_t& p01, uint32_t& p23) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  p01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  p23 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

template <bool kA8>
struct Acc;
template <>
struct Acc<false> {
  using T = float;
};
template <>
struct Acc<true> {
  using T = int;
};

// grid: (ceil(N / kBN), ceil(M / kBM), splits); block: kThreads; dynamic
// shared memory: Tile<kBits, kA8>::kSmem.
template <int kBits, bool kA8>
__global__ void __launch_bounds__(kThreads) quant_linear_kernel(
    const uint8_t* __restrict__ x,          // A16: bf16 [M, K]; A8: int8 [M, K]
    const float* __restrict__ xs,           // A8: f32 [M]
    const uint8_t* __restrict__ w,          // [N, Kb] bytes: int8 codes or packed int4
    const __nv_bfloat16* __restrict__ s,    // [N]
    __nv_bfloat16* __restrict__ y,          // [M, N] (one split)
    typename Acc<kA8>::T* __restrict__ part,  // [splits, M, N] (several splits)
    int M, int N, int K, int n_chunks, int splits) {
  using Lay = Tile<kBits, kA8>;
  using AccT = typename Acc<kA8>::T;
  extern __shared__ __align__(16) uint8_t smem[];

  const int Kb = kBits == 4 ? K / 2 : K;  // weight bytes per row = k per half
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int sp = blockIdx.z;
  const int c_begin = sp * n_chunks / splits;
  const int c_count = (sp + 1) * n_chunks / splits - c_begin;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wn = warp % kWarpsN;  // the warp's 16 weight rows
  const int wk = warp / kWarpsN;  // the warp's chunk of each stage
  const int lane = tid & 31;
  const int gid = lane >> 2;  // mma groupID: row of A and C, column of B
  const int tig = lane & 3;   // thread in group
  const int c_end = c_begin + c_count;
  const int n_stages = (c_count + kWarpsK - 1) / kWarpsK;

  // stage i: chunks c_begin + kWarpsK i + (0 .. kWarpsK-1) of the split, each
  // kBN weight rows x 64 bytes and the activations' matching columns (k,
  // and k + K/2 for int4); chunks past the split are zero-filled
  auto issue = [&](int i) {
    uint8_t* st = smem + (i % kStages) * Lay::kStageBytes;
    const int c0 = c_begin + i * kWarpsK;
#pragma unroll
    for (int p = tid; p < kWarpsK * Lay::kWPieces; p += kThreads) {
      const int sub = p / Lay::kWPieces, pp = p % Lay::kWPieces;
      const int r = pp / (kChunk / 16), part16 = pp % (kChunk / 16);
      const int byte = (c0 + sub) * kChunk + 16 * part16;
      const bool ok = n0 + r < N && byte < Kb && c0 + sub < c_end;
      const uint8_t* src = ok ? w + (size_t)(n0 + r) * Kb + byte : w;
      cp_async16(st + sub * Lay::kSubBytes + Lay::kXSub + r * kChunk + 16 * part16, src,
                 ok ? 16 : 0);
    }
    constexpr int kPerRow = Lay::kXRowBytes / 16;
    constexpr int kPerHalf = Lay::kXHalfBytes / 16;
#pragma unroll
    for (int p = tid; p < kWarpsK * Lay::kXPieces; p += kThreads) {
      const int sub = p / Lay::kXPieces, pp = p % Lay::kXPieces;
      const int r = pp / kPerRow, piece = pp % kPerRow;
      const int half = piece / kPerHalf, within = piece % kPerHalf;
      const int k = (c0 + sub) * kChunk + within * (16 / Lay::kXBytes);  // within its half
      const bool ok = m0 + r < M && k < Kb && c0 + sub < c_end;
      const uint8_t* src =
          ok ? x + ((size_t)(m0 + r) * K + half * Kb + k) * Lay::kXBytes : x;
      cp_async16(st + sub * Lay::kSubBytes + r * Lay::kXStride + half * Lay::kXHalfBytes +
                     16 * within,
                 src, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_stages) issue(i);
    cp_async_commit();
  }

  AccT acc[2][2][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0;

  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage `it` landed
    __syncthreads();               // everyone's; and stage it-1 is free
    if (it + kStages - 1 < n_stages) issue(it + kStages - 1);
    cp_async_commit();
    const uint8_t* xst = smem + (it % kStages) * Lay::kStageBytes + wk * Lay::kSubBytes;
    const uint8_t* wst = xst + Lay::kXSub;
    // the thread's 16 bytes of weight row gid of each n8 tile
    uint4 wb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wb[j] = *reinterpret_cast<const uint4*>(wst + (16 * wn + 8 * j + gid) * kChunk + 16 * tig);

#pragma unroll
    for (int half = 0; half < Lay::kHalves; ++half) {
      const uint8_t* xh = xst + half * Lay::kXHalfBytes;
      if constexpr (!kA8) {
        // k16 steps 2h + j: the thread's k slots (2t, 2t+1, 2t+8, 2t+9) hold
        // columns 16t + 4 step + (0, 1, 2, 3) of the chunk, in both operands
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint4 xa[2][2];  // [m16 tile][row gid, gid + 8]: 8 columns from 16t + 8h
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              xa[mt][rr] = *reinterpret_cast<const uint4*>(
                  xh + (16 * mt + 8 * rr + gid) * Lay::kXStride + 32 * tig + 16 * h);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int step = 2 * h + j;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const uint32_t word = step == 0 ? wb[nt].x : step == 1 ? wb[nt].y
                                  : step == 2 ? wb[nt].z : wb[nt].w;
              uint32_t b0, b1;
              if constexpr (kBits == 4) {
                nibbles_to_bf16(word, half == 1, b0, b1);
              } else {
                int8_to_bf16(word, b0, b1);
              }
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                const uint4& lo = xa[mt][0];
                const uint4& hi = xa[mt][1];
                const uint32_t a[4] = {j ? lo.z : lo.x, j ? hi.z : hi.x, j ? lo.w : lo.y,
                                       j ? hi.w : hi.y};
                mma_bf16(acc[mt][nt], a, b0, b1);
              }
            }
          }
        }
      } else {
        // k32 steps 0, 1: the thread's k slots (4t..4t+3, 16+4t..16+4t+3)
        // hold columns 16t + 8 step + (0..3, 4..7) of the chunk
        uint4 xa[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            xa[mt][rr] = *reinterpret_cast<const uint4*>(
                xh + (16 * mt + 8 * rr + gid) * Lay::kXStride + 16 * tig);
#pragma unroll
        for (int step = 0; step < 2; ++step) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            uint32_t b0 = step ? wb[nt].z : wb[nt].x;
            uint32_t b1 = step ? wb[nt].w : wb[nt].y;
            if constexpr (kBits == 4) {
              // nibble v as the int8 16 v: the sum is shifted back at the end
              if (half == 0) {
                b0 = (b0 << 4) & 0xF0F0F0F0u;
                b1 = (b1 << 4) & 0xF0F0F0F0u;
              } else {
                b0 &= 0xF0F0F0F0u;
                b1 &= 0xF0F0F0F0u;
              }
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              const uint4& lo = xa[mt][0];
              const uint4& hi = xa[mt][1];
              const uint32_t a[4] = {step ? lo.z : lo.x, step ? hi.z : hi.x,
                                     step ? lo.w : lo.y, step ? hi.w : hi.y};
              mma_s8(acc[mt][nt], a, b0, b1);
            }
          }
        }
      }
    }
  }
  // the warp groups' sums merged in group order (fixed: the same for
  // every M), through shared memory once the ring is idle
  cp_async_wait<0>();
  if constexpr (kWarpsK > 1) {
    __syncthreads();
    AccT* red = reinterpret_cast<AccT*>(smem);
    if (wk > 0) {
      AccT* mine = red + (((wk - 1) * kWarpsN + wn) * 32 + lane) * 16;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(a * 2 + b) * 4 + e] = acc[a][b][e];
    }
    __syncthreads();
    if (wk > 0) return;
    for (int g = 1; g < kWarpsK; ++g) {
      const AccT* theirs = red + (((g - 1) * kWarpsN + wn) * 32 + lane) * 16;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][b][e] += theirs[(a * 2 + b) * 4 + e];
    }
  }

  // c0, c1: row gid, columns 2t, 2t+1; c2, c3: row gid + 8
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 16 * mt + gid + 8 * (e >> 1);
        const int n = n0 + 16 * wn + 8 * nt + 2 * tig + (e & 1);
        if (m >= M || n >= N) continue;
        AccT v = acc[mt][nt][e];
        if constexpr (kA8 && kBits == 4) v >>= 4;  // exact: a sum of multiples of 16
        if (splits > 1) {
          part[((size_t)sp * M + m) * N + n] = v;
        } else if constexpr (kA8) {
          y[(size_t)m * N + n] = __float2bfloat16_rn((float)v * xs[m] * __bfloat162float(s[n]));
        } else {
          y[(size_t)m * N + n] = __float2bfloat16_rn(v * __bfloat162float(s[n]));
        }
      }
}

// One thread per output: the splits' partials added in split order, then
// the scales. grid: ceil(M * N / kReduceThreads).
template <bool kA8>
__global__ void __launch_bounds__(kReduceThreads) reduce_splits_kernel(
    const typename Acc<kA8>::T* __restrict__ part, const float* __restrict__ xs,
    const __nv_bfloat16* __restrict__ s, __nv_bfloat16* __restrict__ y, int M, int N,
    int splits) {
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  typename Acc<kA8>::T v = part[i];
  for (int g = 1; g < splits; ++g) v += part[g * mn + i];
  const int n = (int)(i % N);
  if constexpr (kA8) {
    y[i] = __float2bfloat16_rn((float)v * xs[i / N] * __bfloat162float(s[n]));
  } else {
    y[i] = __float2bfloat16_rn(v * __bfloat162float(s[n]));
  }
}

int splits_for(int N, int K, int bits) {
  const int Kb = bits == 4 ? K / 2 : K;
  const int chunks = (Kb + kChunk - 1) / kChunk;
  const int tiles = (N + kBN - 1) / kBN;
  int g = (kTargetBlocks + tiles / 2) / tiles;
  g = g < chunks / kMinChunksPerSplit ? g : chunks / kMinChunksPerSplit;
  g = g < kMaxSplits ? g : kMaxSplits;
  return g > 1 ? g : 1;
}

// The kernel's dynamic shared memory may exceed the 48 KB default; the
// raised limit belongs to the current device, so it is set once per device.
template <int kBits, bool kA8>
cudaError_t raise_smem_limit() {
  static std::atomic<uint64_t> done{0};  // bit i: device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(quant_linear_kernel<kBits, kA8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<kBits, kA8>::kSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int kBits, bool kA8>
int launch(const void* x, const void* xs, const void* w, const void* s, void* y, void* part,
           int M, int N, int K, cudaStream_t stream) {
  using AccT = typename Acc<kA8>::T;
  const cudaError_t attr = raise_smem_limit<kBits, kA8>();
  if (attr != cudaSuccess) return (int)attr;
  const int Kb = kBits == 4 ? K / 2 : K;
  const int n_chunks = (Kb + kChunk - 1) / kChunk;
  const int splits = splits_for(N, K, kBits);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  quant_linear_kernel<kBits, kA8><<<grid, kThreads, Tile<kBits, kA8>::kSmem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const __nv_bfloat16*>(s),
      static_cast<__nv_bfloat16*>(y), static_cast<AccT*>(part), M, N, K, n_chunks, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  reduce_splits_kernel<kA8><<<(unsigned)((mn + kReduceThreads - 1) / kReduceThreads),
                              kReduceThreads, 0, stream>>>(
      static_cast<const AccT*>(part), static_cast<const float*>(xs),
      static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(y), M, N, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Splits of the K range for a weight [N, K] of `bits` (4 or 8): the
// caller's scratch holds splits * M * N f32 (a16) or int32 (a8) elements
// when it is above 1. Depends on N, K and bits only.
extern "C" int sjd_quant_linear_splits(int N, int K, int bits) { return splits_for(N, K, bits); }

// a8 == 0: x bf16 [M, K], xs unused; a8 != 0: x int8 [M, K], xs f32 [M].
// w: int8 [N, K] (bits 8) or packed uint8 [N, K/2] (bits 4); s bf16 [N];
// y bf16 [M, N]; part: the scratch (NULL for one split). The weight bytes
// per row must be a multiple of 16, x and w 16-byte aligned (checked by the
// Python wrapper; bits other than 4 and 8 return cudaErrorInvalidValue).
extern "C" int sjd_quant_linear(const void* x, const void* xs, const void* w, const void* s,
                                void* y, void* part, int M, int N, int K, int bits, int a8,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4 && !a8) return launch<4, false>(x, xs, w, s, y, part, M, N, K, st);
  if (bits == 8 && !a8) return launch<8, false>(x, xs, w, s, y, part, M, N, K, st);
  if (bits == 4 && a8) return launch<4, true>(x, xs, w, s, y, part, M, N, K, st);
  if (bits == 8 && a8) return launch<8, true>(x, xs, w, s, y, part, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}
