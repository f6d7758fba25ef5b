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
// the bytes that must come from HBM: a 4096 x 4096 projection is 8.4 MB in
// int4, 2.5 us at 3.35 TB/s, against 1.07 GFLOP, 1.1 us at the bf16 tensor
// cores' dense peak. What the card spends beyond that goes to the bytes the
// kernel moves besides: every block stages the activation columns of its
// chunks beside its weight rows, so every N tile reads the whole activation
// again from L2 (at 64 weight rows per block, twice the int4 weight bytes),
// and a K range split over several blocks writes and reads partial sums.
// What the design does about it:
//
// - K1's block holds kBN = 128 weight rows (8 warps of 16): each staged
//   activation chunk feeds all of them, half the activation bytes per
//   weight byte of a 64-row block. K2's activations are int8, half K1's
//   bytes, and its block keeps 64 rows (4 warps of 16, two chunks a stage):
//   no 128-row layout ran faster for it. A block takes kBM = 32 activation
//   rows; M above 32 takes more blocks along M. A chunk is 64 bytes of each
//   weight row; one 16-byte read of a row feeds 16 columns at k and, for
//   int4, 16 at k + K/2, so the activation tile holds both.
// - A cp.async ring, kStages stages of kWarpsK chunks, for the weight and
//   activation tiles, so that the next chunks' bytes are in flight while
//   one is multiplied.
// - Tensor cores through mma.sync: K1 on m16n8k16 bf16 with f32 sums (the
//   int -> bf16 convert is exact: an int4 nibble becomes 136 + v by a bit
//   pattern, minus 136; an int8 code goes through an exact f32); K2 on
//   m16n8k32 s8 with s32 sums, exact, int4 nibbles widened to int8 as
//   16 * v (one mask), the sum shifted right by 4 at the end.
// - One launch. The K range is split over gridDim.z; the split count
//   depends on N, K, the bits and the kernel (sjd_quant_linear_splits),
//   never on M: at most one wave of resident blocks at one M tile (kWaveBlocks), at
//   least a full ring of chunks per split, and at most kMaxSplits (the
//   partials of more splits cost more than their blocks add). With more
//   than one split each block writes its f32 (K1) or int32 (K2) partial to
//   a scratch the caller allocates, then counts its arrival on an int32
//   counter of its (N tile, M tile) in a buffer the caller keeps zeroed.
//   The block that arrives last adds the partials in split order 0 .. g-1,
//   applies the scales, writes y and stores 0 back into the counter, so the
//   next launch, and every replay of a graph that holds this one, finds it
//   zero. A row of y is therefore bit-identical whatever M is (the
//   batcher's promise: a request's tokens do not depend on the batch
//   width). The kernel assumes one stream at a time: two launches in
//   flight together on one counter buffer would mix their arrivals.
// - The k order inside an mma is permuted alike in both operands so that
//   each thread reads consecutive bytes; shared-memory rows are padded so
//   that the 16-byte fragment reads of a quarter warp hit distinct banks.
//   The kernel declares no static shared memory: a 16-byte flag beside the
//   dynamic ring made the same loop 15-40% slower on the H100, so the
//   arrival flag lives in the idle ring.
//
// C interface (ctypes): sjd_quant_linear(...) returns cudaGetLastError();
// sjd_quant_linear_splits(N, K, bits, a8) returns the split count, which
// sizes the caller's scratch; sjd_quant_linear_tile(dim, a8) the block's
// weight rows (dim 0) and activation rows (dim 1), which size its
// counters; sjd_quant_linear_resident(bits, a8) the blocks the current
// device holds at once. The kernel launches on the given stream and
// allocates nothing.

#include <atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the block's warps: kWarpsN along N of kWarpRows weight rows each, kWarpsK
// along K (warp group kk takes chunk kk of a stage); K1 (A16) and K2 (A8)
// each have their own layout
constexpr int kWarpRows = 16;  // weight rows per warp: kWarpRows / 8 n8 tiles
constexpr int kWarpsNA16 = 8;  // K1: 8 x 16 = 128 weight rows
constexpr int kWarpsKA16 = 1;
constexpr int kWarpsNA8 = 4;   // K2: 4 x 16 = 64 weight rows, 2 chunks a stage
constexpr int kWarpsKA8 = 2;
constexpr int kStages = 4;     // stages of kWarpsK chunks in the cp.async ring
constexpr int kBlocksPerSM = 2;  // blocks resident on each SM (registers capped to fit)
constexpr int kSMs = 132;        // the H100 SXM's
constexpr int kMaxSplits = 4;    // more splits write more partials than they save
constexpr bool kStageX = true;  // false only in a timing copy: no activation loads
constexpr int kNT = kWarpRows / 8;        // n8 tiles per warp
constexpr int kBM = 32;                   // activation rows per block (two m16 tiles)
constexpr int kChunk = 64;                // weight bytes per row per chunk
constexpr int kWaveBlocks = kSMs * kBlocksPerSM;  // one wave of blocks
static_assert(kWarpRows % 8 == 0 && kWarpRows >= 8, "a warp takes whole n8 tiles");

template <bool kA8>
struct Warps {
  static constexpr int kN = kA8 ? kWarpsNA8 : kWarpsNA16;
  static constexpr int kK = kA8 ? kWarpsKA8 : kWarpsKA16;
  static constexpr int kThreads = 32 * kN * kK;
  static constexpr int kBN = kN * kWarpRows;  // weight rows per block
  static constexpr int kMinChunksPerSplit = kStages * kK;  // a split fills the ring
  static_assert(kThreads % kBN == 0 && kBM % (kThreads / kBN) == 0,
                "the split sum: a thread keeps its column and takes whole rows");
};

template <int kBits, bool kA8>
struct Tile {
  static constexpr int kWarpsN = Warps<kA8>::kN, kWarpsK = Warps<kA8>::kK;
  static constexpr int kBN = Warps<kA8>::kBN;
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
  // the warp groups' sums, merged at the end: [kWarpsK - 1][kWarpsN][32 lanes][kPerLane]
  static constexpr int kPerLane = 2 * kNT * 4;
  static constexpr int kRed = (kWarpsK - 1) * kWarpsN * 32 * kPerLane * 4;
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

// y's element from its summed product: the scales in JAX's order
template <bool kA8>
__device__ __forceinline__ __nv_bfloat16 scaled(typename Acc<kA8>::T v, const float* xs,
                                                const __nv_bfloat16* s, int m, int n) {
  if constexpr (kA8) {
    return __float2bfloat16_rn((float)v * xs[m] * __bfloat162float(s[n]));
  } else {
    return __float2bfloat16_rn(v * __bfloat162float(s[n]));
  }
}

// grid: (ceil(N / kBN), ceil(M / kBM), splits); block: kThreads; dynamic
// shared memory: Tile<kBits, kA8>::kSmem (kBN, kThreads: Warps<kA8>).
template <int kBits, bool kA8>
__global__ void __launch_bounds__(Warps<kA8>::kThreads, kBlocksPerSM) quant_linear_kernel(
    const uint8_t* __restrict__ x,          // A16: bf16 [M, K]; A8: int8 [M, K]
    const float* __restrict__ xs,           // A8: f32 [M]
    const uint8_t* __restrict__ w,          // [N, Kb] bytes: int8 codes or packed int4
    const __nv_bfloat16* __restrict__ s,    // [N]
    __nv_bfloat16* __restrict__ y,          // [M, N]
    typename Acc<kA8>::T* __restrict__ part,  // [splits, M, N] (several splits)
    int* __restrict__ counters,             // [gridDim.y * gridDim.x], zero (several splits)
    int M, int N, int K, int n_chunks, int splits) {
  using Lay = Tile<kBits, kA8>;
  using AccT = typename Acc<kA8>::T;
  constexpr int kWarpsN = Warps<kA8>::kN, kWarpsK = Warps<kA8>::kK;
  constexpr int kThreads = Warps<kA8>::kThreads, kBN = Warps<kA8>::kBN;
  extern __shared__ __align__(16) uint8_t smem[];

  const int Kb = kBits == 4 ? K / 2 : K;  // weight bytes per row = k per half
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int sp = blockIdx.z;
  const int c_begin = sp * n_chunks / splits;
  const int c_count = (sp + 1) * n_chunks / splits - c_begin;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wn = warp % kWarpsN;  // the warp's kWarpRows weight rows
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
    if constexpr (kStageX) {
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
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_stages) issue(i);
    cp_async_commit();
  }

  AccT acc[2][kNT][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < kNT; ++b)
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
    uint4 wb[kNT];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      wb[j] = *reinterpret_cast<const uint4*>(wst + (kWarpRows * wn + 8 * j + gid) * kChunk +
                                              16 * tig);

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
            for (int nt = 0; nt < kNT; ++nt) {
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
          for (int nt = 0; nt < kNT; ++nt) {
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
      AccT* mine = red + (((wk - 1) * kWarpsN + wn) * 32 + lane) * Lay::kPerLane;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < kNT; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) mine[(a * kNT + b) * 4 + e] = acc[a][b][e];
    }
    __syncthreads();
    if (wk == 0) {
      for (int g = 1; g < kWarpsK; ++g) {
        const AccT* theirs = red + (((g - 1) * kWarpsN + wn) * 32 + lane) * Lay::kPerLane;
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < kNT; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][b][e] += theirs[(a * kNT + b) * 4 + e];
      }
    }
  }

  // c0, c1: row gid, columns 2t, 2t+1; c2, c3: row gid + 8
  if (wk == 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 16 * mt + gid + 8 * (e >> 1);
          const int n = n0 + kWarpRows * wn + 8 * nt + 2 * tig + (e & 1);
          if (m >= M || n >= N) continue;
          AccT v = acc[mt][nt][e];
          if constexpr (kA8 && kBits == 4) v >>= 4;  // exact: a sum of multiples of 16
          if (splits > 1) {
            part[((size_t)sp * M + m) * N + n] = v;
          } else {
            y[(size_t)m * N + n] = scaled<kA8>(v, xs, s, m, n);
          }
        }
  }
  if (splits == 1) return;

  // the split sum, in this launch: the tile's last block to arrive adds the
  // partials in split order (fixed: the same for every M) and zeroes the
  // tile's counter again
  __syncthreads();  // every partial of this block is written, the ring idle
  int* counter = counters + blockIdx.y * gridDim.x + blockIdx.x;
  int* arrived_last = reinterpret_cast<int*>(smem);
  if (tid == 0) {
    // release: the block's partials (ordered before by the barrier) before
    // its arrival; acquire: every other block's partials before the sum
    int before;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(before) : "l"(counter) : "memory");
    *arrived_last = before == splits - 1;
  }
  __syncthreads();
  if (!*arrived_last) return;
  // kPer outputs per thread, consecutive threads on consecutive columns;
  // the loads of kBatch splits are in flight together (from L2: ld.cg)
  constexpr int kPer = kBM * kBN / kThreads;
  constexpr int kRowStep = kThreads / kBN;  // output j: row m1 + j kRowStep, column n1
  constexpr int kBatch = kPer >= 32 ? 1 : 32 / kPer;
  const int m1 = m0 + tid / kBN, n1 = n0 + tid % kBN;
  const size_t mn = (size_t)M * N;
  const AccT* p1 = part + (size_t)m1 * N + n1;
  AccT v[kPer];
  for (int g0 = 0; g0 < splits; g0 += kBatch) {
    AccT t[kBatch][kPer];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        t[b][j] = g0 + b < splits && m1 + j * kRowStep < M && n1 < N
                      ? __ldcg(p1 + (g0 + b) * mn + j * kRowStep * N)
                      : AccT(0);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (g0 + b < splits) v[j] = g0 + b == 0 ? t[b][j] : v[j] + t[b][j];
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int m = m1 + j * kRowStep;
    if (m < M && n1 < N) y[(size_t)m * N + n1] = scaled<kA8>(v[j], xs, s, m, n1);
  }
  if (tid == 0) *counter = 0;
}

template <bool kA8>
int splits_for(int N, int K, int bits) {
  const int Kb = bits == 4 ? K / 2 : K;
  const int chunks = (Kb + kChunk - 1) / kChunk;
  const int tiles = (N + Warps<kA8>::kBN - 1) / Warps<kA8>::kBN;
  const int fill = chunks / Warps<kA8>::kMinChunksPerSplit;
  int g = kWaveBlocks / tiles;  // at most one wave at one M tile
  g = g < fill ? g : fill;
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
           void* counters, int M, int N, int K, cudaStream_t stream) {
  using AccT = typename Acc<kA8>::T;
  const cudaError_t attr = raise_smem_limit<kBits, kA8>();
  if (attr != cudaSuccess) return (int)attr;
  const int Kb = kBits == 4 ? K / 2 : K;
  const int n_chunks = (Kb + kChunk - 1) / kChunk;
  const int splits = splits_for<kA8>(N, K, kBits);
  if (splits > 1 && (part == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  constexpr int kBN = Warps<kA8>::kBN;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  quant_linear_kernel<kBits, kA8>
      <<<grid, Warps<kA8>::kThreads, Tile<kBits, kA8>::kSmem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(xs),
      static_cast<const uint8_t*>(w), static_cast<const __nv_bfloat16*>(s),
      static_cast<__nv_bfloat16*>(y), static_cast<AccT*>(part), static_cast<int*>(counters),
      M, N, K, n_chunks, splits);
  return (int)cudaGetLastError();
}

template <int kBits, bool kA8>
int resident() {
  cudaError_t err = raise_smem_limit<kBits, kA8>();
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quant_linear_kernel<kBits, kA8>, Warps<kA8>::kThreads,
        Tile<kBits, kA8>::kSmem);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

}  // namespace

// Splits of the K range for a weight [N, K] of `bits` (4 or 8) under K1
// (a8 == 0) or K2: the caller's scratch holds splits * M * N f32 (a16) or
// int32 (a8) elements when it is above 1. Depends on N, K, bits and a8 only.
extern "C" int sjd_quant_linear_splits(int N, int K, int bits, int a8) {
  return a8 ? splits_for<true>(N, K, bits) : splits_for<false>(N, K, bits);
}

// K1's (a8 == 0) or K2's block: its weight rows (dim 0) or activation rows
// (dim 1); a launch of several splits counts arrivals on ceil(N / rows0) *
// ceil(M / rows1) counters.
extern "C" int sjd_quant_linear_tile(int dim, int a8) {
  return dim != 0 ? kBM : a8 ? Warps<true>::kBN : Warps<false>::kBN;
}

// Blocks of the kernel for (bits, a8) the current device holds at once, or
// minus a CUDA error.
extern "C" int sjd_quant_linear_resident(int bits, int a8) {
  if (bits == 4 && !a8) return resident<4, false>();
  if (bits == 8 && !a8) return resident<8, false>();
  if (bits == 4 && a8) return resident<4, true>();
  if (bits == 8 && a8) return resident<8, true>();
  return -(int)cudaErrorInvalidValue;
}

// a8 == 0: x bf16 [M, K], xs unused; a8 != 0: x int8 [M, K], xs f32 [M].
// w: int8 [N, K] (bits 8) or packed uint8 [N, K/2] (bits 4); s bf16 [N];
// y bf16 [M, N]; part: the scratch and counters: int32 zeros, one per
// (N tile, M tile) (both NULL for one split). The weight bytes per row must
// be a multiple of 16, x and w 16-byte aligned (checked by the Python
// wrapper; bits other than 4 and 8 return cudaErrorInvalidValue).
extern "C" int sjd_quant_linear(const void* x, const void* xs, const void* w, const void* s,
                                void* y, void* part, void* counters, int M, int N, int K,
                                int bits, int a8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4 && !a8) return launch<4, false>(x, xs, w, s, y, part, counters, M, N, K, st);
  if (bits == 8 && !a8) return launch<8, false>(x, xs, w, s, y, part, counters, M, N, K, st);
  if (bits == 4 && a8) return launch<4, true>(x, xs, w, s, y, part, counters, M, N, K, st);
  if (bits == 8 && a8) return launch<8, true>(x, xs, w, s, y, part, counters, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}
