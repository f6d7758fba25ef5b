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
// K1 (quant_linear_kernel_wg). What bounds it depends on M. At the batched
// cells' decode windows (96 to 160 rows) and in a prefill (tiles of up to
// 256 rows): the operations. A 4096 x 4096 int4 projection at M = 160 is 5.4
// GFLOP, 5.4 us at the bf16 tensor cores' 989 TFLOP/s, against 8.4 MB of
// packed weight, 2.5 us at 3.35 TB/s. Only wgmma reaches that rate, and only
// if the weights are widened once per launch, not once per slice of M. At
// the solo window's 32 rows: the weight bytes (the same 8.4 MB against 1.1
// GFLOP). There the time above that bound goes to what each block does per
// 64-byte chunk of its rows: the same warps widen 128 rows x 64 bytes into
// bf16 fragments and issue the chunk's wgmmas, whose m64n32k16 shape runs
// at about a third of the tensor cores' rate; two blocks share an SM. What
// the design does about it:
//
// - The block holds 128 weight rows, two consumer warpgroups of 64 (wgmma's
//   m), against kN activation rows: M rounded up to 16 (M <= 16) or 32, at
//   most 256 (wgmma's largest n); above 256, M is cut into equal tiles of at
//   most 256 rows, one block row each. So at M <= 256 each weight byte is
//   read and widened once per launch, and every product runs on
//   wgmma.m64n{kN}k16 with A from registers and f32 sums in registers.
// - A, the weights: each thread widens its fragment from the staged bytes
//   into registers, as 16-bit reads of two codes (no bank conflicts under
//   the tile's 64-byte swizzle) at offsets fixed for the launch (a row's
//   swizzle phase is its own); int4 nibble v becomes the bf16 pattern of
//   136 + v (one lop3 of mask and exponent), minus 136, int8 goes through an
//   exact f32. Both exact; six instructions widen four int4 codes.
// - B, the activations: K-major, 128-byte swizzle, one swizzle atom of 64
//   columns per k16 group of four steps. int4 stages the first half's 64
//   columns j and the second half's K/2 + j of a 64-byte chunk as two atoms,
//   so that a thread's two bytes feed one step of each half (low nibbles,
//   high nibbles).
// - Loads by TMA, from a producer: a warp where two blocks share an SM (kN
//   <= 64), else a warpgroup that hands its registers to the consumers
//   (setmaxnreg, so that kN / 2 sums a thread fit). One of its threads asks
//   for each stage's tiles (activations from a [M][2][K/2] or [M][K] tensor
//   map, weights from [N][Kb]), which land swizzled; out-of-range rows and
//   columns read 0. Each slot of the ring (kStages chunks, up to 8, what
//   shared memory holds at kN: 3 at 256 rows) has two mbarriers: full, on
//   which the tiles count their bytes and the consumers wait, and empty, on
//   which each consumer warp arrives once the slot's last wgmma has retired
//   and the producer waits before it refills the slot. No block-wide
//   barrier is left in the loop, and every slot is in flight. (cp.async by
//   every thread, 3072 copies of 16 bytes a chunk at 160 rows, ran the
//   kernel at half this speed on the H100.)
// - The wgmmas of a chunk are issued one k16 step after the other, each on
//   its own commit and waiting only for the one before (which frees its A
//   registers), so that the next step's fragments are widened while a step
//   runs; the first scales the sums by 0, so no instruction besides wgmma
//   writes them. (A chunk's eight wgmmas issued back to back on one commit
//   ran slower on the H100 at 32 rows: each waits for the one before, and
//   the warp waits with them, with no widening left to overlap.)
// - The K order inside a row is fixed (chunk by chunk, within a chunk k16
//   steps in order, int4 alternating halves) and the split sum adds in
//   split order, so a row's output is bit-identical whatever M is.
//
// K2 (quant_linear_kernel). At the decode path's M = 32 the weights are the
// bytes that must come from HBM; what the card spends beyond them goes to the
// bytes the kernel moves besides: every block stages the activation columns
// of its chunks beside its weight rows, and a K range split over several
// blocks writes and reads partial sums. What the design does about it:
//
// - The block keeps 64 weight rows (4 warps of 16, two chunks a stage) and
//   kBM = 32 activation rows; M above 32 takes more blocks along M. A chunk
//   is 64 bytes of each weight row; one 16-byte read of a row feeds 16
//   columns at k and, for int4, 16 at k + K/2, so the activation tile holds
//   both.
// - A cp.async ring, kStages stages of kWarpsK chunks, for the weight and
//   activation tiles, so that the next chunks' bytes are in flight while
//   one is multiplied.
// - mma.sync m16n8k32 s8 with s32 sums, exact, int4 nibbles widened to int8
//   as 16 * v (one mask), the sum shifted right by 4 at the end. The k order
//   inside an mma is permuted alike in both operands so that each thread
//   reads consecutive bytes; shared-memory rows are padded so that the
//   16-byte fragment reads of a quarter warp hit distinct banks. The kernel
//   declares no static shared memory: a 16-byte flag beside the dynamic ring
//   made the same loop 15-40% slower on the H100, so the arrival flag lives
//   in the idle ring.
//
// Both: one launch per product. The K range is split over gridDim.z; the
// split count depends on N, K, the bits and the kernel (sjd_quant_linear_splits),
// never on M: at most one wave of resident blocks at one 32-row M tile
// (kWaveBlocks), at least a full ring of chunks per split, and at most
// kMaxSplits (the partials of more splits cost more than their blocks add).
// With more than one split each block writes its f32 (K1) or int32 (K2)
// partial to a scratch the caller allocates (K1 in its own fragment order,
// 16 bytes a thread), then counts its arrival on an int32 counter of its
// (N tile, M tile) in a buffer the caller keeps zeroed. The block that
// arrives last adds the partials in split order 0 .. g-1 (K1 its own from its
// registers), applies the scales, writes y and stores 0 back into the
// counter, so the next launch, and every replay of a graph that holds this
// one, finds it zero. A row of y is therefore bit-identical whatever M is
// (the batcher's promise: a request's tokens do not depend on the batch
// width). The kernels assume one stream at a time: two launches in flight
// together on one counter buffer would mix their arrivals.
//
// C interface (ctypes): sjd_quant_linear(...) returns cudaGetLastError();
// sjd_quant_linear_splits(N, K, bits, a8) returns the split count;
// sjd_quant_linear_scratch(M, N, K, bits, a8) the elements of the caller's
// scratch; sjd_quant_linear_tile(dim, a8) the block's weight rows (dim 0) and
// 32 activation rows (dim 1), which size its counters;
// sjd_quant_linear_resident(bits, a8) the blocks the current device holds at
// once. The kernels launch on the given stream and allocate nothing; K1's
// tensor maps are encoded on the host at each launch (cuTensorMapEncodeTiled
// through the runtime's driver entry point) and passed as kernel parameters,
// so a captured graph replays them.

#include <atomic>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the block's warps: kWarpsN along N of kWarpRows weight rows each, kWarpsK
// along K (warp group kk takes chunk kk of a stage); K1 (A16) and K2 (A8)
// each have their own layout
constexpr int kWarpRows = 16;  // weight rows per warp: kWarpRows / 8 n8 tiles
constexpr int kWarpsNA16 = 8;  // K1: 8 x 16 = 128 weight rows, two warpgroups, a chunk a stage
constexpr int kWarpsKA16 = 1;
constexpr int kWarpsNA8 = 4;   // K2: 4 x 16 = 64 weight rows, 2 chunks a stage
constexpr int kWarpsKA8 = 2;
constexpr int kStages = 4;     // K2's ring: stages of kWarpsK chunks (and a split's least)
constexpr int kBlocksPerSM = 2;  // blocks resident on each SM (registers capped to fit)
constexpr int kSMs = 132;        // the H100 SXM's
constexpr int kMaxSplits = 4;    // more splits write more partials than they save
constexpr bool kStageX = true;  // false only in a timing copy: no activation loads
constexpr bool kWgMma = true;    // false only in a timing copy: K1 issues no wgmma
constexpr bool kWgWiden = true;  // false only in a timing copy: K1's weight bytes unwidened
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

// c += a (16x32, row) . b (32x8, col), s8 in, s32 accumulate
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// ---------------------------------------------------------------------------
// K1: quant_linear_kernel_wg<kBits, kN>, the block's 128 weight rows against
// kN activation rows on wgmma (the header says why and how).

constexpr int kWgRows = 64;           // weight rows per consumer warpgroup: wgmma's m
constexpr int kWgConsumers = 2 * 128;  // two warpgroups: K1's 128 weight rows (Warps<false>)
constexpr int kWgMaxN = 256;        // activation rows per block at most: wgmma's largest n
constexpr int kWgMaxStages = 8;     // chunks in the ring at most
constexpr int kSmemPerSM = 233472;  // the H100's 228 KB, the driver's 1 KB a block included
constexpr int kSmemPerBlock = 232448;
static_assert(kWgConsumers / 128 * kWgRows == Warps<false>::kBN &&
                  Warps<false>::kThreads == kWgConsumers,
              "K1's block: 8 warps of 16 weight rows, two warpgroups");

template <int kBits, int kN>
struct WgTile {
  static constexpr int kAtoms = kBits == 4 ? 2 : 1;  // 128-byte activation rows per chunk
  static constexpr int kSteps = 4 * kAtoms;          // k16 steps per chunk
  static constexpr int kBlocks = kN <= 64 ? 2 : 1;   // blocks resident on each SM
  static constexpr int kXBytes = kAtoms * kN * 128;  // a chunk's activation tile
  static constexpr int kStageBytes = kXBytes + Warps<false>::kBN * kChunk;
  static constexpr int kPerBlock = kSmemPerSM / kBlocks - 1024 < kSmemPerBlock
                                       ? kSmemPerSM / kBlocks - 1024 : kSmemPerBlock;
  static constexpr int kBars = 16 * kWgMaxStages;  // a slot's two mbarriers: full, empty
  static constexpr int kFit = (kPerBlock - 1024 - kBars) / kStageBytes;
  static constexpr int kStages = kFit < kWgMaxStages ? kFit : kWgMaxStages;
  // the ring, 1 KB to align it to the swizzle's atoms, its mbarriers
  static constexpr int kSmem = kStages * kStageBytes + 1024 + kBars;
  // the block: two consumer warpgroups and the producer. Two blocks share
  // an SM (kBlocks 2): a producer warp. A block alone on its SM: a producer
  // warpgroup, which hands its registers to the consumers (setmaxnreg), so
  // that kN / 2 sums a thread fit beside the A fragments
  static constexpr int kThreads = kWgConsumers + (kBlocks == 1 ? 128 : 32);
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static_assert(kBlocks == 2 || (kWgConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536 &&
                                 65536 / kThreads / 8 * 8 * kThreads >=
                                     kWgConsumers * kConsumerRegs + 128 * kProducerRegs),
                "setmaxnreg: the consumers' registers come from the producer's");
  static_assert(kN % 16 == 0 && kN <= kWgMaxN, "wgmma's n: a multiple of 16, at most 256");
  static_assert(kStages >= 3, "the ring holds the chunk multiplied, one draining, one landing");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// B's descriptor: K-major, 128-byte swizzle, activation rows 128 bytes
// apart (8-row groups 1024), starting at shared address addr
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64 x n] += a (registers: 64 x 16 bf16, m16n8k16's A fragment per warp)
// . b (shared: 16 x n bf16 by b_desc), f32 sums in registers
template <int kN>
struct Wgmma;
#define QL_F8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define QL_UNPAREN(...) __VA_ARGS__
#define QL_WGMMA(N, REGS, OUTS, AB, SCALE)                                                  \
  template <>                                                                              \
  struct Wgmma<N> {                                                                        \
    static __device__ __forceinline__ void run(float* d, const uint32_t* a, uint64_t desc,   \
                                               int scale) {                                \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"                       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS "}, " AB \
                   ", p, 1, 1, 0;\n}\n"                                                     \
                   : QL_UNPAREN OUTS                                                        \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale));     \
    }                                                                                      \
  };
#define QL_R0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define QL_R1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define QL_R2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define QL_R3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define QL_R4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define QL_R5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define QL_R6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define QL_R7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define QL_R8 "%64, %65, %66, %67, %68, %69, %70, %71"
#define QL_R9 "%72, %73, %74, %75, %76, %77, %78, %79"
#define QL_R10 "%80, %81, %82, %83, %84, %85, %86, %87"
#define QL_R11 "%88, %89, %90, %91, %92, %93, %94, %95"
#define QL_R12 "%96, %97, %98, %99, %100, %101, %102, %103"
#define QL_R13 "%104, %105, %106, %107, %108, %109, %110, %111"
#define QL_R14 "%112, %113, %114, %115, %116, %117, %118, %119"
#define QL_R15 "%120, %121, %122, %123, %124, %125, %126, %127"
// the first 2g groups of 8 accumulators: their operand numbers, their operands
#define QL_R_2 QL_R0 ", " QL_R1
#define QL_F_2 QL_F8(0), QL_F8(8)
#define QL_R_4 QL_R_2 ", " QL_R2 ", " QL_R3
#define QL_F_4 QL_F_2, QL_F8(16), QL_F8(24)
#define QL_R_6 QL_R_4 ", " QL_R4 ", " QL_R5
#define QL_F_6 QL_F_4, QL_F8(32), QL_F8(40)
#define QL_R_8 QL_R_6 ", " QL_R6 ", " QL_R7
#define QL_F_8 QL_F_6, QL_F8(48), QL_F8(56)
#define QL_R_10 QL_R_8 ", " QL_R8 ", " QL_R9
#define QL_F_10 QL_F_8, QL_F8(64), QL_F8(72)
#define QL_R_12 QL_R_10 ", " QL_R10 ", " QL_R11
#define QL_F_12 QL_F_10, QL_F8(80), QL_F8(88)
#define QL_R_14 QL_R_12 ", " QL_R12 ", " QL_R13
#define QL_F_14 QL_F_12, QL_F8(96), QL_F8(104)
#define QL_R_16 QL_R_14 ", " QL_R14 ", " QL_R15
#define QL_F_16 QL_F_14, QL_F8(112), QL_F8(120)
QL_WGMMA(16, QL_R0, (QL_F8(0)), "{%8, %9, %10, %11}, %12", "%13")
QL_WGMMA(32, QL_R_2, (QL_F_2), "{%16, %17, %18, %19}, %20", "%21")
QL_WGMMA(64, QL_R_4, (QL_F_4), "{%32, %33, %34, %35}, %36", "%37")
QL_WGMMA(96, QL_R_6, (QL_F_6), "{%48, %49, %50, %51}, %52", "%53")
QL_WGMMA(128, QL_R_8, (QL_F_8), "{%64, %65, %66, %67}, %68", "%69")
QL_WGMMA(160, QL_R_10, (QL_F_10), "{%80, %81, %82, %83}, %84", "%85")
QL_WGMMA(192, QL_R_12, (QL_F_12), "{%96, %97, %98, %99}, %100", "%101")
QL_WGMMA(224, QL_R_14, (QL_F_14), "{%112, %113, %114, %115}, %116", "%117")
QL_WGMMA(256, QL_R_16, (QL_F_16), "{%128, %129, %130, %131}, %132", "%133")
#undef QL_WGMMA
#undef QL_UNPAREN
#undef QL_F8

// two packed int4 bytes (byte 0: column j, byte 1: column j + 1) -> bf16x2
// of their low nibbles (columns j, j + 1 of the first half of K) and of
// their high nibbles (the second half), exactly: nibble v (two's
// complement) becomes the bf16 bit pattern of 136 + v, then 136 is
// subtracted
__device__ __forceinline__ void nibble_pairs_to_bf16(uint32_t u, uint32_t& lo, uint32_t& hi) {
  const uint32_t t = __byte_perm(u, 0, 0x4140);
  // (t & 0x000F000F) ^ 0x43084308 and the same of t >> 4, one lop3 each
  // (the compiler's own takes two)
  uint32_t a, b;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(a) : "r"(t), "r"(0x000F000Fu), "r"(0x43084308u));
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(b) : "r"(t >> 4), "r"(0x000F000Fu), "r"(0x43084308u));
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  const __nv_bfloat162 ra = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&a), off);
  const __nv_bfloat162 rb = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&b), off);
  lo = *reinterpret_cast<const uint32_t*>(&ra);
  hi = *reinterpret_cast<const uint32_t*>(&rb);
}

// two int8 codes (bytes 0, 1 of u) -> bf16x2, exactly: byte b becomes the
// f32 2^23 + (b ^ 0x80), minus 2^23 + 128, whose upper half is the bf16
// value
__device__ __forceinline__ uint32_t int8_pair_to_bf16(uint32_t u) {
  const uint32_t v = u ^ 0x8080u;
  const float f0 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7651)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// TMA and mbarrier: one thread asks for a whole tile, which lands in shared
// memory (swizzled as its tensor map says) and counts its bytes on the
// stage's mbarrier; the threads wait on the barrier's phase
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// waits for phase `parity` of the barrier to complete; traps after about
// 2^31 cycles rather than hang the device
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 31)) __trap();
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar) : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// the consumer warps' barrier (the producer has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWgConsumers) : "memory");
}
// the weight tile's 64-byte swizzle (TMA's and CUTLASS's Swizzle<2,4,3>):
// the 16-byte unit (bits 4-5) XOR bits 7-8
__device__ __forceinline__ int swz64(int off) { return off ^ (((off >> 7) & 3) << 4); }

// grid: (ceil(N / 128), ceil(M / kN), splits); block: WgTile::kThreads (two
// consumer warpgroups, each 64 weight rows, and the producer); dynamic
// shared memory: WgTile<kBits, kN>::kSmem. tx: the activations' tensor map
// (int4: [M][2 halves][K/2], int8: [M][K], bf16, boxes of kN rows x 64
// columns, 128-byte swizzle); tw: the weight's ([N][Kb] bytes, boxes of 128
// rows x 64 bytes, 64-byte swizzle).
template <int kBits, int kN>
__global__ void __launch_bounds__(WgTile<kBits, kN>::kThreads, WgTile<kBits, kN>::kBlocks)
    quant_linear_kernel_wg(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
    const __nv_bfloat16* __restrict__ s,  // [N]
    __nv_bfloat16* __restrict__ y,        // [M, N]
    float* __restrict__ part,             // [tiles][splits][kN * 128] (several splits)
    int* __restrict__ counters,           // [gridDim.y * gridDim.x], zero (several splits)
    int M, int N, int n_chunks, int splits) {
  using Lay = WgTile<kBits, kN>;
  constexpr int kBN = Warps<false>::kBN;
  constexpr int kStages = Lay::kStages, kAtoms = Lay::kAtoms;
  constexpr int kTx = Warps<false>::kBN * kChunk + (kStageX ? Lay::kXBytes : 0);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = smem_addr(smem);
  const uint32_t full = sbase + kStages * Lay::kStageBytes;  // slot i's at + 8 i: its bytes in
  const uint32_t empty = full + 8 * kWgMaxStages;  // slot i's at + 8 i: its wgmmas retired

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kN;
  const int sp = blockIdx.z;
  const int c_begin = sp * n_chunks / splits;
  const int n_stages = (sp + 1) * n_chunks / splits - c_begin;  // one chunk a stage
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // the thread's weight rows in the block: A's rows gid and gid + 8 of its warp
  const int r0 = kWgRows * (warp >> 2) + 16 * (warp & 3) + gid;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, kWgConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWgConsumers / 32) {
    if constexpr (Lay::kBlocks == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Lay::kProducerRegs));
    // the producer: one lane keeps every slot of the ring in flight.
    // Stage i: chunk c_begin + i, kAtoms activation tiles (int4: the first
    // half's 64 columns j, then the second half's, K/2 + j), then the
    // weight tile of 128 rows x 64 bytes, into slot i % kStages once each
    // consumer warp has released the slot's stage before
    if (tid == kWgConsumers) {
      for (int i = 0; i < n_stages; ++i) {
        const int slot = i % kStages;
        if (i >= kStages) mbar_wait(empty + 8 * slot, (i / kStages + 1) & 1);
        const uint32_t st = sbase + slot * Lay::kStageBytes;
        const uint32_t bar = full + 8 * slot;
        const int c = (c_begin + i) * kChunk;
        mbar_expect(bar, kTx);
        if constexpr (kStageX) {
          if constexpr (kBits == 4) {
            tma_load(st, &tx, c, 0, m0, bar);
            tma_load(st + kN * 128, &tx, c, 1, m0, bar);
          } else {
            tma_load(st, &tx, c, m0, bar);
          }
        }
        tma_load(st + Lay::kXBytes, &tw, c, n0, bar);
      }
    }
    return;
  }

  if constexpr (Lay::kBlocks == 1)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Lay::kConsumerRegs));
  // the consumers. acc: [n8 tile j][row gid, gid + 8][column 2 tig, 2 tig +
  // 1]; the first wgmma scales them by 0 (zeroed registers would serialize
  // the wgmmas: ptxas C7515)
  float acc[kN / 2];
  // A's k slots (2t, 2t+1) and (2t+8, 2t+9) of k16 step q of a 64-column
  // tile are the tile's columns 16q + 2t, + 1 and 16q + 8 + 2t, + 1: weight
  // bytes 16q + 2t and 16q + 8 + 2t (int4: their low nibbles for the first
  // half, their high nibbles for the second). In a slot's swizzled weight
  // tile those of row gid lie at qoff[q] and qoff[q] + 8, those of row gid +
  // 8 (the same swizzle phase) 512 bytes on
  int qoff[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) qoff[q] = swz64(r0 * kChunk + 16 * q + 2 * tig);
  const uint64_t desc0 = b_desc(sbase);

  // a k16 step's wgmma on its own commit, the next step's A fragments
  // widened while it runs; a stage's slot goes back to the producer once
  // its last step has retired
  int slot = 0, before = kStages - 1;  // stage it's slot, stage it - 1's
  uint32_t phase = 0;                   // of stage it's full barrier
  for (int it = 0; it < n_stages; ++it) {
    mbar_wait(full + 8 * slot, phase);  // stage `it` landed
    const uint8_t* wst = smem + slot * Lay::kStageBytes + Lay::kXBytes;
    uint32_t raw[4][4];  // [q][row gid, gid + 8, the same at + 8 columns]
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        raw[q][k] =
            *reinterpret_cast<const uint16_t*>(wst + qoff[q] + 512 * (k & 1) + 8 * (k >> 1));
    // an offset of o bytes adds o >> 4 to a descriptor (shared addresses stay
    // below 256 KB: its 14-bit address field does not carry)
    const uint64_t dst = desc0 + ((slot * Lay::kStageBytes) >> 4);
#pragma unroll
    for (int step = 0; step < Lay::kSteps; ++step) {
      const int q = step / kAtoms, atom = step % kAtoms;
      uint32_t a[4];  // rows gid, gid + 8 at slots (2t, 2t+1); the same at (2t+8, 2t+9)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (!kWgWiden) {
          a[k] = raw[q][k] << (16 * atom);
        } else if constexpr (kBits == 4) {
          uint32_t lo, hi;
          nibble_pairs_to_bf16(raw[q][k], lo, hi);
          a[k] = atom ? hi : lo;
        } else {
          a[k] = int8_pair_to_bf16(raw[q][k]);
        }
      }
      const uint64_t desc = dst + ((atom * kN * 128 + 32 * q) >> 4);
      wgmma_fence();
      if constexpr (kWgMma) {
        Wgmma<kN>::run(acc, a, desc, it > 0 || step > 0);
      } else {
        asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
      }
      wgmma_commit();
      wgmma_wait<1>();  // the step before has retired: its A registers are free
      if (step == 0 && it > 0 && lane == 0)  // and it closed stage it - 1: the slot is free
        mbar_arrive(empty + 8 * before);
    }
    before = slot;
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < kN / 2; ++e) asm volatile("" : "+f"(acc[e])::"memory");

  if (splits > 1) {
    // each block's partial in its own fragment order: the tile's split sp
    // at part + ((tile * splits + sp) * kN * kBN), float4 j of thread tid at
    // [j][tid], so that every store and load is 16 bytes, a warp's 512
    // contiguous
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    float4* mine = reinterpret_cast<float4*>(part) + (tile * splits + sp) * (kN * kBN / 4);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
      __stcg(mine + j * kWgConsumers + tid,
             make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]));
    // the tile's last block to arrive adds the partials in split order
    // (fixed: the same for every M; its own from its registers) and zeroes
    // the tile's counter again
    consumer_sync();  // every partial of this block is written
    int* counter = counters + tile;
    int* arrived_last = reinterpret_cast<int*>(smem);
    if (tid == 0) {
      // release: the block's partials (ordered before by the barrier) before
      // its arrival; acquire: every other block's partials before the sum
      int before;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(before) : "l"(counter) : "memory");
      *arrived_last = before == splits - 1;
    }
    consumer_sync();
    if (!*arrived_last) return;
    const float4* first = reinterpret_cast<const float4*>(part) + tile * splits * (kN * kBN / 4);
    constexpr int kBatch4 = 2;  // float4s of every split in flight together
#pragma unroll
    for (int j0 = 0; j0 < kN / 8; j0 += kBatch4) {
      float4 t[kMaxSplits][kBatch4];
#pragma unroll
      for (int g = 0; g < kMaxSplits; ++g)
#pragma unroll
        for (int b = 0; b < kBatch4; ++b) {
          const int j = j0 + b;
          if (j < kN / 8 && g < splits && g != sp)
            t[g][b] = __ldcg(first + (g * (kN / 8) + j) * kWgConsumers + tid);
        }
#pragma unroll
      for (int b = 0; b < kBatch4; ++b) {
        const int j = j0 + b;
        if (j >= kN / 8) continue;
        const float4 own = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
        float4 v = sp == 0 ? own : t[0][b];
#pragma unroll
        for (int g = 1; g < kMaxSplits; ++g)
          if (g < splits) {
            const float4 u = g == sp ? own : t[g][b];
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
          }
        acc[4 * j] = v.x;
        acc[4 * j + 1] = v.y;
        acc[4 * j + 2] = v.z;
        acc[4 * j + 3] = v.w;
      }
    }
    if (tid == 0) *counter = 0;
  }

  // acc[4j + e]: weight row r0 + 8 (e >> 1), activation row 8j + 2t + (e & 1)
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 8 * j + 2 * tig + (e & 1);
      const int n = n0 + r0 + 8 * (e >> 1);
      if (m < M && n < N) y[(size_t)m * N + n] = scaled<false>(acc[4 * j + e], nullptr, s, m, n);
    }
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

// A kernel's dynamic shared memory may exceed the 48 KB default; the
// raised limit belongs to the current device, so it is set once per device
// (bit i of `done`: device i).
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}
template <int kBits, bool kA8>
cudaError_t raise_smem_limit() {
  static std::atomic<uint64_t> done{0};
  return raise_smem_limit(quant_linear_kernel<kBits, kA8>, Tile<kBits, kA8>::kSmem, done);
}
template <int kBits, int kN>
cudaError_t raise_smem_limit_wg() {
  static std::atomic<uint64_t> done{0};
  return raise_smem_limit(quant_linear_kernel_wg<kBits, kN>, WgTile<kBits, kN>::kSmem, done);
}

// K1's activation rows per block (wgmma's n) for M rows: M cut into
// ceil(M / kWgMaxN) tiles of equal rows, rounded up to 16 (up to 16 rows)
// or to a multiple of 32
inline int wg_rows(int M) {
  const int tiles = (M + kWgMaxN - 1) / kWgMaxN;
  const int rows = (M + tiles - 1) / tiles;
  return rows <= 16 ? 16 : (rows + 31) / 32 * 32;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda), or null
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// K1's tensor maps: the activations x [M, K] bf16 in boxes of kN rows x 64
// columns, 128-byte swizzle (int4: as [M][2][K/2], so that a box never
// crosses into the second half); the weight [N, Kb] bytes in boxes of 128
// rows x 64 bytes, 64-byte swizzle. Out-of-range rows and columns read 0.
template <int kBits, int kN>
bool encode_maps(CUtensorMap* tx, CUtensorMap* tw, const void* x, const void* w, int M, int N,
                 int K) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t Kb = kBits == 4 ? K / 2 : K;
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult rx;
  if (kBits == 4) {
    const cuuint64_t dims[3] = {Kb, 2, (cuuint64_t)M};
    const cuuint64_t strides[2] = {2 * Kb, 2 * (cuuint64_t)K};
    const cuuint32_t box[3] = {64, 1, kN};
    rx = encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
    const cuuint64_t strides[1] = {2 * (cuuint64_t)K};
    const cuuint32_t box[2] = {64, kN};
    rx = encode(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
                ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  const cuuint64_t wdims[2] = {Kb, (cuuint64_t)N};
  const cuuint64_t wstrides[1] = {Kb};
  const cuuint32_t wbox[2] = {kChunk, (cuuint32_t)Warps<false>::kBN};
  const CUresult rw = encode(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), wdims,
                             wstrides, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rx == CUDA_SUCCESS && rw == CUDA_SUCCESS;
}

template <int kBits, int kN>
int launch_wg(const void* x, const void* w, const void* s, void* y, void* part, void* counters,
              int M, int N, int K, int n_chunks, int splits, cudaStream_t stream) {
  const cudaError_t attr = raise_smem_limit_wg<kBits, kN>();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tx, tw;
  if (!encode_maps<kBits, kN>(&tx, &tw, x, w, M, N, K)) return (int)cudaErrorInvalidValue;
  constexpr int kBN = Warps<false>::kBN;
  const dim3 grid((N + kBN - 1) / kBN, (M + kN - 1) / kN, splits);
  using Lay = WgTile<kBits, kN>;
  quant_linear_kernel_wg<kBits, kN><<<grid, Lay::kThreads, Lay::kSmem, stream>>>(
      tx, tw, static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(part), static_cast<int*>(counters), M, N, n_chunks, splits);
  return (int)cudaGetLastError();
}

template <int kBits>
int launch_wg_rows(const void* x, const void* w, const void* s, void* y, void* part, void* counters,
              int M, int N, int K, int n_chunks, int splits, cudaStream_t stream) {
#define QL_CASE(n)                                                                    \
  case n:                                                                             \
    return launch_wg<kBits, n>(x, w, s, y, part, counters, M, N, K, n_chunks, splits, \
                               stream);
  switch (wg_rows(M)) {
    QL_CASE(16) QL_CASE(32) QL_CASE(64) QL_CASE(96) QL_CASE(128) QL_CASE(160) QL_CASE(192)
    QL_CASE(224) QL_CASE(256)
  }
#undef QL_CASE
  return (int)cudaErrorInvalidValue;
}

// K1 (kA8 false) on quant_linear_kernel_wg, K2 on quant_linear_kernel
template <int kBits, bool kA8>
int launch(const void* x, const void* xs, const void* w, const void* s, void* y, void* part,
           void* counters, int M, int N, int K, cudaStream_t stream) {
  const int Kb = kBits == 4 ? K / 2 : K;
  const int n_chunks = (Kb + kChunk - 1) / kChunk;
  const int splits = splits_for<kA8>(N, K, kBits);
  if (splits > 1 && (part == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  if constexpr (!kA8) {
    return launch_wg_rows<kBits>(x, w, s, y, part, counters, M, N, K, n_chunks, splits, stream);
  } else {
    const cudaError_t attr = raise_smem_limit<kBits, kA8>();
    if (attr != cudaSuccess) return (int)attr;
    constexpr int kBN = Warps<kA8>::kBN;
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
    quant_linear_kernel<kBits, kA8>
        <<<grid, Warps<kA8>::kThreads, Tile<kBits, kA8>::kSmem, stream>>>(
        static_cast<const uint8_t*>(x), static_cast<const float*>(xs),
        static_cast<const uint8_t*>(w), static_cast<const __nv_bfloat16*>(s),
        static_cast<__nv_bfloat16*>(y), static_cast<int*>(part), static_cast<int*>(counters),
        M, N, K, n_chunks, splits);
    return (int)cudaGetLastError();
  }
}

// blocks the current device holds at once: K2's kernel, or K1's at its
// widest n
template <typename Kernel>
int resident(Kernel kernel, int threads, int smem, cudaError_t err) {
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}
template <int kBits, bool kA8>
int resident() {
  if constexpr (kA8) {
    return resident(quant_linear_kernel<kBits, kA8>, Warps<kA8>::kThreads,
                    Tile<kBits, kA8>::kSmem, raise_smem_limit<kBits, kA8>());
  } else {
    return resident(quant_linear_kernel_wg<kBits, kWgMaxN>, WgTile<kBits, kWgMaxN>::kThreads,
                    WgTile<kBits, kWgMaxN>::kSmem, raise_smem_limit_wg<kBits, kWgMaxN>());
  }
}

}  // namespace

// Splits of the K range for a weight [N, K] of `bits` (4 or 8) under K1
// (a8 == 0) or K2; above 1, the caller's scratch holds
// sjd_quant_linear_scratch elements. Depends on N, K, bits and a8 only.
extern "C" int sjd_quant_linear_splits(int N, int K, int bits, int a8) {
  return a8 ? splits_for<true>(N, K, bits) : splits_for<false>(N, K, bits);
}

// Elements (f32 for a8 == 0, int32 otherwise) of the scratch that a launch
// on x [M, K] against a weight [N, K] of `bits` needs for its split partials:
// 0 for one split; K2's splits * M * N; K1's splits * its tiles * 128 weight
// rows * its activation rows per tile (wg_rows), a whole tile each.
extern "C" long long sjd_quant_linear_scratch(int M, int N, int K, int bits, int a8) {
  const int g = a8 ? splits_for<true>(N, K, bits) : splits_for<false>(N, K, bits);
  if (g <= 1) return 0;
  if (a8) return (long long)g * M * N;
  const int n = wg_rows(M);
  const long long bn = Warps<false>::kBN;
  return (long long)g * ((M + n - 1) / n) * n * ((N + bn - 1) / bn) * bn;
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
// y bf16 [M, N]; part: the scratch (sjd_quant_linear_scratch elements) and
// counters: int32 zeros, one per (N tile, 32-row M tile) (both NULL for one
// split). The weight bytes per row must
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
