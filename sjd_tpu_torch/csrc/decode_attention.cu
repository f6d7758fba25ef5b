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
// is wholly masked for a row then adds 2^0 terms that the next live tile's
// correction 2^(m_prev - m_new) = 0 wipes out, where -inf would give
// 2^(-inf - -inf) = NaN. The same holds for a split wholly masked for a row:
// its merge weight 2^(-FLT_MAX - m*) is 0. Scores are kept in log2 units
// (s_k * log2(e) / sqrt(D) is applied before the mask), so exp2 replaces exp.
//
// What bounds it on the H100: bytes. One call must read the live prefix of
// one layer, (cache_end + W) * Hkv * D bytes each of K and V in int8 plus
// their scales: at the main path's 768px shapes (S=2, Hkv=32, D=128, fill
// 2400) about 40 MB, 12 us at 3.35 TB/s. The work is 4 * S * W * H * D *
// rows FLOP (two products), 1.27 GFLOP at fill 2400: 19 us on the f32 CUDA
// cores at their peak, so both products run on the bf16 tensor cores
// (1.3 us there). What each part of the design does about it:
//
// - Split-K over the live prefix. The grid is (ceil(W * group / 16), Hkv,
//   S * n_split), n_split = ceil(L / kSplit) fixed by the buffer length (the
//   host never reads cache_end). kSplit = 256 rows: 128 was slower at every
//   fill measured and 512 slower at fills 150 and 1200 (PERF.md section 6).
//   A block whose split starts at or past cache_end + W returns at once,
//   so the live blocks (640 at fill 2400)
//   fill the 132 SMs. Each live block writes its split's unnormalised
//   partials (acc [16, D], m, l per row, f32) to a scratch the caller
//   allocates; merge_splits_kernel, launched next on the same stream, merges
//   the live splits of each (sample, head, row): m* = max m_i, out =
//   sum 2^(m_i - m*) acc_i / max(sum 2^(m_i - m*) l_i, 1e-37). It reads
//   only the splits the first kernel wrote; the scratch is uninitialised.
// - Tensor cores. A block's 16 query rows are the M = 16 of
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate); four warps split each
//   64-row tile's columns, 16 each. Q's fragments are loaded into registers
//   once. Int8 codes are exact in bf16 (|code| <= 127); they are widened in
//   registers while the B fragments are built (a byte-permute into an f32
//   2^23 + code + 128, minus that offset, then the upper half of each f32).
//   The k order of the score product is permuted alike in Q and K so that
//   each thread reads 4 consecutive bytes (8 for bf16) of one K row; the
//   n order of the P.V product is permuted so that each thread reads 4
//   consecutive bytes of one V row per 4 n-tiles, and holds 8 consecutive
//   output dims. P is re-packed from the score accumulators as the bf16 A
//   operand in registers (FlashAttention-2), with s_v[col] folded in
//   before the rounding, as the TPU kernel folds it into p. The warps'
//   (m, l, acc) are merged through shared memory at the end of the split.
// - A cp.async ring. Raw int8 (or bf16) K and V tiles go global -> shared
//   by cp.async.cg 16-byte copies (8 threads cover one 128-byte head row),
//   kStages tiles deep (3 for int8, 2 for bf16), so the next tiles' copies
//   are in flight while the current one is computed; rows past the live edge are zero-filled, not
//   read. Shared-memory rows are padded (16 bytes for int8, 32 for bf16) so
//   that the fragment reads hit 32 distinct banks.
//
// - D = 100 (LlamaGen GPT-3B). A head row is 200 bytes (bf16) or 100
//   (int8), so rows are 8- or 4-byte aligned, not 16: the ring copies
//   them by cp.async.ca 8- or 4-byte copies instead, 25 per row. The
//   padding is in shared memory, not in the cache (padding the cache to
//   128 would add 28% to its bytes and change the layout the epilogue
//   writes): each tile row is laid out as at D = 128, its columns 100..127
//   zeroed once when the block starts (the copies never write them), and
//   Q's dims 100..127 are zero in registers. Both products then run as at
//   D = 128 (the score product's k and the P.V product's n in 128), the
//   pad dims of the output are zero, and the partials and the merge keep
//   128 columns, of which the merge writes the first 100.
//
// C interface (ctypes): sjd_decode_attention(...) returns cudaGetLastError();
// sjd_decode_attention_split_rows() returns kSplit and
// sjd_decode_attention_partial_dim(D) the columns of a partial row (D, or
// 128 for D = 100), which size the caller's scratch.

#include <atomic>
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 256;  // cache rows per split
constexpr int kRows = 16;    // query rows per block (mma M)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpCols = 16;           // cache rows per warp per tile
constexpr int kTileRows = kWarps * kWarpCols;
constexpr int kMergeThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kSplit % kTileRows == 0, "a tile never crosses a split");

// the head width the products and the partials run at: D, or D rounded up
// to 32 (the P.V product's groups of four n-tiles)
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return (D + 31) / 32 * 32;
}

template <typename KV, int D>
struct Layout {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kStages = kQuant ? 3 : 2;
  static constexpr int kDP = padded_dim<D>();
  // one cache row of one head as kDP columns, padded: fragment reads hit
  // distinct banks
  static constexpr int kStride = kDP * (int)sizeof(KV) + (kQuant ? 16 : 32);
  // the copies: the widest of 16, 8, 4 bytes that keeps every row aligned
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static constexpr int kCopyBytes = kRowBytes % 16 == 0 ? 16 : kRowBytes % 8 == 0 ? 8 : 4;
  static constexpr int kChunksPerRow = kRowBytes / kCopyBytes;
  static constexpr int kTileBytes = kTileRows * kStride;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K then V
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kAccStride = kDP + 4;  // f32, warp merge rows
  static constexpr int kMergeBytes = kWarps * kRows * (kAccStride + 2) * 4;
  static constexpr int kRegion = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
  // then per split row: k scale, v scale (f32), and the valid byte
  static constexpr int kBytes = kRegion + kSplit * 9;
};

// an N-byte global -> shared copy, zero-filled past src_bytes (0 or N)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(N), "r"(src_bytes)
                 : "memory");
  }
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

// four int8 codes -> four exact f32 values: byte b becomes the float
// 2^23 + (b ^ 0x80), and 2^23 + 128 is subtracted
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float f[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}
// two f32 values exact in bf16 -> bf16x2 (lo in the low half): their upper halves
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// grid: (ceil(W * group / kRows), Hkv, S * n_split); block: kThreads;
// dynamic shared memory: Layout<KV, D>::kBytes.
template <typename KV, int D>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q,      // [S, W, H, D]
    const KV* __restrict__ k,                 // [S, NL, L, Hkv, D]
    const KV* __restrict__ v,
    const __nv_bfloat16* __restrict__ ks,     // [S, NL, L, Hkv] (int8 only)
    const __nv_bfloat16* __restrict__ vs,
    const int32_t* __restrict__ cache_end,    // [S]
    const uint8_t* __restrict__ valid,        // [S, L] (bool)
    float* __restrict__ part_acc,             // [S, n_split, Hkv, GW, kDP]
    float* __restrict__ part_ml,              // [S, n_split, Hkv, GW, 2]
    int W, int H, int Hkv, int NL, int L, int layer, int n_split) {
  using Lay = Layout<KV, D>;
  constexpr int kStages = Lay::kStages;
  constexpr int kDP = Lay::kDP;
  constexpr int kKSteps = kDP / 16;   // k steps of the score product
  constexpr int kDGroups = kDP / 32;  // groups of 4 n-tiles of the P.V product
  extern __shared__ __align__(16) uint8_t smem[];
  float* ksc = reinterpret_cast<float*>(smem + Lay::kRegion);
  float* vsc = ksc + kSplit;
  uint8_t* col_ok = reinterpret_cast<uint8_t*>(vsc + kSplit);

  const int s = blockIdx.z / n_split;
  const int sp = blockIdx.z % n_split;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int ce = cache_end[s];
  const int n_live = min(ce + W, L);
  const int c_begin = sp * kSplit;
  if (c_begin >= n_live) return;  // a dead split: nothing to read or write
  const int c_end = min(c_begin + kSplit, n_live);
  const int n_tiles = (c_end - c_begin + kTileRows - 1) / kTileRows;
  const int group = H / Hkv;
  const int GW = W * group;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // mma groupID: row of A and C, column of B
  const int tig = lane & 3;   // thread in group
  const size_t row0 = ((size_t)s * NL + layer) * L;  // cache row of (s, layer, 0)

  if constexpr (kDP != D) {
    // the pad columns of every ring row, zeroed once: no copy writes them
    constexpr int kPadWords = (kDP - D) * (int)sizeof(KV) / 4;
    for (int i = tid; i < kStages * 2 * kTileRows * kPadWords; i += kThreads) {
      const int r = i / kPadWords;  // ring row: stage, operand, tile row
      *reinterpret_cast<uint32_t*>(smem + r * Lay::kStride + Lay::kRowBytes +
                                   4 * (i % kPadWords)) = 0u;
    }
  }

  // the ring: tile i of the split into stage i % kStages
  auto issue = [&](int tile) {
    uint8_t* stage = smem + (tile % kStages) * Lay::kStageBytes;
    const int t0 = c_begin + tile * kTileRows;
    constexpr int kPerOperand = kTileRows * Lay::kChunksPerRow;
#pragma unroll
    for (int c = tid; c < 2 * kPerOperand; c += kThreads) {
      const int which = c / kPerOperand;  // 0: K, 1: V
      const int rr = (c % kPerOperand) / Lay::kChunksPerRow;
      const int part = c % Lay::kChunksPerRow;
      const int col = t0 + rr;
      const KV* base = which ? v : k;
      // rows past the live edge: a zero-filled copy from a live row
      const KV* src = base + ((row0 + min(col, c_end - 1)) * Hkv + h) * D +
                      part * (Lay::kCopyBytes / sizeof(KV));
      cp_async<Lay::kCopyBytes>(
          stage + which * Lay::kTileBytes + rr * Lay::kStride + part * Lay::kCopyBytes, src,
          col < c_end ? Lay::kCopyBytes : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) issue(i);
    cp_async_commit();
  }

  // per split row: s_k * log2(e) / sqrt(D), s_v, and whether the row is
  // valid and live (loads overlap the copies in flight)
  const float score_scale = kLog2e / sqrtf((float)D);
  for (int i = tid; i < kSplit; i += kThreads) {
    const int col = c_begin + i;
    const bool in = col < c_end;
    float kscale = 1.f, vscale = 1.f;
    if (Lay::kQuant && in) {
      kscale = __bfloat162float(ks[(row0 + col) * Hkv + h]);
      vscale = __bfloat162float(vs[(row0 + col) * Hkv + h]);
    }
    ksc[i] = kscale * score_scale;
    vsc[i] = vscale;
    col_ok[i] = in && valid[(size_t)s * L + col];
  }

  // Q's A fragments, once. k slot pairs (2t, 2t+1) and (2t+8, 2t+9) of
  // k-step kk hold dims kk*16 + 4t + (0, 1) and + (2, 3); K's B fragments
  // use the same order.
  uint32_t qa[kKSteps][4];
  int wrow[2];  // window row of each of the thread's two query rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + gid + 8 * half;
    const int rc = min(r, GW - 1);
    wrow[half] = rc / group;
    const __nv_bfloat16* qrow =
        q + (((size_t)s * W + rc / group) * H + h * group + rc % group) * D + 4 * tig;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint2 x = make_uint2(0, 0);
      // past D (the pad dims): zero, as in the ring's pad columns
      if (r < GW && (kDP == D || kk * 16 + 4 * tig < D))
        x = *reinterpret_cast<const uint2*>(qrow + kk * 16);
      qa[kk][half] = x.x;
      qa[kk][2 + half] = x.y;
    }
  }

  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};  // this thread's columns only; summed over the quad at the end
  float acc[kDP / 8][4];    // n-tile 4G + j: dims 32G + 8t + j (+4 for c1, c3)
#pragma unroll
  for (int n = 0; n < kDP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile `it` landed
    __syncthreads();               // everyone's; and tile it-1's stage is free
    if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
    cp_async_commit();
    const int wc = warp * kWarpCols;                // the warp's first tile row
    const int i0 = it * kTileRows + wc;             // ... as a split row
    if (c_begin + i0 >= c_end) continue;            // wholly past the live edge
    const uint8_t* kt = smem + (it % kStages) * Lay::kStageBytes + wc * Lay::kStride;
    const uint8_t* vt = kt + Lay::kTileBytes;

    // scores: 16 query rows x the warp's 16 columns, two n-tiles of 8
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint8_t* kr = kt + (8 * j + gid) * Lay::kStride + (kk * 16 + 4 * tig) * sizeof(KV);
        uint32_t b0, b1;
        if constexpr (Lay::kQuant) {
          float f[4];
          i8x4_to_f32(*reinterpret_cast<const uint32_t*>(kr), f);
          b0 = pack_exact(f[0], f[1]);
          b1 = pack_exact(f[2], f[3]);
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(kr);
          b0 = x.x;
          b1 = x.y;
        }
        mma_bf16(sc[j], qa[kk], b0, b1);
      }
    }

    // scale, mask, online softmax; sc[j][e]: row gid + 8 * (e >> 1),
    // column 8j + 2t + (e & 1) of the warp's 16
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * j + 2 * tig + (e & 1);
        const bool keep = col_ok[i] && c_begin + i <= ce + wrow[e >> 1];
        sc[j][e] = keep ? sc[j][e] * ksc[i] : -FLT_MAX;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFull, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(kFull, mx[half], 2));
      corr[half] = exp2f(m[half] - mx[half]);
      m[half] = mx[half];
      l[half] *= corr[half];
    }
    uint32_t pa[4];  // P (x s_v) as the A operand: k slot = the warp's column
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = i0 + 8 * j + 2 * tig;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(sc[j][e] - m[e >> 1]);
        l[e >> 1] += p[e];
      }
      pa[2 * j] = pack_rn(p[0] * vsc[i], p[1] * vsc[i + 1]);
      pa[2 * j + 1] = pack_rn(p[2] * vsc[i], p[3] * vsc[i + 1]);
    }
#pragma unroll
    for (int n = 0; n < kDP / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // P.V: B rows (k slots) 2t, 2t+1, 2t+8, 2t+9 of the warp's columns;
    // n-tile 4G + j, column gid holds dim 32G + 4 gid + j
#pragma unroll
    for (int G = 0; G < kDGroups; ++G) {
      const uint8_t* vr = vt + (32 * G + 4 * gid) * sizeof(KV);
      const int rows[4] = {2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9};
      if constexpr (Lay::kQuant) {
        float f[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          i8x4_to_f32(*reinterpret_cast<const uint32_t*>(vr + rows[c] * Lay::kStride), f[c]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[4 * G + j], pa, pack_exact(f[0][j], f[1][j]), pack_exact(f[2][j], f[3][j]));
      } else {
        uint2 x[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) x[c] = *reinterpret_cast<const uint2*>(vr + rows[c] * Lay::kStride);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t sel = (j & 1) ? 0x7632 : 0x5410;
          const uint32_t w0 = j < 2 ? x[0].x : x[0].y, w1 = j < 2 ? x[1].x : x[1].y;
          const uint32_t w2 = j < 2 ? x[2].x : x[2].y, w3 = j < 2 ? x[3].x : x[3].y;
          mma_bf16(acc[4 * G + j], pa, __byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel));
        }
      }
    }
  }

  // merge the warps through shared memory (the ring is free), then write
  // the split's partials
  cp_async_wait<0>();
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(smem);  // [kWarps][kRows][kAccStride]
  float* red_m = red_acc + kWarps * kRows * Lay::kAccStride;  // [kWarps][kRows]
  float* red_l = red_m + kWarps * kRows;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(kFull, l[half], 1);
    l[half] += __shfl_xor_sync(kFull, l[half], 2);
    const int r = gid + 8 * half;
    if (tig == 0) {
      red_m[warp * kRows + r] = m[half];
      red_l[warp * kRows + r] = l[half];
    }
    float* dst = red_acc + (warp * kRows + r) * Lay::kAccStride + 8 * tig;
#pragma unroll
    for (int G = 0; G < kDGroups; ++G) {
      float4 lo, hi;  // dims 32G + 8t + 0..3 (c0 / c2) and + 4..7 (c1 / c3)
      lo.x = acc[4 * G][2 * half];
      lo.y = acc[4 * G + 1][2 * half];
      lo.z = acc[4 * G + 2][2 * half];
      lo.w = acc[4 * G + 3][2 * half];
      hi.x = acc[4 * G][2 * half + 1];
      hi.y = acc[4 * G + 1][2 * half + 1];
      hi.z = acc[4 * G + 2][2 * half + 1];
      hi.w = acc[4 * G + 3][2 * half + 1];
      *reinterpret_cast<float4*>(dst + 32 * G) = lo;
      *reinterpret_cast<float4*>(dst + 32 * G + 4) = hi;
    }
  }
  __syncthreads();
  constexpr int kThreadsPerRow = kThreads / kRows;
  constexpr int kDimsPerThread = kDP / kThreadsPerRow;
  const int r = tid / kThreadsPerRow;
  const int d0 = (tid % kThreadsPerRow) * kDimsPerThread;
  if (r0 + r >= GW) return;
  float m_star = -FLT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_star = fmaxf(m_star, red_m[w * kRows + r]);
  float e[kWarps];
  float l_sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    e[w] = exp2f(red_m[w * kRows + r] - m_star);
    l_sum += e[w] * red_l[w * kRows + r];
  }
  const size_t prow = (((size_t)s * n_split + sp) * Hkv + h) * GW + r0 + r;
#pragma unroll
  for (int d = 0; d < kDimsPerThread; d += 4) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 a =
          *reinterpret_cast<const float4*>(red_acc + (w * kRows + r) * Lay::kAccStride + d0 + d);
      o.x += e[w] * a.x;
      o.y += e[w] * a.y;
      o.z += e[w] * a.z;
      o.w += e[w] * a.w;
    }
    *reinterpret_cast<float4*>(part_acc + prow * kDP + d0 + d) = o;
  }
  if (d0 == 0) {
    part_ml[prow * 2] = m_star;
    part_ml[prow * 2 + 1] = l_sum;
  }
}

// One warp per (sample, KV head, query row): merges the splits that
// flash_decode_split_kernel wrote (those below ceil(n_live / kSplit)) and
// writes the bf16 output row's D dims of the partials' kDP.
// grid: ceil(S * Hkv * GW * 32 / kMergeThreads).
template <int D>
__global__ void __launch_bounds__(kMergeThreads) merge_splits_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int32_t* __restrict__ cache_end, __nv_bfloat16* __restrict__ out,
    int S, int W, int H, int Hkv, int L, int n_split) {
  constexpr int kDP = padded_dim<D>();
  constexpr int kPerLane = kDP / 32;
  const int group = H / Hkv;
  const int GW = W * group;
  const int item = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= S * Hkv * GW) return;
  const int r = item % GW;
  const int h = (item / GW) % Hkv;
  const int s = item / (GW * Hkv);
  const int n_live = min(cache_end[s] + W, L);
  const int n_sp = (n_live + kSplit - 1) / kSplit;
  const size_t stride = (size_t)Hkv * GW;  // from one split to the next
  const size_t base = ((size_t)s * n_split * Hkv + h) * GW + r;

  float m_max = -FLT_MAX;
  for (int i = 0; i < n_sp; ++i) m_max = fmaxf(m_max, part_ml[(base + i * stride) * 2]);
  float l = 0.f;
  float acc[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
  for (int i = 0; i < n_sp; ++i) {
    const size_t pr = base + i * stride;
    const float e = exp2f(part_ml[pr * 2] - m_max);
    l = fmaf(e, part_ml[pr * 2 + 1], l);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = fmaf(e, part_acc[pr * kDP + lane * kPerLane + j], acc[j]);
  }
  const float inv_l = 1.f / fmaxf(l, 1e-37f);
  const int w = r / group, g = r % group;
  __nv_bfloat16* o = out + (((size_t)s * W + w) * H + h * group + g) * D + lane * kPerLane;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (kDP == D || lane * kPerLane + j < D) o[j] = __float2bfloat16_rn(acc[j] * inv_l);
}

// The split kernel's dynamic shared memory is over the 48 KB default; the
// raised limit belongs to the current device, so it is set once per device.
template <typename KV, int D>
cudaError_t raise_smem_limit() {
  static std::atomic<uint64_t> done{0};  // bit i: device i
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_decode_split_kernel<KV, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<KV, D>::kBytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <typename KV, int D>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* cache_end, const void* valid, void* out, void* partials, int S, int W,
           int H, int Hkv, int NL, int L, int layer, cudaStream_t stream) {
  constexpr int kSmem = Layout<KV, D>::kBytes;
  const cudaError_t attr = raise_smem_limit<KV, D>();
  if (attr != cudaSuccess) return (int)attr;
  const int n_split = (L + kSplit - 1) / kSplit;
  const int GW = W * (H / Hkv);
  float* part_acc = static_cast<float*>(partials);
  float* part_ml = part_acc + (size_t)S * n_split * Hkv * GW * padded_dim<D>();
  const dim3 grid((GW + kRows - 1) / kRows, Hkv, S * n_split);
  flash_decode_split_kernel<KV, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int32_t*>(cache_end),
      static_cast<const uint8_t*>(valid), part_acc, part_ml, W, H, Hkv, NL, L, layer, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int items = S * Hkv * GW;
  merge_splits_kernel<D><<<(items * 32 + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                           stream>>>(part_acc, part_ml, static_cast<const int32_t*>(cache_end),
                                     static_cast<__nv_bfloat16*>(out), S, W, H, Hkv, L, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sjd_decode_attention_split_rows() { return kSplit; }

extern "C" int sjd_decode_attention_partial_dim(int D) {
  return D == 100 ? padded_dim<100>() : D;
}

// quantized != 0: k/v are int8 with bf16 scales; else k/v are bf16 and the
// scale pointers are ignored. head_dim must be 64, 100 or 128 (checked by
// the Python wrapper; anything else returns cudaErrorInvalidValue). q, k
// and v must be 16-byte aligned. partials: f32 scratch of S * ceil(L /
// kSplit) * Hkv * W * (H / Hkv) * (partial_dim(D) + 2) elements,
// uninitialised.
extern "C" int sjd_decode_attention(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* cache_end, const void* valid, void* out, void* partials,
    int S, int W, int H, int Hkv, int D, int NL, int L, int layer, int quantized,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized && D == 128) {
    return launch<int8_t, 128>(q, k, v, ks, vs, cache_end, valid, out, partials, S, W, H, Hkv,
                               NL, L, layer, st);
  } else if (quantized && D == 64) {
    return launch<int8_t, 64>(q, k, v, ks, vs, cache_end, valid, out, partials, S, W, H, Hkv,
                              NL, L, layer, st);
  } else if (!quantized && D == 128) {
    return launch<__nv_bfloat16, 128>(q, k, v, ks, vs, cache_end, valid, out, partials, S, W,
                                      H, Hkv, NL, L, layer, st);
  } else if (!quantized && D == 64) {
    return launch<__nv_bfloat16, 64>(q, k, v, ks, vs, cache_end, valid, out, partials, S, W,
                                     H, Hkv, NL, L, layer, st);
  } else if (quantized && D == 100) {
    return launch<int8_t, 100>(q, k, v, ks, vs, cache_end, valid, out, partials, S, W, H, Hkv,
                               NL, L, layer, st);
  } else if (!quantized && D == 100) {
    return launch<__nv_bfloat16, 100>(q, k, v, ks, vs, cache_end, valid, out, partials, S, W,
                                      H, Hkv, NL, L, layer, st);
  }
  return (int)cudaErrorInvalidValue;
}
