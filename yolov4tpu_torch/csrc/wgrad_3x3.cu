// Weight gradient of a 3x3 stride-1 SAME convolution, for sm_90a.
//
// Replaces yolov4tpu/ops/wgrad_pallas.py::_wgrad_kernel (wgrad_pallas.py:48,
// the Pallas TPU kernel behind conv3x3_s1's backward).  It computes
//
//   dw[ky, kx, ci, co] = sum_{b, y, x} x[b, y+ky-1, x+kx-1, ci] * dy[b, y, x, co]
//
// with zeros where the shifted pixel leaves the image, in float32, from
// NHWC x (B, H, W, Ci) and dy (B, H, W, Co), both float32 or both bfloat16,
// into an HWIO float32 result (3, 3, Ci, Co).
//
// As a GEMM: C[m, n] = sum_k A[k, m] * B[k, n] with K = B*H*W pixels,
// M = 9*Ci (tap-major: m = (ky*3 + kx)*Ci + ci), N = Co.  A's row k is pixel
// k's 3x3 neighbourhood, B's row k is dy at pixel k; both rows are read
// straight from the NHWC bytes, so nothing is transposed or im2col'd in
// memory.  C row-major is the HWIO layout.
//
// What bounds it on this card: the nine shapes of YOLOv4 at 416^2 do
// 2-13 GFLOP each at batch 8 over 1-97 MB of operands.  Against the H100's
// ~295 operations per byte for bf16 tensor cores the six shapes with
// Ci, Co >= 128 are bound by operations (989 TFLOP/s), the three narrow
// ones (416^2 3->32, 208^2 32->64, 104^2 64->64) by bytes (3.35 TB/s).
// Against the ~20 operations per byte of the float32 CUDA cores every
// shape is bound by operations (67 TFLOP/s).
//
// Two routes, chosen by the operand type:
//
// bfloat16 -- tensor cores (wgrad_tc).  Bound: 989 TFLOP/s, or the bytes of
//   x and dy for the narrow shapes.  Design:
//  - warp-level mma.sync.m16n8k16 (bf16 in, float32 accumulators in
//    registers); a block tile of 128x128 (8 warps of 64x32) where both
//    channel counts reach 128, else 64x64 (4 warps of 32x32);
//  - a K step is 32 pixels; each stage of a 4-deep shared-memory ring holds
//    A as [32][BM] and B as [32][BN] bf16, filled by 16-byte cp.async.cg
//    copies with zero-fill (src-size 0) where the shifted pixel leaves the
//    image, the pixel is at or past the split's end, or the column is past
//    M or N; a masked copy still names a valid address (the tensor's base);
//  - a 16-byte chunk is 8 channels of one tap, so Ci and Co must be
//    multiples of 8 (the wrapper pads them with zeros); each thread's chunk
//    column, its tap and channel, are fixed before the K loop, and its two
//    pixel rows move 32 pixels a step by running offsets, without a
//    multiply or divide;
//  - the copies for step k + 3 are issued after the first 16-deep half of
//    step k's mma's, so they overlap the tensor-core work instead of
//    following the barrier;
//  - both operands are stored M- or N-contiguous, transposed to what
//    mma.sync's row.col wants, so fragments come from ldmatrix.x4.trans;
//    rows are 128 or 256 bytes, so the 16-byte chunk index is XORed with
//    (k row % 8) in the copies and in ldmatrix's addresses, and the eight
//    rows one ldmatrix phase reads fall on distinct banks;
//  - the mma's float32 accumulation rounds toward zero, so its error grows
//    with the chain summed into one partial: the wrapper caps a split at
//    256 K steps.
//   What still holds it back (PERF.md, tools/wgrad_probe.py): the
//   ldmatrix + mma loop alone runs about three times as fast as the whole
//   kernel; the rest is feeding it, i.e. the copies' issue and address
//   work, the barrier a step, and the split partials' traffic.  wgmma and
//   TMA would lift the ceiling further; mma.sync is the simpler step,
//   without descriptors or mbarrier pipelines.
//
// float32 -- CUDA cores (wgrad_tiles).  Full float32, no TF32 (the float32
// fidelity contract of the training path).  Bound: 67 TFLOP/s.  Design:
// register tiles of 8x8 (128 tile) or 4x4 (64 tile) outputs a thread fed
// from shared memory, fmaf; operands staged through registers one K step
// ahead of the compute.
//
// Shared by both routes:
//  - Output tiles are few (52^2 x 128 -> 128 is 9 tiles of 128^2), so each
//    block also takes one slice of the K pixel range (split-K) and the grid
//    is (N tiles, M tiles, splits), sized by the wrapper to fill the 132
//    SMs.  Blocks of one split are adjacent in launch order, so they share
//    their x and dy rows through L2.
//  - Each split writes its float32 partial tile to a workspace; a second
//    kernel sums the splits in a fixed order.  The result is deterministic
//    (no atomics; two launches are bit-equal) and a split count of 1 writes
//    the result directly.
//  - Pixel and element offsets are 64-bit: K reaches 1.38 M pixels at b8
//    and 5.5 M at b32 for 416^2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }

constexpr int kThreads = 256;

// One block: tile (M rows m0.., N cols n0..) over pixels [z*chunk, ...).
// BM = BN, TM = TN; the (BM/TM)^2 threads each own a TM x TN sub-tile made
// of (TM/4) x (TN/4) 4x4 blocks strided by BM/(TM/4), so shared-memory
// reads are 16-byte vectors without bank conflicts.
template <typename T, int BM, int TM>
__global__ void __launch_bounds__(kThreads)
wgrad_tiles(const T* __restrict__ x, const T* __restrict__ dy,
            float* __restrict__ part, int H, int W, int Ci, int Co,
            int64_t K, int64_t chunk) {
  constexpr int BN = BM, TN = TM;
  static_assert((BM / TM) * (BN / TN) == kThreads, "256 threads a block");
  constexpr int BK = 4 * kThreads / BM;  // 4 A and 4 B loads a thread a step
  constexpr int kLoadersPerRow = BM / 4;
  constexpr int kSubM = TM / 4, kSubN = TN / 4;
  constexpr int kStrideM = BM / kSubM, kStrideN = BN / kSubN;
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int M = 9 * Ci;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int64_t kbeg = (int64_t)blockIdx.z * chunk;
  const int64_t kend = kbeg + chunk < K ? kbeg + chunk : K;
  const int64_t HW = (int64_t)H * W;

  // This thread's load slots: K row lr of the tile, columns lc..lc+3.  The
  // (tap, ci) of an A column is fixed for the whole K loop.
  const int lr = tid / kLoadersPerRow, lc = (tid % kLoadersPerRow) * 4;
  int a_ci[4], a_dy[4], a_dx[4];
  bool a_ok[4], b_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + lc + j;
    a_ok[j] = m < M;
    const int t = a_ok[j] ? m / Ci : 0;
    a_ci[j] = a_ok[j] ? m - t * Ci : 0;
    a_dy[j] = t / 3 - 1;
    a_dx[j] = t % 3 - 1;
    b_ok[j] = n0 + lc + j < Co;
  }

  float ra[4], rb[4];
  auto load = [&](int64_t k0) {
    const int64_t p = k0 + lr;
    const bool pok = p < kend;
    const int64_t b = pok ? p / HW : 0;
    const int64_t r = pok ? p - b * HW : 0;
    const int y = (int)(r / W), xx = (int)(r - (int64_t)(r / W) * W);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sy = y + a_dy[j], sx = xx + a_dx[j];
      const bool ok = pok && a_ok[j] && sy >= 0 && sy < H && sx >= 0 && sx < W;
      ra[j] = ok ? to_f32(x[((b * H + sy) * W + sx) * Ci + a_ci[j]]) : 0.f;
      rb[j] = (pok && b_ok[j]) ? to_f32(dy[p * Co + n0 + lc + j]) : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  load(kbeg);
  for (int64_t k0 = kbeg; k0 < kend; k0 += BK) {
    *reinterpret_cast<float4*>(&As[lr][lc]) =
        make_float4(ra[0], ra[1], ra[2], ra[3]);
    *reinterpret_cast<float4*>(&Bs[lr][lc]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
    if (k0 + BK < kend) load(k0 + BK);  // in flight while this tile computes
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int s = 0; s < kSubM; ++s) {
        const float4 v =
            *reinterpret_cast<const float4*>(&As[kk][s * kStrideM + ty * 4]);
        a[s * 4 + 0] = v.x; a[s * 4 + 1] = v.y;
        a[s * 4 + 2] = v.z; a[s * 4 + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < kSubN; ++s) {
        const float4 v =
            *reinterpret_cast<const float4*>(&Bs[kk][s * kStrideN + tx * 4]);
        bv[s * 4 + 0] = v.x; bv[s * 4 + 1] = v.y;
        bv[s * 4 + 2] = v.z; bv[s * 4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + (int64_t)blockIdx.z * M * Co;
#pragma unroll
  for (int s = 0; s < kSubM; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + s * kStrideM + ty * 4 + i;
      if (m >= M) continue;
#pragma unroll
      for (int s2 = 0; s2 < kSubN; ++s2)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + s2 * kStrideN + tx * 4 + j;
          if (n < Co) out[(int64_t)m * Co + n] = acc[s * 4 + i][s2 * 4 + j];
        }
    }
}

// ---------------------------------------------------------------------------
// The bfloat16 route: tensor cores through mma.sync, fed by a cp.async ring.
// ---------------------------------------------------------------------------

constexpr int kTcStep = 32;    // pixels (GEMM K) per K step
constexpr int kTcStages = 4;   // depth of the shared-memory ring
// Blocks of each tile one SM holds at once (__launch_bounds__' minimum);
// the wrapper's plan sizes its waves by them (wgrad_tc_config).
constexpr int kTcBlocks128 = 2, kTcBlocks64 = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; ok == false writes 16 zero bytes
// and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 bf16 matrices, transposed: lanes 8j..8j+7 name the eight rows of
// matrix j; register j of lane l holds (row 2*(l%4) and 2*(l%4)+1, col l/4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, col-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `c` of K row `k` in a ring stage whose rows
// hold kChunks chunks: the chunk index is XORed with k % 8, so the eight
// rows that one ldmatrix phase reads at one logical chunk hit eight
// distinct 16-byte bank groups.
template <int kChunks>
__device__ __forceinline__ uint32_t swizzle(int k, int c) {
  return (uint32_t)((k * kChunks + (c ^ (k & 7))) * 16);
}

template <int BM, int WM, int WN>
struct TcShape {
  static constexpr int BN = BM;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = (BM / WM) * kWarpsN * 32;
  static constexpr int kChunks = BM / 8;               // 16-byte chunks a row
  static constexpr int kRowStep = kThreads / kChunks;  // rows a load pass
  static constexpr int kRows = kTcStep / kRowStep;     // rows a thread loads
  static constexpr int kStageBytes = kTcStep * (BM + BN) * 2;
  static constexpr int kSmemBytes = kTcStages * kStageBytes;
};

// One block: tile (M rows m0.., N cols n0..) over pixels [z*chunk, ...),
// chunk a multiple of kTcStep.  Ci and Co are multiples of 8.
template <int BM, int WM, int WN, int kMinBlocks>
__global__ void __launch_bounds__(TcShape<BM, WM, WN>::kThreads, kMinBlocks)
wgrad_tc(const __nv_bfloat16* __restrict__ x,
         const __nv_bfloat16* __restrict__ dy, float* __restrict__ part,
         int H, int W, int Ci, int Co, int64_t K, int64_t chunk) {
  using S = TcShape<BM, WM, WN>;
  constexpr int kMT = WM / 16, kNT = WN / 8;  // m16 and n8 tiles a warp
  static_assert(kNT % 2 == 0, "B fragments load two n8 tiles at a time");
  static_assert(S::kRows * S::kRowStep == kTcStep, "whole K rows a pass");
  extern __shared__ __align__(128) unsigned char smem[];

  const int M = 9 * Ci;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * S::BN;
  const int64_t kbeg = (int64_t)blockIdx.z * chunk;
  const int64_t kend = kbeg + chunk < K ? kbeg + chunk : K;
  const int nk = (int)((kend - kbeg + kTcStep - 1) / kTcStep);

  // Loader: this thread copies chunk column cc of A and of B for K rows
  // r0, r0 + kRowStep, ...  The A column's (tap, ci) is fixed for the whole
  // K loop.  Each row keeps its element offsets into x (at the shifted
  // pixel) and dy, the pixels left in the split, and its pixel's (y, x);
  // a K step moves all of them 32 pixels on without a multiply or divide.
  const int cc = tid % S::kChunks, r0 = tid / S::kChunks;
  const int am = m0 + cc * 8, bn = n0 + cc * 8;
  const bool a_ok = am < M, b_ok = bn < Co;
  const int tap = a_ok ? am / Ci : 4;
  const int a_ci = a_ok ? am - tap * Ci : 0;
  const int a_dy = tap / 3 - 1, a_dx = tap % 3 - 1;
  const int step_y = kTcStep / W, step_x = kTcStep % W;
  int64_t oa[S::kRows], ob[S::kRows];
  int left[S::kRows], py[S::kRows], px[S::kRows];
#pragma unroll
  for (int j = 0; j < S::kRows; ++j) {
    const int64_t p = kbeg + r0 + j * S::kRowStep;
    const int64_t q = p < K ? p : 0;
    py[j] = (int)((q / W) % H);
    px[j] = (int)(q % W);
    left[j] = (int)(kend - p);
    oa[j] = (p + (int64_t)a_dy * W + a_dx) * Ci + a_ci;
    ob[j] = p * Co + bn;
  }

  const uint32_t ring = smem_addr(smem);
  auto load = [&](int stage) {
    const uint32_t sa = ring + stage * S::kStageBytes;
    const uint32_t sb = sa + kTcStep * BM * 2;
#pragma unroll
    for (int j = 0; j < S::kRows; ++j) {
      const int row = r0 + j * S::kRowStep;
      const bool aok = left[j] > 0 && a_ok &&
                       (unsigned)(py[j] + a_dy) < (unsigned)H &&
                       (unsigned)(px[j] + a_dx) < (unsigned)W;
      const bool bok = left[j] > 0 && b_ok;
      cp_async16(sa + swizzle<S::kChunks>(row, cc), aok ? x + oa[j] : x, aok);
      cp_async16(sb + swizzle<S::kChunks>(row, cc), bok ? dy + ob[j] : dy,
                 bok);
      // The next K step: 32 pixels on, wrapping rows and images.
      oa[j] += kTcStep * Ci;
      ob[j] += kTcStep * Co;
      left[j] -= kTcStep;
      px[j] += step_x;
      py[j] += step_y;
      if (px[j] >= W) {
        px[j] -= W;
        ++py[j];
      }
      while (py[j] >= H) py[j] -= H;
    }
  };

  // Warp tile: rows wm0.., cols wn0.. of the block tile.
  const int wm0 = (warp / S::kWarpsN) * WM, wn0 = (warp % S::kWarpsN) * WN;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTcStages - 2>();  // step kt has landed
    __syncthreads();                 // and every warp is done with kt - 1
    const uint32_t sa = ring + (kt % kTcStages) * S::kStageBytes;
    const uint32_t sb = sa + kTcStep * BM * 2;
#pragma unroll
    for (int kk = 0; kk < kTcStep; kk += 16) {
      // A (16 m x 16 k): matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
      // (m 0-7, k 8-15), (m 8-15, k 8-15) are a0..a3 of m16n8k16.
      uint32_t af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int k = kk + (lane & 7) + ((lane >> 4) << 3);
        const int c = (wm0 + i * 16) / 8 + ((lane >> 3) & 1);
        ldmatrix_x4_trans(af[i], sa + swizzle<S::kChunks>(k, c));
      }
      // B (16 k x 16 n): matrices (k 0-7, n 0-7), (k 8-15, n 0-7),
      // (k 0-7, n 8-15), (k 8-15, n 8-15) are b0, b1 of two n8 tiles.
      uint32_t bf[kNT / 2][4];
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        const int k = kk + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int c = (wn0 + j * 16) / 8 + (lane >> 4);
        ldmatrix_x4_trans(bf[j], sb + swizzle<S::kChunks>(k, c));
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                   bf[j / 2][(j % 2) * 2 + 1]);
      if (kk == 0) {
        // The copies for step kt + 3 go out while the tensor cores work on
        // the first half of step kt; their stage held step kt - 1, which
        // every warp finished before the barrier above.
        if (kt + kTcStages - 1 < nk) load((kt + kTcStages - 1) % kTcStages);
        cp_async_commit();
      }
    }
  }
  cp_async_wait<0>();

  // c0, c1 at (row g, cols 2t, 2t+1) and c2, c3 at row g + 8 of each
  // 16x8 tile; Co is even, so a pair is in or out together.
  float* out = part + (int64_t)blockIdx.z * M * Co;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int m = m0 + wm0 + i * 16 + g, n = n0 + wn0 + j * 8 + t2;
      if (n >= Co) continue;
      if (m < M)
        *reinterpret_cast<float2*>(out + (int64_t)m * Co + n) =
            make_float2(acc[i][j][0], acc[i][j][1]);
      if (m + 8 < M)
        *reinterpret_cast<float2*>(out + (int64_t)(m + 8) * Co + n) =
            make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

// out[i] = sum over splits s = 0, 1, ... of part[s][i], in that order.
__global__ void wgrad_reduce(const float* __restrict__ part,
                             float* __restrict__ out, int64_t n, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[(int64_t)k * n + i];
    out[i] = s;
  }
}

template <typename T, int BM, int TM>
void launch_tiles(const void* x, const void* dy, float* part, int H, int W,
                  int Ci, int Co, int64_t K, int64_t chunk, int splits,
                  cudaStream_t stream) {
  const int M = 9 * Ci;
  dim3 grid((Co + BM - 1) / BM, (M + BM - 1) / BM, splits);
  wgrad_tiles<T, BM, TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), part, H, W, Ci, Co,
      K, chunk);
}

template <int BM, int WM, int WN, int kMinBlocks>
cudaError_t launch_tc(const void* x, const void* dy, float* part, int H,
                      int W, int Ci, int Co, int64_t K, int64_t chunk,
                      int splits, cudaStream_t stream) {
  using S = TcShape<BM, WM, WN>;
  auto kernel = wgrad_tc<BM, WM, WN, kMinBlocks>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int M = 9 * Ci;
  dim3 grid((Co + S::BN - 1) / S::BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, S::kThreads, S::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), part, H, W, Ci, Co, K, chunk);
  return cudaSuccess;
}

}  // namespace

// x (B, H, W, Ci), dy (B, H, W, Co) NHWC-contiguous, both float32
// (bf16 == 0, CUDA-core route) or both bfloat16 (bf16 == 1, tensor-core
// route: Ci and Co multiples of 8, both pointers 16-byte aligned, chunk a
// multiple of 32) -> out (9, Ci, Co) float32.  Split s of `splits` covers
// pixels [s*chunk, (s+1)*chunk); with splits > 1 `ws` holds
// splits * 9*Ci*Co floats.  tile is 128 or 64.  Returns the CUDA error of
// the launches (0 on success).
extern "C" int wgrad_3x3_launch(const void* x, const void* dy, float* ws,
                                float* out, int B, int H, int W, int Ci,
                                int Co, int64_t chunk, int splits, int tile,
                                int bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t K = (int64_t)B * H * W;
  float* part = splits > 1 ? ws : out;
  if (tile != 128 && tile != 64) return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (Ci % 8 || Co % 8 || chunk % kTcStep ||
        (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) %
            16)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e =
        tile == 128
            ? launch_tc<128, 64, 32, kTcBlocks128>(x, dy, part, H, W, Ci, Co,
                                                   K, chunk, splits, stream)
            : launch_tc<64, 32, 32, kTcBlocks64>(x, dy, part, H, W, Ci, Co, K,
                                                 chunk, splits, stream);
    if (e != cudaSuccess) return (int)e;
  } else if (tile == 128) {
    launch_tiles<float, 128, 8>(x, dy, part, H, W, Ci, Co, K, chunk, splits, stream);
  } else {
    launch_tiles<float, 64, 4>(x, dy, part, H, W, Ci, Co, K, chunk, splits, stream);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t n = (int64_t)9 * Ci * Co;
  int blocks = (int)((n + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  wgrad_reduce<<<blocks, 256, 0, stream>>>(ws, out, n, splits);
  return (int)cudaGetLastError();
}

// The tensor-core route's K step in pixels, and the blocks of `tile` (128
// or 64; 0 for another) that one SM holds at once.  The wrapper checks its
// own copies of these against them when it loads the library.
extern "C" void wgrad_tc_config(int tile, int* step, int* blocks_per_sm) {
  *step = kTcStep;
  *blocks_per_sm = tile == 128 ? kTcBlocks128 : tile == 64 ? kTcBlocks64 : 0;
}
