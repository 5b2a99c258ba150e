// Weight gradient of a 3x3 stride-1 SAME convolution, for sm_90a.
//
// Replaces yolov4tpu/ops/wgrad_pallas.py::_wgrad_kernel (the Pallas TPU
// kernel behind conv3x3_s1's backward).  It computes
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
// 2-64 GFLOP each at batch 8 over 1-35 MB of operands, far above the H100's
// ~295 operations per byte for bf16 tensor cores and ~20 for float32 CUDA
// cores: the work is operations, not bytes.  This first kernel uses the
// float32 CUDA cores (fmaf; no TF32, float32 operands stay full float32,
// bfloat16 operands are widened exactly), so its ceiling is the 67 TFLOP/s
// float32 rate, ~15x below the 989 TFLOP/s bf16 tensor-core bound that the
// kernel is held to.  wgmma/TMA tiles are later work.
//
// What the design does about the shapes:
//  - Output tiles are few (13^2 x 512 -> 1024 is 36 x 8 tiles of 128^2 over
//    only 1,352 pixels per image; 52^2 x 128 -> 128 is 9 tiles), so each
//    block also takes one slice of the K pixel range (split-K) and the grid
//    is (N tiles, M tiles, splits) sized by the wrapper to fill the 132 SMs.
//  - Each split writes its float32 partial tile to a workspace; a second
//    kernel sums the splits in a fixed order.  The result is deterministic
//    (no atomics) and a split count of 1 writes the result directly.
//  - A 128x128 tile with 8x8 outputs per thread for Ci, Co >= 128 (most of
//    the FLOPs); a 64x64 tile with 4x4 per thread for the narrow shapes
//    (the 416^2 stem is M = 27, N = 32), where a 128 tile would be mostly
//    padding.
//  - Per K step each thread stages four A and four B values (one pixel, four
//    consecutive columns) in registers, loaded while the block computes on
//    the previous step's shared-memory tile.
//  - Pixel and element offsets are 64-bit: K reaches 1.38 M pixels at b8
//    and 5.5 M at b32 for 416^2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

}  // namespace

// x (B, H, W, Ci), dy (B, H, W, Co) NHWC-contiguous, both float32
// (bf16 == 0) or both bfloat16 (bf16 == 1) -> out (9, Ci, Co) float32.
// Split s of `splits` covers pixels [s*chunk, (s+1)*chunk); with splits > 1
// `ws` holds splits * 9*Ci*Co floats.  tile is 128 or 64.  Returns the CUDA
// error of the launches (0 on success).
extern "C" int wgrad_3x3_launch(const void* x, const void* dy, float* ws,
                                float* out, int B, int H, int W, int Ci,
                                int Co, int64_t chunk, int splits, int tile,
                                int bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t K = (int64_t)B * H * W;
  float* part = splits > 1 ? ws : out;
  if (tile == 128) {
    if (bf16) launch_tiles<__nv_bfloat16, 128, 8>(x, dy, part, H, W, Ci, Co, K, chunk, splits, stream);
    else launch_tiles<float, 128, 8>(x, dy, part, H, W, Ci, Co, K, chunk, splits, stream);
  } else if (tile == 64) {
    if (bf16) launch_tiles<__nv_bfloat16, 64, 4>(x, dy, part, H, W, Ci, Co, K, chunk, splits, stream);
    else launch_tiles<float, 64, 4>(x, dy, part, H, W, Ci, Co, K, chunk, splits, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t n = (int64_t)9 * Ci * Co;
  int blocks = (int)((n + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  wgrad_reduce<<<blocks, 256, 0, stream>>>(ws, out, n, splits);
  return (int)cudaGetLastError();
}
