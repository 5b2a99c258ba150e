// Ceiling of the inner loop of wgrad_3x3.cu's tensor-core route, for
// sm_90a: the same 128x128 block of 8 warps (64x32 warp tiles) and the same
// swizzled ring stage, with only ldmatrix + mma.sync (or mma.sync alone) in
// the loop: no copies from device memory, no barriers, no epilogue beyond
// one store a thread.  tools/wgrad_probe.py times it beside the kernel, so
// the kernel's time splits into the loop's ceiling and the cost of feeding
// it.  Not a kernel of the port's paths.
#include "wgrad_3x3.cu"

namespace {

template <bool kLoad>
__global__ void __launch_bounds__(TcShape<128, 64, 32>::kThreads, kTcBlocks128)
inner_loop(float* out, int steps) {
  using S = TcShape<128, 64, 32>;
  constexpr int kMT = 4, kNT = 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < S::kSmemBytes / 4; i += S::kThreads)
    reinterpret_cast<uint32_t*>(smem)[i] = 0x3f803f80u ^ (i & 7);
  __syncthreads();
  const uint32_t ring = smem_addr(smem);
  const int wm0 = (warp / S::kWarpsN) * 64, wn0 = (warp % S::kWarpsN) * 32;
  float acc[kMT][kNT][4] = {};
  uint32_t af[kMT][4], bf[kNT / 2][4];
  for (int i = 0; i < kMT; ++i)
    for (int e = 0; e < 4; ++e) af[i][e] = 0x3f803f80u + lane;
  for (int j = 0; j < kNT / 2; ++j)
    for (int e = 0; e < 4; ++e) bf[j][e] = 0x3f803f80u + e;
  for (int it = 0; it < steps; ++it) {
    const uint32_t sa = ring + (it % kTcStages) * S::kStageBytes;
    const uint32_t sb = sa + kTcStep * 128 * 2;
#pragma unroll
    for (int kk = 0; kk < kTcStep; kk += 16) {
      if (kLoad) {
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const int k = kk + (lane & 7) + ((lane >> 4) << 3);
          const int c = (wm0 + i * 16) / 8 + ((lane >> 3) & 1);
          ldmatrix_x4_trans(af[i], sa + swizzle<S::kChunks>(k, c));
        }
#pragma unroll
        for (int j = 0; j < kNT / 2; ++j) {
          const int k = kk + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int c = (wn0 + j * 16) / 8 + (lane >> 4);
          ldmatrix_x4_trans(bf[j], sb + swizzle<S::kChunks>(k, c));
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2],
                   bf[j / 2][(j % 2) * 2 + 1]);
    }
  }
  float s = 0.f;
  for (int i = 0; i < kMT; ++i)
    for (int j = 0; j < kNT; ++j)
      for (int e = 0; e < 4; ++e) s += acc[i][j][e];
  out[blockIdx.x * S::kThreads + tid] = s;
}

template <bool kLoad>
int launch_inner(float* out, int blocks, int steps, cudaStream_t stream) {
  using S = TcShape<128, 64, 32>;
  const cudaError_t attr = cudaFuncSetAttribute(
      inner_loop<kLoad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  inner_loop<kLoad><<<blocks, S::kThreads, S::kSmemBytes, stream>>>(out,
                                                                    steps);
  return (int)cudaGetLastError();
}

}  // namespace

// `blocks` blocks of the 128x128 tile, each `steps` K steps of 32 pixels;
// out holds blocks * 256 floats.  with_ldmatrix == 0 leaves the fragments
// in registers (mma.sync alone).  Returns the CUDA error of the launch.
extern "C" int wgrad_probe_inner(float* out, int blocks, int steps,
                                 int with_ldmatrix, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return with_ldmatrix ? launch_inner<true>(out, blocks, steps, stream)
                       : launch_inner<false>(out, blocks, steps, stream);
}
