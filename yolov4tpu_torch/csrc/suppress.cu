// Per-class greedy NMS suppression over score-sorted candidates, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel yolov4tpu/ops/nms_pallas.py::_suppress_kernel
// (launched there by _suppress_batch, one grid step per image, for
// combined_nms_pallas, i.e. nms_impl="pallas").  Called from
// yolov4tpu_torch/ops/nms_cuda.py::suppress, which builds this file with
// nvcc and loads it with ctypes.
//
// Inputs (float32 / int32, contiguous):
//   coords (B, 4, C, K)  corner planes x1, y1, x2, y2 (lo <= hi) of each
//                        class's candidates, sorted by descending score;
//   valid  (B, C, K)     1.0 where the candidate clears the score threshold;
//   nmax   (B,)          the loop bound of each image: the largest number of
//                        valid candidates of any of its classes.
// Output:
//   keep   (B, C, K)     valid, with 0.0 wherever a live earlier candidate
//                        of the same class overlaps by IoU > iou_threshold.
//
// Design: one block per (class, image), grid (C, B), one thread per
// candidate (K <= 1024; the block is K rounded up to a warp, and the tail
// threads only join the barriers).  Shared memory holds the class's K corner
// planes, areas and alive flags.  Candidates are already in score order, so
// the pivot of step i is candidate i, read from shared memory by index: the
// TPU kernel's masked row-sums (nms_pallas.py:59-70) are not needed.  A step
// whose pivot is dead writes nothing, so every thread skips it and its
// barrier together (the flag was last written before an earlier barrier).
//
// Loop bound: as in the Pallas kernel (nms_pallas.py:56), each image loops
// to its own nmax over all classes, not to each class's own count.  For the
// prefix masks combined_nms_sorted makes the two bounds give the same keep;
// for any other 0/1 mask only nmax reproduces the TPU kernel, so the
// wrapper computes it in torch and passes it in.
//
// Numerics: area, intersection, union and the division use the same
// operations in the same order as nms_pallas.py:50,72-76, written with the
// _rn intrinsics so that nvcc cannot contract a multiply and an add into an
// FMA.  So keep equals the plain-torch version (nms_cuda.suppress_reference)
// exactly: one IoU on the other side of the threshold would change the
// detections.  As in the TPU kernel, a later candidate that overlaps a live
// pivot is set to 0 whether or not it is alive; skipping the test where it
// is already 0 changes nothing.
//
// What bounds it on the H100: not memory.  At B=8, C=80, K=256 it moves
// about 3.9 MB (coords and valid in, keep out), about 1.2 us at 3.35 TB/s,
// and the IoU arithmetic is a few MFLOP.  Its time is the up to nmax
// sequential steps of each block, each a barrier and a shared-memory round
// trip: latency.  Making it fast is later work.

#include <cuda_runtime.h>

namespace {

__global__ void suppress_kernel(const float* __restrict__ coords,
                                const float* __restrict__ valid,
                                const int* __restrict__ nmax,
                                float* __restrict__ keep, int C, int K,
                                float iou_threshold) {
    extern __shared__ float smem[];
    float* sx1 = smem;
    float* sy1 = sx1 + K;
    float* sx2 = sy1 + K;
    float* sy2 = sx2 + K;
    float* sarea = sy2 + K;
    float* salive = sarea + K;

    const int c = blockIdx.x;
    const int b = blockIdx.y;
    const int t = threadIdx.x;
    const bool active = t < K;

    const size_t plane = static_cast<size_t>(C) * K;
    const float* cb = coords + static_cast<size_t>(b) * 4 * plane
                      + static_cast<size_t>(c) * K;
    const size_t row = (static_cast<size_t>(b) * C + c) * K;

    float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f, area = 0.f;
    if (active) {
        x1 = cb[t];
        y1 = cb[plane + t];
        x2 = cb[2 * plane + t];
        y2 = cb[3 * plane + t];
        area = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
        sx1[t] = x1;
        sy1[t] = y1;
        sx2[t] = x2;
        sy2[t] = y2;
        sarea[t] = area;
        salive[t] = valid[row + t];
    }
    __syncthreads();

    const int n = min(nmax[b], K);
    for (int i = 0; i < n; ++i) {
        if (!(salive[i] > 0.5f)) continue;  // uniform across the block
        if (active && t > i && salive[t] != 0.f) {
            const float iw = fmaxf(
                __fsub_rn(fminf(sx2[i], x2), fmaxf(sx1[i], x1)), 0.f);
            const float ih = fmaxf(
                __fsub_rn(fminf(sy2[i], y2), fmaxf(sy1[i], y1)), 0.f);
            const float inter = __fmul_rn(iw, ih);
            const float uni = __fsub_rn(__fadd_rn(sarea[i], area), inter);
            const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
            if (iou > iou_threshold) salive[t] = 0.f;
        }
        __syncthreads();
    }
    if (active) keep[row + t] = salive[t];
}

}  // namespace

extern "C" int suppress_launch(const float* coords, const float* valid,
                               const int* nmax, float* keep, int B, int C,
                               int K, float iou_threshold,
                               cudaStream_t stream) {
    const int threads = ((K + 31) / 32) * 32;
    const size_t smem = static_cast<size_t>(K) * 6 * sizeof(float);
    dim3 grid(C, B);
    suppress_kernel<<<grid, threads, smem, stream>>>(
        coords, valid, nmax, keep, C, K, iou_threshold);
    return static_cast<int>(cudaGetLastError());
}
