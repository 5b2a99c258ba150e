// Rank-ordered per-class greedy NMS suppression with an in-loop per-class
// cap, for Hopper (sm_90a).
//
// Replaces the TPU kernel yolov4tpu/ops/nms_pallas.py::_suppress_rank_kernel
// (launched there by _suppress_rank_batch, one grid step per image).  Called
// from yolov4tpu_torch/ops/nms_cuda.py::suppress_rank, which builds this file
// with nvcc and loads it with ctypes.
//
// Inputs (float32 / int32, contiguous):
//   coords (B, 4, K)  candidate corner planes x1, y1, x2, y2 (lo <= hi),
//                     in the candidate order shared by every class;
//   scores (B, C, K)  class scores in candidate order;
//   rank   (B, C, K)  rank[b,c,k] = position of candidate k in class c's
//                     stable descending-score order (a permutation of 0..K-1).
// Output:
//   keep   (B, C, K)  1.0 where the candidate survives suppression and cap.
//
// Design: one block per (class, image), grid (C, B), one thread per
// candidate (K <= 1024; the block is K rounded up to a warp, and the tail
// threads only join the barriers).  Shared memory holds the K corner planes
// and areas, perm (the inverse of rank: perm[rank[t]] = t) and the alive
// flags.  The loop walks the pivot rank i: thread 0 applies the cap to pivot
// perm[i] exactly as nms_pallas.py:231-236 does, then, after a barrier,
// every thread whose rank is > i tests its IoU against the live pivot.
//
// Loop bound: the Pallas kernel runs to the image-wide longest valid prefix
// nmax.  Here each block stops at its own class's valid count nvalid.  That
// is the same result: rank comes from a stable descending sort of the same
// scores and valid = score > score_threshold, so every rank >= nvalid is a
// candidate that was never alive, whose pivot step changes neither the cap
// count nor any alive flag.
//
// Numerics: area, intersection, union and the division use the same
// operations in the same order as nms_pallas.py:212,238-242, written with
// the _rn intrinsics so that nvcc cannot contract a multiply and an add into
// an FMA.  So keep equals the plain-torch version
// (nms_cuda.suppress_rank_reference) exactly, not just within a tolerance:
// one IoU on the other side of the threshold would change the detections.
//
// What bounds it on the H100: not memory.  At B=8, C=80, K=256 it moves
// about 2 MB (coords, scores, rank in, keep out), well under a microsecond
// at 3.35 TB/s, and the IoU arithmetic is a few MFLOP.  Its time is the
// nvalid sequential steps of each block, each two __syncthreads barriers
// and a shared-memory round trip: latency.  With hundreds of blocks in
// flight, the card hides some of it.  Making it fast (skipping dead pivots
// without a barrier, several classes per block, warp-level ballots) is
// later work.

#include <cuda_runtime.h>

namespace {

__global__ void suppress_rank_kernel(const float* __restrict__ coords,
                                     const float* __restrict__ scores,
                                     const int* __restrict__ rank,
                                     float* __restrict__ keep,
                                     int C, int K, float iou_threshold,
                                     float score_threshold,
                                     int max_per_class) {
    extern __shared__ float smem[];
    float* sx1 = smem;
    float* sy1 = sx1 + K;
    float* sx2 = sy1 + K;
    float* sy2 = sx2 + K;
    float* sarea = sy2 + K;
    int* salive = reinterpret_cast<int*>(sarea + K);
    int* sperm = salive + K;
    __shared__ int spivot_alive;

    const int c = blockIdx.x;
    const int b = blockIdx.y;
    const int t = threadIdx.x;
    const bool active = t < K;

    const float* cb = coords + static_cast<size_t>(b) * 4 * K;
    const size_t row = (static_cast<size_t>(b) * C + c) * K;

    int my_rank = 0;
    int valid = 0;
    float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f, area = 0.f;
    if (active) {
        x1 = cb[t];
        y1 = cb[K + t];
        x2 = cb[2 * K + t];
        y2 = cb[3 * K + t];
        area = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
        sx1[t] = x1;
        sy1[t] = y1;
        sx2[t] = x2;
        sy2[t] = y2;
        sarea[t] = area;
        my_rank = rank[row + t];
        valid = scores[row + t] > score_threshold;
        salive[t] = valid;
        sperm[my_rank] = t;
    }
    // Barrier that also counts this class's valid candidates.
    const int nvalid = __syncthreads_count(valid);

    int count = 0;  // survivors so far (thread 0 only)
    for (int i = 0; i < nvalid; ++i) {
        if (t == 0) {
            const int p = sperm[i];
            int palive = salive[p];
            // Per-class cap: a pivot past max_per_class survivors is dropped.
            if (palive) {
                if (count + 1 > max_per_class) {
                    palive = 0;
                    salive[p] = 0;
                } else {
                    ++count;
                }
            }
            spivot_alive = palive;
        }
        __syncthreads();
        if (spivot_alive && active && my_rank > i && salive[t]) {
            const int p = sperm[i];
            const float iw = fmaxf(
                __fsub_rn(fminf(sx2[p], x2), fmaxf(sx1[p], x1)), 0.f);
            const float ih = fmaxf(
                __fsub_rn(fminf(sy2[p], y2), fmaxf(sy1[p], y1)), 0.f);
            const float inter = __fmul_rn(iw, ih);
            const float uni = __fsub_rn(__fadd_rn(sarea[p], area), inter);
            const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
            if (iou > iou_threshold) salive[t] = 0;
        }
        __syncthreads();
    }
    if (active) keep[row + t] = salive[t] ? 1.f : 0.f;
}

}  // namespace

extern "C" int suppress_rank_launch(const float* coords, const float* scores,
                                    const int* rank, float* keep, int B,
                                    int C, int K, float iou_threshold,
                                    float score_threshold, int max_per_class,
                                    cudaStream_t stream) {
    const int threads = ((K + 31) / 32) * 32;
    const size_t smem = static_cast<size_t>(K) * (5 * sizeof(float) +
                                                  2 * sizeof(int));
    dim3 grid(C, B);
    suppress_rank_kernel<<<grid, threads, smem, stream>>>(
        coords, scores, rank, keep, C, K, iou_threshold, score_threshold,
        max_per_class);
    return static_cast<int>(cudaGetLastError());
}
