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
// Semantics, those of the Pallas body (nms_pallas.py:56-82): pivot i runs
// for i < nmax (per image, as the TPU kernel loops, so any mask gives its
// result, prefix or not); it is live when its alive value is > 0.5, i.e.
// valid[i] > 0.5 and no live earlier pivot removed it; a live pivot clears
// every later candidate it overlaps, whatever that candidate's mask.  So
// keep[j] = removed[j] ? 0 : valid[j], as suppress_reference's
// alive = valid.clone() gives for any float mask.
//
// Design: one block per (class, image), grid (C, B), one thread per
// candidate for the loads (K <= 1024; the block is K rounded up to a warp,
// and at least 256 threads).  Shared memory holds the class's corners and
// areas, each warp's ballots of valid > 0.5 (the pivots) and of valid != 0,
// and the IoU bitmask.  Two phases, with one barrier between them and one
// after:
//
// 1. The IoU bitmask, by every thread.  Bit j % 32 of word M[i][j / 32] is
//    set when candidate j > i overlaps candidate i by IoU > iou_threshold,
//    for the rows that can be pivots (i < min(nmax, K), valid[i] > 0.5) and
//    the later columns whose valid is not 0 (clearing a candidate whose
//    valid is 0 changes no keep; any other is tested whatever its value).
//    So a row runs to the last word holding a nonzero valid, which is the
//    mask's row stride, and the rows end at the last pivot.  A warp takes a
//    row (rows dealt round-robin over the block's at least 8 warps) and
//    its words from the diagonal on; each lane tests one column and
//    __ballot_sync makes the word, so every IoU of a word runs at once.
//    Words left of the diagonal are never read and not computed.
// 2. The greedy scan, by warp 0 alone, with no barrier, a word at a time.
//    Lane l holds word l of the removed bits (K = 1024 is exactly 32
//    words).  For word w, a shuffle gives every lane the word's live
//    pivots, each lane loads the diagonal mask word of its row, and the
//    pivots of the word are taken in order from registers alone: __ffs of
//    the live bits, one __shfl_sync of that row's word, an AND.  Dead
//    pivots cost nothing.  Then the lanes after w OR in the kept rows'
//    words (independent loads).  The steps are the surviving pivots, not
//    nmax.
//
// Numerics: area, intersection, union and the division use the same operations
// in the same order as nms_pallas.py:50,72-76, written with the _rn intrinsics
// so that nvcc cannot contract a multiply and an add into an FMA, and the
// division is a true division after `uni > 0` (left out where the intersection
// is 0: its quotient +-0 compares as 0 does).  So every mask bit equals the
// plain version's comparison and keep equals nms_cuda.suppress_reference
// exactly: one IoU on the other side of the threshold would change the
// detections.
//
// Shared memory: K float4 corners, K areas and K rows of
// ceil(K / 32) mask words: 13 KB at the main path's K = 256, 148 KB at
// K = 1024, past the 48 KB a launch gets without
// cudaFuncAttributeMaxDynamicSharedMemorySize, which the launch function
// raises once to the size of K = 1024.  If that fails, or the launch is
// refused, the error code goes back to the wrapper, which raises.
//
// What bounds it on the H100: not memory and not arithmetic.  At B=8,
// C=80, K=256 it moves about 3.9 MB (coords and valid in, keep out), about
// 1.2 us at 3.35 TB/s.  On the "pallas" path's inputs (score 0.3) all of
// an image's ~99 valid candidates fall in one class: phase 1's ~99 x 99 / 2
// IoU tests and a scan of ~36 surviving pivots in 8 of the 640 blocks.
// chip_smoke.py splits the kernel's 0.013 ms there (NVIDIA H100 80GB HBM3,
// 700 W): 0.002 ms with nothing valid (the launch, the loads, the barriers
// and the store of 640 blocks), about 0.09 us a scan step (from the time
// at IoU threshold 1.0, where all 99 survive), and ~0.008 ms for those
// blocks' phase 1: eight warps, each a chain of shared loads, the IoU with
// its IEEE division, a ballot and a store per mask word.  At the
// evaluation path's score 0.05 (36 valid a class on average, up to 256)
// the kernel takes 0.062 ms: a class with 256 valid candidates that all
// survive pays 256 x 256 / 2 IoU tests in phase 1 and 256 scan steps
// (~0.023 ms), where the barrier chain it replaces took 0.087 ms.  More
// threads a block shorten phase 1 (1024 threads: 0.047 ms at score 0.05)
// but raise the floor of the many-block launches (0.030 ms against 0.010
// at B=64); several classes per block would not help either: 640 blocks of
// 256 threads are all resident at once on 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 1024;
constexpr int kWarp = 32;
constexpr int kMinThreads = 256;   // 8 warps for phase 1 at any K
constexpr unsigned kFull = 0xffffffffu;

// IoU(pivot p, candidate c) > iou_threshold, with boxes as (x1, y1, x2, y2).
// A division with a zero dividend is left out: its quotient, +-0, compares
// with the threshold as 0 does, and it would take the slow path of the
// IEEE division, as would most pairs, which do not intersect.
__device__ __forceinline__ bool overlaps(float4 p, float parea, float4 c,
                                         float area, float iou_threshold) {
    const float iw = fmaxf(__fsub_rn(fminf(p.z, c.z), fmaxf(p.x, c.x)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(p.w, c.w), fmaxf(p.y, c.y)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(parea, area), inter);
    const float iou = uni > 0.f && inter > 0.f ? __fdiv_rn(inter, uni) : 0.f;
    return iou > iou_threshold;
}

__device__ __forceinline__ bool bit_of(const unsigned* words, int j) {
    return (words[j / kWarp] >> (j % kWarp)) & 1u;
}

__global__ void __launch_bounds__(kMaxK)
suppress_kernel(const float* __restrict__ coords,
                const float* __restrict__ valid, const int* __restrict__ nmax,
                float* __restrict__ keep, int C, int K, float iou_threshold) {
    extern __shared__ float4 sbox[];                    // (x1, y1, x2, y2)
    float* sarea = reinterpret_cast<float*>(sbox + K);
    unsigned* smask = reinterpret_cast<unsigned*>(sarea + K);
    __shared__ unsigned spivot[kWarp];    // bit t: valid[t] > 0.5
    __shared__ unsigned snonzero[kWarp];  // bit t: valid[t] != 0
    __shared__ unsigned sremoved[kWarp];

    const int c = blockIdx.x;
    const int b = blockIdx.y;
    const int t = threadIdx.x;
    const int lane = t % kWarp;
    const int warp = t / kWarp;
    const int warps = blockDim.x / kWarp;
    const bool active = t < K;

    const size_t plane = static_cast<size_t>(C) * K;
    const float* cb = coords + static_cast<size_t>(b) * 4 * plane
                      + static_cast<size_t>(c) * K;
    const size_t row = (static_cast<size_t>(b) * C + c) * K;

    float v = 0.f;
    if (active) {
        const float4 box = make_float4(cb[t], cb[plane + t], cb[2 * plane + t],
                                       cb[3 * plane + t]);
        sbox[t] = box;
        sarea[t] = __fmul_rn(__fsub_rn(box.z, box.x), __fsub_rn(box.w, box.y));
        v = valid[row + t];
    }
    const unsigned pivots = __ballot_sync(kFull, v > 0.5f);
    const unsigned nonzero = __ballot_sync(kFull, v != 0.f);
    if (lane == 0 && warp < kWarp) {
        spivot[warp] = pivots;
        snonzero[warp] = nonzero;
    }
    const int n = max(min(nmax[b], K), 0);
    __syncthreads();

    // Every warp: lane l's word of the pivots (valid > 0.5, below n), the
    // rows up to the last pivot, and the mask's row stride: the words up to
    // the last one with a nonzero valid (no later column can change keep).
    const int base = lane * kWarp;
    unsigned todo = 0u;
    unsigned nz = 0u;
    if (base < K) {
        todo = spivot[lane];
        if (n <= base) todo = 0u;
        else if (n < base + kWarp) todo &= (1u << (n - base)) - 1u;
        nz = snonzero[lane];
    }
    const unsigned pivot_lanes = __ballot_sync(kFull, todo != 0u);
    const int words = kWarp - __clz(__ballot_sync(kFull, nz != 0u));
    int rows = 0;
    if (pivot_lanes != 0u) {
        const int top = kWarp - 1 - __clz(pivot_lanes);
        rows = top * kWarp + kWarp - __clz(__shfl_sync(kFull, todo, top));
    }

    // Phase 1: row i of the mask for each pivot i, one warp a row (rows
    // dealt round-robin), one column a lane: word w is the ballot of the
    // lanes whose candidate j = 32 w + lane > i has a nonzero valid and
    // overlaps the pivot.  Columns whose valid is 0 are not tested
    // (clearing them changes no keep); a column past K has a zero valid
    // bit, and its load is clamped into the array, so the IoU runs
    // unconditionally.
    for (int i = warp; i < rows; i += warps) {
        if (!bit_of(spivot, i)) continue;
        const float4 p = sbox[i];
        const float parea = sarea[i];
        for (int w = i / kWarp; w < words; ++w) {
            const int j = w * kWarp + lane;
            const int k = min(j, K - 1);
            const bool hit = overlaps(p, parea, sbox[k], sarea[k],
                                      iou_threshold);
            const unsigned bits =
                __ballot_sync(kFull, j > i && bit_of(snonzero, j) && hit);
            if (lane == 0) smask[i * words + w] = bits;
        }
    }
    __syncthreads();

    // Phase 2: the greedy scan by warp 0, a word at a time.  Lane l holds
    // word l of the removed bits.  For word w: the live pivots (the same
    // value in every lane), each lane's diagonal mask word of its row, then
    // the pivots of the word in order from registers alone (ffs, one
    // shuffle each), then the kept rows' later words OR-ed into lanes > w
    // (independent loads).
    if (warp == 0) {
        unsigned removed = 0u;
        for (int w = 0; w < words; ++w) {
            unsigned live = __shfl_sync(kFull, todo & ~removed, w);
            if (live == 0u) continue;
            const unsigned diag = (live >> lane) & 1u
                ? smask[(w * kWarp + lane) * words + w] : 0u;
            unsigned kept = 0u, gone = 0u;
            while (live != 0u) {
                const int bit = __ffs(live) - 1;
                const unsigned suppressed = __shfl_sync(kFull, diag, bit);
                kept |= 1u << bit;
                gone |= suppressed;
                live &= ~suppressed & ~(1u << bit);
            }
            if (lane == w) removed |= gone;
            if (lane > w && lane < words)
                for (unsigned k = kept; k != 0u; k &= k - 1u) {
                    const int i = w * kWarp + __ffs(k) - 1;
                    removed |= smask[i * words + lane];
                }
        }
        sremoved[lane] = removed;
    }
    __syncthreads();
    if (active) keep[row + t] = bit_of(sremoved, t) ? 0.f : v;
}

constexpr size_t smem_bytes(int K) {
    return static_cast<size_t>(K) * (sizeof(float4) + sizeof(float)) +
           static_cast<size_t>(K) * ((K + kWarp - 1) / kWarp) *
               sizeof(unsigned);
}

}  // namespace

extern "C" int suppress_launch(const float* coords, const float* valid,
                               const int* nmax, float* keep, int B, int C,
                               int K, float iou_threshold,
                               cudaStream_t stream) {
    // Once per process: allow the dynamic shared memory of K = 1024.
    static const cudaError_t attr = cudaFuncSetAttribute(
        suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxK)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
    const int rounded = ((K + kWarp - 1) / kWarp) * kWarp;
    const int threads = rounded > kMinThreads ? rounded : kMinThreads;
    dim3 grid(C, B);
    suppress_kernel<<<grid, threads, smem_bytes(K), stream>>>(
        coords, valid, nmax, keep, C, K, iou_threshold);
    return static_cast<int>(cudaGetLastError());
}
