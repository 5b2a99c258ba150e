// Rank-ordered per-class greedy NMS suppression with the per-class cap, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel yolov4tpu/ops/nms_pallas.py::_suppress_rank_kernel
// (launched there by _suppress_rank_batch, one grid step per image).  Called
// from yolov4tpu_torch/ops/nms_cuda.py::suppress_rank, which builds this file
// with nvcc and loads it with ctypes.
//
// Inputs (float32 / int32, contiguous):
//   coords (B, 4, K)  candidate corner planes x1, y1, x2, y2 (lo <= hi),
//                     in the candidate order shared by every class;
//   scores (B, C, K)  class scores in candidate order (finite);
//   rank   (B, C, K)  rank[b,c,k] = position of candidate k in class c's
//                     stable descending-score order (a permutation of 0..K-1).
// Output:
//   keep   (B, C, K)  1.0 where the candidate survives suppression and cap.
//
// Design: one block per (class, image), grid (C, B), one thread per
// candidate for the loads (K <= 1024; the block is K rounded up to a warp,
// and at least 256 threads).  Each thread stores its candidate's corners
// and area in shared memory at its rank, so the class's candidates sit in
// score order.  The valid ones (score > score_threshold) are exactly the
// ranks below nvalid, the count the first barrier returns: rank comes from
// a stable descending sort of the same scores.  Then two phases, with one
// barrier between them and one after:
//
// 1. The IoU bitmask, by every thread.  Bit j % 32 of word M[i][j / 32] is
//    set when rank j > i overlaps rank i by IoU > iou_threshold, for the
//    rows and columns below nvalid (later ranks are never alive).  A warp
//    takes a row (rows dealt round-robin over the block's at least 8
//    warps) and its words from the diagonal on; each lane tests one column
//    and __ballot_sync makes the word, so every IoU of a word runs at once
//    and the pivot's corners are one shared-memory broadcast.  Words left
//    of the diagonal are never read and not computed.
// 2. The greedy scan, by warp 0 alone, with no barrier, a word at a time.
//    Lane l holds word l of the "removed" bits (K = 1024 is exactly 32
//    words).  For word w, a shuffle gives every lane the word's live
//    pivots, each lane loads the diagonal mask word of its row, and the
//    pivots of the word are taken in order from registers alone: __ffs of
//    the live bits, one __shfl_sync of that row's word, an AND.  Dead
//    pivots cost nothing.  Then the lanes after w OR in the kept rows'
//    words (independent loads).  Once max_per_class pivots are kept, every
//    later live pivot is dropped and suppresses nothing, exactly as
//    nms_pallas.py:231-236 does, so the scan marks them all removed and
//    stops; max_per_class <= 0 keeps nothing.  The steps are the kept
//    pivots, not nvalid.
//
// Numerics: area, intersection, union and the division use the same operations
// in the same order as nms_pallas.py:212,238-242, written with the _rn
// intrinsics so that nvcc cannot contract a multiply and an add into an FMA,
// and the division is a true division after `uni > 0` (left out where the
// intersection is 0: its quotient +-0 compares as 0 does).  So every mask bit
// equals the plain version's comparison and keep equals
// nms_cuda.suppress_rank_reference exactly: one IoU on the other side of the
// threshold would change the detections.
//
// Shared memory: K float4 corners, K areas and K rows of
// ceil(K / 32) mask words: 13 KB at the main path's K = 256, 148 KB at
// K = 1024, past the 48 KB a launch gets without
// cudaFuncAttributeMaxDynamicSharedMemorySize, which the launch function
// raises once to the size of K = 1024.  If that fails, or the launch is
// refused, the error code goes back to the wrapper, which raises.
//
// What bounds it on the H100: not memory and not arithmetic.  At B=8,
// C=80, K=256 it moves about 2 MB (coords, scores, rank in, keep out),
// 0.6 us at 3.35 TB/s.  On the "fast" path's inputs (score 0.3) all of an
// image's ~99 valid candidates fall in one class, so 8 of the 640 blocks do
// the work: phase 1's ~99 x 99 / 2 IoU tests and a scan of ~36 kept
// pivots; the other blocks load, count nothing and store.  chip_smoke.py
// splits the kernel's 0.011 ms there (NVIDIA H100 80GB HBM3, 700 W): the
// same launch with nothing valid takes 0.002 ms (the launch, the loads, the
// barriers and the store of 640 blocks), a scan step about 0.09 us (the
// time grows so with IoU threshold 1.0, where all 99 are kept), which
// leaves ~0.006 ms for the dense blocks' phase 1: eight warps, each a chain
// of shared loads, the IoU with its IEEE division, a ballot and a store
// per mask word.  At B=64 the 5,120 blocks' floor is 0.008 ms.  More
// threads a block shorten phase 1 but raise that floor (512 or 1024
// threads: 0.013 or 0.036 ms at B=64), and several classes per block would
// not help either: 640 blocks of 256 threads are all resident at once on
// 132 SMs.

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

__global__ void __launch_bounds__(kMaxK)
suppress_rank_kernel(const float* __restrict__ coords,
                     const float* __restrict__ scores,
                     const int* __restrict__ rank, float* __restrict__ keep,
                     int C, int K, float iou_threshold, float score_threshold,
                     int max_per_class) {
    extern __shared__ float4 sbox[];         // (x1, y1, x2, y2), rank order
    float* sarea = reinterpret_cast<float*>(sbox + K);
    unsigned* smask = reinterpret_cast<unsigned*>(sarea + K);
    __shared__ unsigned sremoved[kWarp];

    const int c = blockIdx.x;
    const int b = blockIdx.y;
    const int t = threadIdx.x;
    const int lane = t % kWarp;
    const int warp = t / kWarp;
    const int warps = blockDim.x / kWarp;
    const bool active = t < K;

    const float* cb = coords + static_cast<size_t>(b) * 4 * K;
    const size_t row = (static_cast<size_t>(b) * C + c) * K;

    int my_rank = 0;
    int valid = 0;
    if (active) {
        const float4 box = make_float4(cb[t], cb[K + t], cb[2 * K + t],
                                       cb[3 * K + t]);
        my_rank = rank[row + t];
        sbox[my_rank] = box;
        sarea[my_rank] =
            __fmul_rn(__fsub_rn(box.z, box.x), __fsub_rn(box.w, box.y));
        valid = scores[row + t] > score_threshold;
    }
    // Barrier that also counts this class's valid candidates.
    const int nvalid = __syncthreads_count(valid);
    const int words = (nvalid + kWarp - 1) / kWarp;   // mask row stride

    // Phase 1: row i of the mask for each rank i < nvalid, one warp a row
    // (rows dealt round-robin), one column a lane: word w is the ballot of
    // the lanes whose rank j = 32 w + lane, i < j < nvalid, overlaps the
    // pivot.  A column's load is clamped into the array, so the IoU runs
    // unconditionally.
    for (int i = warp; i < nvalid; i += warps) {
        const float4 p = sbox[i];
        const float parea = sarea[i];
        for (int w = i / kWarp; w < words; ++w) {
            const int j = w * kWarp + lane;
            const int k = min(j, K - 1);
            const bool hit = overlaps(p, parea, sbox[k], sarea[k],
                                      iou_threshold);
            const unsigned bits =
                __ballot_sync(kFull, j > i && j < nvalid && hit);
            if (lane == 0) smask[i * words + w] = bits;
        }
    }
    __syncthreads();

    // Phase 2: the greedy scan by warp 0, a word at a time.  Lane l holds
    // word l of the removed bits (ranks >= nvalid start removed).  For word
    // w: its live pivots (the same value in every lane), each lane's
    // diagonal mask word of its row, then the pivots of the word in order
    // from registers alone (ffs, one shuffle each), then the kept rows'
    // later words OR-ed into lanes > w (independent loads).  The cap: once
    // max_per_class pivots are kept, every later live pivot is dropped and
    // suppresses nothing, so the scan marks them all removed and stops.
    if (warp == 0) {
        const int base = lane * kWarp;
        unsigned removed = kFull;
        if (nvalid >= base + kWarp) removed = 0u;
        else if (nvalid > base) removed = kFull << (nvalid - base);
        const unsigned todo = ~removed;
        int count = 0;
        bool capped = max_per_class <= 0;
        if (capped) removed = kFull;       // the cap keeps nothing
        for (int w = 0; w < words && !capped; ++w) {
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
                if (++count == max_per_class) {
                    gone |= live;           // past the cap: dropped
                    capped = true;
                    break;
                }
            }
            if (lane == w) removed |= gone;
            if (capped) {
                if (lane > w) removed |= todo;
            } else if (lane > w && lane < words) {
                for (unsigned k = kept; k != 0u; k &= k - 1u) {
                    const int i = w * kWarp + __ffs(k) - 1;
                    removed |= smask[i * words + lane];
                }
            }
        }
        sremoved[lane] = removed;
    }
    __syncthreads();
    if (active) {
        const unsigned gone = (sremoved[my_rank / kWarp] >> (my_rank % kWarp))
                              & 1u;
        keep[row + t] = gone ? 0.f : 1.f;
    }
}

constexpr size_t smem_bytes(int K) {
    return static_cast<size_t>(K) * (sizeof(float4) + sizeof(float)) +
           static_cast<size_t>(K) * ((K + kWarp - 1) / kWarp) *
               sizeof(unsigned);
}

}  // namespace

extern "C" int suppress_rank_launch(const float* coords, const float* scores,
                                    const int* rank, float* keep, int B,
                                    int C, int K, float iou_threshold,
                                    float score_threshold, int max_per_class,
                                    cudaStream_t stream) {
    // Once per process: allow the dynamic shared memory of K = 1024.
    static const cudaError_t attr = cudaFuncSetAttribute(
        suppress_rank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxK)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
    const int rounded = ((K + kWarp - 1) / kWarp) * kWarp;
    const int threads = rounded > kMinThreads ? rounded : kMinThreads;
    dim3 grid(C, B);
    suppress_rank_kernel<<<grid, threads, smem_bytes(K), stream>>>(
        coords, scores, rank, keep, C, K, iou_threshold, score_threshold,
        max_per_class);
    return static_cast<int>(cudaGetLastError());
}
