// Training's BatchNorm + activation of a convolution, for sm_90a: the
// forward and the backward of
//
//   out = act(round(round(y * scale) + shift)),
//   scale = round(gamma * inv),  shift = round(beta - mean * gamma * inv),
//   inv = 1 / sqrt(max(E[y^2] - E[y]^2, 0) + 1e-3),
//
// with the batch's own per-channel statistics, over a conv's output y
// (N, C, H, W) in channels_last memory, read as rows of C channels
// (N*H*W, C), bfloat16 or float32.  act is leaky (alpha 0.1) or mish
// (every BN conv of YOLOv4 ends in one of them).  round is bfloat16's rounding in the bf16 instantiations.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the batch moments,
// the affine and the activation, and their gradients, by itself.
// PyTorch's eager training forward (models/network.py, _ApplyOps.conv)
// ran them as ~20 kernels a conv (a float32 copy of y, its square, two
// reductions, a multiply and an add, ten for mish) and autograd mirrored
// each in the backward, ~40 passes over the conv's output in all.  Called
// from yolov4tpu_torch/ops/bn_act.py (the autograd Function), which builds
// this file with nvcc and loads it with ctypes.
//
// Forward, bn_act_forward: two passes over y.
//   1. bn_act_stats: sum(w y) and sum((w y)^2) per channel in float32, w
//      the sample's mask weight (1 without a mask); per-block partials,
//      then bn_act_stats_finish sums them in a fixed order (no atomics: a
//      step repeats bit for bit) and does the per-channel work: mean,
//      E[y^2] (the mask's denominator max(valid, 1) * H * W, and + 1 for
//      an all-padding batch), var, inv, scale and shift rounded to the
//      storage type, and the new moving statistics (momentum 0.99).
//   2. bn_act_fwd: out = act(round(round(y * scale) + shift)), the eager
//      chain's float32 operations and bf16 roundings in its order (the _rn
//      intrinsics: no FMA contraction; IEEE division; the library expf),
//      so equal bit for bit to _activate(y * scale + shift) given the same
//      scale and shift.  bf16 mish reads a table of all 65,536 bf16 values
//      in shared memory (bn_act_table_fill, the same arithmetic).
// Backward, bn_act_backward: two passes over g and y.
//   3. bn_act_grad_stats: z recomputed as the forward rounded it,
//      gz = g * act'(z) in float32, and sum(gz), sum(gz y) per channel;
//      bn_act_grad_finish gives dbeta, dgamma and the batch statistics'
//      terms (through shift, inv, var's clamp and the denominator; zero
//      when the statistics are constants of the backward).
//   4. bn_act_grad: dy = round(gz * scale + w (A + B y)), A and B those
//      terms over the denominator.
// The backward keeps float32 from g to dy: it is closer to float32
// autograd than the eager bf16 autograd, which rounds every intermediate.
//
// What bounds it on the H100: bytes.  Each pass does a few dozen
// operations a value against 2-6 bytes, far below the card's 295
// operations a byte.  The least the work can move is 10 bytes a bf16
// value (y read and out written forward; g, y read and dy written
// backward); this design moves 16 (y twice forward, g and y twice
// backward), so it can reach 62.5% of that bound.
//
// Design: every kernel tiles rows x channels the same way.  A thread owns
// one 16-byte vector of channels (8 bf16 or 4 float32; one value on the
// scalar route, for C not a multiple of the vector or a misaligned
// pointer) and walks rows with a grid stride, kUnroll rows' loads in
// flight; a block holds block / W rows of W vectors, W = min(C / lanes,
// block), and a second grid dimension covers wider rows.  So a thread's
// channels, its scale and shift, stay in registers, and a warp reads
// whole rows, contiguous in channels_last memory.  The reductions add a
// thread's rows in registers, the block's row lanes in shared memory by a
// fixed tree, and the blocks' partials in the finish kernel, in a fixed
// order.  g may be a view with rows ldg values apart (a slice of a
// concat's gradient), which it reads in place.  Each launch function
// allocates nothing, never synchronises, launches on the caller's stream
// and returns cudaGetLastError()'s code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLeaky = 1;
constexpr int kMish = 2;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;     // of kThreads: a grid's blocks an SM
constexpr int kLutThreads = 1024;   // one block an SM beside its table
constexpr int kFinishThreads = 512;  // 16 warps over the partials
constexpr int kUnroll = 4;          // rows a thread has in flight
constexpr int kRowsPerThread = 16;  // a reduction thread's rows at least
constexpr float kEps = 1e-3f;       // Keras BatchNormalization's epsilon

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
    if constexpr (BF16) {
        return __bfloat162float(__float2bfloat16_rn(x));
    } else {
        return x;
    }
}

__device__ __forceinline__ float rnd_as(bool bf16, float x) {
    return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// act(z) for one value z exact in the storage type, the eager chain's
// arithmetic (ops/epilogue.py::_mish, F.leaky_relu).
template <bool BF16, int ACT>
__device__ __forceinline__ float activate(float v) {
    if constexpr (ACT == kMish) {
        const float c = v > 20.f ? 20.f : v;
        const float u = rnd<BF16>(expf(c));
        const float t1 = rnd<BF16>(__fmul_rn(u, u));
        const float t2 = rnd<BF16>(__fmul_rn(2.f, u));
        const float n = rnd<BF16>(__fadd_rn(t1, t2));
        const float d = rnd<BF16>(__fadd_rn(n, 2.f));
        const float q = rnd<BF16>(__fdiv_rn(n, d));
        const float p = rnd<BF16>(__fmul_rn(v, q));
        return v > 20.f ? v : p;
    } else {
        static_assert(ACT == kLeaky, "leaky or mish");
        return v > 0.f ? v : rnd<BF16>(__fmul_rn(v, 0.1f));
    }
}

// act'(z) in float32: mish' = n / (n + 2) + z 4u(u + 1) / (n + 2)^2 with
// u = e^z, n = u^2 + 2u, and 1 above the exp's clamp at 20 (where the
// chain's output is z itself).
template <int ACT>
__device__ __forceinline__ float dact(float z) {
    if constexpr (ACT == kMish) {
        if (z > 20.f) return 1.f;
        const float u = __expf(z);
        const float n = u * (u + 2.f);
        const float w = __fdividef(1.f, n + 2.f);
        return n * w + z * (4.f * u * (u + 1.f) * w) * w;
    } else {
        static_assert(ACT == kLeaky, "leaky or mish");
        return z > 0.f ? 1.f : 0.1f;
    }
}

// z = round(round(y * scale) + shift), the eager affine's two kernels.
template <bool BF16>
__device__ __forceinline__ float affine(float y, float scale, float shift) {
    return rnd<BF16>(__fadd_rn(rnd<BF16>(__fmul_rn(y, scale)), shift));
}

// bf16 mish of every bf16 value, indexed by its bits.
constexpr int kTableBytes = (1 << 16) * 2;
__device__ __align__(16) unsigned short g_mish_table[1 << 16];

__global__ void bn_act_table_fill() {
    const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < (1u << 16)) {
        g_mish_table[i] = static_cast<unsigned short>(
            __float_as_uint(activate<true, kMish>(__uint_as_float(i << 16)))
            >> 16);
    }
}

// N values of one row as a register: a 16-byte vector (8 bf16 or 4
// float32) or, for N = 1, one value.
template <bool BF16, int N>
struct Pack {
    static_assert(N == 1 || N == (BF16 ? 8 : 4), "16-byte vectors or one");
    using Raw = std::conditional_t<N == 1, float, uint4>;

    __device__ __forceinline__ static Raw load(const void* p, int64_t e) {
        if constexpr (N == 1) {
            if constexpr (BF16) {
                const unsigned short h =
                    __ldg(static_cast<const unsigned short*>(p) + e);
                return __uint_as_float(static_cast<unsigned>(h) << 16);
            } else {
                return __ldg(static_cast<const float*>(p) + e);
            }
        } else {
            constexpr int kElem = BF16 ? 2 : 4;
            return __ldg(reinterpret_cast<const uint4*>(
                static_cast<const char*>(p) + e * kElem));
        }
    }

    __device__ __forceinline__ static void unpack(const Raw& v, float* f) {
        if constexpr (N == 1) {
            f[0] = v;
        } else if constexpr (BF16) {
            const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                f[2 * j] = __uint_as_float(w[j] << 16);
                f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
            }
        } else {
            f[0] = __uint_as_float(v.x);
            f[1] = __uint_as_float(v.y);
            f[2] = __uint_as_float(v.z);
            f[3] = __uint_as_float(v.w);
        }
    }

    // f: values exact in the storage type.
    __device__ __forceinline__ static void store(void* p, int64_t e,
                                                 const float* f) {
        if constexpr (N == 1) {
            if constexpr (BF16) {
                static_cast<unsigned short*>(p)[e] =
                    static_cast<unsigned short>(__float_as_uint(f[0]) >> 16);
            } else {
                static_cast<float*>(p)[e] = f[0];
            }
        } else {
            constexpr int kElem = BF16 ? 2 : 4;
            uint4 v;
            if constexpr (BF16) {
                unsigned w[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    w[j] = (__float_as_uint(f[2 * j]) >> 16) |
                           (__float_as_uint(f[2 * j + 1]) & 0xffff0000u);
                }
                v = make_uint4(w[0], w[1], w[2], w[3]);
            } else {
                v = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                               __float_as_uint(f[2]), __float_as_uint(f[3]));
            }
            __stcs(reinterpret_cast<uint4*>(static_cast<char*>(p) +
                                            e * kElem),
                   v);
        }
    }
};

// This thread's place: vector column ``col`` (channels col * N ...) of
// rows lane, lane + step, ...; ``active`` false for the threads a block
// has beyond its rows x W.
struct Tile {
    int col;
    int lane;
    int rpi;  // rows a block iteration
    int64_t step;
    bool active;
};

__device__ __forceinline__ Tile tile(int V, int W, int block) {
    Tile t;
    t.rpi = block / W;
    t.lane = threadIdx.x / W;
    t.col = blockIdx.y * W + threadIdx.x % W;
    t.step = static_cast<int64_t>(gridDim.x) * t.rpi;
    t.active = t.lane < t.rpi && t.col < V;
    return t;
}

__device__ __forceinline__ float weight(const float* mask, int64_t row,
                                        int64_t hw) {
    return mask == nullptr ? 1.f : __ldg(mask + row / hw);
}

// Sums the block's row lanes of a and b (N floats each a thread) in
// shared memory by a fixed tree; lane 0's threads write their column's
// sums to partial rows 2 * blockIdx.x (a) and 2 * blockIdx.x + 1 (b).
template <int N>
__device__ __forceinline__ void block_partials(const Tile& t, const float* a,
                                               const float* b, int W, int C,
                                               float* work) {
    __shared__ float sa[kThreads * N];
    __shared__ float sb[kThreads * N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
        sa[threadIdx.x * N + j] = a[j];
        sb[threadIdx.x * N + j] = b[j];
    }
    __syncthreads();
    int half = 1;
    while (half < t.rpi) half <<= 1;
    for (half >>= 1; half > 0; half >>= 1) {
        if (t.active && t.lane < half && t.lane + half < t.rpi) {
            const int o = (threadIdx.x + half * W) * N;
#pragma unroll
            for (int j = 0; j < N; ++j) {
                sa[threadIdx.x * N + j] += sa[o + j];
                sb[threadIdx.x * N + j] += sb[o + j];
            }
        }
        __syncthreads();
    }
    if (t.active && t.lane == 0) {
        float* pa = work + static_cast<int64_t>(2 * blockIdx.x) * C;
        float* pb = pa + C;
#pragma unroll
        for (int j = 0; j < N; ++j) {
            pa[t.col * N + j] = sa[threadIdx.x * N + j];
            pb[t.col * N + j] = sb[threadIdx.x * N + j];
        }
    }
}

// Pass 1: per-block partial sums of w y and (w y)^2.
template <bool BF16, int N>
__global__ void __launch_bounds__(kThreads)
    bn_act_stats(const void* __restrict__ y, int64_t rows, int C, int V,
                 int W, int64_t hw, const float* __restrict__ mask,
                 float* __restrict__ work) {
    using P = Pack<BF16, N>;
    const Tile t = tile(V, W, kThreads);
    float s[N], q[N];
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = q[j] = 0.f;
    if (t.active) {
        for (int64_t r = static_cast<int64_t>(blockIdx.x) * t.rpi + t.lane;
             r < rows; r += kUnroll * t.step) {
            typename P::Raw v[kUnroll];
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
                const int64_t rk = r + k * t.step;
                if (rk < rows) v[k] = P::load(y, rk * C + t.col * N);
            }
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
                const int64_t rk = r + k * t.step;
                if (rk < rows) {
                    float f[N];
                    P::unpack(v[k], f);
                    const float w = weight(mask, rk, hw);
#pragma unroll
                    for (int j = 0; j < N; ++j) {
                        const float a = f[j] * w;
                        s[j] += a;
                        q[j] += a * a;
                    }
                }
            }
        }
    }
    block_partials<N>(t, s, q, W, C, work);
}

// Sums each channel's ``nblocks`` partial pairs in a fixed order: warp w
// takes partials w, w + 16, ..., then warp 0 adds the 16 warps' sums in
// order.  Returns true in the threads of warp 0 that hold a channel.
__device__ __forceinline__ bool sum_partials(const float* work, int nblocks,
                                             int C, int* c_out, float* a,
                                             float* b) {
    constexpr int kWarps = kFinishThreads / 32;
    __shared__ float wa[kWarps][32];
    __shared__ float wb[kWarps][32];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c = blockIdx.x * 32 + lane;
    float sa = 0.f, sb = 0.f;
    if (c < C) {
        for (int p = warp; p < nblocks; p += kWarps) {
            sa += work[static_cast<int64_t>(2 * p) * C + c];
            sb += work[static_cast<int64_t>(2 * p + 1) * C + c];
        }
    }
    wa[warp][lane] = sa;
    wb[warp][lane] = sb;
    __syncthreads();
    if (warp != 0 || c >= C) return false;
    sa = sb = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
        sa += wa[k][lane];
        sb += wb[k][lane];
    }
    *c_out = c;
    *a = sa;
    *b = sb;
    return true;
}

// Saved per-channel rows of ``stats`` (float32, kStatRows x C).
constexpr int kMean = 0;
constexpr int kDiff = 1;   // E[y^2] - E[y]^2 before the clamp
constexpr int kInv = 2;
constexpr int kScale = 3;  // rounded to the storage type
constexpr int kShift = 4;  // rounded to the storage type
constexpr int kDenom = 5;  // the moments' denominator
constexpr int kStatRows = 6;

// The per-channel work of the forward, in the eager chain's float32
// operations: mean, E[y^2], var, inv, scale, shift, the moving statistics.
__global__ void __launch_bounds__(kFinishThreads)
    bn_act_stats_finish(const float* __restrict__ work, int nblocks, int C,
                        int64_t rows, int64_t hw,
                        const float* __restrict__ mask, int batch, int bf16,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const float* __restrict__ mean_in,
                        const float* __restrict__ var_in, float momentum,
                        float complement, float* __restrict__ stats,
                        float* __restrict__ new_mean,
                        float* __restrict__ new_var) {
    int c;
    float s, q;
    if (!sum_partials(work, nblocks, C, &c, &s, &q)) return;
    float denom, pad = 0.f;
    if (mask != nullptr) {
        float valid = 0.f;
        for (int n = 0; n < batch; ++n) valid += mask[n];
        denom = __fmul_rn(valid > 1.f ? valid : 1.f, static_cast<float>(hw));
        pad = valid > 0.f ? 0.f : 1.f;  // unit variance for all padding
    } else {
        denom = static_cast<float>(rows);
    }
    const float mean = __fdiv_rn(s, denom);
    const float mean2 = __fadd_rn(__fdiv_rn(q, denom), pad);
    const float diff = __fsub_rn(mean2, __fmul_rn(mean, mean));
    const float var = diff > 0.f ? diff : 0.f;
    const float inv = __frsqrt_rn(__fadd_rn(var, kEps));
    const float g = gamma[c];
    stats[kMean * C + c] = mean;
    stats[kDiff * C + c] = diff;
    stats[kInv * C + c] = inv;
    stats[kScale * C + c] = rnd_as(bf16, __fmul_rn(g, inv));
    stats[kShift * C + c] =
        rnd_as(bf16, __fsub_rn(beta[c], __fmul_rn(__fmul_rn(mean, g), inv)));
    stats[kDenom * C + c] = denom;
    new_mean[c] = __fadd_rn(__fmul_rn(momentum, mean_in[c]),
                            __fmul_rn(complement, mean));
    new_var[c] = __fadd_rn(__fmul_rn(momentum, var_in[c]),
                           __fmul_rn(complement, var));
}

template <int N>
__device__ __forceinline__ void channel_row(const float* stats, int row,
                                            int C, int col, float* f) {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = __ldg(stats + row * C + col * N + j);
}

// Pass 2: out = act(round(round(y * scale) + shift)).  LUT (bf16 mish
// only): 1,024-thread blocks with the mish table in shared memory.
template <bool BF16, int N, int ACT, bool LUT>
__global__ void __launch_bounds__(LUT ? kLutThreads : kThreads)
    bn_act_fwd(const void* __restrict__ y, void* __restrict__ out,
               int64_t rows, int C, int V, int W,
               const float* __restrict__ stats) {
    using P = Pack<BF16, N>;
    constexpr int kBlock = LUT ? kLutThreads : kThreads;
    static_assert(!LUT || (BF16 && ACT == kMish), "the table is bf16 mish");
    const unsigned short* table = nullptr;
    if constexpr (LUT) {
        extern __shared__ uint4 smem[];
        const uint4* src = reinterpret_cast<const uint4*>(g_mish_table);
        for (int k = threadIdx.x; k < kTableBytes / 16; k += kBlock) {
            smem[k] = src[k];
        }
        __syncthreads();
        table = reinterpret_cast<const unsigned short*>(smem);
    }
    const Tile t = tile(V, W, kBlock);
    if (!t.active) return;
    float sc[N], sh[N];
    channel_row<N>(stats, kScale, C, t.col, sc);
    channel_row<N>(stats, kShift, C, t.col, sh);
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * t.rpi + t.lane;
         r < rows; r += kUnroll * t.step) {
        typename P::Raw v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const int64_t rk = r + k * t.step;
            if (rk < rows) v[k] = P::load(y, rk * C + t.col * N);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const int64_t rk = r + k * t.step;
            if (rk < rows) {
                float f[N];
                P::unpack(v[k], f);
#pragma unroll
                for (int j = 0; j < N; ++j) {
                    const float z = affine<BF16>(f[j], sc[j], sh[j]);
                    if constexpr (LUT) {
                        f[j] = __uint_as_float(
                            static_cast<unsigned>(
                                table[__float_as_uint(z) >> 16])
                            << 16);
                    } else {
                        f[j] = activate<BF16, ACT>(z);
                    }
                }
                P::store(out, rk * C + t.col * N, f);
            }
        }
    }
}

// Pass 3: per-block partial sums of gz = g act'(z) and of gz y.
template <bool BF16, int N, int ACT>
__global__ void __launch_bounds__(kThreads)
    bn_act_grad_stats(const void* __restrict__ g, int64_t ldg,
                      const void* __restrict__ y, int64_t rows, int C, int V,
                      int W, const float* __restrict__ stats,
                      float* __restrict__ work) {
    using P = Pack<BF16, N>;
    const Tile t = tile(V, W, kThreads);
    float s[N], q[N];
#pragma unroll
    for (int j = 0; j < N; ++j) s[j] = q[j] = 0.f;
    if (t.active) {
        float sc[N], sh[N];
        channel_row<N>(stats, kScale, C, t.col, sc);
        channel_row<N>(stats, kShift, C, t.col, sh);
        for (int64_t r = static_cast<int64_t>(blockIdx.x) * t.rpi + t.lane;
             r < rows; r += kUnroll * t.step) {
            typename P::Raw gv[kUnroll], yv[kUnroll];
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
                const int64_t rk = r + k * t.step;
                if (rk < rows) {
                    gv[k] = P::load(g, rk * ldg + t.col * N);
                    yv[k] = P::load(y, rk * C + t.col * N);
                }
            }
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
                if (r + k * t.step < rows) {
                    float fg[N], fy[N];
                    P::unpack(gv[k], fg);
                    P::unpack(yv[k], fy);
#pragma unroll
                    for (int j = 0; j < N; ++j) {
                        const float gz =
                            fg[j] * dact<ACT>(affine<BF16>(fy[j], sc[j],
                                                           sh[j]));
                        s[j] += gz;
                        q[j] += gz * fy[j];
                    }
                }
            }
        }
    }
    block_partials<N>(t, s, q, W, C, work);
}

// Saved rows of ``grads`` (float32, kGradRows x C).
constexpr int kDGamma = 0;
constexpr int kDBeta = 1;
constexpr int kA = 2;  // dmean / denom
constexpr int kB = 3;  // 2 dmean2 / denom
constexpr int kGradRows = 4;

// The per-channel work of the backward: with S = sum(gz), T = sum(gz y),
// dbeta = S, dgamma = inv (T - mean S); the statistics' terms through
// shift (dmean = -S gamma inv) and inv (dvar = -inv^3 gamma (T - mean S)
// / 2, passed by var's clamp where E[y^2] - E[y]^2 >= 0), dmean2 = dvar,
// dmean -= 2 mean dvar; both 0 without stats_gradient.
__global__ void __launch_bounds__(kFinishThreads)
    bn_act_grad_finish(const float* __restrict__ work, int nblocks, int C,
                       const float* __restrict__ gamma,
                       const float* __restrict__ stats, int stats_gradient,
                       float* __restrict__ grads) {
    int c;
    float s, q;
    if (!sum_partials(work, nblocks, C, &c, &s, &q)) return;
    const float mean = stats[kMean * C + c];
    const float inv = stats[kInv * C + c];
    const float g = gamma[c];
    const float centred = q - mean * s;
    grads[kDGamma * C + c] = inv * centred;
    grads[kDBeta * C + c] = s;
    float a = 0.f, b = 0.f;
    if (stats_gradient) {
        const float denom = stats[kDenom * C + c];
        const float dvar = stats[kDiff * C + c] >= 0.f
                               ? -0.5f * g * centred * inv * inv * inv
                               : 0.f;
        const float dmean = -s * g * inv - 2.f * mean * dvar;
        a = dmean / denom;
        b = 2.f * dvar / denom;
    }
    grads[kA * C + c] = a;
    grads[kB * C + c] = b;
}

// Pass 4: dy = round(gz scale + w (A + B y)).
template <bool BF16, int N, int ACT>
__global__ void __launch_bounds__(kThreads)
    bn_act_grad(const void* __restrict__ g, int64_t ldg,
                const void* __restrict__ y, void* __restrict__ dy,
                int64_t rows, int C, int V, int W, int64_t hw,
                const float* __restrict__ mask,
                const float* __restrict__ stats,
                const float* __restrict__ grads) {
    using P = Pack<BF16, N>;
    const Tile t = tile(V, W, kThreads);
    if (!t.active) return;
    float sc[N], sh[N], a[N], b[N];
    channel_row<N>(stats, kScale, C, t.col, sc);
    channel_row<N>(stats, kShift, C, t.col, sh);
    channel_row<N>(grads, kA, C, t.col, a);
    channel_row<N>(grads, kB, C, t.col, b);
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * t.rpi + t.lane;
         r < rows; r += kUnroll * t.step) {
        typename P::Raw gv[kUnroll], yv[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const int64_t rk = r + k * t.step;
            if (rk < rows) {
                gv[k] = P::load(g, rk * ldg + t.col * N);
                yv[k] = P::load(y, rk * C + t.col * N);
            }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const int64_t rk = r + k * t.step;
            if (rk < rows) {
                float fg[N], fy[N];
                P::unpack(gv[k], fg);
                P::unpack(yv[k], fy);
                const float w = weight(mask, rk, hw);
#pragma unroll
                for (int j = 0; j < N; ++j) {
                    const float gz =
                        fg[j] * dact<ACT>(affine<BF16>(fy[j], sc[j], sh[j]));
                    fy[j] = rnd<BF16>(gz * sc[j] + w * (a[j] + b[j] * fy[j]));
                }
                P::store(dy, rk * C + t.col * N, fy);
            }
        }
    }
}

// The tiling of one call: N values a thread, V vectors a row, W of them a
// block, and the grid.
struct Plan {
    int V;
    int W;
    dim3 grid;
};

Plan plan(int64_t rows, int C, int N, int block, int cap, int min_rows) {
    Plan p;
    p.V = C / N;
    p.W = p.V < block ? p.V : block;
    const int chunks = (p.V + p.W - 1) / p.W;
    const int64_t per_block = static_cast<int64_t>(block / p.W) * min_rows;
    int64_t x = (rows + per_block - 1) / per_block;
    const int64_t most = cap / chunks > 0 ? cap / chunks : 1;
    if (x > most) x = most;
    if (x < 1) x = 1;
    p.grid = dim3(static_cast<unsigned>(x), static_cast<unsigned>(chunks));
    return p;
}

bool aligned(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool BF16, int N, int ACT>
cudaError_t forward_pass(const void* y, void* out, int64_t rows, int C,
                         const float* stats, int max_blocks, bool table,
                         cudaStream_t stream) {
    if constexpr (BF16 && N == 8 && ACT == kMish) {
        if (table) {
            // One 1,024-thread block an SM.
            const Plan p = plan(rows, C, N, kLutThreads,
                                max_blocks / kBlocksPerSm, kUnroll);
            bn_act_fwd<true, 8, kMish, true>
                <<<p.grid, kLutThreads, kTableBytes, stream>>>(
                    y, out, rows, C, p.V, p.W, stats);
            return cudaGetLastError();
        }
    }
    const Plan p = plan(rows, C, N, kThreads, max_blocks, kUnroll);
    bn_act_fwd<BF16, N, ACT, false><<<p.grid, kThreads, 0, stream>>>(
        y, out, rows, C, p.V, p.W, stats);
    return cudaGetLastError();
}

template <bool BF16, int N>
cudaError_t forward(const void* y, void* out, int64_t rows, int C,
                    int64_t hw, int act, const float* mask, int batch,
                    const float* gamma, const float* beta,
                    const float* mean_in, const float* var_in,
                    float momentum, float complement, float* stats,
                    float* new_mean, float* new_var, float* work,
                    int max_blocks, bool table, cudaStream_t stream) {
    const Plan p = plan(rows, C, N, kThreads, max_blocks, kRowsPerThread);
    bn_act_stats<BF16, N><<<p.grid, kThreads, 0, stream>>>(
        y, rows, C, p.V, p.W, hw, mask, work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bn_act_stats_finish<<<(C + 31) / 32, kFinishThreads, 0, stream>>>(
        work, static_cast<int>(p.grid.x), C, rows, hw, mask, batch, BF16,
        gamma, beta, mean_in, var_in, momentum, complement, stats, new_mean,
        new_var);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return act == kLeaky
               ? forward_pass<BF16, N, kLeaky>(y, out, rows, C, stats,
                                               max_blocks, table, stream)
               : forward_pass<BF16, N, kMish>(y, out, rows, C, stats,
                                              max_blocks, table, stream);
}

template <bool BF16, int N, int ACT>
cudaError_t backward(const void* g, int64_t ldg, const void* y, void* dy,
                     int64_t rows, int C, int64_t hw, const float* mask,
                     const float* gamma, const float* stats,
                     int stats_gradient, float* grads, float* work,
                     int max_blocks, cudaStream_t stream) {
    const Plan p = plan(rows, C, N, kThreads, max_blocks, kRowsPerThread);
    bn_act_grad_stats<BF16, N, ACT><<<p.grid, kThreads, 0, stream>>>(
        g, ldg, y, rows, C, p.V, p.W, stats, work);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bn_act_grad_finish<<<(C + 31) / 32, kFinishThreads, 0, stream>>>(
        work, static_cast<int>(p.grid.x), C, gamma, stats, stats_gradient,
        grads);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const Plan q = plan(rows, C, N, kThreads, max_blocks, kUnroll);
    bn_act_grad<BF16, N, ACT><<<q.grid, kThreads, 0, stream>>>(
        g, ldg, y, dy, rows, C, q.V, q.W, hw, mask, stats, grads);
    return cudaGetLastError();
}

template <bool BF16, int N>
cudaError_t backward_act(const void* g, int64_t ldg, const void* y, void* dy,
                         int64_t rows, int C, int64_t hw, int act,
                         const float* mask, const float* gamma,
                         const float* stats, int stats_gradient,
                         float* grads, float* work, int max_blocks,
                         cudaStream_t stream) {
    return act == kLeaky
               ? backward<BF16, N, kLeaky>(g, ldg, y, dy, rows, C, hw, mask,
                                           gamma, stats, stats_gradient,
                                           grads, work, max_blocks, stream)
               : backward<BF16, N, kMish>(g, ldg, y, dy, rows, C, hw, mask,
                                          gamma, stats, stats_gradient,
                                          grads, work, max_blocks, stream);
}

}  // namespace

// The grid's most blocks on a card of ``sms`` SMs: the ``max_blocks`` the
// launches take, and the rows of their float32 scratch (max_blocks x 2 x C).
extern "C" int bn_act_max_blocks(int sms) { return sms * kBlocksPerSm; }

// Fills the current device's mish table on the stream, waits for it, and
// allows the table kernel its shared memory.  Once per device, before the
// first launch with table = 1, and outside any CUDA graph's capture (it
// synchronises).  Returns 0 or a cudaError_t code.
extern "C" int bn_act_init(void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err = cudaFuncSetAttribute(
        bn_act_fwd<true, 8, kMish, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    bn_act_table_fill<<<(1 << 16) / 256, 256, 0, stream>>>();
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
    return static_cast<int>(err);
}

// The forward: y, out rows x C values (channels_last; hw = H * W rows an
// image); mask: null or ``batch`` float32 sample weights; gamma, beta,
// mean_in, var_in: C float32 each; stats: 6 x C float32 written (the
// rows the backward reads), new_mean, new_var: C float32 written; work:
// max_blocks x 2 x C float32 of scratch, max_blocks from
// bn_act_max_blocks.  bf16: 1 for bfloat16, 0 for
// float32; act: 1 leaky, 2 mish; table: 1 if bn_act_init has
// run on this device.  Returns 0 or a cudaError_t code.
extern "C" int bn_act_forward(const void* y, void* out, int64_t rows, int C,
                              int64_t hw, int bf16, int act,
                              const float* mask, int batch,
                              const float* gamma, const float* beta,
                              const float* mean_in, const float* var_in,
                              float momentum, float complement, float* stats,
                              float* new_mean, float* new_var, float* work,
                              int max_blocks, int table, void* stream_ptr) {
    if (rows < 1 || C < 1 || hw < 1 || max_blocks < kBlocksPerSm ||
        (act != kLeaky && act != kMish))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int lanes = bf16 ? 8 : 4;
    const bool vec = aligned(y) && aligned(out) && C % lanes == 0;
    const bool lut = table != 0;
    if (bf16) {
        return static_cast<int>(
            vec ? forward<true, 8>(y, out, rows, C, hw, act, mask, batch,
                                   gamma, beta, mean_in, var_in, momentum,
                                   complement, stats, new_mean, new_var,
                                   work, max_blocks, lut, stream)
                : forward<true, 1>(y, out, rows, C, hw, act, mask, batch,
                                   gamma, beta, mean_in, var_in, momentum,
                                   complement, stats, new_mean, new_var,
                                   work, max_blocks, lut, stream));
    }
    return static_cast<int>(
        vec ? forward<false, 4>(y, out, rows, C, hw, act, mask, batch, gamma,
                                beta, mean_in, var_in, momentum, complement,
                                stats, new_mean, new_var, work, max_blocks,
                                lut, stream)
            : forward<false, 1>(y, out, rows, C, hw, act, mask, batch, gamma,
                                beta, mean_in, var_in, momentum, complement,
                                stats, new_mean, new_var, work, max_blocks,
                                lut, stream));
}

// The backward: g rows x C values with rows ldg values apart (channels
// contiguous), y and dy rows x C (channels_last); stats: the forward's;
// grads: 4 x C float32 written (dgamma, dbeta, then the statistics'
// terms); the rest as bn_act_forward takes them.  stats_gradient: 0 when
// the batch statistics are constants of the backward.  Returns 0 or a
// cudaError_t code.
extern "C" int bn_act_backward(const void* g, int64_t ldg, const void* y,
                               void* dy, int64_t rows, int C, int64_t hw,
                               int bf16, int act, const float* mask,
                               const float* gamma, const float* stats,
                               int stats_gradient, float* grads, float* work,
                               int max_blocks, void* stream_ptr) {
    if (rows < 1 || C < 1 || hw < 1 || ldg < C || max_blocks < kBlocksPerSm ||
        (act != kLeaky && act != kMish))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    const int lanes = bf16 ? 8 : 4;
    const bool vec = aligned(g) && aligned(y) && aligned(dy) &&
                     C % lanes == 0 && ldg % lanes == 0;
    if (bf16) {
        return static_cast<int>(
            vec ? backward_act<true, 8>(g, ldg, y, dy, rows, C, hw, act,
                                        mask, gamma, stats, stats_gradient,
                                        grads, work, max_blocks, stream)
                : backward_act<true, 1>(g, ldg, y, dy, rows, C, hw, act,
                                        mask, gamma, stats, stats_gradient,
                                        grads, work, max_blocks, stream));
    }
    return static_cast<int>(
        vec ? backward_act<false, 4>(g, ldg, y, dy, rows, C, hw, act, mask,
                                     gamma, stats, stats_gradient, grads,
                                     work, max_blocks, stream)
            : backward_act<false, 1>(g, ldg, y, dy, rows, C, hw, act, mask,
                                     gamma, stats, stats_gradient, grads,
                                     work, max_blocks, stream));
}
