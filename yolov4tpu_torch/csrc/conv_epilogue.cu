// The epilogue of a convolution of the folded (inference) forward, for
// sm_90a: bias add and activation in one pass,
//
//   out = act(round(y + b)),
//
// over a conv's output y (N, C, H, W) in channels_last memory, read as
// rows of C channels (N*H*W, C), and its (C,) bias b, both bfloat16 or both
// float32.  act is linear, leaky (alpha 0.1) or mish, a template parameter:
// one instantiation per activation and type.
//
// Replaces no TPU kernel: in the JAX package XLA fuses the bias and the
// activation into the conv's output by itself.  PyTorch's eager forward
// (models/network.py, _FoldedApplyOps.conv) ran them as one broadcast add
// and ten elementwise kernels for mish (clamp, exp, u*u, 2u, add, +2,
// divide, multiply, compare, where) or one for leaky, each reading and
// writing a whole bf16 tensor.  Called from
// yolov4tpu_torch/ops/epilogue.py::conv_epilogue, which builds this file
// with nvcc and loads it with ctypes.
//
// Numerics: the kernel repeats the eager chain's arithmetic in registers,
// in its order, each operation in float32 and, in the bfloat16
// instantiation, rounded to bfloat16 (round to nearest even) where the
// chain stores a bf16 tensor:
//
//   v  = rn(y + b)
//   u  = rn(expf(min(v, 20)))          (NaN passes through the min)
//   t1 = rn(u * u),  t2 = rn(2 * u),  n = rn(t1 + t2),  d = rn(n + 2)
//   q  = rn(n / d),  p = rn(v * q)
//   mish = v > 20 ? v : p;   leaky = v > 0 ? v : rn(v * 0.1f)
//
// written with the _rn intrinsics, so that nvcc contracts no multiply and
// add into an FMA, with IEEE division, and with the CUDA library's expf,
// which PyTorch's exp kernel calls too (no --use_fast_math, denormals
// kept).  So the output equals network._activate(y + _bias(b), act), the
// plain version, bit for bit.
//
// What bounds it on the H100: bytes, once mish's arithmetic is out of the
// way.  Computed, mish takes ~50 instructions a value (expf, an IEEE
// division, seven bf16 roundings) against 4 bytes moved: a bf16 pass ran
// at 40% of its bytes' bound (6.98 ms for the 70 mish epilogues of a 416^2
// b64 forward, 2.76 ms bound), the float32 one, with half the values a
// byte, at 84%.  The least time is one read of y and one write of out at
// 3.35 TB/s; the bias is a few KB.  At 416^2 b64 the 110 epilogues of a
// bf16 forward move 13.7 GB, 4.1 ms.
//
// Design: a grid-stride loop of 256-thread blocks, capped at four waves of
// 8 blocks on each SM.  Where C is a multiple of the 16-byte vector's
// values (8 bf16 or 4 float32) and the three pointers are 16-byte aligned,
// a thread moves whole vectors: a vector then never straddles two rows, so
// its first channel is its offset mod C, kept by a running sum instead of
// a division a vector.  Each thread first issues the 16-byte read-only
// loads (ld.global.nc) of four vectors, then computes and stores them
// (st.global.cs, streaming), so four loads a thread are in flight to cover
// the memory's latency.  The bias comes through the same read-only path
// (L1).  Any other C (the heads' 255 channels) or alignment takes the
// scalar loop, one value a thread a step, with the same running channel.
//
// bf16 mish on that vector route reads a table instead: a bf16 value has
// 65,536 bit patterns, so mish of each, computed once per device by
// mish_table_fill with the arithmetic above, is 128 KB.  One 1,024-thread
// block an SM copies it into shared memory (from L2 after the first
// block), then a value is its rounded sum's entry: an add, a paired
// rounding and a shared-memory load.  The same function of the same bits,
// so the same output.
//
// A second mode, for the convs of YOLOv4-P6 whose output is one half of a
// concat that a BN + mish follows (the BN folded to a per-channel s, t):
//
//   out = mish(round(round(mish(round(y + b)) * s) + t)),
//
// the chain _activate(_activate(y + b) * s + t) of the plain version
// (ops/epilogue.py::conv_epilogue_merge_reference) in the same roundings.
// Its kernels (epilogue_merge_vec, epilogue_merge_lut, epilogue_merge_scalar)
// are instantiations of their own, so the first mode's kernels carry no
// branch for it, and their names tell them apart in a device trace.  The
// eager chain ran four passes at each such conv (add, mish, multiply-add,
// mish; mish itself ten kernels); this reads y once and writes out once.
//
// The table is filled by conv_epilogue_init, which the caller runs once
// per device, outside any CUDA graph's capture: it launches the fill on
// the caller's stream and waits for it, so that later launches on any
// stream find the table written.  A launch that is not told the table is
// filled (table = 0) computes mish instead: the same bits.  The launch
// function allocates nothing, never synchronises, launches on the
// caller's stream and returns cudaGetLastError()'s code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLinear = 0;
constexpr int kLeaky = 1;
constexpr int kMish = 2;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;       // vectors a thread has in flight
constexpr int kBlocksPerSm = 8;  // 2,048 threads an SM
constexpr int kWaves = 4;
constexpr int kLutThreads = 1024;  // one block an SM beside its table

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
    if constexpr (BF16) {
        return __bfloat162float(__float2bfloat16_rn(x));
    } else {
        return x;
    }
}

// act(v) for one value v exact in the storage type, as float32.  Every
// value returned is exact in the storage type.
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
    } else if constexpr (ACT == kLeaky) {
        return v > 0.f ? v : rnd<BF16>(__fmul_rn(v, 0.1f));
    } else {
        return v;
    }
}

// act(round(y + b)) for one value, y and b given as float32 (for bf16 the
// exact widening of the stored value).
template <bool BF16, int ACT>
__device__ __forceinline__ float epilogue(float y, float b) {
    return activate<BF16, ACT>(rnd<BF16>(__fadd_rn(y, b)));
}

// bf16 mish of every bf16 value, indexed by its bits: mish_table_fill
// writes activate<true, kMish> of each, once per device.
constexpr int kTableBytes = (1 << 16) * 2;
__device__ __align__(16) unsigned short g_mish_table[1 << 16];

__global__ void mish_table_fill() {
    const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < (1u << 16)) {
        g_mish_table[i] = static_cast<unsigned short>(
            __float_as_uint(activate<true, kMish>(__uint_as_float(i << 16)))
            >> 16);
    }
}

// A 16-byte vector as its values in float32: 8 bf16 or 4 float32.
template <bool BF16>
struct Lanes;

template <>
struct Lanes<true> {
    static constexpr int kN = 8;
    __device__ __forceinline__ static void unpack(const uint4 v, float* f) {
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            f[2 * j] = __uint_as_float(w[j] << 16);
            f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
    }
    // The values are exact bf16 values, so the top 16 bits are the bf16.
    __device__ __forceinline__ static uint4 pack(const float* f) {
        unsigned w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            w[j] = (__float_as_uint(f[2 * j]) >> 16) |
                   (__float_as_uint(f[2 * j + 1]) & 0xffff0000u);
        }
        return make_uint4(w[0], w[1], w[2], w[3]);
    }
};

template <>
struct Lanes<false> {
    static constexpr int kN = 4;
    __device__ __forceinline__ static void unpack(const uint4 v, float* f) {
        f[0] = __uint_as_float(v.x);
        f[1] = __uint_as_float(v.y);
        f[2] = __uint_as_float(v.z);
        f[3] = __uint_as_float(v.w);
    }
    __device__ __forceinline__ static uint4 pack(const float* f) {
        return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                          __float_as_uint(f[2]), __float_as_uint(f[3]));
    }
};

// nvec 16-byte vectors; C a multiple of the vector's values.
template <bool BF16, int ACT>
__global__ void __launch_bounds__(kThreads)
    epilogue_vec(const uint4* __restrict__ y, const char* __restrict__ b,
                 uint4* __restrict__ out, int64_t nvec, int C) {
    using L = Lanes<BF16>;
    constexpr int kElem = BF16 ? 2 : 4;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    const int step = static_cast<int>((stride * L::kN) % C);
    int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    int c = static_cast<int>((i * L::kN) % C);
    for (; i < nvec; i += kUnroll * stride) {
        uint4 v[kUnroll];
        int ch[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            ch[k] = c;
            c += step;
            if (c >= C) c -= C;
            if (i + k * stride < nvec) v[k] = __ldg(y + i + k * stride);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            if (i + k * stride < nvec) {
                const uint4 bv = __ldg(reinterpret_cast<const uint4*>(
                    b + static_cast<int64_t>(ch[k]) * kElem));
                float f[L::kN], g[L::kN];
                L::unpack(v[k], f);
                L::unpack(bv, g);
#pragma unroll
                for (int j = 0; j < L::kN; ++j) {
                    f[j] = epilogue<BF16, ACT>(f[j], g[j]);
                }
                __stcs(out + i + k * stride, L::pack(f));
            }
        }
    }
}

// bf16 mish over nvec 16-byte vectors, C a multiple of 8: each block
// copies the table into shared memory, then a value is its rounded sum's
// entry, one shared-memory load in place of the chain's arithmetic.
__global__ void __launch_bounds__(kLutThreads, 1)
    mish_lut_vec(const uint4* __restrict__ y, const char* __restrict__ b,
                 uint4* __restrict__ out, int64_t nvec, int C) {
    extern __shared__ uint4 smem[];
    const uint4* src = reinterpret_cast<const uint4*>(g_mish_table);
    for (int k = threadIdx.x; k < kTableBytes / 16; k += kLutThreads) {
        smem[k] = src[k];
    }
    __syncthreads();
    const unsigned short* table = reinterpret_cast<const unsigned short*>(smem);
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kLutThreads;
    const int step = static_cast<int>((stride * 8) % C);
    int64_t i = static_cast<int64_t>(blockIdx.x) * kLutThreads + threadIdx.x;
    int c = static_cast<int>((i * 8) % C);
    for (; i < nvec; i += kUnroll * stride) {
        uint4 v[kUnroll];
        int ch[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            ch[k] = c;
            c += step;
            if (c >= C) c -= C;
            if (i + k * stride < nvec) v[k] = __ldg(y + i + k * stride);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            if (i + k * stride < nvec) {
                const uint4 bv = __ldg(reinterpret_cast<const uint4*>(
                    b + static_cast<int64_t>(ch[k]) * 2));
                const unsigned yw[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
                const unsigned bw[4] = {bv.x, bv.y, bv.z, bv.w};
                unsigned o[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const __nv_bfloat162 s = __floats2bfloat162_rn(
                        __fadd_rn(__uint_as_float(yw[j] << 16),
                                  __uint_as_float(bw[j] << 16)),
                        __fadd_rn(__uint_as_float(yw[j] & 0xffff0000u),
                                  __uint_as_float(bw[j] & 0xffff0000u)));
                    o[j] = static_cast<unsigned>(
                               table[__bfloat16_as_ushort(s.x)]) |
                           (static_cast<unsigned>(
                                table[__bfloat16_as_ushort(s.y)])
                            << 16);
                }
                __stcs(out + i + k * stride, make_uint4(o[0], o[1], o[2], o[3]));
            }
        }
    }
}

// mish of a bf16 value (as float32) from the table.
__device__ __forceinline__ float mish_from(const unsigned short* table,
                                           float v) {
    return __uint_as_float(
        static_cast<unsigned>(table[__float_as_uint(v) >> 16]) << 16);
}

// The second mode for one value, given as float32 (exact in the storage
// type); mish from the table when LUT (bf16 only), else computed.
template <bool BF16, bool LUT>
__device__ __forceinline__ float merge_one(float y, float b, float s, float t,
                                           const unsigned short* table) {
    static_assert(BF16 || !LUT, "the table holds bf16 values");
    const float v = rnd<BF16>(__fadd_rn(y, b));
    float m;
    if constexpr (LUT) {
        m = mish_from(table, v);
    } else {
        m = activate<BF16, kMish>(v);
    }
    const float w = rnd<BF16>(__fadd_rn(rnd<BF16>(__fmul_rn(m, s)), t));
    if constexpr (LUT) {
        return mish_from(table, w);
    } else {
        return activate<BF16, kMish>(w);
    }
}

// The second mode over nvec 16-byte vectors, C a multiple of the vector's
// values.  LUT (bf16 only): one 1,024-thread block an SM with the mish
// table in shared memory, as mish_lut_vec; else 256-thread blocks that
// compute mish.
template <bool BF16, bool LUT>
__global__ void __launch_bounds__(LUT ? kLutThreads : kThreads)
    epilogue_merge_vec(const uint4* __restrict__ y,
                       const char* __restrict__ b,
                       const char* __restrict__ s,
                       const char* __restrict__ t,
                       uint4* __restrict__ out, int64_t nvec, int C) {
    using L = Lanes<BF16>;
    constexpr int kElem = BF16 ? 2 : 4;
    constexpr int kBlock = LUT ? kLutThreads : kThreads;
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
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
    const int step = static_cast<int>((stride * L::kN) % C);
    int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
    int c = static_cast<int>((i * L::kN) % C);
    for (; i < nvec; i += kUnroll * stride) {
        uint4 v[kUnroll];
        int ch[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            ch[k] = c;
            c += step;
            if (c >= C) c -= C;
            if (i + k * stride < nvec) v[k] = __ldg(y + i + k * stride);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            if (i + k * stride < nvec) {
                const int64_t off = static_cast<int64_t>(ch[k]) * kElem;
                float f[L::kN], gb[L::kN], gs[L::kN], gt[L::kN];
                L::unpack(v[k], f);
                L::unpack(__ldg(reinterpret_cast<const uint4*>(b + off)), gb);
                L::unpack(__ldg(reinterpret_cast<const uint4*>(s + off)), gs);
                L::unpack(__ldg(reinterpret_cast<const uint4*>(t + off)), gt);
#pragma unroll
                for (int j = 0; j < L::kN; ++j) {
                    f[j] = merge_one<BF16, LUT>(f[j], gb[j], gs[j], gt[j],
                                                table);
                }
                __stcs(out + i + k * stride, L::pack(f));
            }
        }
    }
}

template <bool BF16>
__device__ __forceinline__ float load_one(const void* p, int64_t e) {
    if constexpr (BF16) {
        const unsigned short h =
            __ldg(static_cast<const unsigned short*>(p) + e);
        return __uint_as_float(static_cast<unsigned>(h) << 16);
    } else {
        return __ldg(static_cast<const float*>(p) + e);
    }
}

// n values, any C, any alignment of the element type.
template <bool BF16, int ACT>
__global__ void __launch_bounds__(kThreads)
    epilogue_scalar(const void* __restrict__ y, const void* __restrict__ b,
                    void* __restrict__ out, int64_t n, int C) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    const int step = static_cast<int>(stride % C);
    int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    int c = static_cast<int>(e % C);
    for (; e < n; e += stride) {
        const float r = epilogue<BF16, ACT>(load_one<BF16>(y, e),
                                            load_one<BF16>(b, c));
        if constexpr (BF16) {
            static_cast<unsigned short*>(out)[e] =
                static_cast<unsigned short>(__float_as_uint(r) >> 16);
        } else {
            static_cast<float*>(out)[e] = r;
        }
        c += step;
        if (c >= C) c -= C;
    }
}

// The second mode over n values, any C, any alignment; mish computed.
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    epilogue_merge_scalar(const void* __restrict__ y,
                          const void* __restrict__ b,
                          const void* __restrict__ s,
                          const void* __restrict__ t,
                          void* __restrict__ out, int64_t n, int C) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    const int step = static_cast<int>(stride % C);
    int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    int c = static_cast<int>(e % C);
    for (; e < n; e += stride) {
        const float r = merge_one<BF16, false>(load_one<BF16>(y, e),
                                        load_one<BF16>(b, c),
                                        load_one<BF16>(s, c),
                                        load_one<BF16>(t, c), nullptr);
        if constexpr (BF16) {
            static_cast<unsigned short*>(out)[e] =
                static_cast<unsigned short>(__float_as_uint(r) >> 16);
        } else {
            static_cast<float*>(out)[e] = r;
        }
        c += step;
        if (c >= C) c -= C;
    }
}

int sm_count() {
    static const int sms = [] {
        int dev = 0, n = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
                cudaSuccess || n < 1)
            n = 132;
        return n;
    }();
    return sms;
}

int grid_for(int64_t units, int threads, int per_thread, int cap) {
    const int64_t per_block = static_cast<int64_t>(threads) * per_thread;
    const int64_t need = (units + per_block - 1) / per_block;
    return need < cap ? static_cast<int>(need) : cap;
}

template <bool BF16, int ACT>
cudaError_t launch(const void* y, const void* b, void* out, int64_t n, int C,
                   bool vec, bool table, cudaStream_t stream) {
    const int cap = sm_count() * kBlocksPerSm * kWaves;
    if (vec) {
        if (BF16 && ACT == kMish && table) {
            const int64_t nvec = n / 8;
            mish_lut_vec<<<grid_for(nvec, kLutThreads, kUnroll, sm_count()),
                           kLutThreads, kTableBytes, stream>>>(
                static_cast<const uint4*>(y), static_cast<const char*>(b),
                static_cast<uint4*>(out), nvec, C);
        } else {
            const int64_t nvec = n / Lanes<BF16>::kN;
            epilogue_vec<BF16, ACT><<<grid_for(nvec, kThreads, kUnroll, cap),
                                      kThreads, 0, stream>>>(
                static_cast<const uint4*>(y), static_cast<const char*>(b),
                static_cast<uint4*>(out), nvec, C);
        }
    } else {
        epilogue_scalar<BF16, ACT><<<grid_for(n, kThreads, 1, cap), kThreads,
                                     0, stream>>>(y, b, out, n, C);
    }
    return cudaGetLastError();
}

template <bool BF16>
int launch_act(const void* y, const void* b, void* out, int64_t n, int C,
               bool vec, bool table, int act, cudaStream_t stream) {
    switch (act) {
        case kLinear:
            return static_cast<int>(
                launch<BF16, kLinear>(y, b, out, n, C, vec, table, stream));
        case kLeaky:
            return static_cast<int>(
                launch<BF16, kLeaky>(y, b, out, n, C, vec, table, stream));
        case kMish:
            return static_cast<int>(
                launch<BF16, kMish>(y, b, out, n, C, vec, table, stream));
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <bool BF16>
cudaError_t launch_merge(const void* y, const void* b, const void* s,
                         const void* t, void* out, int64_t n, int C, bool vec,
                         bool table, cudaStream_t stream) {
    const int cap = sm_count() * kBlocksPerSm * kWaves;
    if (vec) {
        const int64_t nvec = n / Lanes<BF16>::kN;
        const auto* yv = static_cast<const uint4*>(y);
        const auto* bc = static_cast<const char*>(b);
        const auto* sc = static_cast<const char*>(s);
        const auto* tc = static_cast<const char*>(t);
        auto* ov = static_cast<uint4*>(out);
        if constexpr (BF16) {
            if (table) {
                epilogue_merge_vec<true, true>
                    <<<grid_for(nvec, kLutThreads, kUnroll, sm_count()),
                       kLutThreads, kTableBytes, stream>>>(yv, bc, sc, tc,
                                                           ov, nvec, C);
                return cudaGetLastError();
            }
        }
        epilogue_merge_vec<BF16, false>
            <<<grid_for(nvec, kThreads, kUnroll, cap), kThreads, 0,
               stream>>>(yv, bc, sc, tc, ov, nvec, C);
    } else {
        epilogue_merge_scalar<BF16><<<grid_for(n, kThreads, 1, cap), kThreads,
                                      0, stream>>>(y, b, s, t, out, n, C);
    }
    return cudaGetLastError();
}

}  // namespace

// Fills the current device's mish table on the stream, waits for it, and
// allows the table kernel its shared memory.  Once per device, before the
// first launch with table = 1, and outside any CUDA graph's capture (it
// synchronises).  Returns 0 or a cudaError_t code.
extern "C" int conv_epilogue_init(void* stream_ptr) {
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    cudaError_t err = cudaFuncSetAttribute(
        mish_lut_vec, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTableBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(epilogue_merge_vec<true, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTableBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    mish_table_fill<<<(1 << 16) / 256, 256, 0, stream>>>();
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
    return static_cast<int>(err);
}

// y, out: rows x C values (channels_last memory of an NCHW tensor); b: C
// values; bf16: 1 for bfloat16, 0 for float32; act: 0 linear, 1 leaky,
// 2 mish; table: 1 if conv_epilogue_init has run on this device (bf16
// mish then reads the table).  Returns 0 or a cudaError_t code.
extern "C" int conv_epilogue_launch(const void* y, const void* b, void* out,
                                    int64_t rows, int C, int bf16, int act,
                                    int table, void* stream_ptr) {
    if (rows < 0 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n = rows * C;
    if (n == 0) return 0;
    const int lanes = bf16 ? 8 : 4;
    const bool aligned = ((reinterpret_cast<uintptr_t>(y) |
                           reinterpret_cast<uintptr_t>(b) |
                           reinterpret_cast<uintptr_t>(out)) %
                          16) == 0;
    const bool vec = aligned && C % lanes == 0;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    return bf16 ? launch_act<true>(y, b, out, n, C, vec, table != 0, act,
                                   stream)
                : launch_act<false>(y, b, out, n, C, vec, table != 0, act,
                                    stream);
}

// The second mode: y, out rows x C values (channels_last); b, s, t: C
// values each; bf16 and table as conv_epilogue_launch takes them.
// Returns 0 or a cudaError_t code.
extern "C" int conv_epilogue_merge_launch(const void* y, const void* b,
                                          const void* s, const void* t,
                                          void* out, int64_t rows, int C,
                                          int bf16, int table,
                                          void* stream_ptr) {
    if (rows < 0 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n = rows * C;
    if (n == 0) return 0;
    const int lanes = bf16 ? 8 : 4;
    const bool aligned = ((reinterpret_cast<uintptr_t>(y) |
                           reinterpret_cast<uintptr_t>(b) |
                           reinterpret_cast<uintptr_t>(s) |
                           reinterpret_cast<uintptr_t>(t) |
                           reinterpret_cast<uintptr_t>(out)) %
                          16) == 0;
    const bool vec = aligned && C % lanes == 0;
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    return static_cast<int>(
        bf16 ? launch_merge<true>(y, b, s, t, out, n, C, vec, table != 0,
                                  stream)
             : launch_merge<false>(y, b, s, t, out, n, C, vec, table != 0,
                                   stream));
}
