// Exact 2x bilinear upsample of an NCHW tensor (bf16 or f32), for Hopper (sm_90a).
//
// No TPU kernel: the JAX package resizes with XLA's resize (jax.image.resize
// in accel_tpu/ops/upsample.py). This kernel serves the port's exact 2x
// upscales (ops/upsample.py::upsample2x): FlowNet-S's decoder, where every
// "deconv" is a 2x resize and a 3x3 conv, and its flow's 2x resizes.
//
// Function: F.interpolate(x, scale_factor=2, mode="bilinear",
// align_corners=False), in x's dtype, the arithmetic in f32. Output index o
// along an axis of n samples reads s = max(0.5 * (o + 0.5) - 0.5, 0),
// i0 = floor(s), i1 = min(i0 + 1, n - 1), l1 = s - i0, l0 = 1 - l1: taps
// 0.25 / 0.75 inside, (1, 0) at o = 0, and at o = 2n - 1 the last sample read
// twice, still weighted 0.75 and 0.25. The value is
//   l0y * (l0x * a + l1x * b) + l1y * (l0x * c + l1x * d)
// in that order, with each weighted pair formed as fma(l0, u, l1 * v)
// (lerp2): the rounding of ATen's upsample_bilinear2d on this card, which
// the kernel equals bit for bit at every shape and dtype tried.
//
// Bound: bytes. Every input byte is read once and four output bytes are
// written; nothing is reused across planes, so the kernel is a stream of
// 5 bytes per input byte at the HBM rate.
//
// Design. ATen's NCHW kernel starts one thread per output pixel and walks
// all N*C planes in sequence inside it: at (4, 1024, 8, 16) -> 16x32 that is
// 512 threads of 4,096 planes each. Here the work is cut over planes, rows
// and columns. A thread owns one plane, a strip of R input rows and V input
// columns (one 16-byte vector: 8 bf16 or 4 f32). It reads the strip's rows
// and one row each side as vectors, plus one column each side as scalars,
// forms each input row's horizontal lerp at its 2V output columns once (a
// row's lerp serves up to four output rows), and writes its 2R output rows
// of 2V values as 16-byte stores. Consecutive threads take consecutive
// column vectors of a row, so a warp's loads and stores are contiguous. A
// width that is no multiple of V, or a tensor not 16-byte aligned, takes
// scalar loads and stores with the columns clamped, for any h, w >= 1. The
// launcher picks R in 8, 4, 2, 1: the largest that still starts a full
// card's worth of threads. No shared memory, no synchronisation, no
// allocation: a launch on the caller's stream, which a CUDA graph captures.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kFill = 132LL * 2048;  // the threads an H100 holds at once

// l0 * u + l1 * v with one rounding for the first product and the sum
__device__ __forceinline__ float lerp2(float l0, float u, float l1, float v) {
    return __fmaf_rn(l0, u, __fmul_rn(l1, v));
}

template <typename T>
struct Io;

template <>
struct Io<float> {
    static constexpr int V = 4;
    __device__ static float get(const float* p) { return __ldg(p); }
    __device__ static void load(const float* p, float* v) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
    __device__ static void put(float* p, float v) { *p = v; }
    // 2V values, two 16-byte stores
    __device__ static void store(float* p, const float* v) {
        float4* q = reinterpret_cast<float4*>(p);
        q[0] = make_float4(v[0], v[1], v[2], v[3]);
        q[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
};

template <>
struct Io<__nv_bfloat16> {
    static constexpr int V = 8;
    __device__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
    __device__ static void load(const __nv_bfloat16* p, float* v) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // the lower half holds the first value
            v[2 * k] = __uint_as_float(words[k] << 16);
            v[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
        }
    }
    __device__ static void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
    __device__ static uint32_t pack(float lo, float hi) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<const uint32_t*>(&b);
    }
    __device__ static void store(__nv_bfloat16* p, const float* v) {
        uint4* q = reinterpret_cast<uint4*>(p);
        q[0] = make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                          pack(v[6], v[7]));
        q[1] = make_uint4(pack(v[8], v[9]), pack(v[10], v[11]), pack(v[12], v[13]),
                          pack(v[14], v[15]));
    }
};

// hl[k]: input row ``row``'s horizontal lerp at output column 2 * c0 + k
template <typename T, bool kVec>
__device__ __forceinline__ void row_lerp(const T* __restrict__ row, int c0, int w,
                                         float (&hl)[2 * Io<T>::V]) {
    constexpr int V = Io<T>::V;
    float v[V + 2];  // input columns c0 - 1 .. c0 + V, clamped to the row
    v[0] = Io<T>::get(row + max(c0 - 1, 0));
    if (kVec) {
        Io<T>::load(row + c0, v + 1);
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[1 + j] = Io<T>::get(row + min(c0 + j, w - 1));
    }
    v[V + 1] = Io<T>::get(row + min(c0 + V, w - 1));
#pragma unroll
    for (int j = 0; j < V; ++j) {
        // even column 2m: taps (m - 1, m) at (0.25, 0.75); (0, 1) at (1, 0) for m = 0
        hl[2 * j] = c0 + j == 0 ? lerp2(1.f, v[1], 0.f, v[2])
                                : lerp2(0.25f, v[j], 0.75f, v[j + 1]);
        // odd column 2m + 1: taps (m, min(m + 1, w - 1)) at (0.75, 0.25)
        hl[2 * j + 1] = lerp2(0.75f, v[j + 1], 0.25f, v[j + 2]);
    }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_row(T* __restrict__ dst, int c0, int w,
                                          const float (&o)[2 * Io<T>::V]) {
    constexpr int V = Io<T>::V;
    if (kVec) {
        Io<T>::store(dst + 2 * c0, o);
    } else {
#pragma unroll
        for (int k = 0; k < 2 * V; ++k) {
            if (c0 + k / 2 < w) Io<T>::put(dst + 2 * c0 + k, o[k]);
        }
    }
}

// grid: one thread per (plane, strip of R input rows, vector of V columns),
// the column vector fastest
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
upsample2x_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t total, int h, int w,
                  int chunks, int strips, int R) {
    constexpr int V = Io<T>::V;
    const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (t >= total) return;
    const int c0 = (int)(t % chunks) * V;
    const int64_t rest = t / chunks;
    const int r0 = (int)(rest % strips) * R;
    const int64_t plane = rest / strips;
    const T* src = x + plane * h * w;
    T* dst = y + plane * 4 * h * w;
    const int r1 = min(r0 + R, h);
    const int w2 = 2 * w;

    float prev[2 * V], cur[2 * V], nxt[2 * V], o[2 * V];
    row_lerp<T, kVec>(src + (int64_t)max(r0 - 1, 0) * w, c0, w, prev);
    row_lerp<T, kVec>(src + (int64_t)r0 * w, c0, w, cur);
    for (int i = r0; i < r1; ++i) {
        row_lerp<T, kVec>(src + (int64_t)min(i + 1, h - 1) * w, c0, w, nxt);
        // output row 2i: rows (i - 1, i) at (0.25, 0.75); rows (0, min(1, h - 1)) at (1, 0)
        // for i = 0
#pragma unroll
        for (int k = 0; k < 2 * V; ++k) {
            o[k] = i == 0 ? lerp2(1.f, cur[k], 0.f, nxt[k])
                          : lerp2(0.25f, prev[k], 0.75f, cur[k]);
        }
        store_row<T, kVec>(dst + (int64_t)(2 * i) * w2, c0, w, o);
        // output row 2i + 1: rows (i, min(i + 1, h - 1)) at (0.75, 0.25)
#pragma unroll
        for (int k = 0; k < 2 * V; ++k) o[k] = lerp2(0.75f, cur[k], 0.25f, nxt[k]);
        store_row<T, kVec>(dst + (int64_t)(2 * i + 1) * w2, c0, w, o);
#pragma unroll
        for (int k = 0; k < 2 * V; ++k) {
            prev[k] = cur[k];
            cur[k] = nxt[k];
        }
    }
}

template <typename T>
int launch(const void* x, void* y, int planes, int h, int w, cudaStream_t stream) {
    constexpr int V = Io<T>::V;
    const bool vec = w % V == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
    const int chunks = (w + V - 1) / V;
    int R = 8;
    while (R > 1 && (int64_t)planes * ((h + R - 1) / R) * chunks < kFill) R /= 2;
    const int strips = (h + R - 1) / R;
    const int64_t total = (int64_t)planes * strips * chunks;
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    if (vec) {
        upsample2x_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
            (const T*)x, (T*)y, total, h, w, chunks, strips, R);
    } else {
        upsample2x_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
            (const T*)x, (T*)y, total, h, w, chunks, strips, R);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// x (planes, h, w) -> y (planes, 2h, 2w), both contiguous, bf16 or f32
extern "C" int upsample2x_launch(const void* x, void* y, int planes, int h, int w, int is_bf16,
                                 cudaStream_t stream) {
    if ((int64_t)planes * h * w == 0) return 0;
    return is_bf16 ? launch<__nv_bfloat16>(x, y, planes, h, w, stream)
                   : launch<float>(x, y, planes, h, w, stream);
}
