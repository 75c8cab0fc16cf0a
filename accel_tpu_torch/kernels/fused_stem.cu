// Fused ResNet stem: conv 7x7 / stride 2 / pad 3 over 3 input channels,
// the folded FrozenBN affine and relu, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accel_tpu/ops/fused_stem.py::_kernel
// (called through fused_stem_fwd). The TPU kernel re-lays the image
// pixel-pair-major so the 3-channel input fills the 128-wide lanes, and
// runs the conv as one (64, 224) @ (224, W/2) matmul per stem row; it needs
// W/2 to be 128-aligned. None of that is needed here.
//
//   out[n,co,oy,ox] = relu(inv[co] * sum_{c,ky,kx} w[co,c,ky,kx]
//                              * x[n,c,2oy-3+ky,2ox-3+kx] + shift[co])
//
// One block per (image, ROWS output rows, TX-wide x tile). The block stages
// the 7x7x3x64 weights in shared memory once (37.6 KB in f32) and, for each
// of its rows, the 7 input rows x (2*TX+5) columns x 3 channels it reads
// (zero outside the image). Each thread computes one output pixel's 64
// channels in f32 registers: 147 taps x 64 FMAs, the weights read as float4
// broadcasts (every thread of a warp reads the same address). The epilogue
// applies inv/shift and relu and writes the input dtype, NCHW.
// Bound: f32 FMA issue (9408 FMAs per output pixel against 6 input bytes
// and 128 output bytes); the weights' shared-memory reads ride beside the
// FMAs as one float4 load per 4 FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CI = 3, K = 7, CO = 64;
constexpr int TX = 128;  // output pixels along x per block (one per thread)
constexpr int ROWS = 4;  // output rows per block (reuses the staged weights)
constexpr int SW = 2 * TX + K - 2;  // staged input columns per row: 2*TX+5
constexpr int W_FLOATS = CI * K * K * CO;
constexpr int SMEM_BYTES = (W_FLOATS + 2 * CO + CI * K * SW) * 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// w: (CI, K, K, CO) f32, output channel innermost
template <typename T>
__global__ void __launch_bounds__(TX)
fused_stem_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ inv, const float* __restrict__ shift,
                  T* __restrict__ out, int H, int W, int Ho, int Wo) {
    extern __shared__ float4 smem4[];
    float* s_w = reinterpret_cast<float*>(smem4);
    float* s_inv = s_w + W_FLOATS;
    float* s_shift = s_inv + CO;
    float* s_in = s_shift + CO;  // (CI, K, SW)

    const int tx = threadIdx.x;
    const int ox0 = blockIdx.x * TX;
    const int n = blockIdx.z;
    for (int i = tx; i < W_FLOATS; i += TX) s_w[i] = w[i];
    if (tx < CO) {
        s_inv[tx] = inv[tx];
        s_shift[tx] = shift[tx];
    }

    const int64_t plane_in = (int64_t)H * W;
    const T* xn = x + (int64_t)n * CI * plane_in;
    const int ix0 = 2 * ox0 - 3;
    const int ox = ox0 + tx;
    const float4* w4 = reinterpret_cast<const float4*>(s_w);

    for (int r = 0; r < ROWS; ++r) {
        const int oy = blockIdx.y * ROWS + r;
        if (oy >= Ho) break;  // uniform across the block
        __syncthreads();      // previous row's reads of s_in are done
        const int iy0 = 2 * oy - 3;
        for (int i = tx; i < CI * K * SW; i += TX) {
            const int c = i / (K * SW);
            const int ky = (i / SW) % K;
            const int j = i % SW;
            const int iy = iy0 + ky, ix = ix0 + j;
            s_in[i] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                          ? to_f32(xn[c * plane_in + (int64_t)iy * W + ix])
                          : 0.f;
        }
        __syncthreads();

        float acc[CO];
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[co] = 0.f;
#pragma unroll 1
        for (int cky = 0; cky < CI * K; ++cky) {
            const float* row = s_in + cky * SW + 2 * tx;
            const float4* wrow = w4 + cky * K * (CO / 4);
#pragma unroll
            for (int kx = 0; kx < K; ++kx) {
                const float v = row[kx];
#pragma unroll
                for (int q = 0; q < CO / 4; ++q) {
                    const float4 wv = wrow[kx * (CO / 4) + q];
                    acc[4 * q + 0] += v * wv.x;
                    acc[4 * q + 1] += v * wv.y;
                    acc[4 * q + 2] += v * wv.z;
                    acc[4 * q + 3] += v * wv.w;
                }
            }
        }
        if (ox < Wo) {
            T* o = out + (int64_t)n * CO * Ho * Wo + (int64_t)oy * Wo + ox;
#pragma unroll
            for (int co = 0; co < CO; ++co) {
                const float y = fmaxf(acc[co] * s_inv[co] + s_shift[co], 0.f);
                store(o + (int64_t)co * Ho * Wo, y);
            }
        }
    }
}

template <typename T>
int launch(const void* x, const float* w, const float* inv, const float* shift, void* out,
           int N, int H, int W, int Ho, int Wo, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_stem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Wo + TX - 1) / TX, (Ho + ROWS - 1) / ROWS, N);
    fused_stem_kernel<T><<<grid, TX, SMEM_BYTES, stream>>>(
        (const T*)x, w, inv, shift, (T*)out, H, W, Ho, Wo);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_stem_launch(const void* x, const float* w, const float* inv,
                                 const float* shift, void* out, int N, int H, int W, int Ho,
                                 int Wo, int is_bf16, cudaStream_t stream) {
    if ((int64_t)N * Ho * Wo == 0) return 0;
    return is_bf16 ? launch<__nv_bfloat16>(x, w, inv, shift, out, N, H, W, Ho, Wo, stream)
                   : launch<float>(x, w, inv, shift, out, N, H, W, Ho, Wo, stream);
}
