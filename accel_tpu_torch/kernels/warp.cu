// Flow-guided bilinear warp with a displacement bound, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accel_tpu/ops/warp_pallas.py::_warp_kernel
// (called through warp_pallas_fwd). That kernel avoids gathers, which the
// TPU's vector memory handles badly, by a masked-roll accumulation over
// every integer displacement in [-D, D+1]^2. A GPU gathers cheaply, so this
// kernel takes the four bilinear taps directly: the MXNet BilinearSampler
// shape that the roll-accumulation emulates.
//
//   out[n,c,y,x] = sum over the 4 taps of feat[n,c,y0+i,x0+j] * w_ij
//   with (fx, fy) = clamp(flow[n,:,y,x], -D, D), sy = y + fy, sx = x + fx,
//   y0 = floor(sy), x0 = floor(sx), and taps outside the image weighted 0.
//
// One thread per output pixel (n, y, x), a grid row per image row; it
// reads the flow once, forms the four taps and weights, and loops over the
// C channels accumulating in f32.
// Bound: memory. Per pixel it reads 8 bytes of flow and 4 taps per channel
// (neighbouring threads read neighbouring pixels, so the taps coalesce and
// hit L1/L2) and writes C values; arithmetic is a few FMAs per byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void warp_kernel(const T* __restrict__ feat, const float* __restrict__ flow,
                            T* __restrict__ out, int C, int H, int W, float D) {
    // grid: (ceil(W / blockDim.x), H, N)
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y;
    const int n = blockIdx.z;
    if (x >= W) return;
    const int64_t plane = (int64_t)H * W;
    const int64_t p = (int64_t)y * W + x;

    const float* fl = flow + (int64_t)n * 2 * plane;
    const float fx = fminf(fmaxf(fl[p], -D), D);
    const float fy = fminf(fmaxf(fl[plane + p], -D), D);
    // same float operations as the plain version (ops/warp.py)
    const float sy = (float)y + fy;
    const float sx = (float)x + fx;
    const float y0f = floorf(sy);
    const float x0f = floorf(sx);
    const float wy = sy - y0f;
    const float wx = sx - x0f;
    const int y0 = (int)y0f;
    const int x0 = (int)x0f;

    const float w[4] = {(1.f - wy) * (1.f - wx), (1.f - wy) * wx, wy * (1.f - wx), wy * wx};
    int64_t off[4];
    bool valid[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int yi = y0 + (t >> 1);
        const int xi = x0 + (t & 1);
        valid[t] = yi >= 0 && yi < H && xi >= 0 && xi < W;
        off[t] = valid[t] ? (int64_t)yi * W + xi : 0;
    }

    const T* src = feat + (int64_t)n * C * plane;
    T* dst = out + (int64_t)n * C * plane + p;
    for (int c = 0; c < C; ++c) {
        const T* s = src + (int64_t)c * plane;
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) acc += valid[t] ? to_f32(s[off[t]]) * w[t] : 0.f;
        store(dst + (int64_t)c * plane, acc);
    }
}

}  // namespace

extern "C" int warp_launch(const void* feat, const float* flow, void* out, int N, int C,
                           int H, int W, float max_disp, int is_bf16, cudaStream_t stream) {
    if ((int64_t)N * H * W == 0) return 0;
    const int threads = 128;
    const dim3 grid((W + threads - 1) / threads, H, N);
    if (is_bf16) {
        warp_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
            (const __nv_bfloat16*)feat, flow, (__nv_bfloat16*)out, C, H, W, max_disp);
    } else {
        warp_kernel<float><<<grid, threads, 0, stream>>>(
            (const float*)feat, flow, (float*)out, C, H, W, max_disp);
    }
    return (int)cudaGetLastError();
}
