// Bilinear warp of wide feature maps with a fused scale epilogue, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accel_tpu/ops/warp_onehot.py::_kernel
// (called through warp_onehot_fwd), which serves DFF's 1024-channel fc6
// feature warp. That kernel builds a banded one-hot matrix per output row so
// that the TPU's matrix unit does the gather. A GPU gathers cheaply, so this
// kernel takes the four bilinear taps directly and keeps only what the TPU
// kernel computes:
//
//   fy = clamp(flow_y, -D, D), fx = flow_x (not clamped),
//   sy = y + fy, sx = x + fx, y0 = floor(sy), x0 = floor(sx),
//   w_ij = round_w(ry_i * cx_j)  with ry = (1-wy, wy), cx = (1-wx, wx),
//   out[n,c,y,x] = sum_ij round_w(feat[n,c,y0+i,x0+j]) * w_ij   (f32 sum)
//   [* (f32(scale[n,c,y,x]) * gain[n])]
//
// round_w rounds to the weights dtype (bf16 round-to-nearest-even, or f32
// unchanged): each tap weight is formed in f32 and rounded once, and the
// feature value is rounded to the same dtype, as the TPU kernel casts the
// matmul's right-hand side. Taps outside the image read 0 (the TPU kernel's
// halo and lane padding).
//
// One thread per output pixel (n, y, x) computes the four weights once and
// loops over a group of kChannelGroup channels; a grid axis over channel
// groups fills the SMs at C=1024 (N*H*W = 32 k pixels on the DFF shape).
// Bound: memory. Per channel a pixel reads 4 taps (neighbouring threads read
// neighbouring pixels, so the taps coalesce and hit L1/L2), the scale value,
// and writes one value; the arithmetic is a few FMAs per value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // output pixels per block, along x
constexpr int kChannelGroup = 64;   // channels per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <bool kBf16Weights>
__device__ __forceinline__ float round_w(float v) {
    if constexpr (kBf16Weights) {
        return __bfloat162float(__float2bfloat16_rn(v));
    } else {
        return v;
    }
}

template <typename T, bool kBf16Weights>
__global__ void __launch_bounds__(kThreads) warp_onehot_kernel(
        const T* __restrict__ feat, const float* __restrict__ flow,
        const void* __restrict__ scale, int scale_bf16, const float* __restrict__ gain,
        T* __restrict__ out, int C, int H, int W, float D) {
    // grid: (ceil(W / kThreads), H, N * ceil(C / kChannelGroup))
    const int x = blockIdx.x * kThreads + threadIdx.x;
    const int y = blockIdx.y;
    const int groups = (C + kChannelGroup - 1) / kChannelGroup;
    const int n = blockIdx.z / groups;
    const int c0 = (blockIdx.z % groups) * kChannelGroup;
    const int c1 = min(C, c0 + kChannelGroup);
    if (x >= W) return;
    const int64_t plane = (int64_t)H * W;
    const int64_t p = (int64_t)y * W + x;

    const float* fl = flow + (int64_t)n * 2 * plane;
    const float fx = fl[p];
    const float fy = fminf(fmaxf(fl[plane + p], -D), D);
    const float sy = (float)y + fy;
    const float sx = (float)x + fx;
    const float y0f = floorf(sy);
    const float x0f = floorf(sx);
    const float wy = sy - y0f;
    const float wx = sx - x0f;
    const float ry[2] = {1.f - wy, wy};
    const float cx[2] = {1.f - wx, wx};

    float w[4];
    int64_t off[4];
    bool valid[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        // the product in f32 (no FMA contraction), then one rounding
        w[t] = round_w<kBf16Weights>(__fmul_rn(ry[t >> 1], cx[t & 1]));
        // bounds in float: flow_x is unbounded, so x0 may not fit an int
        const float yi = y0f + (float)(t >> 1);
        const float xi = x0f + (float)(t & 1);
        valid[t] = yi >= 0.f && yi <= (float)(H - 1) && xi >= 0.f && xi <= (float)(W - 1);
        off[t] = valid[t] ? (int64_t)yi * W + (int64_t)xi : 0;
    }

    const int64_t base = (int64_t)n * C * plane;
    for (int c = c0; c < c1; ++c) {
        const T* s = feat + base + (int64_t)c * plane;
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (valid[t]) acc += round_w<kBf16Weights>(to_f32(s[off[t]])) * w[t];
        }
        const int64_t o = base + (int64_t)c * plane + p;
        if (scale != nullptr) {
            float sv = scale_bf16 ? __bfloat162float(((const __nv_bfloat16*)scale)[o])
                                  : ((const float*)scale)[o];
            if (gain != nullptr) sv *= gain[n];
            acc *= sv;
        }
        store(out + o, acc);
    }
}

template <typename T, bool kBf16Weights>
void launch(const void* feat, const float* flow, const void* scale, int scale_bf16,
            const float* gain, void* out, int C, int H, int W, float D, dim3 grid,
            cudaStream_t stream) {
    warp_onehot_kernel<T, kBf16Weights><<<grid, kThreads, 0, stream>>>(
        (const T*)feat, flow, scale, scale_bf16, gain, (T*)out, C, H, W, D);
}

}  // namespace

// feat (N,C,H,W) f32 or bf16, flow (N,2,H,W) f32 (dx, dy), scale (N,C,H,W)
// f32 or bf16 or null, gain (N,) f32 or null, out like feat.
extern "C" int warp_onehot_launch(const void* feat, const float* flow, const void* scale,
                                  const float* gain, void* out, int N, int C, int H, int W,
                                  float max_disp, int feat_bf16, int scale_bf16,
                                  int weights_bf16, cudaStream_t stream) {
    if ((int64_t)N * C * H * W == 0) return 0;
    const int groups = (C + kChannelGroup - 1) / kChannelGroup;
    const dim3 grid((W + kThreads - 1) / kThreads, H, N * groups);
    if (feat_bf16) {
        if (weights_bf16) {
            launch<__nv_bfloat16, true>(feat, flow, scale, scale_bf16, gain, out, C, H, W,
                                        max_disp, grid, stream);
        } else {
            launch<__nv_bfloat16, false>(feat, flow, scale, scale_bf16, gain, out, C, H, W,
                                         max_disp, grid, stream);
        }
    } else {
        if (weights_bf16) {
            launch<float, true>(feat, flow, scale, scale_bf16, gain, out, C, H, W, max_disp,
                                grid, stream);
        } else {
            launch<float, false>(feat, flow, scale, scale_bf16, gain, out, C, H, W, max_disp,
                                 grid, stream);
        }
    }
    return (int)cudaGetLastError();
}
