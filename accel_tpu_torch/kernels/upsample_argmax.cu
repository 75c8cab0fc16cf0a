// Fused bilinear upsample + channel argmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accel_tpu/ops/upsample_argmax.py::_kernel
// (called through upsample_argmax). That kernel computes argmax_c(A x_c B^T)
// with the interpolation matrices A, B on the TPU's matrix unit, and needs
// H and W to be multiples of 128. Here each output pixel takes its two
// taps per axis directly, so any output size works.
//
// Taps follow the half-pixel rule of jax.image.resize('linear') and
// F.interpolate(bilinear, align_corners=False) for an upscale:
//   s = (o + 0.5) * in / out - 0.5, clamped to [0, in-1];
//   i0 = floor(s), i1 = min(i0 + 1, in-1), weight of i1 = s - i0.
// (A downscale antialiases, needs more taps, and is refused by the wrapper.)
//
// One thread per output pixel (n, Y, X), a grid row per output row: it
// loops over the C classes, forms the bilinear value in f32 and keeps a
// running strict '>' maximum, so the first maximal class wins as in argmax;
// it writes one uint8. The full-res
// C-channel logits never exist. Bound: memory, by the H*W bytes written;
// the (C, h, w) source plane is small and stays in L1/L2.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Taps {
    int i0, i1;
    float l0, l1;
};

__device__ __forceinline__ Taps taps(int o, int n_in, float scale) {
    float s = scale * ((float)o + 0.5f) - 0.5f;
    s = fminf(fmaxf(s, 0.f), (float)(n_in - 1));
    Taps t;
    t.i0 = (int)s;  // s >= 0, so truncation is floor
    t.i1 = min(t.i0 + 1, n_in - 1);
    t.l1 = s - (float)t.i0;
    t.l0 = 1.f - t.l1;
    return t;
}

__global__ void upsample_argmax_kernel(const float* __restrict__ logits, uint8_t* __restrict__ out,
                                       int C, int h, int w, int H, int W) {
    // grid: (ceil(W / blockDim.x), H, N)
    const int X = blockIdx.x * blockDim.x + threadIdx.x;
    const int Y = blockIdx.y;
    const int n = blockIdx.z;
    if (X >= W) return;

    const Taps ty = taps(Y, h, (float)h / (float)H);
    const Taps tx = taps(X, w, (float)w / (float)W);
    const int64_t o00 = (int64_t)ty.i0 * w + tx.i0, o01 = (int64_t)ty.i0 * w + tx.i1;
    const int64_t o10 = (int64_t)ty.i1 * w + tx.i0, o11 = (int64_t)ty.i1 * w + tx.i1;

    const int64_t plane_in = (int64_t)h * w;
    const float* src = logits + (int64_t)n * C * plane_in;
    float best = -INFINITY;
    int arg = 0;
    for (int c = 0; c < C; ++c) {
        const float* s = src + (int64_t)c * plane_in;
        const float v = ty.l0 * (tx.l0 * s[o00] + tx.l1 * s[o01])
                      + ty.l1 * (tx.l0 * s[o10] + tx.l1 * s[o11]);
        if (v > best) {
            best = v;
            arg = c;
        }
    }
    out[((int64_t)n * H + Y) * W + X] = (uint8_t)arg;
}

}  // namespace

extern "C" int upsample_argmax_launch(const float* logits, uint8_t* out, int N, int C, int h,
                                      int w, int H, int W, cudaStream_t stream) {
    if ((int64_t)N * H * W == 0) return 0;
    const int threads = 256;
    const dim3 grid((W + threads - 1) / threads, H, N);
    upsample_argmax_kernel<<<grid, threads, 0, stream>>>(logits, out, C, h, w, H, W);
    return (int)cudaGetLastError();
}
