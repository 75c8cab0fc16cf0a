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
// What bounds it on this card: nothing but latency. The score map the
// served path warps is (1,19,64,128) f32: 1.3 MB in and out, 0.4 us at the
// HBM rate, and it was written just before, so it sits in L2. A kernel
// this small takes the time of a launch plus the chain of dependent memory
// round trips of its slowest thread, so the design keeps every thread's
// chain short and puts all of the card's SMs on it at once:
//
// - One thread per output element (n, c, y, x). A block is 32 consecutive
//   x of one row (a warp each, so neighbouring threads write neighbouring
//   x) times kChannels channels; the grid is (x strips, rows, images x
//   channel chunks): 1,280 blocks of 128 threads at (1,19,64,128), one
//   wave that every SM shares. Each thread reads the flow, forms its four
//   taps and weights, does four independent gathers and one store: two
//   round trips deep, where the previous design looped over all C channels
//   in one thread (19 dependent steps of four gathers each, on 64 blocks).
// - The taps are formed once per pixel and channel rather than shared
//   through shared memory: the kChannels warps of a block read the same
//   flow values, so all but the first read hit L1, and the ~20 arithmetic
//   instructions of the taps cost less than a block barrier would. Threads
//   that take 2 or 5 channels each, sharing the taps in registers, were
//   no faster on an H100 (fewer threads, the same round trips).
// - No staging of the input rows in shared memory, though the clamp would
//   allow it (every tap of output row y lies in input rows [y-D, y+D+1]).
//   A block that makes one output row would stage 2D+2 = 18 input rows of
//   each channel at D=8, where its taps touch about two: a smooth flow
//   puts the taps of neighbouring x in the same one or two 128-byte lines
//   of a row, so they coalesce and hit L1, and L2 serves each input line
//   to the few blocks that need it. A taller block would stage fewer rows
//   per output row but leave too few blocks to fill the card.
//
// The float operations are those of the plain version (ops/warp.py), so
// the f32 results agree to rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;    // consecutive x per block row (one warp)
constexpr int kChannels = 4;  // channels per block, one warp each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kLanes * kChannels)
warp_kernel(const T* __restrict__ feat, const float* __restrict__ flow, T* __restrict__ out,
            int C, int H, int W, float D, int chunks) {
    // grid: (ceil(W / kLanes), H, N * chunks); block: (kLanes, kChannels)
    const int x = blockIdx.x * kLanes + threadIdx.x;
    const int y = blockIdx.y;
    const int n = blockIdx.z / chunks;
    const int c = (blockIdx.z - n * chunks) * kChannels + threadIdx.y;
    if (x >= W || c >= C) return;
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

    const T* src = feat + ((int64_t)n * C + c) * plane;
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int yi = y0 + (t >> 1);
        const int xi = x0 + (t & 1);
        const bool valid = yi >= 0 && yi < H && xi >= 0 && xi < W;
        v[t] = valid ? to_f32(src[(int64_t)yi * W + xi]) : 0.f;
    }
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) acc += v[t] * w[t];
    store(out + ((int64_t)n * C + c) * plane + p, acc);
}

}  // namespace

extern "C" int warp_launch(const void* feat, const float* flow, void* out, int N, int C,
                           int H, int W, float max_disp, int is_bf16, cudaStream_t stream) {
    if ((int64_t)N * C * H * W == 0) return 0;
    const int chunks = (C + kChannels - 1) / kChannels;
    const dim3 grid((W + kLanes - 1) / kLanes, H, N * chunks);
    const dim3 block(kLanes, kChannels);
    if (is_bf16) {
        warp_kernel<__nv_bfloat16><<<grid, block, 0, stream>>>(
            (const __nv_bfloat16*)feat, flow, (__nv_bfloat16*)out, C, H, W, max_disp, chunks);
    } else {
        warp_kernel<float><<<grid, block, 0, stream>>>(
            (const float*)feat, flow, (float*)out, C, H, W, max_disp, chunks);
    }
    return (int)cudaGetLastError();
}
