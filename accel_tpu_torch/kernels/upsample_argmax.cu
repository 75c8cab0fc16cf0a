// Fused bilinear upsample + channel argmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accel_tpu/ops/upsample_argmax.py::_kernel
// (called through upsample_argmax). That kernel computes argmax_c(A x_c B^T)
// with the interpolation matrices A, B on the TPU's matrix unit, and needs
// H to be a multiple of its row block. Here the same separable product is
// formed from two taps per axis, so any output size works.
//
// Taps follow the half-pixel rule of jax.image.resize('linear') and
// F.interpolate(bilinear, align_corners=False) for an upscale:
//   s = (o + 0.5) * in / out - 0.5, clamped to [0, in-1];
//   i0 = floor(s), i1 = min(i0 + 1, in-1), weight of i1 = s - i0.
// (A downscale antialiases, needs more taps, and is refused by the wrapper.)
//
// What bounds it on this card: instructions. The output is one byte per
// pixel and the (C, h, w) source stays in L2, so bytes bound it at a few
// microseconds. The work is, per class and output pixel, a vertical lerp
// (FMUL + FFMA) and the running argmax's compare and two selects (FSETP,
// FSEL, SEL; the last three share the half-width integer/compare pipe):
// 0.8 G class-pixels for 20 frames at 1024x2048. The previous design
// formed each pixel's value from scratch (four gathers and three lerps per
// class and pixel, with their address arithmetic), ~3x the instructions.
// Diagnostic builds on an H100 (one pass left out at a time) put most of
// the time in the column pass, and half as much in the row pass until its
// loads walked pointers; what is left is the compare chain.
//
// The design shares the row pass. A thread owns one output column X and
// walks a run of kRows = 32 consecutive output rows (fewer where a small
// map would leave the card idle):
// - Row pass: for the two input rows (i0, i1) that the current output row
//   names, r_k[c] = l0x * x_c[i_k][x0] + l1x * x_c[i_k][x1], for all C
//   classes, kept in registers. It is formed again only when (i0, i1)
//   changes: at a band boundary (every 16 output rows at x16), where the
//   old i1 becomes the new i0 and only one row is loaded, and at the
//   clamped top and bottom edges.
// - Column pass per output pixel: v_c = l0y * r_0[c] + l1y * r_1[c], then a
//   running strict '>' over the classes, so the first maximal class wins as
//   in argmax: five instructions per class and pixel, no loads. The
//   vertical taps of the block's rows are formed once, in shared memory.
// The float order is the previous kernel's and ATen's upsample_bilinear2d
// (horizontal lerps, then the vertical lerp), so the map agrees with the
// plain version up to FMA contraction. The classes are held in registers,
// in arrays of the smallest CM = 4, 8, ..., 32 that holds C (padding
// classes are -inf and never win; arrays of exactly 19 were no faster than
// 20 on an H100). Above 32 classes the thread walks them in chunks of 32
// and forms the row pass anew for every chunk and row: correct, and slower.
//
// Tried on an H100 and dropped: two or four rows of a band per step (more
// independent compare chains, but the extra registers halved the blocks
// an SM holds: slower), a tree of compares instead of the chain, and
// inline PTX that keeps one predicate per compare (both slower than the
// code the compiler makes of the plain loop), and runs of 16 or 64 rows at
// the served shapes.
//
// Stores: one uint8 per thread and row, 32 consecutive bytes per warp (no
// wider stores). The full-res C-channel logits never exist. A grid of
// (128-column strips, kRows-row runs, frames) gives 2,560 blocks of 128
// threads at (5,19,64,128) -> 1024x2048.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;  // output columns per block, one per thread
constexpr int kRows = 32;   // output rows per thread, at most
constexpr int kMinBlocks = 4 * 132;  // a few blocks per SM of an H100

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

// r[j] = horizontal lerp of input row i of class c0 + j (-inf past C)
template <int CM>
__device__ __forceinline__ void row_pass(float (&r)[CM], const float* __restrict__ src,
                                         int64_t plane, int c0, int C, int i, int w,
                                         const Taps& tx) {
    // walk the class planes with two pointers: an add per class and tap,
    // where indexing each plane from the base cost six integer operations
    const float* p0 = src + (int64_t)c0 * plane + (int64_t)i * w + tx.i0;
    const float* p1 = p0 + (tx.i1 - tx.i0);
#pragma unroll
    for (int j = 0; j < CM; ++j) {
        r[j] = c0 + j < C ? tx.l0 * *p0 + tx.l1 * *p1 : -INFINITY;
        p0 += plane;
        p1 += plane;
    }
}

// the vertical lerp of classes c0 + j (r0, r1: the two rows' row pass) and
// the running argmax over them
template <int CM>
__device__ __forceinline__ void column_pass(const float (&r0)[CM], const float (&r1)[CM],
                                            const Taps& ty, int c0, float& best, int& arg) {
    int a = -1;
#pragma unroll
    for (int j = 0; j < CM; ++j) {
        const float v = ty.l0 * r0[j] + ty.l1 * r1[j];
        if (v > best) {
            best = v;
            a = j;
        }
    }
    if (a >= 0) arg = c0 + a;
}

template <int CM>
__global__ void __launch_bounds__(kCols)
upsample_argmax_kernel(const float* __restrict__ logits, uint8_t* __restrict__ out,
                       int C, int h, int w, int H, int W, int run) {
    // grid: (ceil(W / kCols), ceil(H / run), N); run <= kRows
    __shared__ Taps rows_taps[kRows];  // the vertical taps of the block's rows
    const int Y0 = blockIdx.y * run;
    const int Y1 = min(Y0 + run, H);
    if (threadIdx.x < run && Y0 + (int)threadIdx.x < H) {
        rows_taps[threadIdx.x] = taps(Y0 + threadIdx.x, h, (float)h / (float)H);
    }
    __syncthreads();
    const int X = blockIdx.x * kCols + threadIdx.x;
    if (X >= W) return;
    const int n = blockIdx.z;
    const Taps tx = taps(X, w, (float)w / (float)W);
    const int64_t plane = (int64_t)h * w;
    const float* src = logits + (int64_t)n * C * plane;
    uint8_t* dst = out + (int64_t)n * H * W + X;
    const bool chunked = C > CM;

    float r0[CM], r1[CM];
    int band0 = -1, band1 = -1;  // the input rows r0 and r1 hold
    for (int Y = Y0; Y < Y1; ++Y) {
        const Taps ty = rows_taps[Y - Y0];
        float best = -INFINITY;
        int arg = 0;
        for (int c0 = 0; c0 < C; c0 += CM) {
            if (chunked || ty.i0 != band0 || ty.i1 != band1) {
                if (!chunked && ty.i0 == band1) {
#pragma unroll
                    for (int j = 0; j < CM; ++j) r0[j] = r1[j];
                } else {
                    row_pass(r0, src, plane, c0, C, ty.i0, w, tx);
                }
                row_pass(r1, src, plane, c0, C, ty.i1, w, tx);
                band0 = ty.i0;
                band1 = ty.i1;
            }
            column_pass(r0, r1, ty, c0, best, arg);
        }
        dst[(int64_t)Y * W] = (uint8_t)arg;
    }
}

template <int CM>
void launch(const float* logits, uint8_t* out, int N, int C, int h, int w, int H, int W,
            cudaStream_t stream) {
    // kRows rows per thread, or fewer where that leaves the card idle (a
    // small map), down to one
    const int strips = (W + kCols - 1) / kCols;
    int run = kRows;
    while (run > 1 && (int64_t)strips * ((H + run - 1) / run) * N < kMinBlocks) run /= 2;
    const dim3 grid(strips, (H + run - 1) / run, N);
    upsample_argmax_kernel<CM><<<grid, kCols, 0, stream>>>(logits, out, C, h, w, H, W, run);
}

}  // namespace

extern "C" int upsample_argmax_launch(const float* logits, uint8_t* out, int N, int C, int h,
                                      int w, int H, int W, cudaStream_t stream) {
    if ((int64_t)N * H * W == 0) return 0;
    // the smallest register template that holds all C classes
    switch (((C < 32 ? C : 32) + 3) / 4) {
        case 1: launch<4>(logits, out, N, C, h, w, H, W, stream); break;
        case 2: launch<8>(logits, out, N, C, h, w, H, W, stream); break;
        case 3: launch<12>(logits, out, N, C, h, w, H, W, stream); break;
        case 4: launch<16>(logits, out, N, C, h, w, H, W, stream); break;
        case 5: launch<20>(logits, out, N, C, h, w, H, W, stream); break;
        case 6: launch<24>(logits, out, N, C, h, w, H, W, stream); break;
        case 7: launch<28>(logits, out, N, C, h, w, H, W, stream); break;
        default: launch<32>(logits, out, N, C, h, w, H, W, stream); break;
    }
    return (int)cudaGetLastError();
}
