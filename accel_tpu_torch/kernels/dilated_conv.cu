// Stride-1, 'same'-padded dilated 3x3 convolution, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accel_tpu/ops/dilated_pallas.py::_kernel
// (called through pallas_conv_general_dilated), DeepLab's atrous convs:
//
//   out[n,co,y,x] = sum_{i,j,ci} w[co,ci,i,j] * x[n,ci,y+(i-1)d,x+(j-1)d]
//
// with zero padding d, f32 accumulation and the output in the operands'
// dtype (both bf16, or both f32). NCHW activations; the weights come
// pre-packed as wp[tap][ci][co] (tap = 3i + j), so a chunk of them is a
// row-major (ci x co) tile.
//
// Implicit GEMM: M = output pixels, N = output channels, K = 9 taps x Cin.
// A block owns BM output pixels (a run along x of one row) x BN output
// channels. It loops over the nine taps and over input-channel chunks of
// BK; for each it stages the (BK x BM) input tile of the tap's shifted row
// (zeros outside the image) and the (BK x BN) weight tile in shared memory,
// then multiplies them into f32 accumulators:
// - bf16: nvcuda::wmma 16x16x16 bf16 fragments with f32 accumulators, four
//   warps of 32x32 each; the result goes through shared memory so the
//   stores to out are coalesced along x;
// - f32: CUDA-core FMAs, each thread an 8-pixel x 4-channel register tile
//   (f32 operands must stay f32: TF32 would drop ten mantissa bits).
// A tap whose row lies in the padding is skipped by the whole block.
// Bound: the staging. Every operand element is loaded from L2 once per tap
// (9x re-reads of the input); fc6 at 64x128 is ~309 GFLOP per frame, so
// this simple form sits well below the tensor cores' rate. wgmma/TMA and
// an input tile reused across the taps are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;         // output pixels per block
constexpr int BN = 64;         // output channels per block
constexpr int BK = 32;         // input channels per staged chunk
constexpr int kThreads = 128;  // four warps
constexpr int LDA = BM + 8;    // padded leading dims: wmma needs multiples of 8 (16-bit)
constexpr int LDB = BN + 8;
constexpr int LDC = BM + 4;    // and multiples of 4 (f32)

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
    return __float2bfloat16_rn(0.f);
}

// As[k][p] = x[n, ci0+k, iy, px0+p+dx] and Bs[k][c] = wp[tap, ci0+k, co0+c],
// zero outside the image and past Cin / Cout. xn points at image n, wtap at
// the tap's (Cin x Cout) weight slab.
template <typename T>
__device__ __forceinline__ void stage(T (*As)[LDA], T (*Bs)[LDB], const T* __restrict__ xn,
                                      const T* __restrict__ wtap, int ci0, int co0, int Cin,
                                      int Cout, int H, int W, int iy, int px0, int dx) {
    for (int e = threadIdx.x; e < BK * BM; e += kThreads) {
        const int k = e / BM, p = e % BM;
        const int ci = ci0 + k, ix = px0 + p + dx;
        T v = zero<T>();
        if (ci < Cin && ix >= 0 && ix < W) v = xn[((int64_t)ci * H + iy) * W + ix];
        As[k][p] = v;
    }
    for (int e = threadIdx.x; e < BK * BN; e += kThreads) {
        const int k = e / BN, c = e % BN;
        const int ci = ci0 + k, co = co0 + c;
        T v = zero<T>();
        if (ci < Cin && co < Cout) v = wtap[(int64_t)ci * Cout + co];
        Bs[k][c] = v;
    }
}

struct Tile {
    int px0, y, n, co0;
};

__device__ __forceinline__ Tile tile_of_block(int Cout) {
    // grid: (ceil(W / BM), H, N * ceil(Cout / BN))
    const int nco = (Cout + BN - 1) / BN;
    return Tile{(int)blockIdx.x * BM, (int)blockIdx.y, (int)blockIdx.z / nco,
                ((int)blockIdx.z % nco) * BN};
}

__global__ void __launch_bounds__(kThreads) dilated_conv_bf16(
        const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
        __nv_bfloat16* __restrict__ out, int Cin, int Cout, int H, int W, int d) {
    __shared__ __align__(32) __nv_bfloat16 As[BK][LDA];
    __shared__ __align__(32) __nv_bfloat16 Bs[BK][LDB];
    __shared__ __align__(32) float Cs[BN][LDC];
    const Tile t = tile_of_block(Cout);
    const int warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;  // the warp's 32x32 quarter of the tile

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    const __nv_bfloat16* xn = x + (int64_t)t.n * Cin * H * W;
    for (int tap = 0; tap < 9; ++tap) {
        const int iy = t.y + (tap / 3 - 1) * d;
        if (iy < 0 || iy >= H) continue;  // the same for every thread of the block
        const int dx = (tap % 3 - 1) * d;
        const __nv_bfloat16* wtap = wp + (int64_t)tap * Cin * Cout;
        for (int ci0 = 0; ci0 < Cin; ci0 += BK) {
            stage(As, Bs, xn, wtap, ci0, t.co0, Cin, Cout, H, W, iy, t.px0, dx);
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                // A is (pixels x k) stored k-major: a col_major fragment
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[2];
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    wmma::load_matrix_sync(a[i], &As[kk][wm * 32 + i * 16], LDA);
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    wmma::load_matrix_sync(b[j], &Bs[kk][wn * 32 + j * 16], LDB);
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
            }
            __syncthreads();
        }
    }
    // Cs[c][p]: channel-major, so the stores below run along x
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(&Cs[wn * 32 + j * 16][wm * 32 + i * 16], acc[i][j], LDC,
                                    wmma::mem_col_major);
    __syncthreads();
    for (int e = threadIdx.x; e < BN * BM; e += kThreads) {
        const int c = e / BM, p = e % BM;
        const int co = t.co0 + c, px = t.px0 + p;
        if (co < Cout && px < W)
            out[(((int64_t)t.n * Cout + co) * H + t.y) * W + px] = __float2bfloat16_rn(Cs[c][p]);
    }
}

__global__ void __launch_bounds__(kThreads) dilated_conv_f32(
        const float* __restrict__ x, const float* __restrict__ wp, float* __restrict__ out,
        int Cin, int Cout, int H, int W, int d) {
    __shared__ float As[BK][LDA];
    __shared__ float Bs[BK][LDB];
    const Tile t = tile_of_block(Cout);
    // 8 x 16 threads; thread (tm, tn) owns pixels tm + 8r and channels tn + 16s
    const int tm = threadIdx.x % 8, tn = threadIdx.x / 8;
    float acc[8][4] = {};

    const float* xn = x + (int64_t)t.n * Cin * H * W;
    for (int tap = 0; tap < 9; ++tap) {
        const int iy = t.y + (tap / 3 - 1) * d;
        if (iy < 0 || iy >= H) continue;
        const int dx = (tap % 3 - 1) * d;
        const float* wtap = wp + (int64_t)tap * Cin * Cout;
        for (int ci0 = 0; ci0 < Cin; ci0 += BK) {
            stage(As, Bs, xn, wtap, ci0, t.co0, Cin, Cout, H, W, iy, t.px0, dx);
            __syncthreads();
#pragma unroll 4
            for (int k = 0; k < BK; ++k) {
                float a[8], b[4];
#pragma unroll
                for (int r = 0; r < 8; ++r) a[r] = As[k][tm + 8 * r];
#pragma unroll
                for (int s = 0; s < 4; ++s) b[s] = Bs[k][tn + 16 * s];
#pragma unroll
                for (int r = 0; r < 8; ++r)
#pragma unroll
                    for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
            }
            __syncthreads();
        }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        const int co = t.co0 + tn + 16 * s;
        if (co >= Cout) continue;
        float* row = out + (((int64_t)t.n * Cout + co) * H + t.y) * W;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int px = t.px0 + tm + 8 * r;
            if (px < W) row[px] = acc[r][s];
        }
    }
}

}  // namespace

// x (N,Cin,H,W), wp (9,Cin,Cout), out (N,Cout,H,W), all f32 or all bf16.
extern "C" int dilated_conv_launch(const void* x, const void* wp, void* out, int N, int Cin,
                                   int Cout, int H, int W, int d, int is_bf16,
                                   cudaStream_t stream) {
    if ((int64_t)N * Cout * H * W == 0) return 0;
    const dim3 grid((W + BM - 1) / BM, H, N * ((Cout + BN - 1) / BN));
    if (is_bf16) {
        dilated_conv_bf16<<<grid, kThreads, 0, stream>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)wp, (__nv_bfloat16*)out, Cin, Cout,
            H, W, d);
    } else {
        dilated_conv_f32<<<grid, kThreads, 0, stream>>>((const float*)x, (const float*)wp,
                                                        (float*)out, Cin, Cout, H, W, d);
    }
    return (int)cudaGetLastError();
}
