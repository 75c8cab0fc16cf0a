// Stride-1, 'same'-padded dilated 3x3 convolution, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accel_tpu/ops/dilated_pallas.py::_kernel
// (called through pallas_conv_general_dilated), DeepLab's atrous convs:
//
//   out[n,co,y,x] = sum_{i,j,ci} w[co,ci,i,j] * x[n,ci,y+(i-1)d,x+(j-1)d]
//
// with zero padding d, f32 accumulation and the output in the operands'
// dtype (both bf16, or both f32), NCHW. The weights come pre-packed as
// wp[tap][co][ci] (tap = 3i + j, ops/dilated_cuda.py::pack_dilated_weight).
//
// bf16: an implicit GEMM on wgmma, fed by TMA. M = output pixels, N =
// output channels, K = 9 taps x Cin. The input arrives channels-last (NHWC,
// the wrapper's copy), so a (pixels x 64 channels) tile is the canonical
// K-major A operand with a 128-byte swizzle, and every global stride is a
// multiple of 16 bytes whenever Cin % 8 == 0.
// - A block owns a 128-pixel x 256-channel output tile: the pixels are a
//   BY x BX patch of one image (BX*BY = 128, the host picks BX in 8..128
//   to waste the fewest pixels at the image's right and bottom edges).
// - One producer thread walks (tap, 64-channel chunk) and starts two TMA
//   tile loads per step into a 4-stage shared-memory ring: the input patch
//   shifted by the tap's ((i-1)d, (j-1)d), and the tap's (256 x 64) weight
//   slab. A shifted patch that reaches past the image edge is zero-filled
//   by TMA (signed coordinates), so the padding costs no branch and no
//   padded copy. Each stage has a "full" mbarrier (TMA transaction bytes)
//   and an "empty" one (one arrival per consumer warp).
// - Two consumer warpgroups (setmaxnreg 232, the producer's drops to 40)
//   each run wgmma.m64n256k16 on their 64-pixel half of the stage, 4 per
//   stage, keeping one stage's group in flight while the next one starts.
// - Taps whose shifted patch lies wholly in the padding are skipped.
// - Epilogue: the f32 accumulators are rounded to bf16 into a channel-major
//   tile in the (then idle) stage memory, then written to NCHW as 16-byte
//   stores along x (scalar stores when W % 8 != 0).
// Halo reuse: one TMA load per tap, the re-reads of the same input rows
// served by L2 (fc6's whole input is 32 MB, under the 50 MB L2). A shared
// halo'd tile would need operand descriptors that start d pixel rows into
// a swizzled tile, but the 128-byte swizzle pattern is tied to 8-row,
// 1024-byte atoms, so only shifts that are multiples of 8 rows could be
// expressed; d is 2 or 6 on DeepLab's path.
// Bound: tensor-core FLOPs (fc6 at 64x128: 309 GFLOP nominal, ~0.31 ms at
// the 989 TFLOP/s bf16 peak; the operand bytes need ~0.03 ms at 3.35 TB/s).
//
// f32: CUDA-core FMAs, 64x64 tiles, each thread an 8-pixel x 4-channel
// register tile, operands staged through shared memory per tap and
// 32-channel chunk (f32 operands must stay f32: TF32 would drop ten
// mantissa bits). Bound: FMA throughput.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---- bf16: TMA + wgmma ----------------------------------------------------------

constexpr int BM = 128;  // output pixels per tile
constexpr int BN = 256;  // output channels per tile
constexpr int BK = 64;   // input channels per stage: one 128-byte swizzled row
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK * 2;  // 16 KB
constexpr int B_BYTES = BN * BK * 2;  // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int WG = 128;               // threads per warpgroup
constexpr int THREADS = 3 * WG;       // consumer warpgroups 0, 1; producer 2
constexpr int LDC = BM + 8;           // epilogue tile cs[BN][LDC] bf16, over the stages
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
static_assert(BN * LDC * 2 <= STAGES * STAGE_BYTES, "epilogue tile must fit the stages");

struct Geometry {
    int Cin, Cout, H, W, d;
    int bx, by;                       // the pixel patch of a tile
    int tiles_x, tiles_y, tiles_n;
};

// does the tap's shifted patch overlap the image?
__device__ __forceinline__ bool tap_live(int tap, int y0, int x0, const Geometry& g) {
    const int dy = (tap / 3 - 1) * g.d, dx = (tap % 3 - 1) * g.d;
    return y0 + dy < g.H && y0 + g.by - 1 + dy >= 0 && x0 + dx < g.W && x0 + g.bx - 1 + dx >= 0;
}

// x_map: NHWC bf16 x, dims {Cin, W, H, N}, box {64, bx, by, 1}
// w_map: wp bf16, dims {Cin, Cout, 9}, box {64, 256, 1}
__global__ void __launch_bounds__(THREADS, 1) dilated_conv_bf16(
        const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
        __nv_bfloat16* __restrict__ out, const Geometry g) {
    extern __shared__ uint8_t smem_raw[];
    // stages on 1024-byte boundaries (the 128-byte swizzle's atom)
    uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;

    const int tile_n = blockIdx.x % g.tiles_n;  // the blocks sharing a pixel patch run together
    const int tile_m = blockIdx.x / g.tiles_n;
    const int n = tile_m / (g.tiles_x * g.tiles_y);
    const int y0 = (tile_m / g.tiles_x) % g.tiles_y * g.by;
    const int x0 = tile_m % g.tiles_x * g.bx;
    const int co0 = tile_n * BN;
    const int kchunks = (g.Cin + BK - 1) / BK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / WG;
    if (wg == 2) {
        // ---- producer ----
        setmaxnreg_dec<40>();
        if (threadIdx.x == 2 * WG) {
            int s = 0;
            uint32_t phase = 0;
            for (int tap = 0; tap < 9; ++tap) {
                if (!tap_live(tap, y0, x0, g)) continue;
                const int dy = (tap / 3 - 1) * g.d, dx = (tap % 3 - 1) * g.d;
                for (int kc = 0; kc < kchunks; ++kc) {
                    mbar_wait(&empty[s], phase ^ 1);
                    uint8_t* st = smem + s * STAGE_BYTES;
                    mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
                    tma_load_4d(st, &x_map, &full[s], kc * BK, x0 + dx, y0 + dy, n);
                    tma_load_3d(st + A_BYTES, &w_map, &full[s], kc * BK, co0, tap);
                    if (++s == STAGES) {
                        s = 0;
                        phase ^= 1;
                    }
                }
            }
        }
    } else {
        // ---- consumers: warpgroup wg owns pixels 64wg .. 64wg+63 ----
        setmaxnreg_inc<232>();
        const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
        float acc[128];
#pragma unroll
        for (int i = 0; i < 128; ++i) acc[i] = 0.f;
        fence_registers(acc);
        int live = 0;
        for (int tap = 0; tap < 9; ++tap) live += tap_live(tap, y0, x0, g);
        const int steps = live * kchunks;
        int s = 0, prev = -1, step = 0;
        uint32_t phase = 0;
        for (int tap = 0; tap < 9; ++tap) {
            if (!tap_live(tap, y0, x0, g)) continue;
            for (int kc = 0; kc < kchunks; ++kc) {
                mbar_wait(&full[s], phase);
                uint8_t* st = smem + s * STAGE_BYTES;
                const uint64_t da = sw128_desc(st + wg * (A_BYTES / 2));
                const uint64_t db = sw128_desc(st + A_BYTES);
                wgmma_fence();
#pragma unroll
                for (int k = 0; k < BK / 16; ++k) wgmma_m64n256k16(acc, da + 2 * k, db + 2 * k);
                wgmma_commit();
                // the previous stage's products are done: release it. The last
                // step waits for all, inside the loop: a wait after it would let
                // the compiler copy the loop's accumulators out before the wait
                if (++step == steps) {
                    wgmma_wait<0>();
                } else {
                    wgmma_wait<1>();
                }
                if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
                prev = s;
                if (++s == STAGES) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
        fence_registers(acc);

        // every load has landed and been consumed: the stages are free
        named_barrier_sync(1, 2 * WG);
        __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem);
        // accumulator layout: register 4j+{0,1,2,3} holds (pixel r, channel c),
        // (r, c+1), (r+8, c), (r+8, c+1) with c = 8j + 2(lane % 4)
        const int r = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int c = 8 * j + 2 * (lane % 4);
            cs[c * LDC + r] = __float2bfloat16_rn(acc[4 * j]);
            cs[(c + 1) * LDC + r] = __float2bfloat16_rn(acc[4 * j + 1]);
            cs[c * LDC + r + 8] = __float2bfloat16_rn(acc[4 * j + 2]);
            cs[(c + 1) * LDC + r + 8] = __float2bfloat16_rn(acc[4 * j + 3]);
        }
        named_barrier_sync(1, 2 * WG);
        const bool vec = g.W % 8 == 0;
        for (int e = threadIdx.x; e < BN * (BM / 8); e += 2 * WG) {
            const int c = e / (BM / 8), p = e % (BM / 8) * 8;  // 8 pixels of one patch row
            const int co = co0 + c, y = y0 + p / g.bx, x = x0 + p % g.bx;
            if (co >= g.Cout || y >= g.H || x >= g.W) continue;
            __nv_bfloat16* dst = out + (((int64_t)n * g.Cout + co) * g.H + y) * g.W + x;
            const __nv_bfloat16* src = cs + c * LDC + p;
            if (vec) {
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
                for (int i = 0; i < 8 && x + i < g.W; ++i) dst[i] = src[i];
            }
        }
    }
}

// ---- f32: CUDA cores ----------------------------------------------------------------

constexpr int F_BM = 64;          // output pixels per block
constexpr int F_BN = 64;          // output channels per block
constexpr int F_BK = 32;          // input channels per staged chunk
constexpr int F_THREADS = 128;
constexpr int F_LDA = F_BM + 8;
constexpr int F_LDB = F_BN + 8;

// As[k][p] = x[n, ci0+k, iy, px0+p+dx] and Bs[k][c] = wp[tap, co0+c, ci0+k],
// zero outside the image and past Cin / Cout. xn points at image n, wtap at
// the tap's (Cout x Cin) weight slab.
__device__ __forceinline__ void stage_f32(float (*As)[F_LDA], float (*Bs)[F_LDB],
                                          const float* __restrict__ xn,
                                          const float* __restrict__ wtap, int ci0, int co0,
                                          int Cin, int Cout, int H, int W, int iy, int px0,
                                          int dx) {
    for (int e = threadIdx.x; e < F_BK * F_BM; e += F_THREADS) {
        const int k = e / F_BM, p = e % F_BM;
        const int ci = ci0 + k, ix = px0 + p + dx;
        float v = 0.f;
        if (ci < Cin && ix >= 0 && ix < W) v = xn[((int64_t)ci * H + iy) * W + ix];
        As[k][p] = v;
    }
    for (int e = threadIdx.x; e < F_BK * F_BN; e += F_THREADS) {
        const int c = e / F_BK, k = e % F_BK;  // consecutive threads read consecutive ci
        const int ci = ci0 + k, co = co0 + c;
        float v = 0.f;
        if (ci < Cin && co < Cout) v = wtap[(int64_t)co * Cin + ci];
        Bs[k][c] = v;
    }
}

__global__ void __launch_bounds__(F_THREADS) dilated_conv_f32(
        const float* __restrict__ x, const float* __restrict__ wp, float* __restrict__ out,
        int Cin, int Cout, int H, int W, int d) {
    __shared__ float As[F_BK][F_LDA];
    __shared__ float Bs[F_BK][F_LDB];
    // grid: (ceil(W / F_BM), H, N * ceil(Cout / F_BN))
    const int nco = (Cout + F_BN - 1) / F_BN;
    const int px0 = blockIdx.x * F_BM, y = blockIdx.y;
    const int n = blockIdx.z / nco, co0 = blockIdx.z % nco * F_BN;
    // 8 x 16 threads; thread (tm, tn) owns pixels tm + 8r and channels tn + 16s
    const int tm = threadIdx.x % 8, tn = threadIdx.x / 8;
    float acc[8][4] = {};

    const float* xn = x + (int64_t)n * Cin * H * W;
    for (int tap = 0; tap < 9; ++tap) {
        const int iy = y + (tap / 3 - 1) * d;
        if (iy < 0 || iy >= H) continue;  // the same for every thread of the block
        const int dx = (tap % 3 - 1) * d;
        const float* wtap = wp + (int64_t)tap * Cin * Cout;
        for (int ci0 = 0; ci0 < Cin; ci0 += F_BK) {
            stage_f32(As, Bs, xn, wtap, ci0, co0, Cin, Cout, H, W, iy, px0, dx);
            __syncthreads();
#pragma unroll 4
            for (int k = 0; k < F_BK; ++k) {
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
        const int co = co0 + tn + 16 * s;
        if (co >= Cout) continue;
        float* row = out + (((int64_t)n * Cout + co) * H + y) * W;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int px = px0 + tm + 8 * r;
            if (px < W) row[px] = acc[r][s];
        }
    }
}

// ---- host side --------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up at run time so the library needs no
// -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// the BX x BY patch (BX*BY = 128) that covers H x W with the fewest pixels
void pick_patch(int H, int W, int* bx, int* by) {
    int64_t best = -1;
    for (int b = 128; b >= 8; b /= 2) {
        const int h = BM / b;
        const int64_t cover = (int64_t)((W + b - 1) / b) * b * ((H + h - 1) / h) * h;
        if (best < 0 || cover < best) {
            best = cover;
            *bx = b;
            *by = h;
        }
    }
}

constexpr int kNoEncoder = -1;   // no cuTensorMapEncodeTiled to be found
constexpr int kBadTensorMap = -2;

int launch_bf16(const void* x, const void* wp, void* out, int N, int Cin, int Cout, int H,
                int W, int d, cudaStream_t stream) {
    if (Cin % 8 != 0) return (int)cudaErrorInvalidValue;  // TMA: 16-byte strides
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return kNoEncoder;
    Geometry g{Cin, Cout, H, W, d, 0, 0, 0, 0, 0};
    pick_patch(H, W, &g.bx, &g.by);
    g.tiles_x = (W + g.bx - 1) / g.bx;
    g.tiles_y = (H + g.by - 1) / g.by;
    g.tiles_n = (Cout + BN - 1) / BN;

    const cuuint32_t ones[4] = {1, 1, 1, 1};
    CUtensorMap x_map, w_map;
    const cuuint64_t x_dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
    const cuuint64_t x_strides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                     (cuuint64_t)H * W * Cin * 2};
    const cuuint32_t x_box[4] = {BK, (cuuint32_t)g.bx, (cuuint32_t)g.by, 1};
    if (encode(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), x_dims,
               x_strides, x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return kBadTensorMap;
    const cuuint64_t w_dims[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 9};
    const cuuint64_t w_strides[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)Cout * Cin * 2};
    const cuuint32_t w_box[3] = {BK, BN, 1};
    if (encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(wp), w_dims,
               w_strides, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return kBadTensorMap;

    const cudaError_t err = cudaFuncSetAttribute(
        dilated_conv_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (int64_t)N * g.tiles_y * g.tiles_x * g.tiles_n;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
    dilated_conv_bf16<<<(unsigned)blocks, THREADS, SMEM_BYTES, stream>>>(
        x_map, w_map, (__nv_bfloat16*)out, g);
    return (int)cudaGetLastError();
}

}  // namespace

// bf16: x (N,H,W,Cin) channels-last; f32: x (N,Cin,H,W). wp (9,Cout,Cin),
// out (N,Cout,H,W), all f32 or all bf16. Returns a cudaError_t, or
// kNoEncoder / kBadTensorMap (negative) when a TMA descriptor cannot be made.
extern "C" int dilated_conv_launch(const void* x, const void* wp, void* out, int N, int Cin,
                                   int Cout, int H, int W, int d, int is_bf16,
                                   cudaStream_t stream) {
    if ((int64_t)N * Cout * H * W == 0) return 0;
    if (is_bf16) return launch_bf16(x, wp, out, N, Cin, Cout, H, W, d, stream);
    const dim3 grid((W + F_BM - 1) / F_BM, H, N * ((Cout + F_BN - 1) / F_BN));
    dilated_conv_f32<<<grid, F_THREADS, 0, stream>>>((const float*)x, (const float*)wp,
                                                     (float*)out, Cin, Cout, H, W, d);
    return (int)cudaGetLastError();
}
