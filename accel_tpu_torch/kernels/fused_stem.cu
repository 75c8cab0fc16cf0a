// Fused ResNet stem: conv 7x7 / stride 2 / pad 3 over 3 input channels,
// the folded FrozenBN affine and relu, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accel_tpu/ops/fused_stem.py::_kernel
// (called through fused_stem_fwd). The TPU kernel re-lays the image
// pixel-pair-major so the 3-channel input fills the 128-wide lanes, and
// runs the conv as one (64, 224) @ (224, W/2) bf16 matmul per stem row on
// the matrix unit, f32 accumulation; it needs W/2 to be 128-aligned. None
// of that layout is needed here.
//
//   out[n,co,oy,ox] = relu(inv[co] * sum_{c,ky,kx} w[co,c,ky,kx]
//                              * x[n,c,2oy-3+ky,2ox-3+kx] + shift[co])
//
// bf16 (the serving path): an implicit GEMM on the tensor cores, wgmma
// m64n64k16 with A from registers and f32 accumulators. M = output
// pixels, N = 64, K = (c, ky, kx') with kx' = kx + 1 (kx' = 0 a zero tap),
// 168 taps padded to 176: ops/fused_stem.py::pack_stem_weight makes that
// (176 x 64) operand.
// - Persistent blocks (two per SM, two warpgroups each) walk tiles of 2
//   output rows x 128 output pixels; the 22 KB weight operand is staged in
//   shared memory once per block, as eleven (64 x 16) K-major tiles with
//   the 32-byte swizzle that wgmma reads through a descriptor (so B is read
//   once per warpgroup and k16 step, not once per warp as mma.sync would).
// - A tile's input, 3 channels x 9 rows x 272 columns starting at
//   ix = 2*ox0 - 8 (zeros outside the image), is staged with 16-byte
//   cp.async copies, double-buffered so the next tile's copy overlaps this
//   tile's products. One block barrier per tile; after it each warpgroup
//   runs on its own (products, epilogue, stores of its row), waiting only
//   for its own warps before the stores. The im2col A fragments are read from those rows
//   directly into registers: with the kx' numbering, the tap pair
//   (kx', kx'+1) of an output pixel is one aligned 32-bit word of a staged
//   row, and one k16 step covers two (c, ky) rows. Two steps' fragments
//   are kept, so a step's loads overlap the previous step's wgmma.
// - Warpgroup r computes output row r: its 128 pixels as two m64 halves x
//   64 channels over the 11 k16 steps. The epilogue applies inv/shift and
//   relu, rounds to bf16 into a channel-major tile in shared memory, and
//   each channel row goes out as 16-byte stores along x.
// Bound: the output. At (4,3,1024,2048) it writes 268 MB of NCHW bf16 and
// reads 50 MB: ~0.095 ms at 3.35 TB/s, against ~0.04 ms of bf16 products
// at the tensor cores' peak; the store path is kept to full 16-byte,
// fully coalesced stores. W % 8 != 0 (or W/2 % 8 != 0) falls back to
// element-wise loads (stores).
//
// f32: the CUDA-core kernel: one block per (image, ROWS output rows, TX-wide
// x tile) stages the 7x7x3x64 weights (37.6 KB in f32) and the 7 input
// rows it reads; each thread computes one output pixel's 64 channels, 147
// taps x 64 FMAs, the weights read as float4 broadcasts. Bound: f32 FMA
// throughput (9408 FMAs per output pixel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int CI = 3, K = 7, CO = 64;

// ---- bf16: tensor cores ------------------------------------------------------------

constexpr int TC_TX = 128;             // output pixels along x per tile
constexpr int TC_R = 2;                // output rows per tile
constexpr int TC_THREADS = 256;        // warpgroup r: output row r; its warp w: pixels 16w + 64mb
constexpr int KP = 176;                // packed K (ops/fused_stem.py::STEM_K)
constexpr int KSTEPS = KP / 16;
constexpr int W_TILE = CO * 16 * 2;    // bytes of one k16 step's (64 x 16) B tile
constexpr int IN_ROWS = 2 * TC_R + 5;  // input rows per channel of a tile
constexpr int IN_W = 2 * TC_TX + 16;   // staged columns: ix = 2*ox0 - 8 + j
constexpr int IN_CHUNKS = IN_W / 8;    // 16-byte chunks per staged row
constexpr int IN_ELEMS = CI * IN_ROWS * IN_W;
constexpr int LDO = TC_TX + 8;         // s_out[r][co][LDO]
constexpr int TC_SMEM =
    1024 + KSTEPS * W_TILE + 2 * CO * 4 + (2 * IN_ELEMS + TC_R * CO * LDO) * 2;
static_assert(KP >= 8 * CI * K && KP % 16 == 0, "K covers (c, ky, kx') in k16 steps");

// Stage tile (n, oy0, ox0)'s input rows: buf[c][rr][j] =
// x[n, c, 2*oy0 - 3 + rr, 2*ox0 - 8 + j], zero outside the image.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* buf, const __nv_bfloat16* __restrict__ x,
                                           int n, int oy0, int ox0, int H, int W, bool vec) {
    const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 8;
    const __nv_bfloat16* xn = x + (int64_t)n * CI * H * W;
    if (vec) {  // W % 8 == 0: a 16-byte chunk lies wholly inside or outside the image
        for (int e = threadIdx.x; e < CI * IN_ROWS * IN_CHUNKS; e += TC_THREADS) {
            const int row = e / IN_CHUNKS, chunk = e % IN_CHUNKS;
            const int iy = iy0 + row % IN_ROWS, ix = ix0 + 8 * chunk;
            const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
            const __nv_bfloat16* src = in ? xn + ((int64_t)(row / IN_ROWS) * H + iy) * W + ix : xn;
            cp_async16(smem_addr(buf + row * IN_W + 8 * chunk), src, in ? 16 : 0);
        }
    } else {
        for (int e = threadIdx.x; e < IN_ELEMS; e += TC_THREADS) {
            const int row = e / IN_W;
            const int iy = iy0 + row % IN_ROWS, ix = ix0 + e % IN_W;
            buf[e] = (iy >= 0 && iy < H && ix >= 0 && ix < W)
                         ? xn[((int64_t)(row / IN_ROWS) * H + iy) * W + ix]
                         : __float2bfloat16_rn(0.f);
        }
    }
}

// wk: (KP, CO) bf16 from pack_stem_weight
__global__ void __launch_bounds__(TC_THREADS, 2)
fused_stem_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wk,
                const float* __restrict__ inv, const float* __restrict__ shift,
                __nv_bfloat16* __restrict__ out, int N, int H, int W, int Ho, int Wo) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* s_w = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    float* s_inv = reinterpret_cast<float*>(s_w + KSTEPS * W_TILE);
    float* s_shift = s_inv + CO;
    __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(s_shift + CO);  // 2 x IN_ELEMS
    __nv_bfloat16* s_out = s_in + 2 * IN_ELEMS;                            // [TC_R][CO][LDO]

    // B: per k16 step kb a (64 x 16) K-major tile with the 32-byte swizzle,
    // element (k, co) at kb*W_TILE + 32co + 16((k%16 / 8) ^ (co/4 % 2)) + 2(k%8)
    for (int i = threadIdx.x; i < KP * CO; i += TC_THREADS) {
        const int k = i / CO, co = i % CO, kk = k % 16;
        *reinterpret_cast<__nv_bfloat16*>(s_w + k / 16 * W_TILE + co * 32 +
                                          16 * ((kk / 8) ^ (co / 4 % 2)) + 2 * (kk % 8)) = wk[i];
    }
    if (threadIdx.x < CO) {
        s_inv[threadIdx.x] = inv[threadIdx.x];
        s_shift[threadIdx.x] = shift[threadIdx.x];
    }
    fence_proxy_async();  // the tensor cores read s_w through the async proxy

    const int tiles_x = (Wo + TC_TX - 1) / TC_TX, tiles_y = (Ho + TC_R - 1) / TC_R;
    const int total = N * tiles_y * tiles_x;
    const bool vec_in = W % 8 == 0, vec_out = Wo % 8 == 0;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int r = warp / 4, wq = warp % 4;  // the warpgroup's output row, the warp in it
    const int g = lane / 4, q = lane % 4;   // fragment row group and column pair

    // tile i of this block is t = blockIdx.x + i * gridDim.x, staged in buffer i % 2
    auto stage = [&](int i) {
        const int tt = blockIdx.x + i * gridDim.x;
        if (tt < total)
            stage_tile(s_in + i % 2 * IN_ELEMS, x, tt / (tiles_y * tiles_x),
                       tt / tiles_x % tiles_y * TC_R, tt % tiles_x * TC_TX, H, W, vec_in);
        cp_async_commit();
    };
    stage(0);
    for (int it = 0, t = blockIdx.x; t < total; ++it, t += gridDim.x) {
        cp_async_wait<0>();
        // tile it is staged, and every warp is done with tile it - 1: its input
        // buffer takes tile it + 1 (copied while tile it is computed), and its
        // rows of s_out are free
        __syncthreads();
        stage(it + 1);
        const int n = t / (tiles_y * tiles_x);
        const int oy0 = t / tiles_x % tiles_y * TC_R, ox0 = t % tiles_x * TC_TX;

        // each warpgroup: its row's 128 pixels as two m64 halves (mb) x 64 channels
        const uint32_t* in32 =
            reinterpret_cast<const uint32_t*>(s_in + it % 2 * IN_ELEMS);
        float acc[2][32];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[mb][i] = 0.f;
        fence_registers(acc[0]);
        fence_registers(acc[1]);
        uint32_t a[2][2][4];  // A fragments of two k16 steps in flight
#pragma unroll
        for (int kb = 0; kb < KSTEPS; ++kb) {
            uint32_t (&ak)[2][4] = a[kb % 2];
            if (kb >= 2) wgmma_wait<1>();  // step kb-2, the last reader of ak, is done
            // k 16kb..16kb+7 is (c, ky) row 2kb, k 16kb+8.. row 2kb+1; row 21 is
            // the zero pad (zero weights: any finite staged row serves)
            const int cr0 = 2 * kb, cr1 = 2 * kb + 1 < CI * K ? 2 * kb + 1 : CI * K - 1;
            const uint32_t* row0 = in32 + ((cr0 / K) * IN_ROWS + cr0 % K + 2 * r) * (IN_W / 2);
            const uint32_t* row1 = in32 + ((cr1 / K) * IN_ROWS + cr1 % K + 2 * r) * (IN_W / 2);
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
                // pixel p = 64mb + 16wq + g reads staged columns 2p + 4 + kx', kx' = 2q, 2q+1
                const int w0 = 64 * mb + 16 * wq + g + 2 + q;
                ak[mb][0] = row0[w0];
                ak[mb][1] = row0[w0 + 8];
                ak[mb][2] = row1[w0];
                ak[mb][3] = row1[w0 + 8];
            }
            wgmma_fence();
            const uint64_t db = sw32_desc(s_w + kb * W_TILE);
            wgmma_m64n64k16_rs(acc[0], ak[0], db);
            wgmma_m64n64k16_rs(acc[1], ak[1], db);
            wgmma_commit();
        }
        wgmma_wait<0>();
        fence_registers(acc[0]);
        fence_registers(acc[1]);

        // accumulator mb: registers 4nb + {0,1,2,3} hold (pixel p, channel c),
        // (p, c+1), (p+8, c), (p+8, c+1) with p = 64mb + 16wq + g, c = 8nb + 2q
        __nv_bfloat16* o = s_out + r * CO * LDO;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
            const int c = 8 * nb + 2 * q;
            const float i0 = s_inv[c], i1 = s_inv[c + 1], h0 = s_shift[c], h1 = s_shift[c + 1];
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
                const int p = 64 * mb + 16 * wq + g;
                const float* d = &acc[mb][4 * nb];
                o[c * LDO + p] = __float2bfloat16_rn(fmaxf(d[0] * i0 + h0, 0.f));
                o[(c + 1) * LDO + p] = __float2bfloat16_rn(fmaxf(d[1] * i1 + h1, 0.f));
                o[c * LDO + p + 8] = __float2bfloat16_rn(fmaxf(d[2] * i0 + h0, 0.f));
                o[(c + 1) * LDO + p + 8] = __float2bfloat16_rn(fmaxf(d[3] * i1 + h1, 0.f));
            }
        }
        // each warpgroup stores its own row: it waits only for its own warps
        named_barrier_sync(1 + r, 128);
        const int oy = oy0 + r;
        for (int e = threadIdx.x % 128; e < CO * (TC_TX / 8); e += 128) {
            const int c = e / (TC_TX / 8), p = e % (TC_TX / 8) * 8;
            const int ox = ox0 + p;
            if (oy >= Ho || ox >= Wo) continue;
            __nv_bfloat16* dst = out + (((int64_t)n * CO + c) * Ho + oy) * Wo + ox;
            const __nv_bfloat16* src = o + c * LDO + p;
            if (vec_out) {
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            } else {
                for (int i = 0; i < 8 && ox + i < Wo; ++i) dst[i] = src[i];
            }
        }
    }
}

// ---- f32: CUDA cores ---------------------------------------------------------------

constexpr int TX = 128;  // output pixels along x per block (one per thread)
constexpr int ROWS = 4;  // output rows per block (reuses the staged weights)
constexpr int SW = 2 * TX + K - 2;  // staged input columns per row: 2*TX+5
constexpr int W_FLOATS = CI * K * K * CO;
constexpr int SMEM_BYTES = (W_FLOATS + 2 * CO + CI * K * SW) * 4;

// w: (CI, K, K, CO) f32, output channel innermost
__global__ void __launch_bounds__(TX)
fused_stem_f32(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ inv, const float* __restrict__ shift,
               float* __restrict__ out, int H, int W, int Ho, int Wo) {
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
    const float* xn = x + (int64_t)n * CI * plane_in;
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
                          ? xn[c * plane_in + (int64_t)iy * W + ix]
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
            float* o = out + (int64_t)n * CO * Ho * Wo + (int64_t)oy * Wo + ox;
#pragma unroll
            for (int co = 0; co < CO; ++co)
                o[(int64_t)co * Ho * Wo] = fmaxf(acc[co] * s_inv[co] + s_shift[co], 0.f);
        }
    }
}

}  // namespace

// bf16: w (176, 64) bf16 from pack_stem_weight; f32: w (3, 7, 7, 64) f32.
extern "C" int fused_stem_launch(const void* x, const void* w, const float* inv,
                                 const float* shift, void* out, int N, int H, int W, int Ho,
                                 int Wo, int is_bf16, cudaStream_t stream) {
    if ((int64_t)N * Ho * Wo == 0) return 0;
    if (is_bf16) {
        cudaError_t err = cudaFuncSetAttribute(
            fused_stem_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
        if (err != cudaSuccess) return (int)err;
        int dev = 0, sms = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
        if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
            return (int)err;
        const int64_t tiles = (int64_t)N * ((Ho + TC_R - 1) / TC_R) * ((Wo + TC_TX - 1) / TC_TX);
        const int blocks = (int)(tiles < 2 * sms ? tiles : 2 * sms);
        fused_stem_bf16<<<blocks, TC_THREADS, TC_SMEM, stream>>>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, inv, shift, (__nv_bfloat16*)out,
            N, H, W, Ho, Wo);
        return (int)cudaGetLastError();
    }
    cudaError_t err = cudaFuncSetAttribute(
        fused_stem_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Wo + TX - 1) / TX, (Ho + ROWS - 1) / ROWS, N);
    fused_stem_f32<<<grid, TX, SMEM_BYTES, stream>>>((const float*)x, (const float*)w, inv,
                                                     shift, (float*)out, H, W, Ho, Wo);
    return (int)cudaGetLastError();
}
