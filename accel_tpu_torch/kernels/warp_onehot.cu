// Bilinear warp of wide feature maps with a fused scale epilogue, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel accel_tpu/ops/warp_onehot.py::_kernel
// (called through warp_onehot_fwd), which serves DFF's 1024-channel fc6
// feature warp. That kernel builds a banded one-hot matrix per output row so
// that the TPU's matrix unit does the gather. A GPU gathers from shared
// memory, so this kernel takes the four bilinear taps directly and keeps
// only what the TPU kernel computes:
//
//   fy = clamp(flow_y, -D, D), fx = flow_x (not clamped),
//   sy = y + fy, sx = x + fx, y0 = floor(sy), x0 = floor(sx),
//   w_ij = round_w(ry_i * cx_j)  with ry = (1-wy, wy), cx = (1-wx, wx),
//   out[n,c,y,x] = sum_ij round_w(feat[n,c,y0+i,x0+j]) * w_ij   (f32 sum,
//                  taps in the order 00, 01, 10, 11)
//   [* (f32(scale[n,c,y,x]) * gain[n])]
//
// round_w rounds to the weights dtype (bf16 round-to-nearest-even, or f32
// unchanged): each tap weight is formed in f32 and rounded once, and the
// feature value is rounded to the same dtype, as the TPU kernel casts the
// matmul's right-hand side. Taps outside the image read 0.
//
// Bound: memory. Each output element needs one feature value, one scale
// value and one output write (plus the flow, shared by every channel): at
// (4,1024,64,128) bf16 with a bf16 scale that is 201 MB, 0.060 ms at
// 3.35 TB/s. The arithmetic is a few FMAs per element.
//
// Design. A block owns one frame n, a band of R output rows and a run of
// channel chunks of Cc channels. Because |fy| <= D, every tap of the band
// lies in rows [r0 - ceil(D), r0 + R + ceil(D)], so the source window of a
// chunk, Cc x (R + 2 ceil(D) + 1) rows x (W + 2 pad) columns, is staged in
// shared memory with zeros outside the image: the rows outside [0, H) and
// pad = 16 bytes of columns on each side (a TMA box must start on a 16-byte
// boundary in its innermost dimension; one at column -4 of a bf16 row
// faults). A tap column is clamped into [-2, W], where a clamped tap reads
// only zeros, so no tap needs a bounds test. Each consumer thread owns
// P = 16 / sizeof(feat) consecutive output pixels of one band row: it
// forms their four rounded tap weights and window offsets once, keeps them
// in registers for every channel of the run, and reads the scale and
// writes the output as 16-byte vectors.
//
// Staging: where a feature row is a multiple of 16 bytes and the window is
// at most 256 columns wide, one producer warp loads each window with one
// TMA copy (out-of-range elements arrive as zeros) into a ring of 2-3
// stages on mbarriers, so the next chunk's copy overlaps this chunk's taps.
// Other shapes (CamVid's 45x60) stage by cp.async, 16, 8 or 4 bytes a
// copy, two windows in flight, and read the scale and write the output by
// scalars (a bf16 row of odd length stages by plain loads). The blocks of
// one channel run and frame are numbered band first, so the bands that
// share halo rows run together and read those rows from L2: device memory
// sees feat, scale and out about once each. The launcher's caller
// (ops/warp_onehot.py::plan) picks R, Cc, the stages and the run length.
//
// What is left is not the scatter of the taps: on an H100 a flow drawn
// per pixel (lanes read scattered window columns, conflicting on the
// banks) and a smooth one take the same time. Which of the halo rows'
// L2 reads, the consumers' latency or the TMA ring limits it is not
// measured (ncu does not run there).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

// zero columns on each side of a window row: 16 bytes
template <typename T>
constexpr int kPad = 16 / (int)sizeof(T);

struct NoScale {};

struct Geometry {
    int C, H, W;
    float max_disp;
    int halo;       // ceil(max_disp)
    int rows;       // R, output rows per band
    int chunk;      // Cc, channels per staged window
    int width;      // W + 2 kPad<T>
    int win_rows;   // R + 2 halo + 1
    int nchunks;    // ceil(C / Cc)
    int run;        // chunks per block
    int stages;
    int stage_elems;  // elements between two stages (a multiple of 128 bytes)
    int vec;        // bytes a copy without TMA: 16, 8, 4, or 2 (plain loads)
    int tpr;        // consumer threads per band row
    int consumers;  // consumer threads (whole warps)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __ushort_as_bfloat16(0); }

template <bool kBf16Weights>
__device__ __forceinline__ float round_w(float v) {
    if constexpr (kBf16Weights) {
        return __bfloat162float(__float2bfloat16_rn(v));
    } else {
        return v;
    }
}

// P consecutive values from p, raw: vectors of 16 bytes (8 for P bf16
// values under f32 features), or scalars, of which the first `valid` count
template <int P, bool kVec, typename S>
__device__ __forceinline__ void load_row(const S* p, int valid, S (&v)[P]) {
    if constexpr (kVec) {
        constexpr int kBytes = P * (int)sizeof(S);
        if constexpr (kBytes % 16 == 0) {
#pragma unroll
            for (int i = 0; i < kBytes / 16; ++i)
                reinterpret_cast<uint4*>(v)[i] = reinterpret_cast<const uint4*>(p)[i];
        } else {
            static_assert(kBytes == 8, "an 8-byte row");
            *reinterpret_cast<uint2*>(v) = *reinterpret_cast<const uint2*>(p);
        }
    } else {
#pragma unroll
        for (int i = 0; i < P; ++i) v[i] = i < valid ? p[i] : zero<S>();
    }
}

template <int P, bool kVec>
__device__ __forceinline__ void store_row(float* p, int valid, const float (&v)[P]) {
    if constexpr (kVec) {
#pragma unroll
        for (int i = 0; i < P; i += 4)
            *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    } else {
#pragma unroll
        for (int i = 0; i < P; ++i)
            if (i < valid) p[i] = v[i];
    }
}

template <int P, bool kVec>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, int valid, const float (&v)[P]) {
    if constexpr (kVec) {
        static_assert(P % 8 == 0, "whole 16-byte vectors");
#pragma unroll
        for (int i = 0; i < P; i += 8) {
            uint4 q;
            __nv_bfloat162 h[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[i + 2 * k], v[i + 2 * k + 1]);
            q.x = *reinterpret_cast<uint32_t*>(&h[0]);
            q.y = *reinterpret_cast<uint32_t*>(&h[1]);
            q.z = *reinterpret_cast<uint32_t*>(&h[2]);
            q.w = *reinterpret_cast<uint32_t*>(&h[3]);
            *reinterpret_cast<uint4*>(p + i) = q;
        }
    } else {
#pragma unroll
        for (int i = 0; i < P; ++i)
            if (i < valid) p[i] = __float2bfloat16_rn(v[i]);
    }
}

constexpr int kCpStages = 2;  // windows in flight without TMA

// `bytes` (4, 8 or 16) global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, int bytes,
                                               uint32_t src_bytes) {
    if (bytes == 16) {
        cp_async16(dst, src, src_bytes);
    } else if (bytes == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
    }
}

// Stage the window of channels c0.. (rows r0 - halo ..) into `dst` without
// TMA: each warp copies whole rows, g.vec bytes a copy by cp.async, zeros
// outside the image and past C; a row of odd length in bf16 (g.vec 2) is
// copied by plain loads. The pad columns are left as they are.
template <typename T>
__device__ __forceinline__ void stage_window(T* dst, const T* __restrict__ feat, int n, int r0,
                                             int c0, const Geometry& g) {
    const int lane = threadIdx.x % 32;
    const int64_t plane = (int64_t)g.H * g.W;
    const int per_row = g.W * (int)sizeof(T) / g.vec;
    for (int rr = threadIdx.x / 32; rr < g.chunk * g.win_rows; rr += g.consumers / 32) {
        const int c = rr / g.win_rows, gy = r0 - g.halo + rr % g.win_rows;
        const bool live = c0 + c < g.C && gy >= 0 && gy < g.H;
        const T* src = live ? feat + ((int64_t)n * g.C + c0 + c) * plane + (int64_t)gy * g.W
                            : feat;
        T* row = dst + rr * g.width + kPad<T>;
        if (g.vec >= 4) {
            for (int v = lane; v < per_row; v += 32)
                cp_async_zfill(smem_addr(row) + v * g.vec,
                               reinterpret_cast<const uint8_t*>(src) + (live ? v * g.vec : 0),
                               g.vec, live ? g.vec : 0);
        } else {
            for (int x = lane; x < g.W; x += 32) row[x] = live ? src[x] : zero<T>();
        }
    }
}

// grid: (bands, runs, N); block: g.consumers threads, plus one producer warp
// under kTma. kTma: feature rows are 16-byte multiples and every pointer is
// 16-byte aligned, so the window arrives by TMA and the scale and output
// rows are read and written as vectors.
template <typename T, bool kBf16Weights, typename S, bool kTma>
__global__ void __launch_bounds__(544) warp_onehot_kernel(
        const __grid_constant__ CUtensorMap feat_map, const T* __restrict__ feat,
        const float* __restrict__ flow, const S* __restrict__ scale,
        const float* __restrict__ gain, T* __restrict__ out, const Geometry g) {
    constexpr int P = 16 / (int)sizeof(T);
    constexpr bool kScale = !std::is_same_v<S, NoScale>;
    extern __shared__ uint8_t smem_raw[];
    T* stages = reinterpret_cast<T*>(smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127));
    uint64_t* full = reinterpret_cast<uint64_t*>(stages + g.stages * g.stage_elems);
    uint64_t* empty = full + g.stages;

    const int band = blockIdx.x, n = blockIdx.z;
    const int r0 = band * g.rows;
    const int k0 = blockIdx.y * g.run;
    const int nk = min(g.run, g.nchunks - k0);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int plane_elems = g.win_rows * g.width;

    if constexpr (kTma) {
        if (tid == 0) {
            for (int s = 0; s < g.stages; ++s) {
                mbar_init(&full[s], 1);
                mbar_init(&empty[s], g.consumers / 32);
            }
            mbar_fence_init();
        }
        __syncthreads();
        if (tid >= g.consumers) {
            // ---- producer warp: one TMA copy per chunk window ----
            if (lane == 0) {
                const uint32_t bytes = (uint32_t)(g.chunk * plane_elems * sizeof(T));
                for (int k = 0; k < nk; ++k) {
                    const int s = k % g.stages;
                    mbar_wait(&empty[s], ((k / g.stages) & 1) ^ 1);
                    mbar_arrive_expect_tx(&full[s], bytes);
                    tma_load_4d(stages + s * g.stage_elems, &feat_map, &full[s], -kPad<T>,
                                r0 - g.halo, (k0 + k) * g.chunk, n);
                }
            }
            return;
        }
    }

    // ---- consumers: thread (row, slot) owns pixels x = slot*P .. slot*P+P-1 ----
    const int row = tid / g.tpr, x_base = tid % g.tpr * P;
    const int y = r0 + row;
    const bool active = tid < g.tpr * g.rows && y < g.H && x_base < g.W;
    const int valid = active ? min(P, g.W - x_base) : 0;
    float w[P][4];
    int off[P];
    const int64_t plane = (int64_t)g.H * g.W;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        off[j] = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) w[j][t] = 0.f;
        if (j < valid) {
            const float* fl = flow + (int64_t)n * 2 * plane + (int64_t)y * g.W + x_base + j;
            const float fx = fl[0];
            const float fy = fminf(fmaxf(fl[plane], -g.max_disp), g.max_disp);
            const float sy = (float)y + fy, sx = (float)(x_base + j) + fx;
            const float y0f = floorf(sy), x0f = floorf(sx);
            const float ry[2] = {1.f - (sy - y0f), sy - y0f};
            const float cx[2] = {1.f - (sx - x0f), sx - x0f};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                // the product in f32 (no FMA contraction), then one rounding
                w[j][t] = round_w<kBf16Weights>(__fmul_rn(ry[t >> 1], cx[t & 1]));
            }
            // |fy| <= D keeps y0 and y0 + 1 inside the window; a column
            // clamped into [-2, W] reads only the window's zero columns
            const int wy = (int)y0f - (r0 - g.halo);
            const int wx = (int)fminf(fmaxf(x0f, -2.f), (float)g.W) + kPad<T>;
            off[j] = wy * g.width + wx;
        }
    }
    const float gn = (kScale && gain != nullptr) ? gain[n] : 1.f;

    if constexpr (!kTma) {
        // the pad columns of every stage stay zero; copies fill the rest
        for (int rr = tid; rr < kCpStages * g.chunk * g.win_rows; rr += g.consumers) {
            T* row_ = stages + rr / (g.chunk * g.win_rows) * g.stage_elems
                      + rr % (g.chunk * g.win_rows) * g.width;
            for (int i = 0; i < kPad<T>; ++i) row_[i] = row_[kPad<T> + g.W + i] = zero<T>();
        }
        stage_window(stages, feat, n, r0, k0 * g.chunk, g);
        cp_async_commit();
    }

    for (int k = 0; k < nk; ++k) {
        const int c0 = (k0 + k) * g.chunk;
        const T* st;
        int s = 0;
        if constexpr (kTma) {
            s = k % g.stages;
            mbar_wait(&full[s], (k / g.stages) & 1);
            st = stages + s * g.stage_elems;
        } else {
            // copy the next chunk's window while this one's taps run
            if (k + 1 < nk)
                stage_window(stages + (k + 1) % kCpStages * g.stage_elems, feat, n, r0,
                             c0 + g.chunk, g);
            cp_async_commit();
            cp_async_wait<kCpStages - 1>();
            __syncthreads();
            st = stages + k % kCpStages * g.stage_elems;
        }
        if (active) {
            const int cn = min(g.chunk, g.C - c0);
            int64_t o = ((int64_t)n * g.C + c0) * plane + (int64_t)y * g.W + x_base;
            // (loading the next channel's scale row here, ahead of this
            // channel's taps, measured slower on an H100)
            std::conditional_t<kScale, S, float> sv[P];
            for (int c = 0; c < cn; ++c, o += plane) {
                if constexpr (kScale) load_row<P, kTma>(scale + o, valid, sv);
                const T* win = st + c * plane_elems;
                float acc[P];
#pragma unroll
                for (int j = 0; j < P; ++j) {
                    const T* p = win + off[j];
                    float a = 0.f;
                    a += round_w<kBf16Weights>(to_f32(p[0])) * w[j][0];
                    a += round_w<kBf16Weights>(to_f32(p[1])) * w[j][1];
                    a += round_w<kBf16Weights>(to_f32(p[g.width])) * w[j][2];
                    a += round_w<kBf16Weights>(to_f32(p[g.width + 1])) * w[j][3];
                    acc[j] = a;
                }
                if constexpr (kScale) {
#pragma unroll
                    for (int j = 0; j < P; ++j) {
                        float f = to_f32(sv[j]);
                        if (gain != nullptr) f *= gn;
                        acc[j] *= f;
                    }
                }
                store_row<P, kTma>(out + o, valid, acc);
            }
        }
        if constexpr (kTma) {
            // this warp has read stage s: the producer may refill it
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
        } else {
            __syncthreads();  // stage k % kCpStages is read: it may be refilled
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

constexpr int kNoEncoder = -1;   // no cuTensorMapEncodeTiled to be found
constexpr int kBadTensorMap = -2;
constexpr int kMaxSmem = 232448;  // 227 KB, a block's most on Hopper

template <typename T, bool kBf16Weights, typename S, bool kTma>
int launch(const void* feat, const float* flow, const void* scale, const float* gain,
           void* out, int N, const Geometry& g, dim3 grid, int smem, cudaStream_t stream) {
    CUtensorMap map{};
    if constexpr (kTma) {
        const EncodeTiled encode = encode_tiled();
        if (encode == nullptr) return kNoEncoder;
        const cuuint64_t e = sizeof(T);
        const cuuint64_t dims[4] = {(cuuint64_t)g.W, (cuuint64_t)g.H, (cuuint64_t)g.C,
                                    (cuuint64_t)N};
        const cuuint64_t strides[3] = {g.W * e, (cuuint64_t)g.H * g.W * e,
                                       (cuuint64_t)g.C * g.H * g.W * e};
        const cuuint32_t box[4] = {(cuuint32_t)g.width, (cuuint32_t)g.win_rows,
                                   (cuuint32_t)g.chunk, 1};
        const cuuint32_t ones[4] = {1, 1, 1, 1};
        const CUtensorMapDataType type = sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
        if (encode(&map, type, 4, const_cast<void*>(feat), dims, strides, box, ones,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return kBadTensorMap;
    }
    auto kernel = warp_onehot_kernel<T, kBf16Weights, S, kTma>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const int threads = g.consumers + (kTma ? 32 : 0);
    kernel<<<grid, threads, smem, stream>>>(map, (const T*)feat, flow, (const S*)scale, gain,
                                            (T*)out, g);
    return (int)cudaGetLastError();
}

template <typename T, bool kBf16Weights, typename S>
int launch_staging(bool tma, const void* feat, const float* flow, const void* scale,
                   const float* gain, void* out, int N, const Geometry& g, dim3 grid, int smem,
                   cudaStream_t stream) {
    return tma ? launch<T, kBf16Weights, S, true>(feat, flow, scale, gain, out, N, g, grid,
                                                  smem, stream)
               : launch<T, kBf16Weights, S, false>(feat, flow, scale, gain, out, N, g, grid,
                                                   smem, stream);
}

template <typename T, bool kBf16Weights>
int launch_scale(int scale_kind, bool tma, const void* feat, const float* flow,
                 const void* scale, const float* gain, void* out, int N, const Geometry& g,
                 dim3 grid, int smem, cudaStream_t stream) {
    if (scale_kind == 0)
        return launch_staging<T, kBf16Weights, NoScale>(tma, feat, flow, scale, gain, out, N, g,
                                                        grid, smem, stream);
    if (scale_kind == 1)
        return launch_staging<T, kBf16Weights, float>(tma, feat, flow, scale, gain, out, N, g,
                                                      grid, smem, stream);
    return launch_staging<T, kBf16Weights, __nv_bfloat16>(tma, feat, flow, scale, gain, out, N,
                                                          g, grid, smem, stream);
}

}  // namespace

// feat (N,C,H,W) f32 or bf16, flow (N,2,H,W) f32 (dx, dy), scale (N,C,H,W)
// f32 or bf16 or null, gain (N,) f32 or null (only with scale), out like
// feat. The plan: `rows` output rows per band, `chunk` channels per staged
// window, `stages` windows in flight (2 without TMA), `runs` blocks along the
// channels, `tma` the TMA staging (feature rows of 16-byte multiples, every
// pointer 16-byte aligned, a window row of at most 256 columns). Returns a cudaError_t, or
// kNoEncoder / kBadTensorMap (negative) when a TMA descriptor cannot be made.
extern "C" int warp_onehot_launch(const void* feat, const float* flow, const void* scale,
                                  const float* gain, void* out, int N, int C, int H, int W,
                                  float max_disp, int feat_bf16, int scale_bf16,
                                  int weights_bf16, int rows, int chunk, int stages, int runs,
                                  int tma, cudaStream_t stream) {
    if ((int64_t)N * C * H * W == 0) return 0;
    const int elem = feat_bf16 ? 2 : 4;
    const int P = 16 / elem;
    Geometry g{};
    g.C = C;
    g.H = H;
    g.W = W;
    g.max_disp = max_disp;
    g.halo = (int)ceilf(max_disp);
    g.rows = rows;
    g.chunk = chunk;
    g.width = W + 2 * (feat_bf16 ? kPad<__nv_bfloat16> : kPad<float>);
    g.win_rows = rows + 2 * g.halo + 1;
    g.nchunks = (C + chunk - 1) / chunk;
    g.run = (g.nchunks + runs - 1) / runs;
    g.stages = tma ? stages : kCpStages;
    // without TMA: the widest copy that divides a feature row and the pointer
    g.vec = 2;
    for (int v = 16; v >= 4; v /= 2) {
        if (W * elem % v == 0 && reinterpret_cast<uintptr_t>(feat) % v == 0) {
            g.vec = v;
            break;
        }
    }
    const int64_t stage_bytes = ((int64_t)chunk * g.win_rows * g.width * elem + 127) / 128 * 128;
    g.stage_elems = (int)(stage_bytes / elem);
    g.tpr = (W + P - 1) / P;
    g.consumers = (g.tpr * rows + 31) / 32 * 32;
    const int64_t smem = 128 + g.stages * stage_bytes + 2 * g.stages * 8;
    if (max_disp < 0.f || rows < 1 || chunk < 1 || runs < 1 || g.consumers > 512 ||
        smem > kMaxSmem || (tma && (W * elem % 16 != 0 || g.width > 256 || g.win_rows > 256)))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((H + rows - 1) / rows, (g.nchunks + g.run - 1) / g.run, N);
    const int sk = scale == nullptr ? 0 : (scale_bf16 ? 2 : 1);
    const bool t = tma != 0;
    if (feat_bf16) {
        return weights_bf16
                   ? launch_scale<__nv_bfloat16, true>(sk, t, feat, flow, scale, gain, out, N, g,
                                                       grid, (int)smem, stream)
                   : launch_scale<__nv_bfloat16, false>(sk, t, feat, flow, scale, gain, out, N,
                                                        g, grid, (int)smem, stream);
    }
    return weights_bf16 ? launch_scale<float, true>(sk, t, feat, flow, scale, gain, out, N, g,
                                                    grid, (int)smem, stream)
                        : launch_scale<float, false>(sk, t, feat, flow, scale, gain, out, N, g,
                                                     grid, (int)smem, stream);
}
