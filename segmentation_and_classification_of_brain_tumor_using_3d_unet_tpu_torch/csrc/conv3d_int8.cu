// Q8: the int8 3x3x3 SAME conv of int8 serving, bf16 out:
//   q(v)   = clip(rint(v / act_scale), -127, 127)            (f32, IEEE /)
//   ws[o]  = max(max over t, c of |w[t, c, o]|, 1e-12) / 127
//   wq     = clip(rint(w / ws[o]), -127, 127)
//   acc    = sum over taps t, channels c of q(x[b, (d, h, w) + t - 1, c])
//            * wq[t, c, o]                                   (exact, int32)
//   y      = bf16(f32(acc) * (act_scale * ws[o]) [+ bias[o]])
// with x taken as 0 outside the volume. x (B, D, H, W, ci) bf16 or f32,
// w (27, ci, co) f32 (DHWIO), y (B, D, H, W, co) bf16; any ci, co a
// multiple of 8. The function of the JAX package's ops/conv.py
// conv3d_zcat_int8 (:197-285), bit for bit: the int8 products summed in
// int32 are exact, and every f32 step is the same IEEE operation (no
// --use_fast_math, no contraction: __fmul_rn / __fadd_rn).
//
// It replaces no TPU kernel: in JAX this conv is an XLA conv. PyTorch has
// no int8 3-D conv; torch._int_mm would need a 27x-wide im2col copy.
//
// Bound on the H100: 2 * 27 * ci * co int8 operations a voxel against
// 2 * ci + 2 * co bytes (bf16 in and out), 432 operations a byte at
// 32 -> 32, under the int8 tensor cores' ~590 a byte: the level-0 convs
// are bound by bytes, the deeper ones by operations, the bottleneck's by
// its weights (27 * 1024 * 1024 f32 read and quantized each call).
//
// Design (a first version: right first, fast later):
//  * Weights, once a call, two small kernels: per-output-channel maxima
//    of |w| over splits of K (no atomics), then the scales and the int8
//    weights in the K-major layout (co, 27, cip), cip = ci rounded up to
//    32 with zero channels, through a shared-memory transpose. The
//    tensor cores take B K-major here (mma.sync's .col operand); Hopper's
//    wgmma would allow no transposed int8 B either.
//  * The conv: an implicit GEMM on the warp-level int8 tensor-core MMA
//    mma.sync.m16n8k32.s32.s8.s8.s32. M = the 256 output voxels of a
//    TB x TD x TH x TW patch (any patch; each row is one voxel's
//    address), N = 32 or 64 output channels, K = 27 taps x 32 channels a
//    step. For each 32-channel chunk the block loads the patch's input
//    tile (TB, TD+2, TH+2, TW+2) once in x's own dtype, quantizes it as it
//    lands (zero outside the volume, as a zero pad quantizes to 0) and
//    keeps it in shared memory as int8 at a 48-byte voxel pitch (eight
//    consecutive voxels' 16-byte rows fall in eight bank groups); no int8
//    copy of x goes to device memory. The chunk's 27 weight slabs come in
//    by cp.async beside it. Each tap's A fragments are ldmatrix.x4 loads
//    of a shifted window of the tile, its B fragments ldmatrix.x4 loads of
//    the tap's slab; 8 warps, each 32 rows x N, accumulate in int32
//    registers.
//  * Epilogue: int32 -> f32 (__int2float_rn), times the f32 product
//    act_scale * ws[o] formed first, + bias, one rounding to bf16, staged
//    in shared memory and stored 16 B at a time along co, masked to the
//    volume. The sum is exact and its order fixed: two runs give the same
//    bits.
// mma.sync rather than wgmma in this version: its fragments come from
// plain shared-memory rows through ldmatrix, so the quantize-on-load tile
// needs no wgmma descriptor layout, and any M, N and padding is a mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps, each 32 GEMM rows
constexpr int kRows = 256;      // GEMM rows (output voxels) a block
constexpr int kPitch = 48;      // shared bytes a voxel / a weight row
constexpr int kMaxSplits = 32;  // row blocks of the weights' maxima scratch

struct Patch {
  int TB, TD, TH, TW;
};

struct Args {
  const void* x;
  const int8_t* wq;      // (co, 27, cip), K-major
  const float* w_scale;  // (co,)
  const float* act_scale;
  const float* bias;     // (co,) or null
  bf16* y;
  int B, D, H, W, ci, cip, co;
  Patch p;
  int nd, nh, nw;  // patches along D, H, W
};

__device__ __forceinline__ int quant(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(const float* f, float s) {
  return (static_cast<uint32_t>(quant(f[0], s)) & 0xffu) |
         ((static_cast<uint32_t>(quant(f[1], s)) & 0xffu) << 8) |
         ((static_cast<uint32_t>(quant(f[2], s)) & 0xffu) << 16) |
         (static_cast<uint32_t>(quant(f[3], s)) << 24);
}

// eight channels c.. of x at element idx, 0 past ci
template <typename T>
__device__ __forceinline__ void load8(const T* x, size_t idx, int c, int ci, bool vec,
                                      float (&f)[8]);
template <>
__device__ __forceinline__ void load8<bf16>(const bf16* x, size_t idx, int c, int ci,
                                            bool vec, float (&f)[8]) {
  if (vec) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(x + idx));
    const bf16* v = reinterpret_cast<const bf16*>(&r);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = c + i < ci ? __bfloat162float(x[idx + i]) : 0.f;
  }
}
template <>
__device__ __forceinline__ void load8<float>(const float* x, size_t idx, int c, int ci,
                                             bool vec, float (&f)[8]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + idx));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + idx + 4));
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = c + i < ci ? x[idx + i] : 0.f;
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// GEMM row r of a patch -> (tb, td, th, tw), W fastest
__device__ __forceinline__ void row_pos(int r, const Patch& p, int& tb, int& td, int& th,
                                        int& tw) {
  tw = r % p.TW;
  r /= p.TW;
  th = r % p.TH;
  r /= p.TH;
  td = r % p.TD;
  tb = r / p.TD;
}

// ------------------------------------------------------------ weights
// part[s, o] = max |w[k, o]| over row block s of K = 27 * ci rows
__global__ void __launch_bounds__(kThreads) weight_max_kernel(const float* __restrict__ w,
                                                              float* __restrict__ part, int K,
                                                              int co, int rows) {
  __shared__ float red[8][32];
  const int o = blockIdx.x * 32 + (threadIdx.x & 31);
  const int g = threadIdx.x >> 5;
  const int k1 = min(K, ((int)blockIdx.y + 1) * rows);
  float m = 0.f;
  if (o < co)
    for (int k = (int)blockIdx.y * rows + g; k < k1; k += 8) m = fmaxf(m, fabsf(w[(size_t)k * co + o]));
  red[g][threadIdx.x & 31] = m;
  __syncthreads();
  if (g == 0 && o < co) {
#pragma unroll
    for (int i = 1; i < 8; ++i) m = fmaxf(m, red[i][threadIdx.x]);
    part[(size_t)blockIdx.y * co + o] = m;
  }
}

// ws[o] and wq[o, kp] for 32 channels o and 32 padded K rows kp = t * cip
// + c (blockIdx.y), through a shared transpose
__global__ void __launch_bounds__(kThreads) weight_quant_kernel(
    const float* __restrict__ w, const float* __restrict__ part, int splits,
    float* __restrict__ w_scale, int8_t* __restrict__ wq, int ci, int cip, int co) {
  __shared__ float sc[32];
  __shared__ __align__(16) uint8_t qs[32][36];
  const int ol = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + ol;
  if (g == 0) {
    float m = 0.f;
    if (o < co)
      for (int s = 0; s < splits; ++s) m = fmaxf(m, part[(size_t)s * co + o]);
    const float scale = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
    sc[ol] = scale;
    if (blockIdx.y == 0 && o < co) w_scale[o] = scale;
  }
  __syncthreads();
  for (int kk = g; kk < 32; kk += 8) {
    const int kp = blockIdx.y * 32 + kk;
    const int t = kp / cip, c = kp % cip;
    const float v = (o < co && c < ci) ? w[((size_t)t * ci + c) * co + o] : 0.f;
    qs[ol][kk] = static_cast<uint8_t>(quant(v, sc[ol]));
  }
  __syncthreads();
  const int row = threadIdx.x >> 3, word = threadIdx.x & 7;
  const int orow = blockIdx.x * 32 + row;
  if (orow < co)
    reinterpret_cast<uint32_t*>(wq + (size_t)orow * 27 * cip + blockIdx.y * 32)[word] =
        *reinterpret_cast<const uint32_t*>(&qs[row][4 * word]);
}

// --------------------------------------------------------------- conv
template <int N, typename T>
__global__ void __launch_bounds__(kThreads, 2) conv_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Patch p = a.p;
  const int TWp = p.TW + 2, THp = p.TH + 2, TDp = p.TD + 2;
  const int V = p.TB * TDp * THp * TWp;
  uint8_t* As = smem;
  uint8_t* Bs = smem + ((V * kPitch + 127) & ~127);
  int pid = blockIdx.x;
  const int w0 = (pid % a.nw) * p.TW;
  pid /= a.nw;
  const int h0 = (pid % a.nh) * p.TH;
  pid /= a.nh;
  const int d0 = (pid % a.nd) * p.TD;
  const int b0 = (pid / a.nd) * p.TB;
  const int n0 = blockIdx.y * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float s = *a.act_scale;
  const T* x = static_cast<const T*>(a.x);
  const bool vec = (a.ci & 7) == 0;

  // each lane's ldmatrix row address at tap (0, 0, 0): A rows of its two
  // m16 tiles, B rows of a pair of n8 tiles
  uint32_t a_base[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int mi = lane >> 3;
    const int r = warp * 32 + mt * 16 + (lane & 7) + ((mi & 1) << 3);
    int tb, td, th, tw;
    row_pos(r, p, tb, td, th, tw);
    if (tb >= p.TB) tb = td = th = tw = 0;  // a row past the patch: unused
    a_base[mt] = smem_u32(As) + (((tb * TDp + td) * THp + th) * TWp + tw) * kPitch +
                 (mi >> 1) * 16;
  }
  const uint32_t b_lane =
      smem_u32(Bs) + ((lane & 7) + ((lane >> 4) << 3)) * kPitch + ((lane >> 3) & 1) * 16;

  int acc[2][N / 8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0;

  for (int c0 = 0; c0 < a.cip; c0 += 32) {
    // the chunk's 27 weight slabs (N rows of 32 bytes each), by cp.async
    for (int u = tid; u < 27 * N * 2; u += kThreads) {
      const int half = u & 1, n = (u >> 1) % N, t = (u >> 1) / N;
      const bool ok = n0 + n < a.co;
      const int8_t* src = a.wq + ((size_t)(ok ? n0 + n : 0) * 27 + t) * a.cip + c0 + 16 * half;
      cp_async16(smem_u32(Bs) + (t * N + n) * kPitch + 16 * half, src, ok);
    }
    cp_async_commit();
    // the input tile, quantized as it lands: 8 channels a thread and step
    for (int u = tid; u < V * 4; u += kThreads) {
      const int g = u & 3, v = u >> 2;
      int r = v;
      const int zw = r % TWp;
      r /= TWp;
      const int zh = r % THp;
      r /= THp;
      const int zd = r % TDp;
      const int b = b0 + r / TDp;
      const int d = d0 - 1 + zd, h = h0 - 1 + zh, w = w0 - 1 + zw, c = c0 + 8 * g;
      uint2 q = make_uint2(0u, 0u);
      if (b < a.B && d >= 0 && d < a.D && h >= 0 && h < a.H && w >= 0 && w < a.W && c < a.ci) {
        float f[8];
        load8<T>(x, ((((size_t)b * a.D + d) * a.H + h) * a.W + w) * a.ci + c, c, a.ci, vec, f);
        q.x = pack4(f, s);
        q.y = pack4(f + 4, s);
      }
      *reinterpret_cast<uint2*>(As + v * kPitch + 8 * g) = q;
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int tap = (kd * 3 + kh) * 3 + kw;
          const uint32_t off = ((kd * THp + kh) * TWp + kw) * kPitch;
          uint32_t af[2][4];
          ldmatrix_x4(af[0], a_base[0] + off);
          ldmatrix_x4(af[1], a_base[1] + off);
#pragma unroll
          for (int pp = 0; pp < N / 16; ++pp) {
            uint32_t bf[4];
            ldmatrix_x4(bf, b_lane + (tap * N + pp * 16) * kPitch);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_s8(acc[mt][2 * pp], af[mt], bf[0], bf[1]);
              mma_s8(acc[mt][2 * pp + 1], af[mt], bf[2], bf[3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue, staged in the (now free) weight area at a conflict-free pitch
  constexpr int CP = N * 2 + 16;
  uint8_t* Cs = Bs;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * t4, n = n0 + col;
    float f0 = 0.f, f1 = 0.f, c0 = 0.f, c1 = 0.f;
    if (n < a.co) {  // co % 8 == 0: n + 1 < co too
      f0 = __fmul_rn(s, a.w_scale[n]);
      f1 = __fmul_rn(s, a.w_scale[n + 1]);
      if (a.bias) {
        c0 = a.bias[n];
        c1 = a.bias[n + 1];
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = warp * 32 + mt * 16 + g + 8 * hf;
        float v0 = __fmul_rn(__int2float_rn(acc[mt][j][2 * hf]), f0);
        float v1 = __fmul_rn(__int2float_rn(acc[mt][j][2 * hf + 1]), f1);
        if (a.bias) {
          v0 = __fadd_rn(v0, c0);
          v1 = __fadd_rn(v1, c1);
        }
        *reinterpret_cast<__nv_bfloat162*>(Cs + row * CP + col * 2) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
  __syncthreads();
  constexpr int kChunks = N / 8;  // 16 B a chunk
  for (int u = tid; u < kRows * kChunks; u += kThreads) {
    const int row = u / kChunks, c = u % kChunks;
    int tb, td, th, tw;
    row_pos(row, p, tb, td, th, tw);
    const int b = b0 + tb, d = d0 + td, h = h0 + th, w = w0 + tw, n = n0 + 8 * c;
    if (tb < p.TB && b < a.B && d < a.D && h < a.H && w < a.W && n < a.co)
      *reinterpret_cast<uint4*>(a.y + ((((size_t)b * a.D + d) * a.H + h) * a.W + w) * a.co + n) =
          *reinterpret_cast<const uint4*>(Cs + row * CP + 16 * c);
  }
}

// ---------------------------------------------------------------- host
struct Plan {
  int N;
  Patch p;
  int nb, nd, nh, nw;
  long patches;
  int smem, splits, rows;
};

int pow2_at_least(int n) {
  int v = 1;
  while (v < n) v <<= 1;
  return v;
}

// The patch: up to 8 along W and H, up to 16 along D and B, its volume at
// most 256 rows (the deepest levels' small volumes take several samples
// a block, so their weights are read by fewer blocks); N = 64 where the
// blocks still fill the card, else 32.
Plan plan(int B, int D, int H, int W, int ci, int co) {
  Plan q;
  Patch& p = q.p;
  p.TW = std::min(8, pow2_at_least(W));
  p.TH = std::min(8, pow2_at_least(H));
  p.TD = std::min({16, kRows / (p.TW * p.TH), pow2_at_least(D)});
  p.TB = std::min({16, kRows / (p.TD * p.TH * p.TW), pow2_at_least(B)});
  q.nb = (B + p.TB - 1) / p.TB;
  q.nd = (D + p.TD - 1) / p.TD;
  q.nh = (H + p.TH - 1) / p.TH;
  q.nw = (W + p.TW - 1) / p.TW;
  q.patches = (long)q.nb * q.nd * q.nh * q.nw;
  q.N = (co <= 32 || q.patches * ((co + 63) / 64) < 132) ? 32 : 64;
  const int V = p.TB * (p.TD + 2) * (p.TH + 2) * (p.TW + 2);
  q.smem = ((V * kPitch + 127) & ~127) + 27 * q.N * kPitch;
  const int K = 27 * ci;
  q.splits = std::min(kMaxSplits, std::max(1, (K + 2047) / 2048));
  q.rows = (K + q.splits - 1) / q.splits;
  return q;
}

template <int N, typename T>
int launch_conv(const Args& a, const Plan& q, cudaStream_t s) {
  static bool attr = false;  // per instantiation, once
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_kernel<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const dim3 grid((unsigned)q.patches, (a.co + N - 1) / N);
  conv_kernel<N, T><<<grid, kThreads, q.smem, s>>>(a);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int D, int H, int W, int ci, int co) {
  return B < 1 || D < 1 || H < 1 || W < 1 || ci < 1 || co < 8 || co % 8 ||
         (long)B * D * H * W > 0x7fffffffL || 27L * ci > 0x7fffffffL;
}

}  // namespace

// y = Q8(x, w, act_scale, bias); scratch the wrapper allocates: wq
// (co, 27, cip) int8 and f32s (1 + 32, co) f32 (w_scale, then the maxima
// of each split of K). bias may be null. Three launches on the stream:
// the maxima, the weights' quantization, the conv.
extern "C" int conv3d_int8(const void* x, int x_bf16, const void* w, const void* act_scale,
                           const void* bias, void* wq, void* f32s, void* y, int B, int D,
                           int H, int W, int ci, int co, void* stream) {
  if (bad_shape(B, D, H, W, ci, co)) return (int)cudaErrorInvalidValue;
  const Plan q = plan(B, D, H, W, ci, co);
  if (q.patches > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cip = (ci + 31) / 32 * 32;
  float* w_scale = static_cast<float*>(f32s);
  float* part = w_scale + co;
  const float* wf = static_cast<const float*>(w);
  weight_max_kernel<<<dim3((co + 31) / 32, q.splits), kThreads, 0, s>>>(wf, part, 27 * ci,
                                                                         co, q.rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  weight_quant_kernel<<<dim3((co + 31) / 32, 27 * cip / 32), kThreads, 0, s>>>(
      wf, part, q.splits, w_scale, static_cast<int8_t*>(wq), ci, cip, co);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.x = x;
  a.wq = static_cast<const int8_t*>(wq);
  a.w_scale = w_scale;
  a.act_scale = static_cast<const float*>(act_scale);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<bf16*>(y);
  a.B = B;
  a.D = D;
  a.H = H;
  a.W = W;
  a.ci = ci;
  a.cip = cip;
  a.co = co;
  a.p = q.p;
  a.nd = q.nd;
  a.nh = q.nh;
  a.nw = q.nw;
  if (q.N == 64)
    return x_bf16 ? launch_conv<64, bf16>(a, q, s) : launch_conv<64, float>(a, q, s);
  return x_bf16 ? launch_conv<32, bf16>(a, q, s) : launch_conv<32, float>(a, q, s);
}

// The geometry conv3d_int8 picks: out[0..7] = N, TB, TD, TH, TW, conv
// blocks, dynamic shared memory bytes, splits of K for the maxima.
extern "C" int conv3d_int8_plan(int B, int D, int H, int W, int ci, int co, int* out) {
  if (bad_shape(B, D, H, W, ci, co)) return (int)cudaErrorInvalidValue;
  const Plan q = plan(B, D, H, W, ci, co);
  out[0] = q.N;
  out[1] = q.p.TB;
  out[2] = q.p.TD;
  out[3] = q.p.TH;
  out[4] = q.p.TW;
  out[5] = (int)(q.patches * ((co + q.N - 1) / q.N));
  out[6] = q.smem;
  out[7] = q.splits;
  return 0;
}
