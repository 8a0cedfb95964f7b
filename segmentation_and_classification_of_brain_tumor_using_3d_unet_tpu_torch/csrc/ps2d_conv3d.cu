// K1: bias-free 3x3x3 SAME conv over the halo layout, with the on-load
// input transforms and the output statistics of the level-0 region.
//
// Replaces the Pallas kernel behind ops/pallas/ps2d.py::
// ps2d_conv3d_flat_multi (kernel body `_kernel`, ps2d.py:419-664) of the
// JAX package. Same function, not the same blocks: the TPU kernel packs
// 2x2 spatial phases into 128 lanes and streams depth through a lane
// ring to fill its matrix unit; here the data stay channels-last with a
// one-voxel zero halo on D, H and W ("halo layout",
// (B, D+2, H+2, W+2, C) bf16), which pack_halo and up_k2s2_into_halo
// write and this kernel reads and writes.
//
// What it computes, per output voxel and channel (f32 accumulation,
// one rounding to bf16):
//   y = sum over inputs i, taps t, channels c of  x'_i[vox+t, c] * w[t, off_i+c]
// where x' is the input after the on-load transform, each step rounded
// to bf16 as the reference rounds it:
//   affine   x' = relu?( bf16(bf16(x * scale[b,c]) + shift[b,c]) )
//   mask     x'_0 = bf16(x'_0 * mul0[vox, c])        (input 0 only)
//   halo     x' = 0 at halo voxels (the SAME padding stays exact).
// The concat of the inputs lives only in the K loop (never stored).
// With stats it also adds, per batch item and channel, the sum and the
// sum of squares of the bf16-ROUNDED outputs into stats (B, 2, co)
// (f32, atomics): the next GroupNorm's statistics without another read.
//
// Bound on the H100: at the main path's shapes (batch 4, 128^3, ci 32
// or 32+32, co 32) the conv does 0.46-0.93 TFLOP against 1.1-2.3 GB of
// HBM traffic, so it is bound by tensor-core operations (about 400
// FLOP per byte, above the card's ~295 balance point). Design for that:
// implicit GEMM on the tensor cores (warp-level wmma, bf16 in, f32
// accumulate). A block stages a (3, 10, 34) voxel x 32 channel input
// tile once in shared memory, transformed as it lands, and reuses it for
// all 27 taps of its 8x32 output voxels; each warp holds a 64 voxel x co
// accumulator in registers. Simple first: no TMA, no wgmma, no
// pipelining of the next tile's load behind the current tile's math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kTH = 8;           // output rows (H) per block
constexpr int kTW = 32;          // output columns (W) per block
constexpr int kCK = 32;          // input channels per staged chunk
constexpr int kLD = kCK + 16;    // smem voxel pitch: 96 B keeps wmma's
                                 // 32 B alignment, 2-way bank conflicts
constexpr int kIH = kTH + 2, kIW = kTW + 2;
constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kTileBytes = 3 * kIH * kIW * kLD * (int)sizeof(bf16);

struct Args {
  const bf16* x[2];     // halo layout inputs, ci[i] channels each
  int ci[2];
  int n_in, ci_total;
  const bf16* w;        // (27, ci_total, co): DHWIO
  const bf16* scale;    // (B, ci_total) or null
  const bf16* shift;    // (B, ci_total); set whenever scale is
  int relu;
  const bf16* mul0;     // (B, D+2, H+2, W+2, ci[0]) or null
  bf16* y;              // (B, D+2, H+2, W+2, co)
  float* stats;         // (B, 2, co), zeroed by the caller, or null
  int D, H, W;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int NF>   // co = 16 * NF
__global__ void __launch_bounds__(kThreads) conv_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][16 * NF];
  bf16* tile = reinterpret_cast<bf16*>(smem);   // (3, kIH, kIW, kLD)

  constexpr int co = 16 * NF;
  const int n_wt = (a.W + kTW - 1) / kTW;
  const int w0 = (blockIdx.x % n_wt) * kTW;
  const int h0 = (blockIdx.x / n_wt) * kTH;
  const int d = blockIdx.y, b = blockIdx.z;
  const int Dp = a.D + 2, Hp = a.H + 2, Wp = a.W + 2;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < 2 * co; i += kThreads) red[i / co][i % co] = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][NF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  int coff = 0;   // this input's first row in w and in scale/shift
  for (int in = 0; in < a.n_in; ++in) {
    const bf16* x = a.x[in];
    const int ci = a.ci[in];
    const bool mul = in == 0 && a.mul0 != nullptr;
    for (int c0 = 0; c0 < ci; c0 += kCK) {
      __syncthreads();   // the previous chunk's tile is no longer read
      // ---- stage the input tile, 8 channels (16 B) per item ----------
      constexpr int kVec = kCK / 8;
      for (int it = threadIdx.x; it < 3 * kIH * kIW * kVec; it += kThreads) {
        const int v8 = it % kVec;
        int p = it / kVec;
        const int iw = p % kIW;
        p /= kIW;
        const int ih = p % kIH;
        const int kz = p / kIH;
        const int pd = d + kz, ph = h0 + ih, pw = w0 + iw;   // halo coords
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (pd >= 1 && pd <= a.D && ph >= 1 && ph <= a.H && pw >= 1 &&
            pw <= a.W) {
          const size_t vox = (((size_t)b * Dp + pd) * Hp + ph) * Wp + pw;
          const int c = c0 + v8 * 8;
          v = *reinterpret_cast<const uint4*>(x + vox * ci + c);
          bf16* e = reinterpret_cast<bf16*>(&v);
          if (a.scale != nullptr) {
            const bf16* sc = a.scale + (size_t)b * a.ci_total + coff + c;
            const bf16* sh = a.shift + (size_t)b * a.ci_total + coff + c;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              float t = round_bf16(__bfloat162float(e[k]) * __bfloat162float(sc[k]));
              t = round_bf16(t + __bfloat162float(sh[k]));
              if (a.relu) t = fmaxf(t, 0.f);
              e[k] = __float2bfloat16_rn(t);
            }
          }
          if (mul) {
            const uint4 mv = *reinterpret_cast<const uint4*>(a.mul0 + vox * ci + c);
            const bf16* m = reinterpret_cast<const bf16*>(&mv);
#pragma unroll
            for (int k = 0; k < 8; ++k)
              e[k] = __float2bfloat16_rn(__bfloat162float(e[k]) * __bfloat162float(m[k]));
          }
        }
        *reinterpret_cast<uint4*>(tile + ((kz * kIH + ih) * kIW + iw) * kLD + v8 * 8) = v;
      }
      __syncthreads();
      // ---- 27 taps x 2 k-steps of 16 channels on the tensor cores -----
      for (int tap = 0; tap < 27; ++tap) {
        const int kz = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
#pragma unroll
        for (int ks = 0; ks < kCK / 16; ++ks) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[NF];
          const bf16* wp = a.w + ((size_t)tap * a.ci_total + coff + c0 + ks * 16) * co;
#pragma unroll
          for (int j = 0; j < NF; ++j) wmma::load_matrix_sync(bfr[j], wp + j * 16, co);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // warp's fragment i: output row warp*2 + i/2, columns (i%2)*16..+16
            const int oh = warp * 2 + (i >> 1), ow = (i & 1) * 16;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
            wmma::load_matrix_sync(
                afr, tile + ((kz * kIH + oh + kh) * kIW + ow + kw) * kLD + ks * 16, kLD);
#pragma unroll
            for (int j = 0; j < NF; ++j) wmma::mma_sync(acc[i][j], afr, bfr[j], acc[i][j]);
          }
        }
      }
    }
    coff += ci;
  }

  // ---- epilogue: accumulators -> smem -> bf16 halo layout + stats -----
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);   // (kTH * kTW, co)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(
          stage + ((warp * 2 + (i >> 1)) * kTW + (i & 1) * 16) * co + j * 16,
          acc[i][j], co, wmma::mem_row_major);
  __syncthreads();

  // The block writes its tile and, at the volume's edges, the adjacent
  // halo (zeros): the blocks' boxes partition the whole output, so the
  // output needs no separate clearing.
  const int dlo = d == 0 ? 0 : d + 1, dhi = d == a.D - 1 ? a.D + 1 : d + 1;
  const int hlo = h0 == 0 ? 0 : h0 + 1, hhi = h0 + kTH >= a.H ? a.H + 1 : h0 + kTH;
  const int wlo = w0 == 0 ? 0 : w0 + 1, whi = w0 + kTW >= a.W ? a.W + 1 : w0 + kTW;
  const int nh = hhi - hlo + 1, nw = whi - wlo + 1;
  constexpr int pairs = co / 2;   // divides kThreads: a thread keeps its pair
  const int items = (dhi - dlo + 1) * nh * nw * pairs;
  float s1x = 0.f, s1y = 0.f, s2x = 0.f, s2y = 0.f;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int cp = it % pairs;
    int p = it / pairs;
    const int pw = wlo + p % nw;
    p /= nw;
    const int ph = hlo + p % nh;
    const int pd = dlo + p / nh;
    __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (pd >= 1 && pd <= a.D && ph >= 1 && ph <= a.H && pw >= 1 && pw <= a.W) {
      const float* s = stage + ((ph - 1 - h0) * kTW + (pw - 1 - w0)) * co + 2 * cp;
      v = __floats2bfloat162_rn(s[0], s[1]);
      const float2 f = __bfloat1622float2(v);
      s1x += f.x;
      s1y += f.y;
      s2x += f.x * f.x;
      s2y += f.y * f.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(
        a.y + ((((size_t)b * Dp + pd) * Hp + ph) * Wp + pw) * co + 2 * cp) = v;
  }
  if (a.stats != nullptr) {
    const int cp = threadIdx.x % pairs;
    atomicAdd(&red[0][2 * cp], s1x);
    atomicAdd(&red[0][2 * cp + 1], s1y);
    atomicAdd(&red[1][2 * cp], s2x);
    atomicAdd(&red[1][2 * cp + 1], s2y);
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * co; i += kThreads)
      atomicAdd(a.stats + ((size_t)b * 2 + i / co) * co + i % co, red[i / co][i % co]);
  }
}

template <int NF>
int launch(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<NF>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_wt = (a.W + kTW - 1) / kTW, n_ht = (a.H + kTH - 1) / kTH;
  conv_kernel<NF><<<dim3(n_wt * n_ht, a.D, B), kThreads, kTileBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x1 may be null (one input, ci1 = 0); scale/shift/mul0/stats may be
// null. The caller checks shapes: ci0, ci1 multiples of 32; co 16, 32 or
// 64; every pointer 16 B aligned. Returns the launch's cudaError_t.
extern "C" int ps2d_conv3d(const void* x0, const void* x1, int ci0, int ci1,
                           const void* w, const void* scale, const void* shift,
                           int relu, const void* mul0, void* y, void* stats,
                           int B, int D, int H, int W, int co, void* stream) {
  Args a;
  a.x[0] = static_cast<const bf16*>(x0);
  a.x[1] = static_cast<const bf16*>(x1);
  a.ci[0] = ci0;
  a.ci[1] = ci1;
  a.n_in = x1 != nullptr ? 2 : 1;
  a.ci_total = ci0 + (x1 != nullptr ? ci1 : 0);
  a.w = static_cast<const bf16*>(w);
  a.scale = static_cast<const bf16*>(scale);
  a.shift = static_cast<const bf16*>(shift);
  a.relu = relu;
  a.mul0 = static_cast<const bf16*>(mul0);
  a.y = static_cast<bf16*>(y);
  a.stats = static_cast<float*>(stats);
  a.D = D;
  a.H = H;
  a.W = W;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (co) {
    case 16: return launch<1>(a, B, s);
    case 32: return launch<2>(a, B, s);
    case 64: return launch<4>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ps2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
