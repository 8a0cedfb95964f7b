// K7: bias-free 3x3x3 SAME conv of an unpadded channels-last bf16 tensor,
// bf16 in, f32 accumulation, one rounding to bf16 out:
//   y[b, d, h, w, o] = sum over taps t, channels c of
//                      x[b, (d, h, w) + t - 1, c] * w[t, c, o]
// with x taken as 0 outside the volume. x (B, D, H, W, ci), w (27, ci, co)
// (DHWIO), y (B, D, H, W, co); ci and co multiples of 32.
//
// Replaces the Pallas kernel behind ops/pallas/conv3d.py::wtile_conv3d
// (kernel body `_kernel` :128-291) of the JAX package. Same function, not
// the same blocks: the TPU kernel packs Tw width positions into a
// block-Toeplitz weight matrix (`build_wbig`) to fill its 128 lanes and
// streams depth slices through a VMEM ring; here nothing is repacked.
// Unlike K1 (ps2d_conv3d.cu), which reads the halo layout, this kernel
// reads the unpadded tensor: the input tile is zero-filled at the volume's
// D, H and W borders as it lands in shared memory, so there is no padded
// copy and no separate pad pass.
//
// Bound on the H100: at benchmarks/bench_wtile.py's shapes the conv does
// 27 * 2 * ci * co FLOPs per voxel against 2 * (ci + co) bytes, from about
// 430 FLOP per byte (32 -> 32) upwards, above the card's ~295 balance
// point: bound by tensor-core operations. Design for that, as K1: implicit
// GEMM on warp-level wmma (bf16 in, f32 accumulate). A block stages a
// (3, TH+2, TW+2) voxel x 32 channel input tile once in shared memory and
// reuses it for all 27 taps of its TH x TW output voxels of one depth
// slice; each of its 4 warps holds a 64 voxel x CT accumulator in
// registers. Input channels are taken 32 at a time (a 64 x 512 accumulator
// would not fit in registers); output channels in tiles of CT = 64 (32
// when co % 64 != 0) on a grid axis. The block is 8 x 32 voxels, or
// 16 x 16 where that wastes fewer of them on a narrow volume (W = 10 at
// 15 x 15 x 10: 256 slots for 150 voxels against 512). Simple first: no
// TMA, no wgmma, no pipelining of the next chunk's load behind the math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kCK = 32;          // input channels per staged chunk
constexpr int kLD = kCK + 16;    // smem voxel pitch: 96 B keeps wmma's
                                 // 32 B alignment, 2-way bank conflicts
constexpr int kWarps = 4, kThreads = 32 * kWarps;

template <int TH, int TW>
constexpr int tile_bytes() {
  return 3 * (TH + 2) * (TW + 2) * kLD * (int)sizeof(bf16);
}

struct Args {
  const bf16* x;   // (B, D, H, W, ci)
  const bf16* w;   // (27, ci, co)
  bf16* y;         // (B, D, H, W, co)
  int D, H, W, ci, co;
};

// TH x TW output voxels of one depth slice (TH * TW = 256: 4 warps of 4
// fragments of 16 voxels along W); output-channel tile CT = 16 * NF;
// kOneTile: co == CT (co then a compile-time constant)
template <int TH, int TW, int NF, bool kOneTile>
__global__ void __launch_bounds__(kThreads) conv_kernel(const Args a) {
  static_assert(TH * TW == 256 && TW % 16 == 0, "4 warps x 4 fragments");
  constexpr int IH = TH + 2, IW = TW + 2;
  constexpr int CT = 16 * NF;
  constexpr int kFragsPerRow = TW / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tile = reinterpret_cast<bf16*>(smem);   // (3, IH, IW, kLD)

  const int co = kOneTile ? CT : a.co;
  const unsigned n_ct = co / CT;
  const int co0 = kOneTile ? 0 : (int)(blockIdx.x % n_ct) * CT;
  // spatial tile index kept unsigned (K1's lesson: a signed division put
  // the tile origin in local memory)
  const unsigned sp = kOneTile ? blockIdx.x : blockIdx.x / n_ct;
  const unsigned n_wt = (a.W + TW - 1) / TW;
  const int w0 = (int)(sp % n_wt) * TW;
  const int h0 = (int)(sp / n_wt) * TH;
  const int d = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][NF];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int c0 = 0; c0 < a.ci; c0 += kCK) {
    __syncthreads();   // the previous chunk's tile is no longer read
    // ---- stage the input tile, 8 channels (16 B) per item, zeros outside
    constexpr int kVec = kCK / 8;
    for (int it = threadIdx.x; it < 3 * IH * IW * kVec; it += kThreads) {
      const int v8 = it % kVec;
      int p = it / kVec;
      const int iw = p % IW;
      p /= IW;
      const int ih = p % IH;
      const int kz = p / IH;
      const int gd = d + kz - 1, gh = h0 + ih - 1, gw = w0 + iw - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if ((unsigned)gd < (unsigned)a.D && (unsigned)gh < (unsigned)a.H &&
          (unsigned)gw < (unsigned)a.W) {
        const size_t vox = (((size_t)b * a.D + gd) * a.H + gh) * a.W + gw;
        v = __ldg(reinterpret_cast<const uint4*>(a.x + vox * a.ci + c0) + v8);
      }
      *reinterpret_cast<uint4*>(tile + ((kz * IH + ih) * IW + iw) * kLD + v8 * 8) = v;
    }
    __syncthreads();
    // ---- 27 taps x 2 k-steps of 16 channels on the tensor cores --------
    for (int tap = 0; tap < 27; ++tap) {
      const int kz = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
#pragma unroll
      for (int ks = 0; ks < kCK / 16; ++ks) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[NF];
        const bf16* wp = a.w + ((size_t)tap * a.ci + c0 + ks * 16) * co + co0;
#pragma unroll
        for (int j = 0; j < NF; ++j) wmma::load_matrix_sync(bfr[j], wp + j * 16, co);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // warp's fragment i: output row oh, columns ow..ow+16
          const int oh = warp * (TH / 4) + i / kFragsPerRow;
          const int ow = (i % kFragsPerRow) * 16;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afr;
          wmma::load_matrix_sync(
              afr, tile + ((kz * IH + oh + kh) * IW + ow + kw) * kLD + ks * 16, kLD);
#pragma unroll
          for (int j = 0; j < NF; ++j) wmma::mma_sync(acc[i][j], afr, bfr[j], acc[i][j]);
        }
      }
    }
  }

  // ---- epilogue: accumulators -> smem (f32) -> bf16, inside the volume --
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);   // (TH * TW, CT)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oh = warp * (TH / 4) + i / kFragsPerRow;
    const int ow = (i % kFragsPerRow) * 16;
#pragma unroll
    for (int j = 0; j < NF; ++j)
      wmma::store_matrix_sync(stage + (oh * TW + ow) * CT + j * 16, acc[i][j], CT,
                              wmma::mem_row_major);
  }
  __syncthreads();
  constexpr int kOct = CT / 8;   // 16 B output vectors per voxel
  for (int it = threadIdx.x; it < TH * TW * kOct; it += kThreads) {
    const int o8 = it % kOct, v = it / kOct;
    const int h = h0 + v / TW, w = w0 + v % TW;
    if (h >= a.H || w >= a.W) continue;
    const float* s = stage + v * CT + o8 * 8;
    uint4 u;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = __floats2bfloat162_rn(s[2 * k], s[2 * k + 1]);
    const size_t vox = (((size_t)b * a.D + d) * a.H + h) * a.W + w;
    *reinterpret_cast<uint4*>(a.y + vox * co + co0 + o8 * 8) = u;
  }
}

template <int TH, int TW, int NF, bool kOneTile>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = tile_bytes<TH, TW>();
  static_assert(smem >= TH * TW * 16 * NF * (int)sizeof(float),
                "the epilogue's f32 stage fits in the input tile");
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<TH, TW, NF, kOneTile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  const int n_wt = (a.W + TW - 1) / TW, n_ht = (a.H + TH - 1) / TH;
  const int n_ct = a.co / (16 * NF);
  conv_kernel<TH, TW, NF, kOneTile>
      <<<dim3(n_wt * n_ht * n_ct, a.D, B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int TH, int TW>
int launch_co(const Args& a, int B, cudaStream_t s) {
  if (a.co == 32) return launch<TH, TW, 2, true>(a, B, s);
  if (a.co == 64) return launch<TH, TW, 4, true>(a, B, s);
  if (a.co % 64 == 0) return launch<TH, TW, 4, false>(a, B, s);
  return launch<TH, TW, 2, false>(a, B, s);
}

int padded(int n, int t) { return (n + t - 1) / t * t; }

}  // namespace

// x (B, D, H, W, ci), w (27, ci, co), y (B, D, H, W, co), all bf16; ci and
// co positive multiples of 32; x and y 16 B aligned, w 32 B aligned.
// Returns the launch's cudaError_t.
extern "C" int conv3d_same(const void* x, const void* w, void* y, int B,
                           int D, int H, int W, int ci, int co, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || ci < 1 || co < 1 || ci % 32 ||
      co % 32 || B > 65535 || D > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.y = static_cast<bf16*>(y);
  a.D = D;
  a.H = H;
  a.W = W;
  a.ci = ci;
  a.co = co;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the block shape that leaves fewer output slots empty at the borders
  if (padded(H, 16) * padded(W, 16) < padded(H, 8) * padded(W, 32))
    return launch_co<16, 16>(a, B, s);
  return launch_co<8, 32>(a, B, s);
}
