// K7 in float32: the bias-free 3x3x3 SAME conv of an unpadded
// channels-last f32 tensor, f32 FMAs, f32 out:
//   y[b, d, h, w, o] = sum over taps t, channels c of
//                      x[b, (d, h, w) + t - 1, c] * w[t, c, o]
// with x taken as 0 outside the volume. x (B, D, H, W, ci), w (27, ci, co)
// f32 (DHWIO, not rounded: JAX casts w to x.dtype, conv3d.py:346), y (B, D,
// H, W, co); ci and co multiples of 32.
//
// Replaces the float32 form of the Pallas kernel behind ops/pallas/conv3d.py
// ::wtile_conv3d (conv3d.py:338; JAX tests it in f32, tests/test_pallas.py
// :76-81), and with the taps flipped and ci, co swapped its VJP's data
// gradient (:365). The bf16 form (conv3d_same.cu) is a separate source.
//
// Bound on the H100 and design: simt_conv_f32.cuh, its tile loop. It
// reads the unpadded tensor: the staged box is zero-filled at the volume's
// D, H and W borders, and it writes the patch's voxels inside the volume,
// nothing else.
#include <cuda_runtime.h>
#include <stdint.h>

#include "simt_conv_f32.cuh"

namespace {

using namespace simt_f32;

template <int TN>
__global__ void __launch_bounds__(kThreads, 2)
    conv_same_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ y, int D, int H, int W, int ci, int co,
                         const Patch t) {
  constexpr int N = 8 * TN;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* ws = tile + kKC * t.P;
  int* vox_tab = reinterpret_cast<int*>(ws + 27 * kKC * N);

  const int n_ct = co / N;
  const unsigned bx = blockIdx.x;
  const int co0 = (int)(bx % (unsigned)n_ct) * N;
  const unsigned sp = bx / (unsigned)n_ct;
  const int w0 = (int)(sp % (unsigned)t.n_wt) * t.TW;
  const int h0 = (int)(sp / (unsigned)t.n_wt) * t.TH;
  const int d0 = (int)blockIdx.y * t.TD, b = blockIdx.z;
  const int tid = threadIdx.x, ng = tid % 8, mg = tid / 8;
  const int plane = t.IH * t.IW;

  // the box's voxels: each one's index in x, or -1 outside the volume
  for (int p = tid; p < t.box; p += kThreads) {
    const int kz = p / plane, q = p - kz * plane, ih = q / t.IW, iw = q - ih * t.IW;
    const int gd = d0 + kz - 1, gh = h0 + ih - 1, gw = w0 + iw - 1;
    const bool in = (unsigned)gd < (unsigned)D && (unsigned)gh < (unsigned)H &&
                    (unsigned)gw < (unsigned)W;
    vox_tab[p] = in ? ((b * D + gd) * H + gh) * W + gw : -1;
  }
  __syncthreads();

  const Run r = run_of(t, mg);
  const int col = TN == 2 ? 2 * ng : 4 * ng;
  float acc[kRun][TN];
#pragma unroll
  for (int i = 0; i < kRun; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < ci; c0 += kKC) {
    stage_tile(tile, t, [&](int p, int h) {
      const int vox = vox_tab[p];
      return vox < 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                     : __ldg(reinterpret_cast<const float4*>(x + (size_t)vox * ci + c0 + 4 * h));
    });
    stage_weights<N>(ws, w, ci, co, co0, c0);
    __syncthreads();
    chunk_product<TN>(acc, tile, ws, t, r.a_off, col);
    __syncthreads();
  }

  const int gd = d0 + r.od, gh = h0 + r.oh;
  if (gd >= D || gh >= H) return;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int gw = w0 + r.ow0 + i;
    if (gw >= W) continue;
    float* out = y + ((((size_t)b * D + gd) * H + gh) * W + gw) * co + co0 + col;
#pragma unroll
    for (int s = 0; s < TN / 4; ++s)
      *reinterpret_cast<float4*>(out + 32 * s) =
          make_float4(acc[i][4 * s], acc[i][4 * s + 1], acc[i][4 * s + 2], acc[i][4 * s + 3]);
  }
}

int n_of(int co) { return co % 64 == 0 ? 64 : 32; }

bool valid(int B, int D, int H, int W, int ci, int co) {
  return B >= 1 && D >= 1 && H >= 1 && W >= 1 && ci >= 32 && co >= 32 && ci % 32 == 0 &&
         co % 32 == 0 && B <= 65535 && D <= 65535 && (long)B * D * H * W <= 0x7fffffffL;
}

template <int TN>
int launch(const float* x, const float* w, float* y, int B, int D, int H, int W, int ci, int co,
           const Patch& t, cudaStream_t stream) {
  const int smem = smem_bytes(t, 8 * TN);
  cudaError_t err = cudaFuncSetAttribute(conv_same_f32_kernel<TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_same_f32_kernel<TN><<<dim3(t.n_wt * t.n_ht * (co / (8 * TN)), t.n_dt, B), kThreads, smem,
                             stream>>>(x, w, y, D, H, W, ci, co, t);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, D, H, W, ci) f32, w (27, ci, co) f32, y (B, D, H, W, co) f32; ci
// and co multiples of 32, every pointer 16 B aligned (checked by the
// caller). Returns the launch's cudaError_t.
extern "C" int conv3d_same_f32(const void* x, const void* w, void* y, int B, int D, int H,
                               int W, int ci, int co, void* stream) {
  if (!valid(B, D, H, W, ci, co)) return (int)cudaErrorInvalidValue;
  const Patch t = choose_patch(D, H, W);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n_of(co) == 64 ? launch<8>(xf, wf, yf, B, D, H, W, ci, co, t, s)
                        : launch<4>(xf, wf, yf, B, D, H, W, ci, co, t, s);
}

// The launch geometry conv3d_same_f32 picks: out[0..5] = N, TD, TH, TW,
// blocks, dynamic shared memory bytes.
extern "C" int conv3d_same_f32_plan(int B, int D, int H, int W, int ci, int co, int* out) {
  if (!valid(B, D, H, W, ci, co)) return (int)cudaErrorInvalidValue;
  const Patch t = choose_patch(D, H, W);
  const int N = n_of(co);
  out[0] = N;
  out[1] = t.TD;
  out[2] = t.TH;
  out[3] = t.TW;
  out[4] = t.n_dt * t.n_ht * t.n_wt * (co / N) * B;
  out[5] = smem_bytes(t, N);
  return 0;
}
