// K4: 2x2x2 stride-2 max pool of a halo-layout tensor (bf16 or f32),
// written straight into the next level's halo layout.
//
// Replaces the Pallas kernel behind ops/pallas/ps2d.py::pool_into_flat
// (kernel body `_pool_flat_kernel`, ps2d.py:286-313) of the JAX package,
// whose input and output are the TPU's packed flat forms instead.
// x (B, D+2, H+2, W+2, C) -> y (B, D/2+2, H/2+2, W/2+2, C): the interior
// voxel (d, h, w) of y is the max of the 8 interior voxels
// (2d+a, 2h+p, 2w+q) of x; the one-voxel halo of y is exact zeros. Max is
// exact, so the result is bit-equal to the plain version (NaN propagates,
// as torch's and XLA's max do).
//
// Bound on the H100: pure data movement, so bound by bytes: each input
// byte read once, each output byte written once (0.61 GB at the main
// path's (4, 130^3, 32) -> (4, 66^3, 32) bf16 shape, 0.18 ms at 3.35
// TB/s; twice that in f32). Design for that, as K3: one thread per 16 B
// output vector (8 bf16 or 4 f32 channels); the 8 loads of a thread are
// 16 B each, and neighbouring
// threads read neighbouring channel groups and voxels two apart, so a
// warp's loads touch whole 32 B sectors; halo threads store zeros
// without loading.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// elementwise max of two 16 B vectors of T, NaN propagating
template <typename T>
__device__ __forceinline__ uint4 max8(uint4 a, uint4 b);

template <>
__device__ __forceinline__ uint4 max8<__nv_bfloat16>(uint4 a, uint4 b) {
  __nv_bfloat162* pa = reinterpret_cast<__nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int k = 0; k < 4; ++k) pa[k] = __hmax2_nan(pa[k], pb[k]);
  return a;
}

template <>
__device__ __forceinline__ uint4 max8<float>(uint4 a, uint4 b) {
  float* pa = reinterpret_cast<float*>(&a);
  const float* pb = reinterpret_cast<const float*>(&b);
#pragma unroll
  for (int k = 0; k < 4; ++k) pa[k] = pa[k] != pa[k] || pa[k] > pb[k] ? pa[k] : pb[k];
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int D, int H,
            int W, int groups, long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int D2 = D / 2, H2 = H / 2, W2 = W / 2;
  const int g = (int)(idx % groups);
  long long p = idx / groups;
  const int pw = (int)(p % (W2 + 2));
  p /= W2 + 2;
  const int ph = (int)(p % (H2 + 2));
  p /= H2 + 2;
  const int pd = (int)(p % (D2 + 2));
  const long long b = p / (D2 + 2);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (pd >= 1 && pd <= D2 && ph >= 1 && ph <= H2 && pw >= 1 && pw <= W2) {
    const int Hp = H + 2, Wp = W + 2;
    // input halo coordinates of the window's first voxel
    const int id = 2 * pd - 1, ih = 2 * ph - 1, iw = 2 * pw - 1;
    const long long base = ((b * (D + 2) + id) * Hp + ih) * Wp + iw;
    bool first = true;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint4 t =
              __ldg(x + ((base + ((long long)a * Hp + r) * Wp + q) * groups + g));
          v = first ? t : max8<T>(v, t);
          first = false;
        }
  }
  y[idx] = v;
}

template <typename T>
int launch(const void* x, void* y, int B, int D, int H, int W, int C, cudaStream_t stream) {
  const int groups = C / (16 / (int)sizeof(T));   // 16 B vectors a voxel
  const long long total =
      (long long)B * (D / 2 + 2) * (H / 2 + 2) * (W / 2 + 2) * groups;
  const long long blocks = (total + kThreads - 1) / kThreads;
  pool_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), D, H, W, groups, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, D+2, H+2, W+2, C) halo layout, y (B, D/2+2, H/2+2, W/2+2, C), both
// bf16 (x_bf16 != 0) or both f32; D, H, W even, C a multiple of 8, both
// pointers 16 B aligned (checked by the caller). Returns the launch's
// cudaError_t.
extern "C" int pool_into_halo(const void* x, int x_bf16, void* y, int B, int D, int H,
                              int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, y, B, D, H, W, C, s)
                : launch<float>(x, y, B, D, H, W, C, s);
}
