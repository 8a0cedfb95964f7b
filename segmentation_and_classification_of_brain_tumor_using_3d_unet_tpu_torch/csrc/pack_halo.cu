// K3: relayout of an NDHWC tensor (bf16 or f32) into the halo layout
// (B, D+2, H+2, W+2, C) that the K1 conv reads: the data in the interior,
// exact zeros in the one-voxel halo.
//
// Replaces the Pallas kernel behind ops/pallas/ps2d.py::pack_flat_fast
// (kernel body `_pack_flat_kernel`, ps2d.py:157-164) of the JAX package,
// whose target is the TPU's packed flat form instead.
//
// Bound on the H100: pure data movement, so bound by bytes: each input
// byte read once, each output byte written once (1.10 GB at the main
// path's (4, 128^3, 32) bf16 shape, 0.33 ms at 3.35 TB/s; twice that in
// f32). Design for that: one thread per 16 B output vector (8 bf16 or 4
// f32 channels), consecutive threads on consecutive addresses for both the
// load and the store; halo threads store zeros without loading. The kernel
// moves 16 B vectors whatever they hold: the element type only sets how
// many vectors a voxel has.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int D, int H,
            int W, int groups, long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int g = (int)(idx % groups);
  long long p = idx / groups;
  const int Wp = W + 2, Hp = H + 2, Dp = D + 2;
  const int pw = (int)(p % Wp);
  p /= Wp;
  const int ph = (int)(p % Hp);
  p /= Hp;
  const int pd = (int)(p % Dp);
  const long long b = p / Dp;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (pd >= 1 && pd <= D && ph >= 1 && ph <= H && pw >= 1 && pw <= W)
    v = __ldg(x + (((b * D + (pd - 1)) * H + (ph - 1)) * W + (pw - 1)) * groups + g);
  y[idx] = v;
}

template <typename T>
int launch(const void* x, void* y, int B, int D, int H, int W, int C, cudaStream_t stream) {
  const int groups = C / (16 / (int)sizeof(T));   // 16 B vectors a voxel
  const long long total = (long long)B * (D + 2) * (H + 2) * (W + 2) * groups;
  const long long blocks = (total + kThreads - 1) / kThreads;
  pack_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), D, H, W, groups, total);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, D, H, W, C), y (B, D+2, H+2, W+2, C), both bf16 (x_bf16 != 0) or
// both f32; C a multiple of 8 and both pointers 16 B aligned (checked by
// the caller). Returns the launch's cudaError_t.
extern "C" int pack_halo(const void* x, int x_bf16, void* y, int B, int D, int H, int W,
                         int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, y, B, D, H, W, C, s)
                : launch<float>(x, y, B, D, H, W, C, s);
}
