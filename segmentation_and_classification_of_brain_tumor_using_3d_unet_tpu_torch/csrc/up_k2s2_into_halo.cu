// K2: ConvTranspose3d, kernel 2 and stride 2, with bias, written straight
// into the halo layout that the K1 conv reads.
//
// Replaces the Pallas kernel behind ops/pallas/ps2d.py::up_k2s2_into_flat
// (kernel body `_up_flat_kernel`, ps2d.py:212-225) of the JAX package.
// Output voxel (2d+a, 2h+p, 2w+q) is x[d, h, w] @ wk[a, p, q] + bias with
// f32 accumulation and one rounding to bf16, where wk is the kernel
// already flipped to flax's convention by the caller; the one-voxel
// halo around the (2D2, 2H2, 2W2) volume is written as zeros.
//
// Bound on the H100: at the main path's shape (x (4, 64^3, 64) -> out
// (4, 130^3, 32)) the kernel does 34 GFLOP against 0.70 GB of HBM
// traffic (50 FLOP per byte, far below the card's ~295 balance point):
// it is bound by bytes, mostly the output's. Design for that: one thread
// per (output voxel, 8 channels) stores one 16 B vector, so a warp writes
// 512 contiguous bytes; the 8 phases' weights (32 KB) and the input row
// of each voxel stay in L1, so HBM sees each input and output byte about
// once. The f32 dot runs on the CUDA cores, not the tensor cores: it is
// not what bounds the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
          const float* __restrict__ bias, bf16* __restrict__ y, int D2,
          int H2, int W2, int ci, int co, long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int groups = co / 8;
  const int g = (int)(idx % groups);
  long long p = idx / groups;
  const int Wp = 2 * W2 + 2, Hp = 2 * H2 + 2, Dp = 2 * D2 + 2;
  const int pw = (int)(p % Wp);
  p /= Wp;
  const int ph = (int)(p % Hp);
  p /= Hp;
  const int pd = (int)(p % Dp);
  const int b = (int)(p / Dp);
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (pd >= 1 && pd <= 2 * D2 && ph >= 1 && ph <= 2 * H2 && pw >= 1 && pw <= 2 * W2) {
    const int od = pd - 1, oh = ph - 1, ow = pw - 1;
    const int k = ((od & 1) * 2 + (oh & 1)) * 2 + (ow & 1);
    const bf16* xr = x + ((((size_t)b * D2 + (od >> 1)) * H2 + (oh >> 1)) * W2 + (ow >> 1)) * ci;
    const bf16* wk = w + (size_t)k * ci * co + g * 8;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = bias != nullptr ? bias[g * 8 + j] : 0.f;
    for (int c = 0; c < ci; c += 8) {
      const uint4 xv = __ldg(reinterpret_cast<const uint4*>(xr + c));
      const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float xs = __bfloat162float(xe[t]);
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wk + (size_t)(c + t) * co));
        const bf16* we = reinterpret_cast<const bf16*>(&wv);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaf(xs, __bfloat162float(we[j]), acc[j]);
      }
    }
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16_rn(acc[j]);
  }
  // idx enumerates (halo voxel, channel group), so its 8-channel vector
  // sits at idx * 8
  *reinterpret_cast<uint4*>(y + idx * 8) = out;
}

}  // namespace

// x (B, D2, H2, W2, ci) bf16; w (8, ci, co) bf16, phase k = (a*2+p)*2+q,
// already flipped; bias (co) f32 or null; y (B, 2D2+2, 2H2+2, 2W2+2, co)
// bf16. ci and co multiples of 8, pointers 16 B aligned (checked by the
// caller). Returns the launch's cudaError_t.
extern "C" int up_k2s2_into_halo(const void* x, const void* w, const void* bias,
                                 void* y, int B, int D2, int H2, int W2, int ci,
                                 int co, void* stream) {
  const long long total =
      (long long)B * (2 * D2 + 2) * (2 * H2 + 2) * (2 * W2 + 2) * (co / 8);
  const long long blocks = (total + kThreads - 1) / kThreads;
  up_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y), D2, H2, W2, ci, co,
      total);
  return (int)cudaGetLastError();
}
