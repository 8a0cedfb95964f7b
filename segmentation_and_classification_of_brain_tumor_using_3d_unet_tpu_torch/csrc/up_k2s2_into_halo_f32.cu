// K2 in float32: the ConvTranspose(k=2^3, s=2^3) of the decoder-last up,
// plus its bias, written straight into the halo layout, for f32 tensors.
//
// Replaces the float32 form of the Pallas kernel behind ops/pallas/ps2d.py::
// up_k2s2_into_flat (ps2d.py:228) of the JAX package, which takes its
// weights in x.dtype with no bf16 rounding (:256) and an f32 bias (:259).
// The bf16 form (up_k2s2_into_halo.cu) is a separate source.
//
// What it computes: the GEMM x (R, ci) @ w (ci, 8 co) + bias, R = B * D2 *
// H2 * W2 input voxels, with the column n = k co + o of phase k = (a * 2 +
// p) * 2 + q (the flipped flax tap, arranged by the wrapper) and output
// channel o landing at voxel (2 d + a + 1, 2 h + p + 1, 2 w + q + 1) of y
// (B, 2 D2 + 2, 2 H2 + 2, 2 W2 + 2, co); f32 FMAs over ci in a fixed order,
// then the bias added once. A second kernel writes the halo's zeros.
//
// Bound on the H100: at the main path's level 0 ((4, 64^3, 64) -> (4,
// 130^3, 32)) it reads 0.27 GB and writes 1.13 GB, against 34 GFLOP: about
// 0.42 ms of bytes and 0.51 ms of f32 FMAs, near the balance point of the
// two. Design: a register-blocked SIMT GEMM (a block tile of 64 rows x 128
// columns, K chunks of 16 staged in shared memory, 4 x 8 outputs a
// thread), whose epilogue scatters each thread's 16 B column groups into
// the interleaved halo layout: a warp's 16 column groups cover two phases'
// channels of one voxel pair, adjacent in W, so its stores are whole lines.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 128, kBK = 16;

__global__ void __launch_bounds__(kThreads)
    up_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ y, int R, int D2, int H2,
                  int W2, int ci, int co) {
  __shared__ __align__(16) float As[kBK][kBM + 4];   // k-major
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int nc = 8 * co;
  const int r0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, ng = tid % 16, mg = tid / 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < ci; k0 += kBK) {
    {   // A: 64 rows x 16 channels, one float4 a thread, stored transposed
      const int r = tid >> 2, kq = (tid & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < R && k0 + kq < ci)
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(r0 + r) * ci + k0 + kq));
      As[kq][r] = v.x;
      As[kq + 1][r] = v.y;
      As[kq + 2][r] = v.z;
      As[kq + 3][r] = v.w;
    }
    // B: 16 channels x 128 columns, two float4s a thread
    for (int i = tid; i < kBK * kBN / 4; i += kThreads) {
      const int k = i / (kBN / 4), nq = (i % (kBN / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + k < ci && n0 + nq < nc)
        v = __ldg(reinterpret_cast<const float4*>(w + (size_t)(k0 + k) * nc + n0 + nq));
      *reinterpret_cast<float4*>(&Bs[k][nq]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][4 * mg]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][4 * ng]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + 4 * ng]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int Dp = 2 * D2 + 2, Hp = 2 * H2 + 2, Wp = 2 * W2 + 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * mg + i;
    if (row >= R) continue;
    const int wv = row % W2, t1 = row / W2, hv = t1 % H2, t2 = t1 / H2, dv = t2 % D2,
              b = t2 / D2;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int n = n0 + 4 * ng + 64 * g;
      if (n >= nc) continue;
      const int k = n / co, o = n - k * co;   // co % 4 == 0: one phase a group
      const int pa = k >> 2, pp = (k >> 1) & 1, pq = k & 1;
      float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                             acc[i][4 * g + 3]);
      if (bias != nullptr) {
        const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + o));
        v.x += bb.x;
        v.y += bb.y;
        v.z += bb.z;
        v.w += bb.w;
      }
      const size_t vox = (((size_t)b * Dp + 2 * dv + pa + 1) * Hp + 2 * hv + pp + 1) * Wp +
                         2 * wv + pq + 1;
      *reinterpret_cast<float4*>(y + vox * co + o) = v;
    }
  }
}

// The halo of y (B, Dp, Hp, Wp, co): one warp a (b, pd, ph) row, the
// whole row where pd or ph is on the halo, else its two end voxels.
__global__ void __launch_bounds__(kThreads)
    halo_zero_kernel(float* __restrict__ y, int rows, int Dp, int Hp, int Wp, int co) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int ph = row % Hp, pd = (row / Hp) % Dp;
  float4* base = reinterpret_cast<float4*>(y + (size_t)row * Wp * co);
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const int q = co / 4;
  if (pd == 0 || pd == Dp - 1 || ph == 0 || ph == Hp - 1) {
    for (int i = lane; i < Wp * q; i += 32) base[i] = z;
  } else {
    for (int i = lane; i < 2 * q; i += 32) base[i < q ? i : (Wp - 2) * q + i] = z;
  }
}

bool valid(int B, int D2, int H2, int W2, int ci, int co) {
  return B >= 1 && D2 >= 1 && H2 >= 1 && W2 >= 1 && ci >= 8 && co >= 8 && ci % 8 == 0 &&
         co % 8 == 0 && (long)B * D2 * H2 * W2 <= 0x7fffffffL &&
         (long)B * (2 * D2 + 2) * (2 * H2 + 2) <= 0x7fffffffL;
}

}  // namespace

// x (B, D2, H2, W2, ci) f32; w (ci, 8 co) f32, column k co + o the phase-k
// tap of output channel o (k = (a * 2 + p) * 2 + q, the flax kernel
// flipped); bias (co) f32 or null; y (B, 2 D2 + 2, 2 H2 + 2, 2 W2 + 2, co)
// f32. ci and co multiples of 8, every pointer 16 B aligned (checked by
// the caller). Returns the launches' cudaError_t.
extern "C" int up_k2s2_into_halo_f32(const void* x, const void* w, const void* bias, void* y,
                                     int B, int D2, int H2, int W2, int ci, int co,
                                     void* stream) {
  if (!valid(B, D2, H2, W2, ci, co)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = B * D2 * H2 * W2;
  float* yf = static_cast<float*>(y);
  up_f32_kernel<<<dim3((R + kBM - 1) / kBM, (8 * co + kBN - 1) / kBN), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), yf, R, D2, H2, W2, ci, co);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = B * (2 * D2 + 2) * (2 * H2 + 2);
  halo_zero_kernel<<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(
      yf, rows, 2 * D2 + 2, 2 * H2 + 2, 2 * W2 + 2, co);
  return (int)cudaGetLastError();
}
