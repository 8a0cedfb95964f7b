// K1 in float32: the bias-free 3x3x3 SAME conv over the halo layout, with
// the on-load input transforms and the output statistics, for f32 tensors.
//
// Replaces the float32 form of the Pallas kernel behind ops/pallas/ps2d.py::
// ps2d_conv3d_flat_multi (ps2d.py:667) of the JAX package, which computes
// in the input's dtype: its weights rounded to bf16 first (pack_w_rot,
// ps2d.py:413-414) and widened back (:709), the affine, the mask and the
// scratch in f32 (:727-746), f32 accumulation. The wrapper rounds the
// weights to bf16 and passes them as f32 values; this kernel takes them as
// they come. The bf16 form (ps2d_conv3d.cu) is a separate source.
//
// What it computes, per output voxel and channel (f32 FMAs, no rounding
// but the FMAs'):
//   y = sum over inputs i, taps t, channels c of  x'_i[vox+t, c] * w[t, off_i+c]
//   affine   x' = relu?( (x * scale[b,c]) + shift[b,c] )   (two roundings)
//   mask     x'_0 = x'_0 * mul0[vox, c]                    (input 0 only)
//   halo     x' = 0 at halo voxels: never loaded, so a cotangent with
//            garbage on its halo (K6's data gradient) passes none of it.
// Two inputs are two ranges of K chunks, input 0's then input 1's. With
// stats it writes, per block, batch item and channel, the sum and the sum
// of squares of its f32 outputs inside the volume into the same per-block
// buffer (B, n_sp, 2, co) as the bf16 form, which the wrapper sums over
// the blocks in a fixed order (no atomics: two runs give the same bits).
// Output in the halo layout: each block writes its patch and, at the
// volume's edges, the adjacent halo as zeros.
//
// Bound on the H100 and design: simt_conv_f32.cuh (f32 FMA-bound at the
// serving shapes; a register-blocked SIMT implicit GEMM).
#include <cuda_runtime.h>
#include <stdint.h>

#include "simt_conv_f32.cuh"

namespace {

using namespace simt_f32;

struct Args {
  const float* x[2];   // halo layout inputs, ci[i] channels each
  int ci[2];
  int n0;              // chunks of input 0; the later chunks are input 1's
  const float* w;      // (27, ci_total, co): DHWIO, bf16-exact values
  const float* scale;  // (B, ci_total) or null
  const float* shift;  // (B, ci_total); set whenever scale is
  int relu;
  const float* mul0;   // (B, D+2, H+2, W+2, ci[0]) or null
  float* y;            // (B, D+2, H+2, W+2, co)
  float* part;         // (B, n_sp, 2, co) per-block sums, or null
  int D, H, W, ci_total, co;
};

__device__ __forceinline__ float4 affine4(float4 v, float4 s, float4 h, bool relu) {
  v.x = __fadd_rn(__fmul_rn(v.x, s.x), h.x);
  v.y = __fadd_rn(__fmul_rn(v.y, s.y), h.y);
  v.z = __fadd_rn(__fmul_rn(v.z, s.z), h.z);
  v.w = __fadd_rn(__fmul_rn(v.w, s.w), h.w);
  if (relu) {
    v.x = fmaxf(v.x, 0.f);
    v.y = fmaxf(v.y, 0.f);
    v.z = fmaxf(v.z, 0.f);
    v.w = fmaxf(v.w, 0.f);
  }
  return v;
}

template <int TN>
__global__ void __launch_bounds__(kThreads, 2) conv_f32_kernel(const Args a, const Patch t) {
  constexpr int N = 8 * TN;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                    // kKC * P
  float* ws = tile + kKC * t.P;          // 27 * kKC * N
  int* vox_tab = reinterpret_cast<int*>(ws + 27 * kKC * N);

  const int n_ct = a.co / N;
  const unsigned bx = blockIdx.x;
  const int co0 = (int)(bx % (unsigned)n_ct) * N;
  const unsigned sp = bx / (unsigned)n_ct;
  const int w0 = (int)(sp % (unsigned)t.n_wt) * t.TW;
  const int h0 = (int)(sp / (unsigned)t.n_wt) * t.TH;
  const int d0 = (int)blockIdx.y * t.TD, b = blockIdx.z;
  const int tid = threadIdx.x, ng = tid % 8, mg = tid / 8;
  const int Dp = a.D + 2, Hp = a.H + 2, Wp = a.W + 2;
  const int plane = t.IH * t.IW;

  // the box's voxels: each one's index in the halo layout, or -1 outside
  // the volume (those positions are staged as zeros and never loaded)
  for (int p = tid; p < t.box; p += kThreads) {
    const int kz = p / plane, q = p - kz * plane, ih = q / t.IW, iw = q - ih * t.IW;
    const int gd = d0 + kz - 1, gh = h0 + ih - 1, gw = w0 + iw - 1;
    const bool in = (unsigned)gd < (unsigned)a.D && (unsigned)gh < (unsigned)a.H &&
                    (unsigned)gw < (unsigned)a.W;
    vox_tab[p] = in ? ((b * Dp + gd + 1) * Hp + gh + 1) * Wp + gw + 1 : -1;
  }
  __syncthreads();

  const Run r = run_of(t, mg);
  const int col = TN == 2 ? 2 * ng : 4 * ng;
  float acc[kRun][TN];
#pragma unroll
  for (int i = 0; i < kRun; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const bool affine = a.scale != nullptr;
  const int n_chunks = a.ci_total / kKC;
  for (int c = 0; c < n_chunks; ++c) {
    const bool in0 = c < a.n0;
    // no dynamic index into Args: it stays in the parameter space
    const int ci = in0 ? a.ci[0] : a.ci[1];
    const float* xc = in0 ? a.x[0] + c * kKC : a.x[1] + (c - a.n0) * kKC;
    const float* mc = in0 && a.mul0 != nullptr ? a.mul0 + c * kKC : nullptr;
    const size_t aff = (size_t)b * a.ci_total + c * kKC;
    stage_tile(tile, t, [&](int p, int h) {
      const int vox = vox_tab[p];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vox < 0) return v;
      v = __ldg(reinterpret_cast<const float4*>(xc + (size_t)vox * ci + 4 * h));
      if (affine)
        v = affine4(v, __ldg(reinterpret_cast<const float4*>(a.scale + aff + 4 * h)),
                    __ldg(reinterpret_cast<const float4*>(a.shift + aff + 4 * h)), a.relu);
      if (mc != nullptr) {
        const float4 m = __ldg(reinterpret_cast<const float4*>(mc + (size_t)vox * ci + 4 * h));
        v.x = __fmul_rn(v.x, m.x);
        v.y = __fmul_rn(v.y, m.y);
        v.z = __fmul_rn(v.z, m.z);
        v.w = __fmul_rn(v.w, m.w);
      }
      return v;
    });
    stage_weights<N>(ws, a.w, a.ci_total, a.co, co0, c * kKC);
    __syncthreads();
    chunk_product<TN>(acc, tile, ws, t, r.a_off, col);
    __syncthreads();
  }

  // ---- the run's voxels inside the volume, TN channels each
  const int gd = d0 + r.od, gh = h0 + r.oh;
  const bool row_in = gd < a.D && gh < a.H;
  float s1[TN], s2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    const int gw = w0 + r.ow0 + i;
    if (!row_in || gw >= a.W) continue;
    float* out = a.y + (((size_t)b * Dp + gd + 1) * Hp + gh + 1) * Wp * a.co +
                 (size_t)(gw + 1) * a.co + co0 + col;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      s1[j] += acc[i][j];
      s2[j] += acc[i][j] * acc[i][j];
    }
    if constexpr (TN == 2) {
      *reinterpret_cast<float2*>(out) = make_float2(acc[i][0], acc[i][1]);
    } else {
#pragma unroll
      for (int s = 0; s < TN / 4; ++s)
        *reinterpret_cast<float4*>(out + 32 * s) =
            make_float4(acc[i][4 * s], acc[i][4 * s + 1], acc[i][4 * s + 2], acc[i][4 * s + 3]);
    }
  }

  // ---- statistics: each run's partial sums, then one thread a channel
  // adds the 32 runs in order and writes the block's sums
  if (a.part != nullptr) {
    float2* red = reinterpret_cast<float2*>(ws);   // (kRuns, N), free now
#pragma unroll
    for (int j = 0; j < TN; ++j) red[mg * N + col_of<TN>(ng, j)] = make_float2(s1[j], s2[j]);
    __syncthreads();
    if (tid < N) {
      float2 sum = red[tid];
      for (int m = 1; m < kRuns; ++m) {
        const float2 u = red[m * N + tid];
        sum.x += u.x;
        sum.y += u.y;
      }
      const unsigned spi = blockIdx.y * (unsigned)(t.n_wt * t.n_ht) + sp;
      float* out = a.part + ((size_t)b * t.n_dt * t.n_ht * t.n_wt + spi) * 2 * a.co + co0 + tid;
      out[0] = sum.x;
      out[a.co] = sum.y;
    }
  }

  // ---- at the volume's edges, the halo next to the patch: zeros
  const int dlo = d0 == 0 ? 0 : d0 + 1, dhi = d0 + t.TD >= a.D ? a.D + 1 : d0 + t.TD;
  const int hlo = h0 == 0 ? 0 : h0 + 1, hhi = h0 + t.TH >= a.H ? a.H + 1 : h0 + t.TH;
  const int wlo = w0 == 0 ? 0 : w0 + 1, whi = w0 + t.TW >= a.W ? a.W + 1 : w0 + t.TW;
  if (dlo == 0 || hlo == 0 || wlo == 0 || dhi == a.D + 1 || hhi == a.H + 1 || whi == a.W + 1) {
    const int nh = hhi - hlo + 1, nw = whi - wlo + 1;
    const int items = (dhi - dlo + 1) * nh * nw * (N / 4);
    for (int i = tid; i < items; i += kThreads) {
      const int q = i % (N / 4), v = i / (N / 4), vh = v / nw;
      const int pw = wlo + (v - vh * nw), ph = hlo + vh % nh, pd = dlo + vh / nh;
      if (pd >= 1 && pd <= a.D && ph >= 1 && ph <= a.H && pw >= 1 && pw <= a.W) continue;
      *reinterpret_cast<float4*>(a.y + (((size_t)b * Dp + pd) * Hp + ph) * Wp * a.co +
                                 (size_t)pw * a.co + co0 + 4 * q) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ------------------------------------------------------------- host
// N = 16 for co = 16, else 64 where co allows, else 32.
int n_of(int co) { return co == 16 ? 16 : co % 64 == 0 ? 64 : 32; }

template <int TN>
int launch(const Args& a, int B, const Patch& t, cudaStream_t stream) {
  const int smem = smem_bytes(t, 8 * TN);
  cudaError_t err = cudaFuncSetAttribute(conv_f32_kernel<TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conv_f32_kernel<TN><<<dim3(t.n_wt * t.n_ht * (a.co / (8 * TN)), t.n_dt, B), kThreads, smem,
                        stream>>>(a, t);
  return (int)cudaGetLastError();
}

bool valid(int B, int D, int H, int W, int ci0, int ci1, int co) {
  return B >= 1 && D >= 1 && H >= 1 && W >= 1 && ci0 >= 32 && ci0 % 32 == 0 && ci1 >= 0 &&
         ci1 % 32 == 0 && (co == 16 || (co > 0 && co % 32 == 0)) && B <= 65535 && D <= 65535 &&
         (long)B * (D + 2) * (H + 2) * (W + 2) <= 0x7fffffffL;
}

}  // namespace

// The f32 form of ps2d_conv3d (ps2d_conv3d.cu), same arguments with f32
// tensors: x1 may be null (one input, ci1 = 0); scale/shift/mul0/stats
// may be null. stats, when given, is the per-block buffer (B, n_sp, 2,
// co) f32 (n_sp from ps2d_conv3d_f32_plan), every value of which the
// launch writes. w holds f32 values (bf16-exact as the wrapper passes
// them). ci0, ci1 multiples of 32; co 16 or a multiple of 32; every
// pointer 16 B aligned. Returns the launch's cudaError_t.
extern "C" int ps2d_conv3d_f32(const void* x0, const void* x1, int ci0, int ci1,
                               const void* w, const void* scale, const void* shift,
                               int relu, const void* mul0, void* y, void* stats,
                               int B, int D, int H, int W, int co, void* stream) {
  if (x1 == nullptr) ci1 = 0;
  if (!valid(B, D, H, W, ci0, ci1, co)) return (int)cudaErrorInvalidValue;
  const Patch t = choose_patch(D, H, W);
  Args a;
  a.x[0] = static_cast<const float*>(x0);
  a.x[1] = static_cast<const float*>(x1);
  a.ci[0] = ci0;
  a.ci[1] = ci1;
  a.n0 = ci0 / kKC;
  a.w = static_cast<const float*>(w);
  a.scale = static_cast<const float*>(scale);
  a.shift = static_cast<const float*>(shift);
  a.relu = relu;
  a.mul0 = static_cast<const float*>(mul0);
  a.y = static_cast<float*>(y);
  a.part = static_cast<float*>(stats);
  a.D = D;
  a.H = H;
  a.W = W;
  a.ci_total = ci0 + ci1;
  a.co = co;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = n_of(co);
  if (N == 64) return launch<8>(a, B, t, s);
  if (N == 32) return launch<4>(a, B, t, s);
  return launch<2>(a, B, t, s);
}

// The launch geometry ps2d_conv3d_f32 picks: out[0..7] = N, TD, TH, TW,
// blocks, dynamic shared memory bytes, and the blocks a batch item and
// channel tile (n_sp, the statistics buffer's second axis). ci1 = 0 for
// one input.
extern "C" int ps2d_conv3d_f32_plan(int B, int D, int H, int W, int ci0, int ci1, int co,
                                    int* out) {
  if (!valid(B, D, H, W, ci0, ci1, co)) return (int)cudaErrorInvalidValue;
  const Patch t = choose_patch(D, H, W);
  const int N = n_of(co), n_sp = t.n_dt * t.n_ht * t.n_wt;
  out[0] = N;
  out[1] = t.TD;
  out[2] = t.TH;
  out[3] = t.TW;
  out[4] = n_sp * (co / N) * B;
  out[5] = smem_bytes(t, N);
  out[6] = n_sp;
  return 0;
}
