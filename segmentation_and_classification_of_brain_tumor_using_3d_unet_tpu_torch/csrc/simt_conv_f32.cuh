// The float32 tile loop of K7's f32 form (conv3d_same_f32.cu), and of it
// alone: a 3x3x3 conv as an implicit GEMM in f32 FMA on the CUDA cores (no
// tensor cores: TF32 is not f32). K1's f32 form, which takes bf16-rounded
// weights, runs on the tensor cores instead (ps2d_conv3d_f32.cu: three
// bf16 passes over an exact split of its activations); K7's unrounded
// weights would need the split on both operands.
//
// Bound on the H100: at the serving shapes these convs do 27 * 2 * ci * co
// FLOPs a voxel against 4 * (ci + co) bytes, over 200 FLOP a byte, far
// above the f32 balance point (67 TFLOP/s over 3.35 TB/s, 20 FLOP a byte):
// bound by the f32 FMA rate, 132 SMs x 128 lanes x 2 FLOP a clock. Design
// for that: every operand an FMA reads comes from registers, and shared
// memory is read at most about once for every seven FMAs.
//
// Block: 256 threads, an output patch of 32 runs of 8 voxels along W
// (TD x TH x TW voxels, TW = 8 * gw runs a row, TD * TH * gw = 32) by N =
// 8 * TN output channels. Thread (mg = tid / 8, ng = tid % 8) owns run mg
// (8 consecutive voxels of one row) by TN channels: 8 x TN accumulators.
// K = 27 taps x the input channels, walked in chunks of kKC = 8 channels:
//  * the chunk's input box (TD + 2, TH + 2, TW + 2) is staged in shared
//    memory CHANNEL-MAJOR (tile[k * P + box voxel]), so a thread's run and
//    its two right neighbours are 10 consecutive words: for each (k, kd,
//    kh) a thread loads those 10 values once and uses them for the three
//    kw taps, 3 x 8 x TN FMAs (a warp's four runs fall in four bank
//    groups: one wavefront a load);
//  * the chunk's weights (27, kKC, N) sit beside it; a thread reads its TN
//    channels of one (tap, k) as one or two 16 B loads, the same 128 B for
//    the four runs of a warp (broadcast: one wavefront).
// The sum over (chunk, k, kd, kh, kw) has a fixed order: two runs give the
// same bits. Staging is synchronous (load, store, barrier, compute,
// barrier); two blocks an SM overlap one's staging with the other's FMAs.
#pragma once

#include <cuda_runtime.h>

namespace simt_f32 {

constexpr int kThreads = 256;
constexpr int kKC = 8;      // input channels a chunk
constexpr int kRun = 8;     // voxels a thread, consecutive along W
constexpr int kRuns = 32;   // runs a block

inline int cdiv(int n, int t) { return (n + t - 1) / t; }

// The output patch and its input box, chosen on the host.
struct Patch {
  int TD, TH, TW, gw;      // patch; gw = TW / kRun runs a row
  int ID, IH, IW, box;     // TD + 2, TH + 2, TW + 2 and their product
  int P;                   // channel pitch of the staged tile, P % 8 == 4
  int n_wt, n_ht, n_dt;    // patches along W, H and D
};

// The patch that needs the fewest blocks over a D x H x W volume; among
// those, the smallest box (the least staging).
inline Patch choose_patch(int D, int H, int W) {
  Patch best = {};
  long best_n = -1;
  for (int gw = 1; gw <= 8; gw *= 2)
    for (int TD = 1; TD * gw <= kRuns; TD *= 2) {
      const int TH = kRuns / (TD * gw), TW = kRun * gw;
      const long n = (long)cdiv(D, TD) * cdiv(H, TH) * cdiv(W, TW);
      const int box = (TD + 2) * (TH + 2) * (TW + 2);
      if (best_n < 0 || n < best_n || (n == best_n && box < best.box)) {
        best_n = n;
        best = {TD, TH, TW, gw, TD + 2, TH + 2, TW + 2, box, 0, 0, 0, 0};
      }
    }
  // P = 4 (mod 8): the two 4-channel halves of a voxel, stored by
  // neighbouring lanes, land 16 banks apart
  best.P = best.box + ((12 - best.box % 8) % 8);
  best.n_wt = cdiv(W, best.TW);
  best.n_ht = cdiv(H, best.TH);
  best.n_dt = cdiv(D, best.TD);
  return best;
}

// Dynamic shared memory: the staged tile, the chunk's weights (reused for
// the statistics' partials) and the box's voxel table.
inline int smem_bytes(const Patch& t, int N) {
  return (kKC * t.P + 27 * kKC * N) * 4 + t.box * 4;
}

// Thread tid's run: its first voxel's offset in the patch (od, oh, ow0)
// and in the staged box.
struct Run {
  int od, oh, ow0, a_off;
};

__device__ __forceinline__ Run run_of(const Patch& t, int mg) {
  Run r;
  const int ws = mg % t.gw, q = mg / t.gw;
  r.oh = q % t.TH;
  r.od = q / t.TH;
  r.ow0 = ws * kRun;
  r.a_off = (r.od * t.IH + r.oh) * t.IW + r.ow0;
  return r;
}

// Column of channel j of a thread in n-group ng (within the N-tile):
// TN = 2: 2 ng + j; TN = 4: 4 ng + j; TN = 8: 4 ng + j % 4 + 32 (j / 4).
template <int TN>
__device__ __forceinline__ int col_of(int ng, int j) {
  return TN == 2 ? 2 * ng + j : 4 * ng + (j & 3) + 32 * (j >> 2);
}

template <int TN>
__device__ __forceinline__ void load_b(float (&b)[TN], const float* p) {
  if constexpr (TN == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    b[0] = v.x;
    b[1] = v.y;
  } else {
#pragma unroll
    for (int s = 0; s < TN / 4; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(p + 32 * s);
      b[4 * s] = v.x;
      b[4 * s + 1] = v.y;
      b[4 * s + 2] = v.z;
      b[4 * s + 3] = v.w;
    }
  }
}

// Stage chunk c0's weights: ws[(tap * kKC + k) * N + n] = w[tap, c0 + k,
// co0 + n] of w (27, ci_total, co).
template <int N>
__device__ __forceinline__ void stage_weights(float* ws, const float* __restrict__ w,
                                              int ci_total, int co, int co0, int c0) {
  constexpr int kQ = N / 4;   // float4s a (tap, k) row
  for (int i = threadIdx.x; i < 27 * kKC * kQ; i += kThreads) {
    const int q = i % kQ, tk = i / kQ, k = tk % kKC, tap = tk / kKC;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        w + ((size_t)tap * ci_total + c0 + k) * co + co0 + 4 * q));
    *reinterpret_cast<float4*>(ws + tk * N + 4 * q) = v;
  }
}

// Stage a chunk's input box channel-major: item i is box voxel p = i / 2,
// channels 4 h .. 4 h + 3 (h = i % 2) of the chunk. load(p, h) returns
// the transformed float4 of that item (zeros outside the volume).
template <typename Load>
__device__ __forceinline__ void stage_tile(float* tile, const Patch& t, Load load) {
  for (int i = threadIdx.x; i < 2 * t.box; i += kThreads) {
    const int p = i >> 1, h = i & 1;
    const float4 v = load(p, h);
    float* d = tile + 4 * h * t.P + p;
    d[0] = v.x;
    d[t.P] = v.y;
    d[2 * t.P] = v.z;
    d[3 * t.P] = v.w;
  }
}

// acc[i][j] += sum over the chunk's kKC channels and 27 taps of the staged
// input at (run voxel i + tap) times the weight of (tap, channel, column j).
template <int TN>
__device__ __forceinline__ void chunk_product(float (&acc)[kRun][TN], const float* tile,
                                              const float* ws, const Patch& t, int a_off,
                                              int col) {
  constexpr int N = 8 * TN;
  const int plane = t.IH * t.IW;
#pragma unroll 1
  for (int k = 0; k < kKC; ++k) {
    const float* tk = tile + k * t.P + a_off;
    const float* wk = ws + k * N + col;
#pragma unroll
    for (int kd = 0; kd < 3; ++kd)
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const float* row = tk + kd * plane + kh * t.IW;
        float av[kRun + 2];
#pragma unroll
        for (int i = 0; i < kRun + 2; ++i) av[i] = row[i];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float bv[TN];
          load_b<TN>(bv, wk + ((kd * 3 + kh) * 3 + kw) * kKC * N);
#pragma unroll
          for (int i = 0; i < kRun; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i + kw], bv[j], acc[i][j]);
        }
      }
  }
}

}  // namespace simt_f32
