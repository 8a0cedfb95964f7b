// K1 in float32: the bias-free 3x3x3 SAME conv over the halo layout, with
// the on-load input transforms and the output statistics, for f32 tensors,
// on the tensor cores.
//
// Replaces the float32 form of the Pallas kernel behind ops/pallas/ps2d.py::
// ps2d_conv3d_flat_multi (ps2d.py:667) of the JAX package, which computes
// in the input's dtype: its weights rounded to bf16 first (pack_w_rot,
// ps2d.py:413-414) and widened back (:709), the affine, the mask and the
// scratch in f32 (:727-746), f32 accumulation. The bf16 form
// (ps2d_conv3d.cu) is a separate source.
//
// What it computes, per output voxel and channel:
//   y = sum over inputs i, taps t, channels c of  x'_i[vox+t, c] * w[t, off_i+c]
//   affine   x' = relu?( (x * scale[b,c]) + shift[b,c] )   (two f32 roundings)
//   mask     x'_0 = x'_0 * mul0[vox, c]                    (input 0 only)
//   halo     x' = 0 at halo voxels: never loaded, so a cotangent with
//            garbage on its halo (K6's data gradient) passes none of it.
// The weights come as bf16 (the wrapper rounds them as JAX does), so only
// the activations need more than bf16's 8 significant bits. Each x' is
// split EXACTLY into three bf16 parts,
//   hi = bf16(x'),  mid = bf16(x' - hi),  lo = bf16(x' - hi - mid),
// hi + mid + lo == x' for 0 and every 2^-110 <= |x'| <= 3.3895e38 (three
// 8-bit significands cover f32's 24; each difference is exact in f32;
// below 2^-110 the error is under 2^-133 absolute, bf16's subnormal grid).
// Every product of a part and a weight is exact in f32, so three bf16
// wgmma passes (hi, mid, lo) compute the f32 conv; only the order of
// summation differs, and the tensor cores' accumulation (see the note at
// the main loop).
// Two inputs are two ranges of K chunks, input 0's then input 1's. With
// stats it writes, per block, batch item and channel, the sum and the sum
// of squares of its f32 outputs (unrounded) inside the volume into a
// per-block buffer (B, n_sp, 2, co), which the wrapper sums over the
// blocks in a fixed order (no atomics: two runs give the same bits).
// Output in the halo layout: each block writes its patch and, at the
// volume's edges, the adjacent halo as zeros.
//
// Bound on the H100: at the serving shapes (batch 4, 128^3, ci 32 or
// 32+32, co 32) one pass does 0.46-0.93 TFLOP against 2.3-4.6 GB of f32
// traffic; three passes are 1.4-2.8 TFLOP of bf16 wgmma, ~1.4-2.8 ms at
// 989 TFLOP/s, above the bytes' 0.7-1.4 ms: bound by tensor-core
// operations (on the f32 FMA units alone the same conv would need
// 6.9-13.9 ms).
//
// Design: K1 bf16's implicit GEMM (ps2d_conv3d.cu) in its non-specialised
// form, over the PTX pieces of hopper_gemm.cuh. M = the 128 output voxels
// of a TD x TH x TW patch, N = a tile of 16, 32 or 64 output channels,
// K = 27 taps x the inputs' channels, walked as (input-channel chunk of
// 16) x (step of nine taps, a kz plane); two warpgroups of 64 rows.
//  * Each chunk's f32 input box (TD+2, TH+2, TW+2, 16) lands by cp.async
//    through a voxel table in one f32 slot, in shares issued by the
//    previous chunk's later steps (zero-filled outside the volume).
//  * At the chunk's first step one pass over the landed box applies the
//    transform above and writes hi, mid and lo to three bf16 tiles at a
//    48 B voxel pitch (ldmatrix conflict-free); the f32 slot is then free
//    for the next chunk's shares, and the tiles are read until the next
//    chunk's pass (A comes from registers: wgmma never reads them).
//  * Per tap: three ldmatrix.x4 (a shifted window of each tile) and three
//    RS wgmmas m64nNk16 on the same B descriptor, a 16 x N bf16 weight
//    slab; a ring of per-step slots (nine slabs each) is filled one or two
//    steps ahead. The weights move as in one bf16 pass; only A's ldmatrix
//    work and the MMAs triple.
//  * Each step's passes sum into a fresh accumulator, added into an f32
//    total by one round-to-nearest addition a step (the main loop's note).
//  * Shared memory: at a 4x4x8 patch (a 360-voxel box) the three tiles,
//    the f32 slot, the voxel table and the ring take 88-111 KB, so two
//    blocks run on an SM (KC = 32 chunks would leave room for one).
//  * Epilogue: the f32 totals staged in shared memory, the statistics
//    summed per channel over the patch in a fixed order, 16 B stores of
//    the block's box: its patch and, at the volume's edges, the adjacent
//    halo as zeros.
// On an H100 at the serving forms nine taps a step ran 3-10% faster than
// three (fewer barriers and accumulator drains; compare_builds.py
// --kernel k1f32, PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;        // two wgmma warpgroups
constexpr int kM = 128;              // output voxels (GEMM rows) a block
constexpr int kKC = 16;              // input channels a chunk: one k16 step
constexpr int kVec = kKC / 4;        // 16 B f32 vectors a voxel and chunk
constexpr int kTaps = 9;             // taps a step: a kz plane
constexpr int kRowsC = 27 / kTaps;   // steps a chunk
// weight ring slots, one step each, filled kAhead = slots - 1 steps ahead:
// three at N <= 32, two at N = 64 (three would leave room for one block
// an SM)
template <int N>
__host__ __device__ constexpr int ring_slots() {
  return N <= 32 ? 3 : 2;
}
constexpr int kP = kKC * 2 + 16;     // bf16 tile voxel pitch, bytes
constexpr int kLandP = kKC * 4;      // f32 slot voxel pitch, bytes

struct Args {
  const float* x[2];    // halo layout inputs, ci[i] channels each
  int ci[2];
  int n0;               // chunks of input 0; the later chunks are input 1's
  const bf16* w;        // (27, ci_total, co): DHWIO
  const float* scale;   // (B, ci_total) or null
  const float* shift;   // (B, ci_total); set whenever scale is
  int relu;
  const float* mul0;    // (B, D+2, H+2, W+2, ci[0]) or null
  float* y;             // (B, D+2, H+2, W+2, co)
  float* part;          // (B, n_sp, 2, co) per-block sums, or null
  int D, H, W, ci_total, co;
  int d_live;           // bit 0: plane 0, bit 1: plane D + 1 of every input
                        // holds a D neighbour's values (loaded and
                        // transformed as the interior); else zeros
};

// block geometry, chosen on the host
struct Tile {
  int TD, TH, TW;  // output patch, TD * TH * TW <= kM
  int ID, IH, IW;  // TD + 2, TH + 2, TW + 2
  int n_wt, n_ht;  // patches along W and H
  int n_sp;        // patches a batch item
  int n_ct;        // output-channel tiles
  int a_bytes;     // one bf16 tile (hi, mid or lo)
  int land_off;    // shared-memory offset of the f32 slot
  int tab_off;     // ... and of the box's voxel table
};

// bring the 128 B line at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

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

// ------------------------------------------------------------- kernel
// Every thread copies, between block barriers. Each step s (chunk s / 3,
// the nine taps of plane kz = s % 3): wait for its weights (and at a
// chunk's first step its box), a block barrier, refill the ring slot step
// s - 1 read and fetch a share of the next chunk's box, then at a chunk's
// first step the split pass and another barrier; then per tap the three
// passes' ldmatrix and wgmmas into the step's fresh accumulator, and that
// added into the f32 total (see the accumulation note at the loop).
template <int N, bool kOneTile>
__global__ void __launch_bounds__(kThreads, 2) split_f32_kernel(const Args a, const Tile t) {
  constexpr int kS = ring_slots<N>(), kAhead = kS - 1;
  // steps 1..kSpread of a chunk each fetch a share of the next chunk's box
  // (the last share's group has landed by the next chunk's first step)
  constexpr int kSpread = kRowsC - kAhead;
  constexpr int kSlot = kKC * N * 2;        // bytes of one tap's weight slab
  constexpr int kStepB = kTaps * kSlot;     // ... of one ring slot (a step's)
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_b = smem_u32(smem);
  const uint32_t s_a = s_b + kS * kStepB;   // the hi, mid and lo tiles
  const uint32_t s_land = s_b + t.land_off;

  const int co = kOneTile ? N : a.co;
  const unsigned bx = blockIdx.x;
  const unsigned n_ct = kOneTile ? 1u : (unsigned)t.n_ct;
  const int co0 = kOneTile ? 0 : (int)(bx % n_ct) * N;
  // tile indices kept unsigned (a signed division put the tile origin in
  // local memory, in K1 bf16)
  const unsigned sp = kOneTile ? bx : bx / n_ct;
  const int w0 = (int)(sp % (unsigned)t.n_wt) * t.TW;
  const int h0 = (int)(sp / (unsigned)t.n_wt) * t.TH;
  const int d0 = (int)blockIdx.y * t.TD, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int Dp = a.D + 2, Hp = a.H + 2, Wp = a.W + 2;
  const unsigned TW = (unsigned)t.TW, hw = (unsigned)(t.TH * t.TW);
  const unsigned rows = (unsigned)t.TD * hw;
  const unsigned IW = (unsigned)t.IW, plane = (unsigned)(t.IH * t.IW);
  const unsigned halo = (unsigned)t.ID * plane;
  const int n_chunks = a.ci_total / kKC, n_steps = kRowsC * n_chunks;
  const bool affine = a.scale != nullptr;

  // the box's (TD + 2, IH, IW) voxels, each one's index in the halo
  // layout, or -1 outside the volume (staged as zeros, never loaded; a
  // live D halo plane is inside)
  const int lo = a.d_live & 1, hi = (a.d_live >> 1) & 1;
  int* vox_tab = reinterpret_cast<int*>(smem + t.tab_off);
  for (unsigned p = tid; p < halo; p += kThreads) {
    const unsigned kz = p / plane, q = p - kz * plane;
    const unsigned ih = q / IW, iw = q - ih * IW;
    const int gd = d0 + (int)kz - 1, gh = h0 + (int)ih - 1, gw = w0 + (int)iw - 1;
    const bool in = (unsigned)(gd + lo) < (unsigned)(a.D + lo + hi) &&
                    (unsigned)gh < (unsigned)a.H && (unsigned)gw < (unsigned)a.W;
    vox_tab[p] = in ? ((b * Dp + gd + 1) * Hp + gh + 1) * Wp + gw + 1 : -1;
  }
  __syncthreads();

  // 16 B items i0 + tid, i0 + tid + kThreads, ... < i1 of chunk c's f32
  // box into the f32 slot; for a chunk of input 0 with a mask, each
  // voxel's mask vector (64 B, within one 128 B line) is prefetched into
  // L2 for the split pass
  const unsigned a_items = halo * kVec, a_share = (a_items + kSpread - 1) / kSpread;
  const auto copy_a = [&](int c, unsigned i0, unsigned i1) {
    const bool in0 = c < a.n0;
    const int ci = in0 ? a.ci[0] : a.ci[1];   // no dynamic index: Args stays in
                                              // the parameter space, off the stack
    const float* xc = in0 ? a.x[0] + (size_t)c * kKC : a.x[1] + (size_t)(c - a.n0) * kKC;
    const float* mc = in0 && a.mul0 != nullptr ? a.mul0 + (size_t)c * kKC : nullptr;
    for (unsigned i = i0 + tid; i < i1; i += kThreads) {
      const unsigned v4 = i % kVec, p = i / kVec;
      const int vox = vox_tab[p];
      cp_async16(s_land + p * kLandP + v4 * 16,
                 vox >= 0 ? xc + (size_t)vox * ci + v4 * 4 : a.x[0], vox >= 0);
      if (mc != nullptr && vox >= 0 && v4 == 0) prefetch_l2(mc + (size_t)vox * ci);
    }
  };
  // chunk c's landed box -> transform -> the hi, mid and lo tiles; thread
  // tid keeps channels 4 (tid % kVec) .. + 3 of every voxel it visits (its
  // scale and shift loaded once), two voxels at a time, their mask loads
  // issued before either is used; positions outside the volume stay 0
  const auto split = [&](int c) {
    const int v4 = tid % kVec;
    const float* mc =
        a.mul0 != nullptr && c < a.n0 ? a.mul0 + (size_t)c * kKC + v4 * 4 : nullptr;
    float4 sc = make_float4(0.f, 0.f, 0.f, 0.f), sh = sc;
    if (affine) {
      const size_t off = (size_t)b * a.ci_total + c * kKC + v4 * 4;
      sc = __ldg(reinterpret_cast<const float4*>(a.scale + off));
      sh = __ldg(reinterpret_cast<const float4*>(a.shift + off));
    }
    const unsigned char* land = smem + t.land_off;
    unsigned char* tiles = smem + kS * kStepB;
    constexpr unsigned kStep = kThreads / kVec;
    for (unsigned p0 = tid / kVec; p0 < halo; p0 += 2 * kStep) {
      int vox[2];
      float4 mv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned p = p0 + j * kStep;
        vox[j] = p < halo ? vox_tab[p] : -1;
        mv[j] = mc != nullptr && vox[j] >= 0
                    ? __ldg(reinterpret_cast<const float4*>(mc + (size_t)vox[j] * a.ci[0]))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned p = p0 + j * kStep;
        if (p >= halo) continue;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (vox[j] >= 0) {
          v = *reinterpret_cast<const float4*>(land + p * kLandP + v4 * 16);
          if (affine) v = affine4(v, sc, sh, a.relu);
          if (mc != nullptr) {
            v.x = __fmul_rn(v.x, mv[j].x);
            v.y = __fmul_rn(v.y, mv[j].y);
            v.z = __fmul_rn(v.z, mv[j].z);
            v.w = __fmul_rn(v.w, mv[j].w);
          }
        }
        uint2 hi, mid, lo;
        split4(v, hi, mid, lo);
        unsigned char* e = tiles + p * kP + v4 * 8;
        *reinterpret_cast<uint2*>(e) = hi;
        *reinterpret_cast<uint2*>(e + t.a_bytes) = mid;
        *reinterpret_cast<uint2*>(e + 2 * t.a_bytes) = lo;
      }
    }
  };
  // step s's weights (chunk s / kRowsC, its kTaps taps) into ring slot
  // s % kS, a slab a tap: this thread's 16 B rows tid + kThreads j of a
  // slab and their sources, relative to the slab's, are the same at every
  // tap
  constexpr int kRows = kKC * N / 8;
  constexpr int kMine = (kRows + kThreads - 1) / kThreads;
  uint32_t b_dst[kMine], b_src[kMine];
#pragma unroll
  for (int j = 0; j < kMine; ++j) {
    int k, n8;
    slab_row<N>(tid + j * kThreads, k, n8);
    b_dst[j] = b_offset<N>(k, n8);
    b_src[j] = (uint32_t)(k * co + n8 * 8);
  }
  const auto copy_w = [&](int s) {
    const int c = s / kRowsC, tap0 = kTaps * (s - kRowsC * c);
    const uint32_t slot = s_b + (s % kS) * kStepB;
#pragma unroll
    for (int kt = 0; kt < kTaps; ++kt) {
      const bf16* src = a.w + ((size_t)(tap0 + kt) * a.ci_total + c * kKC) * co + co0;
#pragma unroll
      for (int j = 0; j < kMine; ++j)
        if (kRows % kThreads == 0 || tid + j * kThreads < kRows)
          cp_async16(slot + kt * kSlot + b_dst[j], src + b_src[j], true);
    }
  };

  // the first chunk's box with the first step's weights, then the second
  // step's: one cp.async group each
  copy_a(0, 0, a_items);
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    copy_w(s);
    cp_async_commit();
  }

  const int lane = tid & 31;
  // this lane's ldmatrix row of its warp's 16 (warpgroup tid / 128 owns
  // rows 64 (tid / 128) ..): a voxel (od, oh, ow) of the patch or, past
  // it, voxel 0 (those rows are computed and dropped)
  const unsigned row0 = (unsigned)(tid >> 5) * 16;
  uint32_t a_lane;
  {
    const unsigned r = row0 + (lane & 15), rr = r < rows ? r : 0u;
    const unsigned od = rr / hw, q = rr - od * hw;
    a_lane = (od * plane + (q / TW) * IW + q % TW) * kP + (lane >> 4) * 16;
  }

  // Accumulation. The tensor cores do not round each f32 addition to
  // nearest: a sum into a large accumulator loses low bits of the new
  // terms, with a bias. All 81 x chunks wgmmas into one accumulator erred
  // past an f32 conv (on an H100 the statistics of 64 + 64 -> 64 missed
  // the plain f32 conv's by over 1e-5 of the largest). Each step's 27
  // wgmmas (nine taps, three passes each) therefore start a fresh
  // accumulator (scale-d 0), small beside the output, and its value is
  // added into the total by one f32 round-to-nearest addition a step: a
  // sequential f32 sum of 3 x chunks terms, far shorter than the plain
  // conv's over every tap and channel (against float64 the kernel then
  // errs 0.3-0.5x the plain f32 conv's error).
  float acc[N / 2], tot[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = tot[i] = 0.f;

  // A fragments (hi, mid, lo) in two register sets, used by the taps in
  // turn: a wgmma reads its A registers while it runs, so each tap from
  // the third on waits for the wgmmas of the tap two before it, which
  // read the set it reloads
  uint32_t frag[2][3][4];
#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    const int c = s / kRowsC, row = s - kRowsC * c;
    // step s's weights (and, at a chunk's first step, its box) have landed
    // for every thread, and every wgmma up to step s - 1 is done
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    // refill the slot step s - 1 read; fetch a share of the next chunk's
    // box into the f32 slot (free since this chunk's split pass)
    if (s + kAhead < n_steps) copy_w(s + kAhead);
    if (row >= 1 && row <= kSpread && c + 1 < n_chunks) {
      const unsigned i0 = (row - 1) * a_share;
      copy_a(c + 1, i0, i0 + a_share < a_items ? i0 + a_share : a_items);
    }
    cp_async_commit();
    if (row == 0) {
      // every thread's ldmatrix of the old tiles is behind the barrier
      // above, and no wgmma is in flight
      split(c);
      __syncthreads();
    }
    // tap kt = (kh, kw) of plane kz = row: kh rows and kw voxels on
    const uint32_t a_step = s_a + row * plane * kP + a_lane;
    const uint32_t b_step = s_b + (s % kS) * kStepB;
#pragma unroll
    for (int kt = 0; kt < kTaps; ++kt) {
      uint32_t(&f)[3][4] = frag[kt & 1];
      if (kt >= 2) wgmma_wait<1>();   // tap kt - 2's wgmmas are done
      const uint32_t a_tap = a_step + ((kt / 3) * IW + kt % 3) * kP;
#pragma unroll
      for (int part = 0; part < 3; ++part) ldmatrix_x4(f[part], a_tap + part * t.a_bytes);
      wgmma_fence();
      const uint64_t desc = b_desc<N>(b_step + kt * kSlot);
      Mma<N>::run(acc, f[0], desc, kt == 0 ? 0 : 1);   // the step's first: fresh
      Mma<N>::run(acc, f[1], desc);
      Mma<N>::run(acc, f[2], desc);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_operands(acc);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp done with the ring and the tiles

  // ---- epilogue: the f32 totals -> shared memory (M x N, pitch N + 8
  // words: conflict-free float2 stores)
  constexpr int kLdS = N + 8;
  float* stage = reinterpret_cast<float*>(smem);
  {
    const int col = 2 * (lane & 3), row = (int)row0 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      *reinterpret_cast<float2*>(stage + row * kLdS + 8 * j + col) =
          make_float2(tot[4 * j], tot[4 * j + 1]);
      *reinterpret_cast<float2*>(stage + (row + 8) * kLdS + 8 * j + col) =
          make_float2(tot[4 * j + 2], tot[4 * j + 3]);
    }
  }
  __syncthreads();

  // ---- statistics: thread (g, pair) sums its channel pair over the rows
  // g, g + kG, ... inside the volume; then one thread a pair adds the kG
  // partials in order and writes the block's sums
  if (a.part != nullptr) {
    constexpr int kPairs = N / 2, kG = kThreads / kPairs;
    const int pr = tid % kPairs, g = tid / kPairs;
    float s1x = 0.f, s1y = 0.f, s2x = 0.f, s2y = 0.f;
    for (unsigned r = g; r < rows; r += kG) {
      const unsigned od = r / hw, q = r - od * hw, oh = q / TW, ow = q - oh * TW;
      if (d0 + (int)od >= a.D || h0 + (int)oh >= a.H || w0 + (int)ow >= a.W) continue;
      const float2 f = *reinterpret_cast<const float2*>(stage + r * kLdS + 2 * pr);
      s1x += f.x;
      s1y += f.y;
      s2x += f.x * f.x;
      s2y += f.y * f.y;
    }
    float4* red = reinterpret_cast<float4*>(smem + kM * kLdS * 4);
    red[g * kPairs + pr] = make_float4(s1x, s1y, s2x, s2y);
    __syncthreads();
    if (tid < kPairs) {
      float4 sum = red[tid];
      for (int j = 1; j < kG; ++j) {
        const float4 u = red[j * kPairs + tid];
        sum.x += u.x;
        sum.y += u.y;
        sum.z += u.z;
        sum.w += u.w;
      }
      const unsigned spi = blockIdx.y * (unsigned)(t.n_wt * t.n_ht) + sp;
      float* out = a.part + ((size_t)b * t.n_sp + spi) * 2 * co + co0 + 2 * tid;
      out[0] = sum.x;
      out[1] = sum.y;
      out[co] = sum.z;
      out[co + 1] = sum.w;
    }
  }

  // ---- the block's box in the halo layout: its patch and, at the
  // volume's edges, the adjacent halo (zeros), 16 B stores along co
  const int dlo = d0 == 0 ? 0 : d0 + 1, dhi = d0 + t.TD >= a.D ? a.D + 1 : d0 + t.TD;
  const int hlo = h0 == 0 ? 0 : h0 + 1, hhi = h0 + t.TH >= a.H ? a.H + 1 : h0 + t.TH;
  const int wlo = w0 == 0 ? 0 : w0 + 1, whi = w0 + t.TW >= a.W ? a.W + 1 : w0 + t.TW;
  const unsigned nh = (unsigned)(hhi - hlo + 1), nw = (unsigned)(whi - wlo + 1);
  const unsigned items = (unsigned)(dhi - dlo + 1) * nh * nw * (N / 4);
  for (unsigned i = tid; i < items; i += kThreads) {
    const unsigned n4 = i % (N / 4), v = i / (N / 4), vh = v / nw;
    const int pw = wlo + (int)(v - vh * nw), ph = hlo + (int)(vh % nh), pd = dlo + (int)(vh / nh);
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pd >= 1 && pd <= a.D && ph >= 1 && ph <= a.H && pw >= 1 && pw <= a.W) {
      const unsigned r = (unsigned)(((pd - 1 - d0) * t.TH + (ph - 1 - h0)) * t.TW + (pw - 1 - w0));
      val = *reinterpret_cast<const float4*>(stage + r * kLdS + n4 * 4);
    }
    *reinterpret_cast<float4*>(a.y + ((((size_t)b * Dp + pd) * Hp + ph) * Wp + pw) * co + co0 +
                               n4 * 4) = val;
  }
}

// ------------------------------------------------------------- host
int cdiv(int n, int t) { return (n + t - 1) / t; }

// the weight ring, the three bf16 tiles, the f32 slot and the voxel
// table; the epilogue's stage and its statistics' partials reuse them
int ring_bytes(int N) {
  return (N == 64 ? ring_slots<64>() : ring_slots<32>()) * kTaps * kKC * N * 2;
}
int smem_bytes(int N, int halo) {
  const int loop = ring_bytes(N) + halo * (3 * kP + kLandP + 4);
  const int stage = kM * (N + 8) * 4 + kThreads * 16;
  return loop > stage ? loop : stage;
}

// The launch's geometry.
struct Plan {
  int N, smem;
  Tile t;
  long blocks;
};

// N = 16 for co = 16, else 64 where it divides co, else 32 (the total and
// the accumulator of N = 128, 128 registers a thread, would leave none for
// two blocks an SM).
// The TD x TH x TW patch (at most 128 voxels, TD <= 4, TH balanced over
// H) that needs the fewest blocks within two blocks' shared memory an SM;
// among those, one at least 8 voxels wide (an ldmatrix's eight rows then
// fall in eight bank groups), then the smallest box.
Plan plan(int B, int D, int H, int W, int co) {
  Plan p = {};
  p.N = co == 16 ? 16 : co % 64 == 0 ? 64 : 32;
  long best = -1;
  int best_narrow = 0, best_halo = 0;
  for (int TD = 1; TD <= (D < 4 ? D : 4); ++TD)
    for (int TW = 1; TW <= W && TD * TW <= kM; ++TW) {
      const int most = kM / (TD * TW);
      const int TH = cdiv(H, cdiv(H, H < most ? H : most));
      const int halo = (TD + 2) * (TH + 2) * (TW + 2), narrow = TW < 8 && TW < W;
      if (smem_bytes(p.N, halo) > kSmemBlock) continue;
      const long n = (long)cdiv(D, TD) * cdiv(H, TH) * cdiv(W, TW);
      if (best < 0 || n < best ||
          (n == best && (narrow < best_narrow || (narrow == best_narrow && halo < best_halo)))) {
        best = n;
        best_narrow = narrow;
        best_halo = halo;
        p.t.TD = TD;
        p.t.TH = TH;
        p.t.TW = TW;
      }
    }
  p.t.ID = p.t.TD + 2;
  p.t.IH = p.t.TH + 2;
  p.t.IW = p.t.TW + 2;
  p.t.n_wt = cdiv(W, p.t.TW);
  p.t.n_ht = cdiv(H, p.t.TH);
  p.t.n_sp = (int)best;
  p.t.n_ct = co / p.N;
  const int halo = p.t.ID * p.t.IH * p.t.IW;
  p.t.a_bytes = halo * kP;
  p.t.land_off = ring_bytes(p.N) + 3 * p.t.a_bytes;
  p.t.tab_off = p.t.land_off + halo * kLandP;
  p.smem = smem_bytes(p.N, halo);
  p.blocks = best * B * p.t.n_ct;
  return p;
}

template <int N, bool kOneTile>
int launch(const Args& a, int B, const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(split_f32_kernel<N, kOneTile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const Tile& t = p.t;
  split_f32_kernel<N, kOneTile><<<dim3(t.n_wt * t.n_ht * t.n_ct, cdiv(a.D, t.TD), B), kThreads,
                                   p.smem, stream>>>(a, t);
  return (int)cudaGetLastError();
}

template <int N>
int launch_one(const Args& a, int B, const Plan& p, cudaStream_t s) {
  return a.co == N ? launch<N, true>(a, B, p, s) : launch<N, false>(a, B, p, s);
}

bool valid(int B, int D, int H, int W, int ci0, int ci1, int co) {
  return B >= 1 && D >= 1 && H >= 1 && W >= 1 && ci0 >= 32 && ci0 % 32 == 0 && ci1 >= 0 &&
         ci1 % 32 == 0 && (co == 16 || (co > 0 && co % 32 == 0)) && B <= 65535 && D <= 65535 &&
         (long)B * (D + 2) * (H + 2) * (W + 2) <= 0x7fffffffL;
}

}  // namespace

// The f32 form of ps2d_conv3d (ps2d_conv3d.cu), same arguments with f32
// tensors but the weights: x1 may be null (one input, ci1 = 0);
// scale/shift/mul0/stats may be null. w is bf16 (27, ci0 + ci1, co), the
// weights' values rounded to bf16 as JAX rounds them. stats, when given,
// is the per-block buffer (B, n_sp, 2, co) f32 (n_sp from
// ps2d_conv3d_f32_plan), every value of which the launch writes:
// [b, i, 0, c] the sum and [b, i, 1, c] the sum of squares of channel c's
// f32 outputs inside block i's patch. ci0, ci1 multiples of 32; co 16 or
// a multiple of 32; every pointer 16 B aligned; d_live as
// ps2d_conv3d's. Returns the launch's cudaError_t.
extern "C" int ps2d_conv3d_f32(const void* x0, const void* x1, int ci0, int ci1,
                               const void* w, const void* scale, const void* shift,
                               int relu, const void* mul0, void* y, void* stats,
                               int B, int D, int H, int W, int co, void* stream,
                               int d_live) {
  if (x1 == nullptr) ci1 = 0;
  if (!valid(B, D, H, W, ci0, ci1, co)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, D, H, W, co);
  Args a;
  a.x[0] = static_cast<const float*>(x0);
  a.x[1] = static_cast<const float*>(x1);
  a.ci[0] = ci0;
  a.ci[1] = ci1;
  a.n0 = ci0 / kKC;
  a.w = static_cast<const bf16*>(w);
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
  a.d_live = d_live & 3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.N == 64) return launch_one<64>(a, B, p, s);
  if (p.N == 32) return launch_one<32>(a, B, p, s);
  return launch<16, true>(a, B, p, s);
}

// The launch geometry ps2d_conv3d_f32 picks, with ps2d_conv3d_plan's keys:
// out[0..8] = N, KC, M, TD, TH, TW, blocks, dynamic shared memory bytes,
// and the blocks a batch item and channel tile (n_sp, the statistics
// buffer's second axis). ci1 = 0 for one input.
extern "C" int ps2d_conv3d_f32_plan(int B, int D, int H, int W, int ci0, int ci1, int co,
                                    int* out) {
  if (!valid(B, D, H, W, ci0, ci1, co)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, D, H, W, co);
  out[0] = p.N;
  out[1] = kKC;
  out[2] = kM;
  out[3] = p.t.TD;
  out[4] = p.t.TH;
  out[5] = p.t.TW;
  out[6] = (int)p.blocks;
  out[7] = p.smem;
  out[8] = p.t.n_sp;
  return 0;
}
