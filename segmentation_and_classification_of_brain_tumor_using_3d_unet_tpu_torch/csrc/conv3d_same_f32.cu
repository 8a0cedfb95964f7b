// K7 in float32: the bias-free 3x3x3 SAME conv of an unpadded
// channels-last f32 tensor, f32 out, on the tensor cores:
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
// Both operands carry f32's 24 significant bits. Each is split EXACTLY
// into three bf16 parts,
//   hi = bf16(v),  mid = bf16(v - hi),  lo = bf16(v - hi - mid),
// hi + mid + lo == v for 0 and every 2^-110 <= |v| <= 3.3895e38 (the same
// split as K1's f32 form, ps2d_conv3d_f32.cu). Of the nine part products
// six are kept, x_hi w_hi, x_hi w_mid, x_mid w_hi, x_hi w_lo, x_mid w_mid
// and x_lo w_hi; the three dropped (mid lo, lo mid, lo lo) are each under
// 2^-24 of |x w|, below an f32 conv's own rounding. Every kept product of
// two bf16 values is exact in f32, so six bf16 wgmma passes compute the
// f32 conv to within f32 rounding: against float64 the result errs less
// than the plain f32 conv's (tests/test_torch_k7_split.py holds the
// six-pass sum within 2^-22 (|x| conv |w|) of float64 on the CPU).
//
// Bound on the H100: six bf16 passes of 2 * 27 * ci * co FLOPs a voxel at
// 989 TFLOP/s (an effective 165 TFLOP/s, 2.46x the f32 FMA peak of 66.9)
// against 4 * (ci + co) bytes a voxel: at benchmarks/bench_wtile.py's
// shapes, from about 100 FLOP a byte (32 -> 32) upwards, above the
// tensor cores' ~295 / 6: bound by tensor-core operations.
//
// Design: K1 f32's implicit GEMM (ps2d_conv3d_f32.cu) over the PTX pieces
// of hopper_gemm.cuh, reading the unpadded layout as K7's bf16 form does.
// M = the 128 output voxels of a TD x TH x TW patch, N = a tile of 32 or
// 64 output channels, K = 27 taps x ci, walked as (input-channel chunk of
// 16) x (step of three taps, a (kz, ky) row); two warpgroups of 64 rows.
//  * The weights are split once a call, before the conv, by a small
//    kernel into three bf16 copies (hi, mid, lo) of w in scratch the
//    wrapper allocates: 27 * ci * co values, at most 7 M (70 MB of
//    traffic, some 25 us at 512 -> 512). Splitting them in each block's
//    staging instead would redo the split for every block and need an
//    f32 landing slot for the weights beside the activations'.
//  * Each chunk's f32 input box (TD+2, TH+2, TW+2, 16) lands by cp.async
//    through a voxel table in one f32 slot, in shares issued by the
//    previous chunk's later steps, zero-filled outside the volume.
//  * At the chunk's first step one pass over the landed box splits it
//    into three bf16 tiles (hi, mid, lo) at a 48 B voxel pitch (ldmatrix
//    conflict-free); the f32 slot is then free for the next chunk.
//  * Per tap: three ldmatrix.x4 (a shifted window of each tile) and six RS
//    wgmmas m64nNk16 on three B descriptors, the tap's hi, mid and lo
//    weight slabs (16 x N bf16 each); a ring of per-step slots (three
//    taps x three slabs) is filled one to three steps ahead.
//  * Each step's 18 wgmmas sum into a fresh accumulator (scale-d 0),
//    added into an f32 total by one round-to-nearest addition a step: the
//    tensor cores' f32 accumulation is not round to nearest (K1 f32's
//    finding; the main loop's note there).
//  * Shared memory: at a 4x4x8 patch (a 360-voxel box) the three tiles,
//    the f32 slot and the voxel table take 76 KB; the ring (four slots at
//    N = 32, two at N = 64) 36 KB: 113 KB, two blocks an SM. Steps of
//    nine taps (a kz plane, as K1 f32 takes) triple the ring's slot: two
//    slots leave room for one block an SM, and so they ran 0-22% slower
//    on an H100 (compare_builds.py --kernel k7f32, PERF.md).
//  * Epilogue: the f32 totals staged in shared memory, then 16 B stores of
//    the patch's voxels inside the volume.
// The host (plan) picks the patch that needs the fewest blocks and N = 64
// where it divides co, else 32.
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
constexpr int kTaps = 3;             // taps a step: a (kz, ky) row
constexpr int kRowsC = 27 / kTaps;   // steps a chunk
constexpr int kSMs = 132;            // H100 SXM
// weight ring slots, one step each, filled kAhead = slots - 1 steps ahead
template <int N>
__host__ __device__ constexpr int ring_slots() {
  return N <= 32 ? 4 : 2;
}
constexpr int kP = kKC * 2 + 16;     // bf16 tile voxel pitch, bytes
constexpr int kLandP = kKC * 4;      // f32 slot voxel pitch, bytes

struct Args {
  const float* x;       // (B, D, H, W, ci)
  const bf16* w;        // (3, 27, ci, co): w's hi, mid and lo parts
  float* y;             // (B, D, H, W, co)
  int D, H, W, ci, co;
};

// block geometry, chosen on the host
struct Tile {
  int TD, TH, TW;  // output patch, TD * TH * TW <= kM
  int ID, IH, IW;  // TD + 2, TH + 2, TW + 2
  int n_wt, n_ht;  // patches along W and H
  int n_ct;        // output-channel tiles
  int a_bytes;     // one bf16 tile (hi, mid or lo)
  int land_off;    // shared-memory offset of the f32 slot
  int tab_off;     // ... and of the box's voxel table
};

// ------------------------------------------------------------- kernels
// w (n4 float4s) -> its hi, mid and lo parts, each n4 uint2s (4 bf16)
__global__ void __launch_bounds__(256) split_weights_kernel(const float4* __restrict__ w,
                                                            uint2* __restrict__ parts, long n4) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    uint2 hi, mid, lo;
    split4(__ldg(w + i), hi, mid, lo);
    parts[i] = hi;
    parts[n4 + i] = mid;
    parts[2 * n4 + i] = lo;
  }
}

// Every thread copies, between block barriers. Each step s (chunk s / 9,
// the three taps of row (kz, ky) = (s % 9 / 3, s % 3)): wait for its
// weights (and at a chunk's first step its box), a block barrier, refill
// the ring slot step s - 1 read and fetch a share of the next chunk's box,
// then at a chunk's first step the split pass and another barrier; then
// per tap the three tiles' ldmatrix and six wgmmas into the step's fresh
// accumulator, and that added into the f32 total.
template <int N, bool kOneTile>
__global__ void __launch_bounds__(kThreads, 2) split6_kernel(const Args a, const Tile t) {
  constexpr int kS = ring_slots<N>(), kAhead = kS - 1;
  // steps 1..kSpread of a chunk each fetch a share of the next chunk's box
  // (the last share's group has landed by the next chunk's first step)
  constexpr int kSpread = kRowsC - kAhead;
  constexpr int kSlot = kKC * N * 2;        // bytes of one weight slab
  constexpr int kStepB = kTaps * 3 * kSlot; // ... of one ring slot (a step's)
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
  const unsigned TW = (unsigned)t.TW, hw = (unsigned)(t.TH * t.TW);
  const unsigned rows = (unsigned)t.TD * hw;
  const unsigned IW = (unsigned)t.IW, plane = (unsigned)(t.IH * t.IW);
  const unsigned box = (unsigned)t.ID * plane;
  const int n_chunks = a.ci / kKC, n_steps = kRowsC * n_chunks;

  // the box's (TD + 2, IH, IW) voxels, each one's index in x, or -1
  // outside the volume (staged as zeros, never loaded)
  int* vox_tab = reinterpret_cast<int*>(smem + t.tab_off);
  for (unsigned p = tid; p < box; p += kThreads) {
    const unsigned kz = p / plane, q = p - kz * plane;
    const unsigned ih = q / IW, iw = q - ih * IW;
    const int gd = d0 + (int)kz - 1, gh = h0 + (int)ih - 1, gw = w0 + (int)iw - 1;
    const bool in = (unsigned)gd < (unsigned)a.D && (unsigned)gh < (unsigned)a.H &&
                    (unsigned)gw < (unsigned)a.W;
    vox_tab[p] = in ? ((b * a.D + gd) * a.H + gh) * a.W + gw : -1;
  }
  __syncthreads();

  // 16 B items i0 + tid, i0 + tid + kThreads, ... < i1 of chunk c's f32
  // box into the f32 slot
  const unsigned a_items = box * kVec, a_share = (a_items + kSpread - 1) / kSpread;
  const auto copy_a = [&](int c, unsigned i0, unsigned i1) {
    const float* xc = a.x + (size_t)c * kKC;
    for (unsigned i = i0 + tid; i < i1; i += kThreads) {
      const unsigned v4 = i % kVec, p = i / kVec;
      const int vox = vox_tab[p];
      cp_async16(s_land + p * kLandP + v4 * 16,
                 vox >= 0 ? xc + (size_t)vox * a.ci + v4 * 4 : a.x, vox >= 0);
    }
  };
  // chunk c's landed box -> the hi, mid and lo tiles (zeros outside the
  // volume were landed as zeros)
  const auto split = [&]() {
    const unsigned char* land = smem + t.land_off;
    unsigned char* tiles = smem + kS * kStepB;
    for (unsigned i = tid; i < a_items; i += kThreads) {
      const unsigned v4 = i % kVec, p = i / kVec;
      uint2 hi, mid, lo;
      split4(*reinterpret_cast<const float4*>(land + p * kLandP + v4 * 16), hi, mid, lo);
      unsigned char* e = tiles + p * kP + v4 * 8;
      *reinterpret_cast<uint2*>(e) = hi;
      *reinterpret_cast<uint2*>(e + t.a_bytes) = mid;
      *reinterpret_cast<uint2*>(e + 2 * t.a_bytes) = lo;
    }
  };
  // step s's weights (chunk s / kRowsC, its kTaps taps, three parts each)
  // into ring slot s % kS, a slab a tap and part: this thread's 16 B rows
  // tid + kThreads j of a slab and their sources, relative to the slab's,
  // are the same for every slab
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
  const size_t part_stride = (size_t)27 * a.ci * co;
  const auto copy_w = [&](int s) {
    const int c = s / kRowsC, tap0 = kTaps * (s - kRowsC * c);
    const uint32_t slot = s_b + (s % kS) * kStepB;
#pragma unroll
    for (int kt = 0; kt < kTaps; ++kt) {
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const bf16* src =
            a.w + part * part_stride + ((size_t)(tap0 + kt) * a.ci + c * kKC) * co + co0;
#pragma unroll
        for (int j = 0; j < kMine; ++j)
          if (kRows % kThreads == 0 || tid + j * kThreads < kRows)
            cp_async16(slot + (kt * 3 + part) * kSlot + b_dst[j], src + b_src[j], true);
      }
    }
  };

  // the first chunk's box with the first step's weights, then the next
  // kAhead - 1 steps' weights: one cp.async group each
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

  // Accumulation: each step's 18 wgmmas (three taps, six passes each)
  // start a fresh accumulator (scale-d 0), added into the total by one f32
  // round-to-nearest addition a step (a sum into one large accumulator
  // loses low bits of the new terms, with a bias: ps2d_conv3d_f32.cu)
  float acc[N / 2], tot[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = tot[i] = 0.f;

  // A fragments (hi, mid, lo) in two register sets, used by the taps in
  // turn: a wgmma reads its A registers while it runs, so the third tap
  // waits for the wgmmas of the first, which read the set it reloads
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
      split();
      __syncthreads();
    }
    // the step's taps t0 + kt, t0 = kTaps row: tap (kz, ky, kx) = (t / 9,
    // t / 3 % 3, t % 3), kz planes, ky rows and kx voxels on
    const int t0 = kTaps * row;
    const uint32_t a_step = s_a + ((t0 / 9) * plane + (t0 / 3 % 3) * IW) * kP + a_lane;
    const uint32_t b_step = s_b + (s % kS) * kStepB;
#pragma unroll
    for (int kt = 0; kt < kTaps; ++kt) {
      uint32_t(&f)[3][4] = frag[kt & 1];
      if (kt >= 2) wgmma_wait<1>();   // tap kt - 2's wgmmas are done
      const uint32_t a_tap = a_step + ((kt / 3) * IW + kt % 3) * kP;
#pragma unroll
      for (int part = 0; part < 3; ++part) ldmatrix_x4(f[part], a_tap + part * t.a_bytes);
      wgmma_fence();
      const uint32_t b_tap = b_step + kt * 3 * kSlot;
      const uint64_t wh = b_desc<N>(b_tap), wm = b_desc<N>(b_tap + kSlot),
                     wl = b_desc<N>(b_tap + 2 * kSlot);
      Mma<N>::run(acc, f[0], wh, kt == 0 ? 0 : 1);   // the step's first: fresh
      Mma<N>::run(acc, f[0], wm);
      Mma<N>::run(acc, f[1], wh);
      Mma<N>::run(acc, f[0], wl);
      Mma<N>::run(acc, f[1], wm);
      Mma<N>::run(acc, f[2], wh);
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

  // ---- the patch's voxels inside the volume, 16 B stores along co
  const unsigned items = rows * (N / 4);
  for (unsigned i = tid; i < items; i += kThreads) {
    const unsigned n4 = i % (N / 4), r = i / (N / 4);
    const unsigned od = r / hw, q = r - od * hw, oh = q / TW, ow = q - oh * TW;
    const int gd = d0 + (int)od, gh = h0 + (int)oh, gw = w0 + (int)ow;
    if (gd >= a.D || gh >= a.H || gw >= a.W) continue;
    *reinterpret_cast<float4*>(a.y + (((size_t)b * a.D + gd) * a.H + gh) * a.W * co +
                               (size_t)gw * co + co0 + n4 * 4) =
        *reinterpret_cast<const float4*>(stage + r * kLdS + n4 * 4);
  }
}

// ------------------------------------------------------------- host
int cdiv(int n, int t) { return (n + t - 1) / t; }

// the weight ring, the three bf16 tiles, the f32 slot and the voxel
// table; the epilogue's stage reuses them
int ring_bytes(int N) {
  return (N == 64 ? ring_slots<64>() : ring_slots<32>()) * kTaps * 3 * kKC * N * 2;
}
int smem_bytes(int N, int box) {
  const int loop = ring_bytes(N) + box * (3 * kP + kLandP + 4);
  const int stage = kM * (N + 8) * 4;
  return loop > stage ? loop : stage;
}

// The launch's geometry.
struct Plan {
  int N, smem;
  Tile t;
  long blocks;
};

// The TD x TH x TW patch (at most 128 voxels, TD <= 4, TH the largest
// balanced over H whose box fits) that needs the fewest blocks within two
// blocks' shared memory an SM; among those, one at least 8 voxels wide (an
// ldmatrix's eight rows then fall in eight bank groups), then the smallest
// box. A 1 x 1 x 1 patch (a 27-voxel box) always fits, so every shape
// valid() takes has a plan. N = 64 where it divides co, else 32 (the
// ring's bytes are the same at both, so the patch is too; N = 128 would
// need 128 registers a thread for its total and accumulator). On an H100,
// N = 64 ran faster than 32 at every shape with co % 64 == 0, also at
// 512 -> 512 over 15 x 15 x 10, where it leaves 160 blocks for 132 SMs
// (compare_builds.py --kernel k7f32, PERF.md). N = 0: no patch fits.
Plan plan(int B, int D, int H, int W, int co) {
  Plan p = {};
  long best = -1;
  int best_narrow = 0, best_box = 0;
  for (int TD = 1; TD <= (D < 4 ? D : 4); ++TD)
    for (int TW = 1; TW <= W && TD * TW <= kM; ++TW) {
      const int most = kM / (TD * TW);
      int TH = cdiv(H, cdiv(H, H < most ? H : most));
      // thin volumes (D or W small, H large): the next smaller balanced TH
      // until the box fits
      while (TH > 1 && smem_bytes(64, (TD + 2) * (TH + 2) * (TW + 2)) > kSmemBlock)
        TH = cdiv(H, cdiv(H, TH - 1));
      const int box = (TD + 2) * (TH + 2) * (TW + 2), narrow = TW < 8 && TW < W;
      if (smem_bytes(64, box) > kSmemBlock) continue;
      const long n = (long)cdiv(D, TD) * cdiv(H, TH) * cdiv(W, TW);
      if (best < 0 || n < best ||
          (n == best && (narrow < best_narrow || (narrow == best_narrow && box < best_box)))) {
        best = n;
        best_narrow = narrow;
        best_box = box;
        p.t.TD = TD;
        p.t.TH = TH;
        p.t.TW = TW;
      }
    }
  if (best < 0) return p;
  p.N = co % 64 == 0 ? 64 : 32;
  p.t.ID = p.t.TD + 2;
  p.t.IH = p.t.TH + 2;
  p.t.IW = p.t.TW + 2;
  p.t.n_wt = cdiv(W, p.t.TW);
  p.t.n_ht = cdiv(H, p.t.TH);
  p.t.n_ct = co / p.N;
  const int box = p.t.ID * p.t.IH * p.t.IW;
  p.t.a_bytes = box * kP;
  p.t.land_off = ring_bytes(p.N) + 3 * p.t.a_bytes;
  p.t.tab_off = p.t.land_off + box * kLandP;
  p.smem = smem_bytes(p.N, box);
  p.blocks = best * B * p.t.n_ct;
  return p;
}

template <int N, bool kOneTile>
int launch(const Args& a, int B, const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(split6_kernel<N, kOneTile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const Tile& t = p.t;
  split6_kernel<N, kOneTile><<<dim3(t.n_wt * t.n_ht * t.n_ct, cdiv(a.D, t.TD), B), kThreads,
                                p.smem, stream>>>(a, t);
  return (int)cudaGetLastError();
}

template <int N>
int launch_one(const Args& a, int B, const Plan& p, cudaStream_t s) {
  return a.co == N ? launch<N, true>(a, B, p, s) : launch<N, false>(a, B, p, s);
}

bool valid(int B, int D, int H, int W, int ci, int co) {
  return B >= 1 && D >= 1 && H >= 1 && W >= 1 && ci >= 32 && co >= 32 && ci % 32 == 0 &&
         co % 32 == 0 && B <= 65535 && D <= 65535 && (long)B * D * H * W <= 0x7fffffffL;
}

}  // namespace

// w (27, ci, co) f32 -> its hi, mid and lo parts in wparts (3, 27, ci,
// co) bf16, on `stream`: the first of conv3d_same_f32's two kernels, an
// entry of its own so that it can be timed apart. Returns cudaError_t.
extern "C" int conv3d_same_f32_split_weights(const void* w, void* wparts, int ci, int co,
                                             void* stream) {
  if (ci < 32 || co < 32 || ci % 32 || co % 32) return (int)cudaErrorInvalidValue;
  const long n4 = 27L * ci * co / 4;
  const long blocks = (n4 + 255) / 256;
  split_weights_kernel<<<(unsigned)(blocks < 8 * kSMs ? blocks : 8 * kSMs), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(w), static_cast<uint2*>(wparts), n4);
  return (int)cudaGetLastError();
}

// x (B, D, H, W, ci) f32, w (27, ci, co) f32, y (B, D, H, W, co) f32;
// wparts scratch for w's three bf16 parts, 3 * 27 * ci * co bf16 values,
// which the launch overwrites; ci and co multiples of 32, every pointer
// 16 B aligned (checked by the caller). Launches the weights' split, then
// the conv, on `stream`. Returns the first launch error (cudaError_t).
extern "C" int conv3d_same_f32(const void* x, const void* w, void* wparts, void* y, int B,
                               int D, int H, int W, int ci, int co, void* stream) {
  if (!valid(B, D, H, W, ci, co)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, D, H, W, co);
  if (p.N == 0) return (int)cudaErrorInvalidValue;
  const int err = conv3d_same_f32_split_weights(w, wparts, ci, co, stream);
  if (err != 0) return err;
  Args a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const bf16*>(wparts);
  a.y = static_cast<float*>(y);
  a.D = D;
  a.H = H;
  a.W = W;
  a.ci = ci;
  a.co = co;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.N == 64 ? launch_one<64>(a, B, p, s) : launch_one<32>(a, B, p, s);
}

// The launch geometry conv3d_same_f32 picks, with conv3d_same_plan's keys:
// out[0..7] = N, KC, M, TD, TH, TW, blocks, dynamic shared memory bytes.
extern "C" int conv3d_same_f32_plan(int B, int D, int H, int W, int ci, int co, int* out) {
  if (!valid(B, D, H, W, ci, co)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, D, H, W, co);
  if (p.N == 0) return (int)cudaErrorInvalidValue;
  out[0] = p.N;
  out[1] = kKC;
  out[2] = kM;
  out[3] = p.t.TD;
  out[4] = p.t.TH;
  out[5] = p.t.TW;
  out[6] = (int)p.blocks;
  out[7] = p.smem;
  return 0;
}
