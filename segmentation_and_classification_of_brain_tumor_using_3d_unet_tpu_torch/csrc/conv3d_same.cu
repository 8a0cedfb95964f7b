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
// point: bound by tensor-core operations, which only wgmma reaches. In
// practice the shared memory around the tensor cores binds first: each
// m64nNk16 wgmma reads its 16 x N weight slice from shared memory, each A
// fragment is an ldmatrix, and the weight copies land there too, close to
// the SM's 128 B a clock at the tensor cores' rate; and every instruction
// a step spends on copies or waits shows at narrow N, where a step is
// short.
//
// Design: implicit GEMM on Hopper's warpgroup MMA. M = the output voxels
// of a TD x TH x TW patch (128 or 256: two warpgroups of one or two 64-row
// tiles; any patch shape, since each GEMM row is one voxel's address), N =
// a tile of 32, 64 or 128 output channels, K = 27 taps x ci, walked as
// (input-channel chunk of KC = 32 or 64) x (tap).
//  * A comes from registers (wgmma's RS form): the chunk's input tile
//    (TD+2, TH+2, TW+2, KC), zero-filled outside the volume, is staged once
//    in shared memory at a padded voxel pitch (KC * 2 + 16 bytes: the
//    eight rows of an ldmatrix fall in eight bank groups), and each tap's
//    A fragment is a shifted window of it, loaded with ldmatrix.x4.
//  * B comes from shared memory through a wgmma descriptor: each tap's
//    KC x N weight slab is copied into a ring of slots in the no-swizzle
//    core-matrix layout (MN-major, read with the transpose bit), one copy
//    for all eight consumer warps. M = 256 halves the weight traffic a
//    voxel against M = 128 (ldmatrix and weight reads are per 64 rows).
//  * Every copy is cp.async (16 B, zero-fill form outside the volume):
//    the weights run ahead of the math in the ring, the next chunk's input
//    tile lands in a second slot in shares over the current chunk's taps,
//    and one tap's wgmmas stay in flight while the next tap's A fragments
//    are loaded. At N = 128 a producer warpgroup issues the copies and
//    mbarriers hand the slots over; at narrower N every thread copies
//    between block barriers, two blocks an SM (the kernel comment below).
//  * Epilogue: accumulators -> bf16 (one rounding) -> shared memory ->
//    16 B stores along co, masked to the volume. No atomics: the sum order
//    is fixed, so two runs give the same bits.
// The host (plan) picks M = 256 where that still fills a wave of blocks,
// the patch that needs the fewest blocks, N = the largest of 128, 64, 32
// that divides co, and KC = 64 where ci allows at M = 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;      // warps 0-7: two wgmma warpgroups
constexpr int kSMs = 132;            // H100 SXM
// taps 1..kSpread of a chunk each fetch a share of the next chunk's input
// tile
constexpr int kSpread = 24;

// N = 128 runs warp-specialised: warps 8-11 (a third warpgroup) issue the
// copies. Its consumers need more registers than two blocks an SM allow,
// so latency is hidden inside the block. Narrower N runs two blocks an SM,
// each thread copying and computing.
template <int N>
__host__ __device__ constexpr bool specialised() {
  return N == 128;
}
template <int N>
__host__ __device__ constexpr int block_threads() {
  return specialised<N>() ? kConsumers + 128 : kConsumers;
}
// weight ring slots (one tap each)
template <int N>
__host__ __device__ constexpr int stages() {
  return specialised<N>() ? 6 : 4;
}
constexpr int kSmemSM = 232448;      // shared memory a block can have
// input-tile voxel pitch in bytes
template <int KC>
__host__ __device__ constexpr int pitch() {
  return KC * 2 + 16;
}

struct Args {
  const bf16* x;   // (B, D, H, W, ci)
  const bf16* w;   // (27, ci, co)
  bf16* y;         // (B, D, H, W, co)
  int D, H, W, ci, co;
};

// block geometry, chosen on the host
struct Tile {
  int TD, TH, TW;  // output patch, TD * TH * TW <= the block's rows
  int ID, IH, IW;  // TD + 2, TH + 2, TW + 2
  int n_wt, n_ht;  // patches along W and H
  int n_ct;        // output-channel tiles
  int a_bytes;     // one input-tile slot
  int tab_off;     // shared-memory offset of the tile's voxel table
  int bar_off;     // ... and of the ring's mbarriers
};

// the two consumer warpgroups alone (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ------------------------------------------------------------- kernel
// Warps 0-7, two warpgroups (the consumers), run the wgmmas on M = 128 *
// MH rows, each owning MH consecutive 64-row tiles. The first chunk's tile
// is copied by every thread before the loop. Then:
//  * specialised (N = 128): the producer warpgroup issues every copy; each
//    ring slot has a "full" mbarrier (the producer's 128 threads arrive as
//    their copies land) and an "empty" one (the 256 consumers arrive once
//    the wgmmas that read it have retired); no block-wide barrier.
//  * otherwise: each step starts with a block barrier after which every
//    thread refills the slot read two steps ago (cp.async groups, the
//    weights kAhead = stages - 2 steps ahead).
template <int N, int KC, int MH, bool kOneTile>
__global__ void __launch_bounds__(block_threads<N>(), specialised<N>() ? 1 : 2)
    conv_kernel(const Args a, const Tile t) {
  constexpr bool kWS = specialised<N>();
  constexpr int kThreads = block_threads<N>(), kS = stages<N>(), kAhead = kS - 2;
  constexpr int kP = pitch<KC>();
  constexpr int kSlot = KC * N * 2;   // bytes of one weight slot
  constexpr int kVec = KC / 8;        // 16 B vectors per voxel and chunk
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_b = smem_u32(smem);
  const uint32_t s_a = s_b + kS * kSlot;
  const uint32_t bar = s_b + t.bar_off;   // full_b, empty_b, full_a, empty_a
  const auto full_b = [&](int i) { return bar + 8 * i; };
  const auto empty_b = [&](int i) { return bar + 8 * (kS + i); };
  const auto full_a = [&](int j) { return bar + 8 * (2 * kS + j); };
  const auto empty_a = [&](int j) { return bar + 8 * (2 * kS + 2 + j); };

  const int co = kOneTile ? N : a.co;
  const unsigned bx = blockIdx.x;
  const unsigned n_ct = kOneTile ? 1u : (unsigned)t.n_ct;
  const int co0 = kOneTile ? 0 : (int)(bx % n_ct) * N;
  // tile indices kept unsigned (K1's lesson: a signed division put the
  // tile origin in local memory)
  const unsigned sp = kOneTile ? bx : bx / n_ct;
  const int w0 = (int)(sp % (unsigned)t.n_wt) * t.TW;
  const int h0 = (int)(sp / (unsigned)t.n_wt) * t.TH;
  const int d0 = (int)blockIdx.y * t.TD, b = blockIdx.z;
  const int tid = threadIdx.x;
  const unsigned TW = (unsigned)t.TW, hw = (unsigned)(t.TH * t.TW);
  const unsigned rows = (unsigned)t.TD * hw;
  const unsigned IW = (unsigned)t.IW, plane = (unsigned)(t.IH * t.IW);
  const unsigned halo = (unsigned)t.ID * plane;
  const int n_chunks = a.ci / KC, n_steps = 27 * n_chunks;

  if (kWS && tid == 0) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(full_b(i), kThreads - kConsumers);
      mbar_init(empty_b(i), kConsumers);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(full_a(j), kThreads - kConsumers);
      mbar_init(empty_a(j), kConsumers);
    }
  }
  // the input tile's (TD + 2, IH, IW) voxels, each x's voxel index or -1
  // outside the volume: computed once, so a copy costs no divisions
  int* vox_tab = reinterpret_cast<int*>(smem + t.tab_off);
  for (unsigned p = tid; p < halo; p += kThreads) {
    const unsigned kz = p / plane, q = p - kz * plane;
    const unsigned ih = q / IW, iw = q - ih * IW;
    const int gd = d0 + (int)kz - 1, gh = h0 + (int)ih - 1, gw = w0 + (int)iw - 1;
    const bool in = (unsigned)gd < (unsigned)a.D && (unsigned)gh < (unsigned)a.H &&
                    (unsigned)gw < (unsigned)a.W;
    vox_tab[p] = in ? ((b * a.D + gd) * a.H + gh) * a.W + gw : -1;
  }
  __syncthreads();
  // 16 B items i0 + pt, i0 + pt + nt, ... < i1 of chunk c's input tile
  // (TD + 2, IH, IW, KC) into slot c % 2, zeros outside the volume
  const unsigned a_items = halo * kVec, a_share = (a_items + kSpread - 1) / kSpread;
  const auto copy_a = [&](int c, unsigned i0, unsigned i1, int pt, int nt) {
    const uint32_t slot = s_a + (c & 1) * t.a_bytes;
    const bf16* xc = a.x + (size_t)c * KC;
    for (unsigned i = i0 + pt; i < i1; i += nt) {
      const unsigned v8 = i % kVec, p = i / kVec;
      const int vox = vox_tab[p];
      cp_async16(slot + p * kP + v8 * 16, vox >= 0 ? xc + (size_t)vox * a.ci + v8 * 8 : a.x,
                 vox >= 0);
    }
  };
  // tap 1..kSpread of chunk c's share of chunk c + 1's tile
  const auto copy_a_share = [&](int c, int tap, int pt, int nt) {
    const unsigned i0 = (tap - 1) * a_share;
    copy_a(c + 1, i0, i0 + a_share < a_items ? i0 + a_share : a_items, pt, nt);
  };
  // step s's weights (chunk s / 27, tap s % 27) into ring slot s % kS by
  // the copying threads (all, or the producer's): this thread's 16 B rows
  // pt + kCopiers j of a slab and their sources, relative to the slab's,
  // are the same at every step
  constexpr int kCopiers = kWS ? kThreads - kConsumers : kThreads;
  constexpr int kRows = KC * N / 8;
  constexpr int kMine = (kRows + kCopiers - 1) / kCopiers;
  const int pt = kWS ? tid - kConsumers : tid;
  uint32_t b_dst[kMine], b_src[kMine];
#pragma unroll
  for (int j = 0; j < kMine; ++j) {
    int k, n8;
    slab_row<N>(pt + j * kCopiers, k, n8);
    b_dst[j] = b_offset<N>(k, n8);
    b_src[j] = (uint32_t)(k * co + n8 * 8);
  }
  const auto copy_w = [&](int s) {
    const int c = s / 27, tap = s - 27 * c;
    const uint32_t slot = s_b + (s % kS) * kSlot;
    const bf16* src = a.w + ((size_t)tap * a.ci + c * KC) * co + co0;
#pragma unroll
    for (int j = 0; j < kMine; ++j)
      if (kRows % kCopiers == 0 || pt + j * kCopiers < kRows)
        cp_async16(slot + b_dst[j], src + b_src[j], true);
  };

  // the first chunk's tile, by every thread
  copy_a(0, 0, a_items, tid, kThreads);
  if constexpr (kWS) {
    // a wait covers committed groups only: without the commit, a thread
    // could read the tile before another's copies had landed
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid >= kConsumers) {
      // ------------------------------------------------------ producer
      for (int s = 0; s < n_steps; ++s) {
        const int c = s / 27, tap = s - 27 * c, slot = s % kS;
        if (s >= kS) mbar_wait(empty_b(slot), (s / kS - 1) & 1);
        if (tap >= 1 && tap <= kSpread && c + 1 < n_chunks) {
          // into the slot chunk c - 1 read
          if (tap == 1 && c >= 1) mbar_wait(empty_a((c + 1) & 1), ((c - 1) >> 1) & 1);
          copy_a_share(c, tap, pt, kThreads - kConsumers);
          if (tap == kSpread) mbar_arrive_cp_async(full_a((c + 1) & 1));
        }
        copy_w(s);
        mbar_arrive_cp_async(full_b(slot));
      }
      cp_async_wait<0>();
      return;
    }
  } else {
    // the first kAhead steps' weights, one cp.async group each (the first
    // with the tile)
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      copy_w(s);
      cp_async_commit();
    }
  }

  // ------------------------------------------------------------ consumers
  const int lane = tid & 31;
  // this lane's ldmatrix row in each of its warpgroup's 64-row tiles: a
  // voxel (od, oh, ow) of the patch or, past it, voxel 0 (those rows are
  // computed and dropped)
  const unsigned row0 = (unsigned)((tid >> 7) * 64 * MH + ((tid >> 5) & 3) * 16);
  uint32_t a_lane[MH];
#pragma unroll
  for (int mh = 0; mh < MH; ++mh) {
    const unsigned r = row0 + mh * 64 + (lane & 15), rr = r < rows ? r : 0u;
    const unsigned od = rr / hw, q = rr - od * hw;
    a_lane[mh] = (od * plane + (q / TW) * IW + q % TW) * kP + (lane >> 4) * 16;
  }

  float acc[MH][N / 2];
#pragma unroll
  for (int mh = 0; mh < MH; ++mh)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mh][i] = 0.f;

  // A fragments in two register sets, one per step parity: a wgmma reads
  // its A registers while it runs, so step s loads into the set that step
  // s - 2 read, which wgmma_wait<1> at the end of step s - 1 has retired
  // (the loop runs in pairs so that the set is a compile-time choice)
  uint32_t frag[2][MH][KC / 16][4];
#pragma unroll 1
  for (int s0 = 0; s0 < n_steps; s0 += 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = s0 + h;
      if (s >= n_steps) break;
      const int c = s / 27, tap = s - 27 * c, slot = s % kS;
      if constexpr (kWS) {
        mbar_wait(full_b(slot), (s / kS) & 1);
        if (tap == 0 && c >= 1) mbar_wait(full_a(c & 1), ((c - 1) >> 1) & 1);
        fence_proxy_async();
      } else {
        // step s's weights (and, at a chunk's first tap, its tile) have
        // landed for every thread, and every wgmma up to step s - 2 is done
        cp_async_wait<kAhead - 1>();
        fence_proxy_async();
        __syncthreads();
        // refill the slot step s - 2 read; fetch a share of the next
        // chunk's tile into the slot chunk c - 1 read (its last wgmma
        // finished at step 27c - 1); the share's group has landed by step
        // 27c + 27 as kSpread + kAhead < 27
        if (s + kAhead < n_steps) copy_w(s + kAhead);
        if (tap >= 1 && tap <= kSpread && c + 1 < n_chunks)
          copy_a_share(c, tap, tid, kThreads);
        cp_async_commit();
      }
      const int kz = tap / 9, kh = tap / 3 - 3 * kz, kw = tap - 3 * (tap / 3);
      const uint32_t a_tap = s_a + (c & 1) * t.a_bytes + (kz * plane + kh * IW + kw) * kP;
#pragma unroll
      for (int mh = 0; mh < MH; ++mh)
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks)
          ldmatrix_x4(frag[h][mh][ks], a_tap + a_lane[mh] + ks * 32);
      wgmma_fence();
      const uint32_t b_addr = s_b + slot * kSlot;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks)
#pragma unroll
        for (int mh = 0; mh < MH; ++mh)
          Mma<N>::run(acc[mh], frag[h][mh][ks], b_desc<N>(b_addr + ks * 2 * 16 * N));
      wgmma_commit();
      // step s - 1's wgmmas are done; step s's run on. A specialised step
      // of one 64-row tile (four wgmmas) waits for its own instead: then
      // ptxas pipelines them rather than serialising them (measured faster
      // there; slower with two tiles a step)
      wgmma_wait<kWS && MH == 1 ? 0 : 1>();
      if constexpr (kWS) {
        if (s >= 1) mbar_arrive(empty_b((s - 1) % kS));
        if (tap == 26) mbar_arrive(empty_a(c & 1));   // its ldmatrix reads are done
      }
    }
  }
  wgmma_wait<0>();
  cp_async_wait<0>();
#pragma unroll
  for (int mh = 0; mh < MH; ++mh) fence_operands(acc[mh]);
  consumer_sync();   // both consumer warpgroups done: the rings are free

  // ---- epilogue: accumulators -> bf16 (one rounding) -> shared memory
  // (M x N, pitch N + 8: conflict-free) -> 16 B stores inside the volume
  constexpr int kLdS = N + 8;
  bf16* stage = reinterpret_cast<bf16*>(smem);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int mh = 0; mh < MH; ++mh) {
    const int row = (int)row0 + mh * 64 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(stage + row * kLdS + 8 * j + col) =
          __floats2bfloat162_rn(acc[mh][4 * j], acc[mh][4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(stage + (row + 8) * kLdS + 8 * j + col) =
          __floats2bfloat162_rn(acc[mh][4 * j + 2], acc[mh][4 * j + 3]);
    }
  }
  consumer_sync();
  for (unsigned i = tid; i < rows * (N / 8); i += kConsumers) {
    const unsigned n8 = i % (N / 8), v = i / (N / 8);
    const unsigned od = v / hw, q = v - od * hw;
    const int d = d0 + (int)od, h = h0 + (int)(q / TW), w = w0 + (int)(q % TW);
    if (d >= a.D || h >= a.H || w >= a.W) continue;
    const size_t vox = (((size_t)b * a.D + d) * a.H + h) * a.W + w;
    *reinterpret_cast<uint4*>(a.y + vox * co + co0 + n8 * 8) =
        *reinterpret_cast<const uint4*>(stage + v * kLdS + n8 * 8);
  }
  static_assert(128 * MH * kLdS * 2 <= kSmemSM, "the epilogue stage fits");
}

// One 64 x N x 16 product through the kernel's own pieces (ldmatrix rows
// at the kernel's pitch, the slab layout, b_desc, Mma, the accumulator
// mapping): a (64, 16) and b (16, N) bf16 row-major, d (64, N) f32.
template <int N>
__global__ void __launch_bounds__(128) probe_kernel(const bf16* A, const bf16* Bm, float* D) {
  constexpr int kP = pitch<32>();
  __shared__ __align__(128) unsigned char s_b[16 * N * 2];
  __shared__ __align__(128) unsigned char s_a[64 * kP];
  const int tid = threadIdx.x, lane = tid & 31;
  cp_async16(smem_u32(s_a) + (tid >> 1) * kP + (tid & 1) * 16, A + tid * 8, true);
  for (int i = tid; i < 16 * N / 8; i += 128) {
    int k, n8;
    slab_row<N>(i, k, n8);
    cp_async16(smem_u32(s_b) + b_offset<N>(k, n8), Bm + k * N + n8 * 8, true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  uint32_t frag[4];
  ldmatrix_x4(frag, smem_u32(s_a) + ((tid >> 5) * 16 + (lane & 15)) * kP + (lane >> 4) * 16);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  wgmma_fence();
  Mma<N>::run(acc, frag, b_desc<N>(smem_u32(s_b)));
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(acc);
  const int row = (tid >> 5) * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      D[(row + 8 * (e >> 1)) * N + 8 * j + col + (e & 1)] = acc[4 * j + e];
}

// ------------------------------------------------------------- host
int cdiv(int n, int t) { return (n + t - 1) / t; }

int ring_slots(int N) { return N == 128 ? stages<128>() : stages<64>(); }

// the weight ring, the input-tile slots, the voxel table (rounded to 8 B)
// and 2 * stages + 4 mbarriers; the epilogue's stage reuses them
int smem_bytes(int N, int KC, int MH, int a_slots, int a_bytes, int halo) {
  const int ring = ring_slots(N) * KC * N * 2 + a_slots * a_bytes + (4 * halo + 7) / 8 * 8 +
                   8 * (2 * ring_slots(N) + 4);
  const int stage = 128 * MH * (N + 8) * 2;
  return ring > stage ? ring : stage;
}

// The launch's geometry.
struct Plan {
  int N, KC, MH, smem;
  Tile t;
  long blocks;
};

// The TD x TH x TW patch (at most 128 * MH voxels, TD <= 4, TH balanced
// over H) that needs the fewest blocks within the shared memory; among
// those, one at least 8 voxels wide (an ldmatrix's eight rows then fall in
// eight bank groups), then the smallest halo.
Plan patch(int B, int D, int H, int W, int ci, int co, int N, int KC, int MH) {
  Plan p;
  p.N = N;
  p.KC = KC;
  p.MH = MH;
  const int M = 128 * MH, P = KC * 2 + 16, a_slots = ci > KC ? 2 : 1;
  long best = -1;
  int best_narrow = 0, best_halo = 0;
  for (int TD = 1; TD <= (D < 4 ? D : 4); ++TD)
    for (int TW = 1; TW <= W && TD * TW <= M; ++TW) {
      const int most = M / (TD * TW);
      const int TH = cdiv(H, cdiv(H, H < most ? H : most));
      const int halo = (TD + 2) * (TH + 2) * (TW + 2), narrow = TW < 8 && TW < W;
      if (smem_bytes(N, KC, MH, a_slots, halo * P, halo) > kSmemSM) continue;
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
  p.t.n_ct = co / N;
  const int halo = p.t.ID * p.t.IH * p.t.IW;
  p.t.a_bytes = halo * P;
  p.t.tab_off = ring_slots(N) * KC * N * 2 + a_slots * p.t.a_bytes;
  p.t.bar_off = p.t.tab_off + (4 * halo + 7) / 8 * 8;
  p.smem = smem_bytes(N, KC, MH, a_slots, p.t.a_bytes, halo);
  p.blocks = best * B * p.t.n_ct;
  return p;
}

// M = 256 rows (KC = 32, to keep two input-tile slots in shared memory)
// where that still gives a wave of blocks: the weights are fetched once
// per M rows, so this halves their traffic; otherwise M = 128 with KC = 64
// where ci allows. N = 128, 64 or 32, the largest that divides co (a
// narrower N to fill more SMs would cost as many waves of smaller blocks).
Plan plan(int B, int D, int H, int W, int ci, int co) {
  const int N = co % 128 == 0 ? 128 : co % 64 == 0 ? 64 : 32;
  Plan p = patch(B, D, H, W, ci, co, N, 32, 2);
  if (p.blocks < kSMs) p = patch(B, D, H, W, ci, co, N, ci % 64 == 0 ? 64 : 32, 1);
  return p;
}

template <int N, int KC, int MH, bool kOneTile>
int launch(const Args& a, int B, const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_kernel<N, KC, MH, kOneTile>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  const Tile& t = p.t;
  conv_kernel<N, KC, MH, kOneTile><<<dim3(t.n_wt * t.n_ht * t.n_ct, cdiv(a.D, t.TD), B),
                                     block_threads<N>(), p.smem, stream>>>(a, t);
  return (int)cudaGetLastError();
}

template <int N, int KC, int MH>
int launch_one(const Args& a, int B, const Plan& p, cudaStream_t s) {
  return a.co == N ? launch<N, KC, MH, true>(a, B, p, s) : launch<N, KC, MH, false>(a, B, p, s);
}

template <int KC, int MH>
int launch_n(const Args& a, int B, const Plan& p, cudaStream_t s) {
  if (p.N == 128) return launch_one<128, KC, MH>(a, B, p, s);
  if (p.N == 64) return launch_one<64, KC, MH>(a, B, p, s);
  return launch_one<32, KC, MH>(a, B, p, s);
}

}  // namespace

// x (B, D, H, W, ci), w (27, ci, co), y (B, D, H, W, co), all bf16; ci and
// co positive multiples of 32; x, w and y 16 B aligned. Returns the
// launch's cudaError_t.
extern "C" int conv3d_same(const void* x, const void* w, void* y, int B,
                           int D, int H, int W, int ci, int co, void* stream) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || ci < 1 || co < 1 || ci % 32 ||
      co % 32 || B > 65535 || D > 65535 || (long)B * D * H * W > 0x7fffffffL)
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
  const Plan p = plan(B, D, H, W, ci, co);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.MH == 2) return launch_n<32, 2>(a, B, p, s);
  return p.KC == 64 ? launch_n<64, 1>(a, B, p, s) : launch_n<32, 1>(a, B, p, s);
}

// The launch geometry conv3d_same picks for a shape: out[0..7] = N, KC,
// M, TD, TH, TW, blocks, dynamic shared memory bytes.
extern "C" int conv3d_same_plan(int B, int D, int H, int W, int ci, int co, int* out) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || ci < 1 || co < 1 || ci % 32 || co % 32)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, D, H, W, ci, co);
  out[0] = p.N;
  out[1] = p.KC;
  out[2] = 128 * p.MH;
  out[3] = p.t.TD;
  out[4] = p.t.TH;
  out[5] = p.t.TW;
  out[6] = (int)p.blocks;
  out[7] = p.smem;
  return 0;
}

// One 64 x n x 16 wgmma tile product through the kernel's operand
// helpers (tests): a (64, 16), b (16, n) bf16 row-major -> d (64, n) f32;
// n 32, 64 or 128.
extern "C" int conv3d_same_wgmma_probe(const void* a, const void* b, void* d, int n,
                                       void* stream) {
  const bf16* A = static_cast<const bf16*>(a);
  const bf16* Bm = static_cast<const bf16*>(b);
  float* D = static_cast<float*>(d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 32) probe_kernel<32><<<1, 128, 0, s>>>(A, Bm, D);
  else if (n == 64) probe_kernel<64><<<1, 128, 0, s>>>(A, Bm, D);
  else if (n == 128) probe_kernel<128><<<1, 128, 0, s>>>(A, Bm, D);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
