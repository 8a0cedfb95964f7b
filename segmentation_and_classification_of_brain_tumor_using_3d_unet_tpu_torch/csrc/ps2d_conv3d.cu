// K1: bias-free 3x3x3 SAME conv over the halo layout, with the on-load
// input transforms and the output statistics of the level-0 region.
//
// Replaces the Pallas kernel behind ops/pallas/ps2d.py::
// ps2d_conv3d_flat_multi (kernel body `_kernel`, ps2d.py:419-664) of the
// JAX package. Same function, not the same blocks: the TPU kernel packs
// 2x2 spatial phases into 128 lanes and streams depth through a lane
// ring to fill its matrix unit; here the data stay channels-last with a
// one-voxel zero halo on D, H and W ("halo layout",
// (B, D+2, H+2, W+2, C) bf16), which pack_halo and up_k2s2_into_halo
// write and this kernel reads and writes.
//
// What it computes, per output voxel and channel (f32 accumulation,
// one rounding to bf16):
//   y = sum over inputs i, taps t, channels c of  x'_i[vox+t, c] * w[t, off_i+c]
// where x' is the input after the on-load transform, each step rounded
// to bf16 as the reference rounds it:
//   affine   x' = relu?( bf16(bf16(x * scale[b,c]) + shift[b,c]) )
//   mask     x'_0 = bf16(x'_0 * mul0[vox, c])        (input 0 only)
//   halo     x' = 0 at halo voxels (the SAME padding stays exact).
// The concat of the inputs lives only in the K loop (never stored).
// With stats it also writes, per block, batch item and channel, the sum
// and the sum of squares of the bf16-ROUNDED outputs inside the volume
// into a per-block buffer (B, blocks, 2, co) f32, which the wrapper sums
// over the blocks: the next GroupNorm's statistics without another read,
// in a fixed order (no atomics: two runs give the same bits).
//
// Bound on the H100: at the main path's shapes (batch 4, 128^3, ci 32
// or 32+32, co 32) the conv does 0.46-0.93 TFLOP against 1.1-2.3 GB of
// HBM traffic, so it is bound by tensor-core operations (about 400
// FLOP per byte, above the card's ~295 balance point), which only wgmma
// reaches; as for K7, the shared memory around the tensor cores (weight
// slabs, ldmatrix, the copies landing) binds first in practice.
//
// Design: K7's implicit GEMM (conv3d_same.cu) with a main loop of its own
// and the PTX pieces of hopper_gemm.cuh. M = the output voxels of a
// TD x TH x TW patch (128 or 256), N = a tile of 16, 32, 64 or 128 output
// channels, K = 27 taps x the inputs' channels, walked as (input-channel
// chunk of KC = 32 or 64) x (tap).
//  * A from registers (wgmma's RS form): the chunk's input tile (TD+2,
//    TH+2, TW+2, KC) is staged once in shared memory at a padded voxel
//    pitch, and each tap's A fragment is a shifted window of it
//    (ldmatrix.x4). B from a ring of per-tap KC x N weight slabs in the
//    no-swizzle core-matrix layout, read through a descriptor with the
//    transpose bit. Every copy is cp.async.
//  * Halo layout in: the tile's voxels come through a voxel table; those
//    inside the volume are copied, every other position is zero-filled
//    and never read, so a cotangent with garbage on its halo (K6's data
//    gradient) passes none of it.
//  * Two inputs are two ranges of chunks: input 0's, then input 1's, each
//    with its own pointer and width; chunk c's rows of w, scale and shift
//    start at c * KC. KC = 64 only where both widths are multiples of 64.
//  * On-load transform, once a chunk: a chunk that carries one is copied
//    raw, then rewritten in place in one pass over the landed tile before
//    its first tap, in bf16x2 arithmetic with one rounding a step (the
//    roundings above); halo positions stay 0. Input 0's mask is read from
//    global memory in that pass, two voxels' loads in flight at once,
//    after an L2 prefetch issued with the chunk's tile copies (a slot of
//    its own in shared memory would cost M = 256 its two blocks an SM).
//    The pass is kept lean in registers: at 73 a thread, a one-chunk conv
//    at N = 32 runs three blocks an SM (on an H100, 2.06 ms against 2.51
//    with two at batch 4 x 128^3, 32 -> 32).
//    Chunks without a transform skip the pass.
//  * Epilogue: accumulators -> bf16 (one rounding) -> shared memory; the
//    statistics summed per channel over the patch's voxels in a fixed
//    order; 16 B stores of the block's box: its patch and, at the volume's
//    edges, the adjacent halo as zeros (the boxes partition the output,
//    which needs no clearing).
//  * N = 128 runs a producer warpgroup that issues the copies and runs the
//    pass, handing slots over with mbarriers; narrower N runs two blocks
//    an SM, every thread copying between block barriers.
// The host (plan) picks N = 16 for co = 16, else the largest of 128, 64,
// 32 that divides co (several channel tiles on a grid axis where co > N),
// M = 256 where that still fills a wave of blocks, the patch that needs
// the fewest blocks, and KC = 64 where the widths allow it at M = 128.
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
constexpr int kSmemSM = 232448;      // shared memory a block can have

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
// input-tile voxel pitch in bytes
template <int KC>
__host__ __device__ constexpr int pitch() {
  return KC * 2 + 16;
}

struct Args {
  const bf16* x[2];     // halo layout inputs, ci[i] channels each
  int ci[2];
  int n0;               // chunks of input 0; the later chunks are input 1's
  const bf16* w;        // (27, ci_total, co): DHWIO
  const bf16* scale;    // (B, ci_total) or null
  const bf16* shift;    // (B, ci_total); set whenever scale is
  int relu;
  const bf16* mul0;     // (B, D+2, H+2, W+2, ci[0]) or null
  bf16* y;              // (B, D+2, H+2, W+2, co)
  float* part;          // (B, n_sp, 2, co) per-block sums, or null
  int D, H, W, ci_total, co;
  int d_live;           // bit 0: plane 0, bit 1: plane D + 1 of every input
                        // holds a D neighbour's values (loaded and
                        // transformed as the interior); else zeros
};

// block geometry, chosen on the host
struct Tile {
  int TD, TH, TW;  // output patch, TD * TH * TW <= the block's rows
  int ID, IH, IW;  // TD + 2, TH + 2, TW + 2
  int n_wt, n_ht;  // patches along W and H
  int n_sp;        // patches a batch item
  int n_ct;        // output-channel tiles
  int a_bytes;     // one input-tile slot
  int tab_off;     // shared-memory offset of the tile's voxel table
  int bar_off;     // ... and of the ring's mbarriers
};

// the two consumer warpgroups alone (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
// the producer warpgroup alone (named barrier 2)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// bring the 128 B line at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// bf16x2 arithmetic, one rounding to nearest each (an explicit .rn is
// never contracted into an fma)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t a) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

// ------------------------------------------------------------- kernel
// Warps 0-7, two warpgroups (the consumers), run the wgmmas on M = 128 *
// MH rows, each owning MH consecutive 64-row tiles. The first chunk's tile
// is copied, and transformed, by every thread before the loop. Then:
//  * specialised (N = 128): the producer warpgroup issues every copy and
//    transforms each later chunk's tile once it has landed; each ring slot
//    has a "full" mbarrier (the producer's 128 threads arrive as their
//    copies land, or after the pass) and an "empty" one (the 256 consumers
//    arrive once the wgmmas that read it have retired).
//  * otherwise: each step starts with a block barrier after which every
//    thread refills the slot read two steps ago (cp.async groups, the
//    weights kAhead = stages - 2 steps ahead); a chunk's first step runs
//    the pass between that barrier and one more.
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
  // tile indices kept unsigned (a signed division put the tile origin in
  // local memory)
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
  const int n_chunks = a.ci_total / KC, n_steps = 27 * n_chunks;
  const bool affine = a.scale != nullptr;
  // chunk c carries an on-load transform
  const auto transformed = [&](int c) { return affine || (a.mul0 != nullptr && c < a.n0); };

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
  // the input tile's (TD + 2, IH, IW) voxels, each one's index in the halo
  // layout, or -1 outside the volume (a live D halo plane is inside):
  // computed once, so a copy costs no divisions
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
  // 16 B items i0 + pt, i0 + pt + nt, ... < i1 of chunk c's input tile
  // (TD + 2, IH, IW, KC) into slot c % 2, zeros outside the volume; for a
  // chunk of input 0 with a mask, each voxel's mask vector (KC channels,
  // within one 128 B line) is prefetched into L2 for the pass
  const unsigned a_items = halo * kVec, a_share = (a_items + kSpread - 1) / kSpread;
  const auto copy_a = [&](int c, unsigned i0, unsigned i1, int pt, int nt) {
    const uint32_t slot = s_a + (c & 1) * t.a_bytes;
    const bool in0 = c < a.n0;
    const int ci = in0 ? a.ci[0] : a.ci[1];   // no dynamic index: Args stays in
                                              // the parameter space, off the stack
    const bf16* xc = in0 ? a.x[0] + (size_t)c * KC : a.x[1] + (size_t)(c - a.n0) * KC;
    const bf16* mc = in0 && a.mul0 != nullptr ? a.mul0 + (size_t)c * KC : nullptr;
    for (unsigned i = i0 + pt; i < i1; i += nt) {
      const unsigned v8 = i % kVec, p = i / kVec;
      const int vox = vox_tab[p];
      cp_async16(slot + p * kP + v8 * 16, vox >= 0 ? xc + (size_t)vox * ci + v8 * 8 : a.x[0],
                 vox >= 0);
      if (mc != nullptr && vox >= 0 && v8 == 0) prefetch_l2(mc + (size_t)vox * ci);
    }
  };
  // tap 1..kSpread of chunk c's share of chunk c + 1's tile
  const auto copy_a_share = [&](int c, int tap, int pt, int nt) {
    const unsigned i0 = (tap - 1) * a_share;
    copy_a(c + 1, i0, i0 + a_share < a_items ? i0 + a_share : a_items, pt, nt);
  };
  // chunk c's landed tile rewritten in place at the voxels inside the
  // volume: the affine (and ReLU), then input 0's mask; by threads pt,
  // pt + nt, ... (nt a multiple of kVec: a thread keeps one 8-channel
  // vector of each voxel it visits, so its scale and shift are loaded
  // once), two voxels at a time, their mask loads issued before either
  // is used (four cost 12 registers a thread, and with them the third
  // block an SM of a one-chunk conv at N = 32)
  const auto transform = [&](int c, int pt, int nt) {
    unsigned char* tile = smem + kS * kSlot + (c & 1) * t.a_bytes;
    const int v8 = pt % kVec;
    const bf16* mc = a.mul0 != nullptr && c < a.n0 ? a.mul0 + (size_t)c * KC + v8 * 8 : nullptr;
    uint4 sc = make_uint4(0u, 0u, 0u, 0u), sh = sc;
    if (affine) {
      const size_t off = (size_t)b * a.ci_total + c * KC + v8 * 8;
      sc = *reinterpret_cast<const uint4*>(a.scale + off);
      sh = *reinterpret_cast<const uint4*>(a.shift + off);
    }
    const uint32_t* s = reinterpret_cast<const uint32_t*>(&sc);
    const uint32_t* h = reinterpret_cast<const uint32_t*>(&sh);
    const unsigned step = (unsigned)nt / kVec;
    for (unsigned p0 = pt / kVec; p0 < halo; p0 += 2 * step) {
      int vox[2];
      uint4 mv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned p = p0 + j * step;
        vox[j] = p < halo ? vox_tab[p] : -1;
        mv[j] = mc != nullptr && vox[j] >= 0
                    ? __ldg(reinterpret_cast<const uint4*>(mc + (size_t)vox[j] * a.ci[0]))
                    : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (vox[j] < 0) continue;
        uint4* e = reinterpret_cast<uint4*>(tile + (p0 + j * step) * kP + v8 * 16);
        uint4 v = *e;
        uint32_t* r = reinterpret_cast<uint32_t*>(&v);
        if (affine) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            r[k] = add_bf16x2(mul_bf16x2(r[k], s[k]), h[k]);
            if (a.relu) r[k] = relu_bf16x2(r[k]);
          }
        }
        if (mc != nullptr) {
          const uint32_t* m = reinterpret_cast<const uint32_t*>(&mv[j]);
#pragma unroll
          for (int k = 0; k < 4; ++k) r[k] = mul_bf16x2(r[k], m[k]);
        }
        *e = v;
      }
    }
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
    const bf16* src = a.w + ((size_t)tap * a.ci_total + c * KC) * co + co0;
#pragma unroll
    for (int j = 0; j < kMine; ++j)
      if (kRows % kCopiers == 0 || pt + j * kCopiers < kRows)
        cp_async16(slot + b_dst[j], src + b_src[j], true);
  };

  // the first chunk's tile, by every thread
  copy_a(0, 0, a_items, tid, kThreads);
  if constexpr (kWS) {
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (transformed(0)) {
      transform(0, tid, kThreads);
      __syncthreads();
    }
    if (tid >= kConsumers) {
      // ------------------------------------------------------ producer
      constexpr int kProducers = kThreads - kConsumers;
      for (int s = 0; s < n_steps; ++s) {
        const int c = s / 27, tap = s - 27 * c, slot = s % kS;
        if (s >= kS) mbar_wait(empty_b(slot), (s / kS - 1) & 1);
        if (tap >= 1 && tap <= kSpread && c + 1 < n_chunks) {
          // into the slot chunk c - 1 read
          if (tap == 1 && c >= 1) mbar_wait(empty_a((c + 1) & 1), ((c - 1) >> 1) & 1);
          copy_a_share(c, tap, pt, kProducers);
          if (tap == kSpread) {
            if (transformed(c + 1)) {
              // the whole tile landed, then the pass, then the hand-over
              cp_async_commit();
              cp_async_wait<0>();
              producer_sync();
              transform(c + 1, pt, kProducers);
              mbar_arrive(full_a((c + 1) & 1));
            } else {
              mbar_arrive_cp_async(full_a((c + 1) & 1));
            }
          }
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
        if (tap == 0 && transformed(c)) {
          // the previous step's wgmmas retire first, freeing their A
          // registers for the pass (fewer registers a thread: three blocks
          // an SM where the shared memory leaves room)
          wgmma_wait<0>();
          transform(c, tid, kThreads);
          __syncthreads();
        }
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
      // step s - 1's wgmmas are done; step s's run on (a specialised step
      // of one 64-row tile waits for its own, as K7's)
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
  // (M x N, pitch N + 8: conflict-free)
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

  // ---- statistics: thread (g, pair) sums its channel pair over the rows
  // g, g + kG, ... inside the volume; then one thread a pair adds the kG
  // partials in order and writes the block's sums
  if (a.part != nullptr) {
    constexpr int kPairs = N / 2, kG = kConsumers / kPairs;
    const int pr = tid % kPairs, g = tid / kPairs;
    float s1x = 0.f, s1y = 0.f, s2x = 0.f, s2y = 0.f;
    for (unsigned r = g; r < rows; r += kG) {
      const unsigned od = r / hw, q = r - od * hw, oh = q / TW, ow = q - oh * TW;
      if (d0 + (int)od >= a.D || h0 + (int)oh >= a.H || w0 + (int)ow >= a.W) continue;
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(stage + r * kLdS + 2 * pr));
      s1x += f.x;
      s1y += f.y;
      s2x += f.x * f.x;
      s2y += f.y * f.y;
    }
    float4* red = reinterpret_cast<float4*>(smem + 128 * MH * kLdS * 2);
    red[g * kPairs + pr] = make_float4(s1x, s1y, s2x, s2y);
    consumer_sync();
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
  const unsigned items = (unsigned)(dhi - dlo + 1) * nh * nw * (N / 8);
  for (unsigned i = tid; i < items; i += kConsumers) {
    const unsigned n8 = i % (N / 8), v = i / (N / 8), vh = v / nw;
    const int pw = wlo + (int)(v - vh * nw), ph = hlo + (int)(vh % nh), pd = dlo + (int)(vh / nh);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (pd >= 1 && pd <= a.D && ph >= 1 && ph <= a.H && pw >= 1 && pw <= a.W) {
      const unsigned r = (unsigned)(((pd - 1 - d0) * t.TH + (ph - 1 - h0)) * t.TW + (pw - 1 - w0));
      val = *reinterpret_cast<const uint4*>(stage + r * kLdS + n8 * 8);
    }
    *reinterpret_cast<uint4*>(a.y + ((((size_t)b * Dp + pd) * Hp + ph) * Wp + pw) * co + co0 +
                              n8 * 8) = val;
  }
}

// ------------------------------------------------------------- host
int cdiv(int n, int t) { return (n + t - 1) / t; }

int ring_slots(int N) { return N == 128 ? stages<128>() : stages<64>(); }

// the weight ring, the input-tile slots, the voxel table (rounded to 8 B)
// and 2 * stages + 4 mbarriers; the epilogue's stage and its statistics'
// partials reuse them
int smem_bytes(int N, int KC, int MH, int a_slots, int a_bytes, int halo) {
  const int ring = ring_slots(N) * KC * N * 2 + a_slots * a_bytes + (4 * halo + 7) / 8 * 8 +
                   8 * (2 * ring_slots(N) + 4);
  const int stage = 128 * MH * (N + 8) * 2 + kConsumers * 16;
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
  Plan p = {};
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
  p.t.n_sp = (int)best;
  p.t.n_ct = co / N;
  const int halo = p.t.ID * p.t.IH * p.t.IW;
  p.t.a_bytes = halo * P;
  p.t.tab_off = ring_slots(N) * KC * N * 2 + a_slots * p.t.a_bytes;
  p.t.bar_off = p.t.tab_off + (4 * halo + 7) / 8 * 8;
  p.smem = smem_bytes(N, KC, MH, a_slots, p.t.a_bytes, halo);
  p.blocks = best * B * p.t.n_ct;
  return p;
}

// N = 16 for co = 16, else the largest of 128, 64, 32 that divides co
// (co = 128 as one tile of 128 measured faster than two of 64). M = 256
// rows (KC = 32, to keep two input-tile slots in shared memory) where that
// still gives a wave of blocks: the weights are fetched once per M rows;
// otherwise M = 128 with KC = 64 where both widths allow it.
Plan plan(int B, int D, int H, int W, int ci0, int ci1, int co) {
  const int N = co == 16 ? 16 : co % 128 == 0 ? 128 : co % 64 == 0 ? 64 : 32;
  const int ci = ci0 + ci1;
  Plan p = patch(B, D, H, W, ci, co, N, 32, 2);
  if (p.blocks < kSMs)
    p = patch(B, D, H, W, ci, co, N, ci0 % 64 == 0 && ci1 % 64 == 0 ? 64 : 32, 1);
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
  if (p.N == 32) return launch_one<32, KC, MH>(a, B, p, s);
  return launch<16, KC, MH, true>(a, B, p, s);
}

bool valid(int B, int D, int H, int W, int ci0, int ci1, int co) {
  return B >= 1 && D >= 1 && H >= 1 && W >= 1 && ci0 >= 32 && ci0 % 32 == 0 && ci1 >= 0 &&
         ci1 % 32 == 0 && (co == 16 || (co > 0 && co % 32 == 0)) && B <= 65535 && D <= 65535 &&
         (long)B * (D + 2) * (H + 2) * (W + 2) <= 0x7fffffffL;
}

}  // namespace

// x1 may be null (one input, ci1 = 0); scale/shift/mul0/stats may be
// null. stats, when given, is the per-block buffer (B, n_sp, 2, co) f32
// (n_sp from ps2d_conv3d_plan), every value of which the launch writes:
// [b, i, 0, c] the sum and [b, i, 1, c] the sum of squares of channel c's
// bf16 outputs inside block i's patch. ci0, ci1 multiples of 32; co 16
// or a multiple of 32; every pointer 16 B aligned. d_live: bit 0 (1)
// says plane 0, bit 1 (2) plane D + 1 of every input (and of mul0) holds
// a D neighbour's values, loaded and transformed as the interior; the
// other halo voxels are read as zeros, the output's halo is zero and the
// statistics sum the interior. It comes last, so that a build from
// before it, called with 0, ignores it. Returns the launch's
// cudaError_t.
extern "C" int ps2d_conv3d(const void* x0, const void* x1, int ci0, int ci1,
                           const void* w, const void* scale, const void* shift,
                           int relu, const void* mul0, void* y, void* stats,
                           int B, int D, int H, int W, int co, void* stream,
                           int d_live) {
  if (x1 == nullptr) ci1 = 0;
  if (!valid(B, D, H, W, ci0, ci1, co)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, D, H, W, ci0, ci1, co);
  Args a;
  a.x[0] = static_cast<const bf16*>(x0);
  a.x[1] = static_cast<const bf16*>(x1);
  a.ci[0] = ci0;
  a.ci[1] = ci1;
  a.n0 = ci0 / p.KC;
  a.w = static_cast<const bf16*>(w);
  a.scale = static_cast<const bf16*>(scale);
  a.shift = static_cast<const bf16*>(shift);
  a.relu = relu;
  a.mul0 = static_cast<const bf16*>(mul0);
  a.y = static_cast<bf16*>(y);
  a.part = static_cast<float*>(stats);
  a.D = D;
  a.H = H;
  a.W = W;
  a.ci_total = ci0 + ci1;
  a.co = co;
  a.d_live = d_live & 3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.MH == 2) return launch_n<32, 2>(a, B, p, s);
  return p.KC == 64 ? launch_n<64, 1>(a, B, p, s) : launch_n<32, 1>(a, B, p, s);
}

// The launch geometry ps2d_conv3d picks: out[0..8] = N, KC, M, TD, TH, TW,
// blocks, dynamic shared memory bytes, and the blocks a batch item and
// channel tile (n_sp, the statistics buffer's second axis). ci1 = 0 for
// one input.
extern "C" int ps2d_conv3d_plan(int B, int D, int H, int W, int ci0, int ci1, int co,
                                int* out) {
  if (!valid(B, D, H, W, ci0, ci1, co)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, D, H, W, ci0, ci1, co);
  out[0] = p.N;
  out[1] = p.KC;
  out[2] = 128 * p.MH;
  out[3] = p.t.TD;
  out[4] = p.t.TH;
  out[5] = p.t.TW;
  out[6] = (int)p.blocks;
  out[7] = p.smem;
  out[8] = p.t.n_sp;
  return 0;
}

extern "C" const char* ps2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
