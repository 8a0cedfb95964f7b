// Q8: the int8 3x3x3 SAME conv of int8 serving, bf16 out:
//   q(v)   = clip(rint(v / act_scale), -127, 127)            (f32, IEEE /)
//   ws[o]  = max(max over t, c of |w[t, c, o]|, 1e-12) / 127
//   wq     = clip(rint(w / ws[o]), -127, 127)
//   acc    = sum over taps t, channels c of q(x[b, (d, h, w) + t - 1, c])
//            * wq[t, c, o]                                   (exact, int32)
//   y      = bf16(f32(acc) * (act_scale * ws[o]) [+ bias[o]])
// with x taken as 0 outside the volume. x (B, D, H, W, ci) bf16 or f32,
// w (27, ci, co) f32 (DHWIO), y (B, D, H, W, co) bf16; any ci, co a
// multiple of 8. The function of the JAX package's ops/conv.py
// conv3d_zcat_int8 (:197-285), bit for bit: the int8 products summed in
// int32 are exact (and wrap as JAX's int32 sums would past 2^31, which
// no ci up to 4928 reaches: 27 * 4928 * 127^2 < 2^31), and every f32 step
// is the same IEEE operation (no --use_fast_math, no contraction:
// __fdiv_rn, __fmul_rn, __fadd_rn).
//
// It replaces no TPU kernel: in JAX this conv is an XLA conv. PyTorch has
// no int8 3-D conv; torch._int_mm would need a 27x-wide im2col copy.
//
// Bound on the H100: 2 * 27 * ci * co int8 operations a voxel against
// 2 * ci + 2 * co bytes (bf16 in and out) and the weights: the level-0
// convs (ci <= 64, co = 32 at 128^3) are bound by bytes, the deeper ones
// by operations, the bottleneck's by its weights (read as f32 when they
// are quantized in the call, as int8 when they come prepared).
//
// Design:
//  * Weights, once per weight version (the caller keeps them): two small
//    kernels, the per-output-channel maxima of |w| (atomicMax of their
//    bits over row blocks of K: exact in any order), then the scales and
//    the int8 weights in the layout the tensor cores read, 16 B rows of K
//    (the GEMM's depth, tap-major: k = t * cip + c) for 8 output channels
//    in 128 B core matrices, (co / 8, K / 16, 8, 16). K runs over cip = ci
//    rounded up to 32 (zero channels), or, where ci <= 4, over (tap,
//    channel) pairs packed four channels a tap: 27 * 4 = 108 rounded up
//    to 128, four k32 steps instead of 27.
//  * x, once a call, by its own pass: every element loaded and quantized
//    once into an int8 copy (B, D, H, W, cip), ci / 2 (bf16) or ci / 4
//    (f32) of x's bytes, which the conv then copies as overlapping tiles:
//    the overlap factor (tile voxels over patch voxels) is 2.34 at level
//    0's 4 x 8 x 8 patch, not the 1.27 of a kernel streaming D planes
//    through a ring of three (not built).
//  * The conv: an implicit GEMM on Hopper's warpgroup MMA, int8 in, int32
//    accumulators: wgmma.mma_async m64nNk32.s32.s8.s8, N = 32 or 64 output
//    channels, B K-major from shared memory through a no-swizzle
//    descriptor, A (64 voxels x 32 bytes of K) from registers: ldmatrix.x4
//    of a shifted window of the input tile, or, packed, one 32-bit load a
//    register (one tap's four channels of one voxel). A warpgroup holds
//    MH = 4 (N = 32, not packed) or 2 64-row tiles. The taps run in groups
//    of three (kw = 0, 1, 2): the group's fragments are loaded, its 3 x MH
//    wgmmas issued and retired before the next group's loads, since a
//    fragment written while a wgmma is in flight makes ptxas serialize
//    every wgmma of the kernel (C7513). (A from shared memory through a
//    descriptor needs no fragments, but the tensor cores then fetch A's
//    2 KB a wgmma themselves, and a tap's 16 B shift leaves its core
//    matrices off 128 B: measured 1.3 times slower over the 22 convs.)
//  * A block is persistent, one an SM, of two consumer warpgroups and a
//    producer warpgroup, which copies each item's 32-channel chunks of the
//    input tile (TB, TD+2, TH+2, TW+2, 32) int8 (zeros outside the volume:
//    the pad of a SAME conv quantizes to 0; each tile voxel's offsets from
//    a table built once a block) into rings of stages by cp.async, each
//    stage's completion signalled on an mbarrier and its release on a
//    second one once the wgmmas that read it retire. The int8 copy is read
//    at (TD+2)(TH+2)(TW+2) / (TD TH TW) bytes an element (2.34 at level 0's
//    4 x 8 x 8 patch), mostly from L2. Where the channel tile's 27 * cip *
//    N int8 weights fit beside the rings ("resident": level 0, and 64^3
//    but 128 -> 64, and 64 -> 128 at 32^3) they are copied once a block,
//    and the consumers take the items in turn (ping-pong: one's epilogue
//    runs under the other's wgmmas), each warpgroup its own ring;
//    elsewhere ("streamed") each stage also carries the chunk's 27 weight
//    slabs and both warpgroups take every item (256 rows at N = 64) from
//    one ring, so a slab serves twice the rows.
//  * Split of K where the patches x channel tiles do not fill the 132
//    blocks (the 8^3 and 4^3 levels): each split sums its chunks and adds
//    its int32 partial sums into a zeroed int32 scratch (red.global.add:
//    integer addition is exact and associative, so every run gives the
//    same bits), and a last small kernel applies the epilogue.
//  * Epilogue: int32 -> f32 (__int2float_rn), times the f32 product
//    act_scale * ws[o] formed first, + bias, one rounding to bf16, staged
//    per warp in shared memory and stored 16 B at a time along co, masked
//    to the volume.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSMs = 132;             // H100 SXM
constexpr int kSmemMax = 232448;      // shared memory a block can have
constexpr int kRowsN32 = 256;         // GEMM rows an item where N = 32 (else 128)
constexpr int kConsumers = 256;       // warps 0-7: two warpgroups
constexpr int kProducers = 128;       // warps 8-11
constexpr int kThreads = kConsumers + kProducers;
constexpr int kMaxStages = 6;
constexpr int kPitch = 48;            // A tile bytes a voxel: 32 + 16 pad
constexpr int kMaxTile = 1024;        // A tile voxels at most
constexpr int kBarBytes = 128;        // the rings' mbarriers
constexpr int kMaxSplits = 256;       // row blocks of the weights' maxima

__device__ __forceinline__ int quant(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(const float* f, float s) {
  return (static_cast<uint32_t>(quant(f[0], s)) & 0xffu) |
         ((static_cast<uint32_t>(quant(f[1], s)) & 0xffu) << 8) |
         ((static_cast<uint32_t>(quant(f[2], s)) & 0xffu) << 16) |
         (static_cast<uint32_t>(quant(f[3], s)) << 24);
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// eight channels c.. of x at element idx (c < ci), 0 past ci
template <typename T>
__device__ __forceinline__ void load8(const T* x, size_t idx, int c, int ci, bool vec, float* f);
template <>
__device__ __forceinline__ void load8<bf16>(const bf16* x, size_t idx, int c, int ci, bool vec,
                                            float* f) {
  if (vec) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(x + idx));
    const bf16* v = reinterpret_cast<const bf16*>(&r);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = c + i < ci ? __bfloat162float(x[idx + i]) : 0.f;
  }
}
template <>
__device__ __forceinline__ void load8<float>(const float* x, size_t idx, int c, int ci, bool vec,
                                             float* f) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(x + idx));
    const float4 b = __ldg(reinterpret_cast<const float4*>(x + idx + 4));
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = c + i < ci ? x[idx + i] : 0.f;
  }
}

// 4 B global -> shared (cp.async's .ca form; zeros when !valid)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

// wgmma descriptor of a K-major no-swizzle operand: core matrices of 8
// rows x 16 B (128 contiguous bytes); `lbo` bytes between the two core
// matrices of a k32 step along K, `sbo` bytes between 8-row groups along
// N; base offset 0, no swizzle
__device__ __forceinline__ uint64_t k_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x N, s32, the warpgroup's accumulator) (+)= A (64 x 32 s8, this
// thread's mma.m16n8k32 A fragment) * B (32 x N s8, K-major,
// descriptor); with scale_d = 0, d = A B (d's old values are not read)
#define Q8_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define Q8_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define Q8_OUT16(d)                                                                    \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), \
      "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),       \
      "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
#define Q8_OUT32(d)                                                                      \
  Q8_OUT16(d), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),          \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),      \
      "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])

template <int N>
struct MmaS8;

template <>
struct MmaS8<32> {
  static __device__ __forceinline__ void rs(int (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " Q8_D16
        ", {%16, %17, %18, %19}, %20, p;\n}\n"
        : Q8_OUT16(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct MmaS8<64> {
  static __device__ __forceinline__ void rs(int (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " Q8_D32
        ", {%32, %33, %34, %35}, %36, p;\n}\n"
        : Q8_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// keep the compiler from moving accumulator accesses across a wait
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ------------------------------------------------------------ weights
// wmax[o] = max |w[k, o]| over K = 27 * ci rows, as the bits of a
// non-negative f32 (whose order is their integer order): each block takes
// row block blockIdx.y of 32 channels and folds its maximum in by
// atomicMax, exact in any order; wmax starts at 0
__global__ void __launch_bounds__(256) weight_max_kernel(const float* __restrict__ w,
                                                         int* __restrict__ wmax, int K, int co,
                                                         int rows) {
  __shared__ float red[8][32];
  const int o = blockIdx.x * 32 + (threadIdx.x & 31);
  const int g = threadIdx.x >> 5;
  const int k1 = min(K, ((int)blockIdx.y + 1) * rows);
  float m[4] = {0.f, 0.f, 0.f, 0.f};
  if (o < co) {
    int k = (int)blockIdx.y * rows + g;
    for (; k + 24 < k1; k += 32)
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], fabsf(w[(size_t)(k + 8 * i) * co + o]));
    for (; k < k1; k += 8) m[0] = fmaxf(m[0], fabsf(w[(size_t)k * co + o]));
  }
  red[g][threadIdx.x & 31] = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
  __syncthreads();
  if (g == 0 && o < co) {
    float v = red[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < 8; ++i) v = fmaxf(v, red[i][threadIdx.x]);
    atomicMax(wmax + o, __float_as_int(v));
  }
}

// ws[o] and the int8 weights of 32 channels o and 32 K rows kp (blockIdx.y)
// in the core-matrix layout (co / 8, k16, 8, 16): kp = t * cip + c, or,
// packed (cip = 4), kp = t * 4 + c with taps 27..31 zero
__global__ void __launch_bounds__(256) weight_quant_kernel(
    const float* __restrict__ w, const int* __restrict__ wmax, float* __restrict__ w_scale,
    int8_t* __restrict__ wq, int ci, int cip, int co, int k16) {
  __shared__ float sc[32];
  __shared__ __align__(16) uint8_t qs[32][32];
  const int ol = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int o = blockIdx.x * 32 + ol;
  if (g == 0) {
    const float m = o < co ? __int_as_float(wmax[o]) : 0.f;
    const float scale = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
    sc[ol] = scale;
    if (blockIdx.y == 0 && o < co) w_scale[o] = scale;
  }
  __syncthreads();
  for (int kk = g; kk < 32; kk += 8) {
    const int kp = blockIdx.y * 32 + kk;
    const int t = kp / cip, c = kp % cip;
    const float v = (o < co && c < ci && t < 27) ? w[((size_t)t * ci + c) * co + o] : 0.f;
    qs[ol][kk] = static_cast<uint8_t>(quant(v, sc[ol]));
  }
  __syncthreads();
  if (threadIdx.x < 64) {
    const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int orow = blockIdx.x * 32 + row;
    if (orow < co)
      *reinterpret_cast<uint4*>(wq + ((size_t)(orow >> 3) * k16 + blockIdx.y * 2 + half) * 128 +
                                (orow & 7) * 16) =
          *reinterpret_cast<const uint4*>(&qs[row][16 * half]);
  }
}

// -------------------------------------------------------------- x pass
// xq (B * D * H * W, cip) int8 = q(x), zero channels past ci; a unit is 16
// channels of a voxel (4 when packed); units below 2^31 use `groups`, the
// 16-channel groups a voxel, as a fast division
template <typename T>
__global__ void __launch_bounds__(256) quant_x_kernel(const T* __restrict__ x,
                                                      int8_t* __restrict__ xq, long long units,
                                                      int ci, int cip, FastDiv groups,
                                                      const float* __restrict__ act_scale) {
  const float s = *act_scale;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (cip == 4) {
    for (; u < units; u += stride) {
      float f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = i < ci ? to_f(x[u * ci + i]) : 0.f;
      reinterpret_cast<uint32_t*>(xq)[u] = pack4(f, s);
    }
    return;
  }
  const bool vec = (ci & 7) == 0;
  const bool small = units < 0x7fffffffLL;
  for (; u < units; u += stride) {
    const long long vox = small ? (long long)((int)u / groups) : u / groups.d;
    const int c0 = (int)(u - vox * groups.d) * 16;
    float f[16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 8 * h;
      if (c < ci) {
        load8<T>(x, (size_t)vox * ci + c, c, ci, vec, f + 8 * h);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[8 * h + i] = 0.f;
      }
    }
    uint4 q;
    q.x = pack4(f, s);
    q.y = pack4(f + 4, s);
    q.z = pack4(f + 8, s);
    q.w = pack4(f + 12, s);
    *reinterpret_cast<uint4*>(xq + (size_t)vox * cip + c0) = q;
  }
}

// ---------------------------------------------------------------- conv
// the launch geometry, worked out on the host (plan)
struct Geo {
  int B, D, H, W, ci, co, cip;
  int TB, TD, TH, TW;        // the patch, powers of two
  int lw, lh, ld;            // their log2 (W, H, D)
  int nd, nh, nw;            // patches along D, H, W
  int patches, n_tiles;      // patches; output-channel tiles of N
  int chunks, splits, items; // 32-channel chunks of K (1 packed); K splits
  int stages;                // ring slots
  int a_slot, slot, b_res;   // bytes: an input tile, a ring slot, resident weights
  int k16;                   // 16 B rows of K in the weights' layout
  int V;                     // input-tile voxels
  int HW, DHW;               // voxels a plane, a sample
  FastDiv f_nw, f_nh, f_nd, f_patches, f_tiles;
};

struct Args {
  const int8_t* xq;       // (B, D, H, W, cip)
  const int8_t* wq;       // (co / 8, k16, 8, 16)
  const float* w_scale;   // (co,)
  const float* act_scale;
  const float* bias;      // (co,) or null
  bf16* y;                // (B, D, H, W, co)
  int* acc;               // (B, D, H, W, co) int32, zeroed, where split; else null
};

// a patch row r -> (tb, td, th, tw), W fastest
__device__ __forceinline__ void row_pos(int r, const Geo& g, int& tb, int& td, int& th, int& tw) {
  tw = r & (g.TW - 1);
  th = (r >> g.lw) & (g.TH - 1);
  td = (r >> (g.lw + g.lh)) & (g.TD - 1);
  tb = r >> (g.lw + g.lh + g.ld);
}

// item -> patch origin, channel tile, chunk range. Resident: the item is
// a patch of channel tile blockIdx.y; streamed: ((split * n_tiles + nt) *
// patches + p)
template <bool kResident>
__device__ __forceinline__ void decode(int it, const Geo& g, int& b0, int& d0, int& h0, int& w0,
                                       int& nt, int& c_lo, int& c_hi) {
  int p = it, split = 0;
  nt = blockIdx.y;
  if (!kResident) {
    const int q = it / g.f_patches;
    p = it - q * g.patches;
    split = q / g.f_tiles;
    nt = q - split * g.n_tiles;
  }
  int r = p / g.f_nw;
  w0 = (p - r * g.nw) * g.TW;
  p = r;
  r = p / g.f_nh;
  h0 = (p - r * g.nh) * g.TH;
  p = r;
  r = p / g.f_nd;
  d0 = (p - r * g.nd) * g.TD;
  b0 = r * g.TB;
  c_lo = (int)((long long)split * g.chunks / g.splits);
  c_hi = (int)((long long)(split + 1) * g.chunks / g.splits);
}

// the producer warpgroup alone (named barrier 1)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// Warps 0-3 and 4-7 are two consumer warpgroups, each of MH 64-row
// tiles; warps 8-11 (the producer) copy the input tiles (and, streamed,
// the weight slabs) into rings of stages. Resident, the warpgroups take
// the block's items in turn (ping-pong: one's epilogue runs under the
// other's wgmmas), each item 64 * MH rows, each warpgroup its own ring;
// streamed, both take every item (64 * MH rows each) from one ring, so a
// stage's weight slabs serve twice the rows. Each ring slot has a "full"
// mbarrier (the producer's 128 threads arrive as their copies land) and
// an "empty" one (its consumers arrive once the wgmmas that read it have
// retired). A comes from registers: ldmatrix, or, packed, 32-bit loads.
template <int N, int MH, bool kPacked, bool kResident>
__global__ void __launch_bounds__(kThreads, 1) conv_kernel(const Args a, const Geo g) {
  constexpr int kLd = N + 8;   // staging pitch (bf16): conflict-free rows
  constexpr int kOut = 16 * (N / 8) / 32;   // a lane's 16 B stores a tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t s_bres = s0;
  const uint32_t s_ring = s0 + (kResident ? g.b_res : 0);
  const int ring_end = (kResident ? g.b_res : 0) + g.stages * g.slot;
  bf16* staging = reinterpret_cast<bf16*>(smem + ring_end);
  int* tab_rel = reinterpret_cast<int*>(smem + ring_end + 8 * 16 * kLd * 2);
  int* tab_pos = tab_rel + kMaxTile;
  const uint32_t bar = s0 + ring_end + 8 * 16 * kLd * 2 + kMaxTile * 8;
  const auto full = [&](int i) { return bar + 8 * i; };
  const auto empty = [&](int i) { return bar + 8 * (kMaxStages + i); };
  const int tid = threadIdx.x;
  const int TWp = g.TW + 2, THp = g.TH + 2, TDp = g.TD + 2;
  const int prows = g.TB * g.TD * g.TH * g.TW;
  const int n_local = kResident ? g.patches : g.items;

  constexpr bool kPing = kResident;
  if (tid == 0) {
    for (int i = 0; i < g.stages; ++i) {
      mbar_init(full(i), kProducers);
      mbar_init(empty(i), kPing ? kConsumers / 2 : kConsumers);
    }
  }
  // ping-pong: two rings, one a consumer warpgroup: item k of the block
  // goes to ring k % 2, whose slots r * sr .. r * sr + sr - 1 only that
  // warpgroup reads (one ring would let a warpgroup wait on a slot two
  // phases ahead of its fills, where an mbarrier's parity cannot tell)
  const int sr = kPing ? g.stages / 2 : g.stages;
  if constexpr (kResident) {
    // the channel tile's weights for the whole K, once: contiguous in the
    // layout, (N / 8) x k16 rows of 128 B; zeros past co
    const int n0 = blockIdx.y * N;
    const int pieces = N * g.k16;   // 16 B each
    const int8_t* src = a.wq + (size_t)(n0 >> 3) * g.k16 * 128;
    for (int q = tid; q < pieces; q += kThreads) {
      const bool ok = n0 + 8 * (q / (8 * g.k16)) < g.co;
      cp_async16(s_bres + q * 16, ok ? src + (size_t)q * 16 : a.wq, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---------------------------------------------------------- producer
    const int pt = tid - kConsumers;
    // each tile voxel's offset from the tile's first (tb * DHW + zd * HW +
    // zh * W + zw) and its (tb, zd, zh, zw), a byte each, once a block
    for (int v = pt; v < g.V; v += kProducers) {
      const int zw = v % TWp, zh = (v / TWp) % THp, zd = (v / (TWp * THp)) % TDp,
                tb = v / (TWp * THp * TDp);
      tab_rel[v] = tb * g.DHW + zd * g.HW + zh * g.W + zw;
      tab_pos[v] = tb << 24 | zd << 16 | zh << 8 | zw;
    }
    producer_sync();
    constexpr int kPer = kPacked ? 1 : 2;   // copies a voxel: 4 B, or 2 x 16 B
    int js[2] = {0, 0};   // each ring's stages so far
    int k = 0;
    for (int it = blockIdx.x; it < n_local; it += gridDim.x, ++k) {
      int b0, d0, h0, w0, nt, c_lo, c_hi;
      decode<kResident>(it, g, b0, d0, h0, w0, nt, c_lo, c_hi);
      // the tile's first voxel (it may lie outside the volume)
      const long long base = (long long)b0 * g.DHW + (long long)(d0 - 1) * g.HW +
                             (long long)(h0 - 1) * g.W + (w0 - 1);
      const int r = kPing ? k & 1 : 0;
      for (int c = c_lo; c < c_hi; ++c) {
        const int j = js[r]++;
        const int slot = r * sr + j % sr;
        if (j >= sr) mbar_wait(empty(slot), (j / sr - 1) & 1);
        const uint32_t dst = s_ring + slot * g.slot;
        // the input tile, zeros outside the volume
        const int8_t* src = a.xq + c * 32;
        for (int q = pt; q < g.V * kPer; q += kProducers) {
          const int v = kPacked ? q : q >> 1, half = kPacked ? 0 : q & 1;
          const int e = tab_pos[v];
          const int b = b0 + (e >> 24), d = d0 - 1 + ((e >> 16) & 0xff),
                    h = h0 - 1 + ((e >> 8) & 0xff), w = w0 - 1 + (e & 0xff);
          const bool ok = b < g.B && (unsigned)d < (unsigned)g.D &&
                          (unsigned)h < (unsigned)g.H && (unsigned)w < (unsigned)g.W;
          const long long vox = ok ? base + tab_rel[v] : 0;
          if constexpr (kPacked) {
            cp_async4(dst + v * 4, a.xq + vox * 4, ok);
          } else {
            cp_async16(dst + v * kPitch + half * 16, src + vox * g.cip + half * 16, ok);
          }
        }
        if constexpr (!kResident) {
          // the chunk's 27 weight slabs: (n8, tap) runs of 256 B (the two
          // 16 B-deep core matrices of the tap's k32 step)
          const int n0 = nt * N;
          const uint32_t bdst = dst + g.a_slot;
          for (int q = pt; q < 27 * N * 2; q += kProducers) {
            const int jj = q & 15, tn = q >> 4, tap = tn % 27, n8 = tn / 27;
            const bool ok = n0 + 8 * n8 < g.co;
            const int8_t* wsrc =
                a.wq + ((size_t)((n0 >> 3) + n8) * g.k16 + tap * (g.cip >> 4) + 2 * c) * 128 +
                jj * 16;
            cp_async16(bdst + (n8 * 54 + tap * 2) * 128 + jj * 16, ok ? wsrc : a.wq, ok);
          }
        }
        mbar_arrive_cp_async(full(slot));
      }
    }
    cp_async_wait<0>();
    return;
  }

  // ------------------------------------------------------------ consumers
  const int lane = tid & 31, warp = tid >> 5, wg = tid >> 7, wi = warp & 3;
  // + mh * 64: the warp's rows of an item
  const int row0 = wi * 16 + (kPing ? 0 : wg * 64 * MH);
  // each of this lane's A rows' tile voxel (ldmatrix row address, or,
  // packed, the voxels of rows g and g + 8)
  uint32_t a_lane[MH];
  int vo[MH][2];
#pragma unroll
  for (int mh = 0; mh < MH; ++mh) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row0 + mh * 64 + (kPacked ? (lane >> 2) + 8 * e : (lane & 15)),
                rr = r < prows ? r : 0;
      int tb, td, th, tw;
      row_pos(rr, g, tb, td, th, tw);
      vo[mh][e] = ((tb * TDp + td) * THp + th) * TWp + tw;
    }
    a_lane[mh] = vo[mh][0] * kPitch + (lane >> 4) * 16;
  }
  // packed: the tile offsets of this lane's taps 8 ks + t and 8 ks + 4 + t
  // (t = lane % 4), -1 past tap 26
  int tof[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tap = 8 * ks + 4 * e + (lane & 3);
      tof[ks][e] = (kPacked && tap < 27)
                       ? ((tap / 9) * THp + (tap / 3) % 3) * TWp + tap % 3
                       : -1;
    }
  // the epilogue's 16 B stores: each one's row offset from the patch's
  // first voxel and its (tb, td, th, tw), or -1 past the patch
  int o_rel[MH][kOut], o_pos[MH][kOut];
#pragma unroll
  for (int mh = 0; mh < MH; ++mh)
#pragma unroll
    for (int i = 0; i < kOut; ++i) {
      const int r = row0 + mh * 64 + (lane + 32 * i) / (N / 8);
      int tb, td, th, tw;
      row_pos(r, g, tb, td, th, tw);
      o_rel[mh][i] = tb * g.DHW + td * g.HW + th * g.W + tw;
      o_pos[mh][i] = r < prows ? tb << 24 | td << 16 | th << 8 | tw : -1;
    }
  // the weights' descriptor strides: LBO between a k32 step's two core
  // matrices, SBO between 8-channel groups
  const uint32_t sbo = kResident ? (uint32_t)g.k16 * 128u : 54u * 128u;
  const int gq = lane >> 2, t4 = lane & 3;
  const float sa = *a.act_scale;

  int acc[MH][N / 2];
  uint32_t frag[1][MH][4];
  float fs[N / 8][2], fb[N / 8][2];   // the epilogue's scales and bias
  int cur_nt = -1;
  bf16* st = staging + warp * 16 * kLd;
  int j = 0;   // this warpgroup's ring's stages so far
  const int step = kPing ? 2 * gridDim.x : gridDim.x;
  for (int it = blockIdx.x + (kPing ? wg * gridDim.x : 0); it < n_local; it += step) {
    int b0, d0, h0, w0, nt, c_lo, c_hi;
    decode<kResident>(it, g, b0, d0, h0, w0, nt, c_lo, c_hi);
    for (int c = c_lo; c < c_hi; ++c, ++j) {
      const int slot = (kPing ? wg * sr : 0) + j % sr;
      mbar_wait(full(slot), (j / sr) & 1);
      fence_proxy_async();
      const uint32_t tile = s_ring + slot * g.slot;
      const int first = c == c_lo;   // the item's first products: D = A B
      if constexpr (kPacked) {
        // four k32 steps: taps 8 ks .. 8 ks + 7, four channels each; one
        // fragment set, each step retired before the next one's loads
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int h = 0;
#pragma unroll
          for (int mh = 0; mh < MH; ++mh)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int rw = 0; rw < 2; ++rw) {
                uint32_t v = 0;
                if (tof[ks][e] >= 0)
                  asm volatile("ld.shared.b32 %0, [%1];\n"
                               : "=r"(v)
                               : "r"(tile + (vo[mh][rw] + tof[ks][e]) * 4));
                frag[h][mh][2 * e + rw] = v;
              }
          wgmma_fence();
#pragma unroll
          for (int mh = 0; mh < MH; ++mh)
            MmaS8<N>::rs(acc[mh], frag[h][mh], k_desc(s_bres + ks * 256, 128, sbo),
                         !(first && ks == 0));
          wgmma_commit();
          wgmma_wait<0>();
        }
        mbar_arrive(empty(slot));
      } else {
        // A from registers, three taps (kw = 0, 1, 2 of a (kd, kh)) a
        // group: their fragments loaded before the group's wgmmas and
        // retired before the next group's loads (a fragment written under
        // a wgmma in flight makes ptxas serialize them all)
        const uint32_t wb = kResident ? s_bres + c * 256 : tile + g.a_slot;
        const uint32_t tap_b = kResident ? (uint32_t)(g.cip >> 4) * 128u : 256u;
#pragma unroll 1
        for (int t0 = 0; t0 < 27; t0 += 3) {
          const uint32_t off = tile + ((t0 / 9) * THp + (t0 / 3) % 3) * TWp * kPitch;
          uint32_t fr[3][MH][4];
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int mh = 0; mh < MH; ++mh)
              ldmatrix_x4(fr[kw][mh], off + kw * kPitch + a_lane[mh]);
          wgmma_fence();
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int mh = 0; mh < MH; ++mh)
              MmaS8<N>::rs(acc[mh], fr[kw][mh], k_desc(wb + (t0 + kw) * tap_b, 128, sbo),
                           !(first && t0 + kw == 0));
          wgmma_commit();
          wgmma_wait<0>();
        }
        mbar_arrive(empty(slot));
      }
    }
#pragma unroll
    for (int mh = 0; mh < MH; ++mh) fence_acc(acc[mh]);

    // ------------------------------------------------------ epilogue
    const int n0 = nt * N;
    const long long base = (long long)b0 * g.DHW + (long long)d0 * g.HW +
                           (long long)h0 * g.W + w0;
    if (a.acc) {
      // split: the int32 partial sums into the scratch
#pragma unroll
      for (int mh = 0; mh < MH; ++mh)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int r = row0 + mh * 64 + gq + 8 * e2;
          int tb, td, th, tw;
          row_pos(r < prows ? r : 0, g, tb, td, th, tw);
          const int b = b0 + tb, d = d0 + td, hh = h0 + th, w = w0 + tw;
          if (r >= prows || b >= g.B || d >= g.D || hh >= g.H || w >= g.W) continue;
          int* dst = a.acc + (base + tb * g.DHW + td * g.HW + th * g.W + tw) * g.co;
#pragma unroll
          for (int jj = 0; jj < N / 8; ++jj) {
            const int n = n0 + 8 * jj + 2 * t4;
            if (n < g.co) {   // co % 8 == 0: n + 1 < co too
              atomicAdd(dst + n, acc[mh][4 * jj + 2 * e2]);
              atomicAdd(dst + n + 1, acc[mh][4 * jj + 2 * e2 + 1]);
            }
          }
        }
      continue;
    }
    if (nt != cur_nt) {   // act_scale * ws[o] (formed first) and bias[o]
      cur_nt = nt;
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * jj + 2 * t4 + e;
          fs[jj][e] = n < g.co ? __fmul_rn(sa, a.w_scale[n]) : 0.f;
          fb[jj][e] = n < g.co && a.bias ? a.bias[n] : 0.f;
        }
    }
#pragma unroll
    for (int mh = 0; mh < MH; ++mh) {
#pragma unroll
      for (int jj = 0; jj < N / 8; ++jj) {
        const int col = 8 * jj + 2 * t4;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float v0 = __fmul_rn(__int2float_rn(acc[mh][4 * jj + 2 * e2]), fs[jj][0]);
          float v1 = __fmul_rn(__int2float_rn(acc[mh][4 * jj + 2 * e2 + 1]), fs[jj][1]);
          if (a.bias) {
            v0 = __fadd_rn(v0, fb[jj][0]);
            v1 = __fadd_rn(v1, fb[jj][1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(st + (gq + 8 * e2) * kLd + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kOut; ++i) {
        const int q = lane + 32 * i, rl = q / (N / 8), c8 = q % (N / 8), e = o_pos[mh][i];
        const int n = n0 + 8 * c8;
        if (e >= 0 && b0 + (e >> 24) < g.B && d0 + ((e >> 16) & 0xff) < g.D &&
            h0 + ((e >> 8) & 0xff) < g.H && w0 + (e & 0xff) < g.W && n < g.co)
          *reinterpret_cast<uint4*>(a.y + (base + o_rel[mh][i]) * g.co + n) =
              *reinterpret_cast<const uint4*>(st + rl * kLd + 8 * c8);
      }
      __syncwarp();
    }
  }
}

// the split's epilogue: y = bf16(f32(acc) * (act_scale * ws[o]) [+ bias])
__global__ void __launch_bounds__(256) finish_kernel(const int* __restrict__ acc,
                                                     const float* __restrict__ w_scale,
                                                     const float* __restrict__ act_scale,
                                                     const float* __restrict__ bias,
                                                     bf16* __restrict__ y, long long units,
                                                     int co8) {
  const float sa = *act_scale;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(u % co8) * 8;
    const int4 lo = reinterpret_cast<const int4*>(acc)[2 * u];
    const int4 hi = reinterpret_cast<const int4*>(acc)[2 * u + 1];
    const int v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    __align__(16) __nv_bfloat162 out[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v0 = __fmul_rn(__int2float_rn(v[2 * i]), __fmul_rn(sa, w_scale[n + 2 * i]));
      float v1 = __fmul_rn(__int2float_rn(v[2 * i + 1]), __fmul_rn(sa, w_scale[n + 2 * i + 1]));
      if (bias) {
        v0 = __fadd_rn(v0, bias[n + 2 * i]);
        v1 = __fadd_rn(v1, bias[n + 2 * i + 1]);
      }
      out[i] = __floats2bfloat162_rn(v0, v1);
    }
    reinterpret_cast<uint4*>(y)[u] = *reinterpret_cast<const uint4*>(out);
  }
}

// One 64 x N x 32 int8 product through the kernel's own pieces (ldmatrix
// rows at the kernel's pitch, the weights' core-matrix layout, k_desc,
// MmaS8, the accumulator mapping): a (64, 32) and b (N, 32) s8 row-major
// (b K-major), d (64, N) s32.
template <int N>
__global__ void __launch_bounds__(128) probe_kernel(const int8_t* A, const int8_t* Bm, int* D) {
  __shared__ __align__(128) unsigned char s_b[32 * N];
  __shared__ __align__(128) unsigned char s_a[64 * kPitch];
  const int tid = threadIdx.x, lane = tid & 31;
  cp_async16(smem_u32(s_a) + (tid >> 1) * kPitch + (tid & 1) * 16, A + tid * 16, true);
  for (int i = tid; i < 2 * N; i += 128) {   // (n, k16) rows of 16 B
    const int n = i >> 1, h = i & 1;
    cp_async16(smem_u32(s_b) + ((n >> 3) * 2 + h) * 128 + (n & 7) * 16, Bm + n * 32 + h * 16,
               true);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  uint32_t frag[4];
  ldmatrix_x4(frag, smem_u32(s_a) + ((tid >> 5) * 16 + (lane & 15)) * kPitch + (lane >> 4) * 16);
  int acc[N / 2];
  wgmma_fence();
  MmaS8<N>::rs(acc, frag, k_desc(smem_u32(s_b), 128, 256), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  const int row = (tid >> 5) * 16 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      D[(row + 8 * (e >> 1)) * N + 8 * j + col + (e & 1)] = acc[4 * j + e];
}

// ---------------------------------------------------------------- host
int pow2_at_least(int n) {
  int v = 1;
  while (v < n) v <<= 1;
  return v;
}
int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}
int round128(int n) { return (n + 127) & ~127; }

bool bad_shape(int B, int D, int H, int W, int ci, int co) {
  return B < 1 || D < 1 || H < 1 || W < 1 || ci < 1 || co < 8 || co % 8 ||
         (long)B * D * H * W > 0x7fffffffL || ci > 0x7fffffff / 27 / 32;
}

struct Plan {
  Geo g;
  int N, packed, resident, grid_x, grid_y, smem, weight_splits;
};

// The patch for N output channels a tile: up to 8 along W and H, up to
// 16 along D and B, at most 256 voxels where N = 32 (not packed) and 128
// else (a warpgroup's accumulators of four or two 64-row tiles), twice that
// streamed (both warpgroups on an item); the deepest levels' small
// volumes take several samples an item; its tile at most kMaxTile
// voxels. Resident where the channel tile's weights and two tile slots
// fit (else false, where not asked for streamed); streamed, its K split
// where the items do not fill the 132 blocks.
bool shape_plan(Plan& q, int N, bool streamed) {
  Geo& g = q.g;
  const int B = g.B, D = g.D, H = g.H, W = g.W;
  q.N = N;
  g.n_tiles = (g.co + N - 1) / N;
  g.TW = std::min(8, pow2_at_least(W));
  g.TH = std::min(8, pow2_at_least(H));
  const int rows = (N == 32 && !q.packed ? kRowsN32 : kRowsN32 / 2) * (streamed ? 2 : 1);
  g.TD = std::min({16, rows / (g.TW * g.TH), pow2_at_least(D)});
  g.TB = std::min({16, rows / (g.TD * g.TH * g.TW), pow2_at_least(B)});
  while (g.TB * (g.TD + 2) * (g.TH + 2) * (g.TW + 2) > kMaxTile) {
    if (g.TB > 1)
      g.TB >>= 1;
    else
      g.TD >>= 1;
  }
  g.lw = log2i(g.TW), g.lh = log2i(g.TH), g.ld = log2i(g.TD);
  const int nb = (B + g.TB - 1) / g.TB;
  g.nd = (D + g.TD - 1) / g.TD;
  g.nh = (H + g.TH - 1) / g.TH;
  g.nw = (W + g.TW - 1) / g.TW;
  const long patches = (long)nb * g.nd * g.nh * g.nw;
  g.patches = (int)std::min(patches, 0x7fffffffL);
  g.HW = H * W;
  g.DHW = D * H * W;
  g.f_nw = fast_div(g.nw);
  g.f_nh = fast_div(g.nh);
  g.f_nd = fast_div(g.nd);
  g.f_patches = fast_div(g.patches);
  g.f_tiles = fast_div(g.n_tiles);
  g.V = g.TB * (g.TD + 2) * (g.TH + 2) * (g.TW + 2);
  g.a_slot = round128(g.V * (q.packed ? 4 : kPitch));
  const int fixed = 8 * 16 * (N + 8) * 2 + kMaxTile * 8 + kBarBytes;
  const int b_res = g.k16 * 16 * N;
  q.resident = !streamed && (q.packed || b_res + 2 * g.a_slot + fixed <= kSmemMax);
  if (!q.resident && !streamed) return false;
  if (q.resident) {
    g.b_res = b_res;
    g.slot = g.a_slot;
    g.stages = std::min(kMaxStages, (kSmemMax - fixed - b_res) / g.slot) & ~1;
    g.splits = 1;
  } else {
    g.b_res = 0;
    g.slot = g.a_slot + 27 * 32 * N;
    g.stages = std::min(kMaxStages, (kSmemMax - fixed) / g.slot) & ~1;
    const long tiles = patches * g.n_tiles;
    g.splits = (int)std::max(1L, std::min((long)g.chunks, kSMs / tiles));
  }
  const long items = patches * g.n_tiles * g.splits;
  g.items = (int)std::min(items, 0x7fffffffL);
  if (q.resident) {
    q.grid_x = (int)std::min(patches, (long)std::max(1, kSMs / g.n_tiles));
    q.grid_y = g.n_tiles;
  } else {
    q.grid_x = (int)std::min(items, (long)kSMs);
    q.grid_y = 1;
  }
  q.smem = g.b_res + g.stages * g.slot + fixed;
  return true;
}

// N = 32 where co <= 32, else 64; resident where the weights fit, else
// streamed
Plan plan(int B, int D, int H, int W, int ci, int co) {
  Plan q;
  Geo& g = q.g;
  g.B = B, g.D = D, g.H = H, g.W = W, g.ci = ci, g.co = co;
  q.packed = ci <= 4;
  g.cip = q.packed ? 4 : (ci + 31) / 32 * 32;
  g.k16 = q.packed ? 8 : 27 * g.cip / 16;
  g.chunks = q.packed ? 1 : g.cip / 32;
  const int n0 = co <= 32 ? 32 : 64;
  if (!shape_plan(q, n0, false)) shape_plan(q, n0, true);
  q.weight_splits = std::min(kMaxSplits, std::max(1, (27 * ci + 255) / 256));
  return q;
}

template <int N, bool kPacked, bool kResident>
int launch_conv(const Args& a, const Plan& q, cudaStream_t s) {
  // 64-row tiles a warpgroup: four where N = 32 (two packed, whose A
  // fragments' offsets take the registers)
  constexpr int MH = N == 32 && !kPacked ? 4 : 2;
  static bool attr = false;  // per instantiation, once
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(conv_kernel<N, MH, kPacked, kResident>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmemMax);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  conv_kernel<N, MH, kPacked, kResident>
      <<<dim3(q.grid_x, q.grid_y), kThreads, q.smem, s>>>(a, q.g);
  return (int)cudaGetLastError();
}

template <int N>
int launch_form(const Args& a, const Plan& q, cudaStream_t s) {
  if (q.packed) return launch_conv<N, true, true>(a, q, s);
  return q.resident ? launch_conv<N, false, true>(a, q, s) : launch_conv<N, false, false>(a, q, s);
}

int blocks_for(long long units) {
  return (int)std::max(1LL, std::min((units + 255) / 256, (long long)kSMs * 16));
}

}  // namespace

// The prepared weights: wq (co / 8, k16, 8, 16) int8 (k16 = 27 * cip / 16,
// or 8 where ci <= 4) and f32s (2, co): w_scale, then the maxima of |w|
// (their bits). A memset and two launches on the stream.
extern "C" int conv3d_int8_weights(const void* w, void* wq, void* f32s, int ci, int co,
                                   void* stream) {
  if (bad_shape(1, 1, 1, 1, ci, co)) return (int)cudaErrorInvalidValue;
  const Plan q = plan(1, 1, 1, 1, ci, co);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w_scale = static_cast<float*>(f32s);
  int* wmax = reinterpret_cast<int*>(w_scale + co);
  const float* wf = static_cast<const float*>(w);
  const int K = 27 * ci, rows = (K + q.weight_splits - 1) / q.weight_splits;
  cudaError_t e = cudaMemsetAsync(wmax, 0, sizeof(int) * co, s);
  if (e != cudaSuccess) return (int)e;
  weight_max_kernel<<<dim3((co + 31) / 32, q.weight_splits), 256, 0, s>>>(wf, wmax, K, co, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  weight_quant_kernel<<<dim3((co + 31) / 32, q.g.k16 / 2), 256, 0, s>>>(
      wf, wmax, w_scale, static_cast<int8_t*>(wq), ci, q.g.cip, co, q.g.k16);
  return (int)cudaGetLastError();
}

// y = Q8(x) with prepared weights (conv3d_int8_weights); scratch the
// wrapper allocates: xq (B * D * H * W * cip) int8, and, where the plan
// splits K, acc (B * D * H * W, co) int32 (else null), zeroed here. bias
// may be null. Launches on the stream: x's pass, the conv, and, where K is
// split, a memset before the conv and the split's epilogue after it.
extern "C" int conv3d_int8(const void* x, int x_bf16, const void* wq, const void* w_scale,
                           const void* act_scale, const void* bias, void* xq, void* acc, void* y,
                           int B, int D, int H, int W, int ci, int co, void* stream) {
  if (bad_shape(B, D, H, W, ci, co)) return (int)cudaErrorInvalidValue;
  const Plan q = plan(B, D, H, W, ci, co);
  if ((q.g.splits > 1) != (acc != nullptr) || q.g.stages < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long vox = (long long)B * D * H * W;
  const long long units = q.packed ? vox : vox * (q.g.cip / 16);
  const FastDiv groups = fast_div(q.packed ? 1 : q.g.cip / 16);
  const float* sc = static_cast<const float*>(act_scale);
  if (x_bf16)
    quant_x_kernel<bf16><<<blocks_for(units), 256, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(xq), units, ci, q.g.cip, groups, sc);
  else
    quant_x_kernel<float><<<blocks_for(units), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xq), units, ci, q.g.cip, groups, sc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.xq = static_cast<const int8_t*>(xq);
  a.wq = static_cast<const int8_t*>(wq);
  a.w_scale = static_cast<const float*>(w_scale);
  a.act_scale = sc;
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<bf16*>(y);
  a.acc = static_cast<int*>(acc);
  if (acc) {
    e = cudaMemsetAsync(acc, 0, sizeof(int) * (size_t)vox * co, s);
    if (e != cudaSuccess) return (int)e;
  }
  const int code = q.N == 64 ? launch_form<64>(a, q, s) : launch_form<32>(a, q, s);
  if (code != 0 || acc == nullptr) return code;
  const long long fin = vox * (co / 8);
  finish_kernel<<<blocks_for(fin), 256, 0, s>>>(a.acc, a.w_scale, sc, a.bias, a.y, fin, co / 8);
  return (int)cudaGetLastError();
}

// The geometry conv3d_int8 picks (ops/conv_int8.py::conv3d_int8_plan_of
// mirrors it): out[0..19] = packed, resident, N, TB, TD, TH, TW, n_tiles,
// patches, chunks, splits, items, grid_x, grid_y, stages, smem, cip, tile
// voxels, weight splits, k16.
extern "C" int conv3d_int8_plan(int B, int D, int H, int W, int ci, int co, int* out) {
  if (bad_shape(B, D, H, W, ci, co)) return (int)cudaErrorInvalidValue;
  const Plan q = plan(B, D, H, W, ci, co);
  const Geo& g = q.g;
  const int v[20] = {q.packed, q.resident, q.N, g.TB, g.TD, g.TH, g.TW,
                     g.n_tiles, g.patches, g.chunks, g.splits, g.items, q.grid_x,
                     q.grid_y, g.stages, q.smem, g.cip, g.V, q.weight_splits, g.k16};
  for (int i = 0; i < 20; ++i) out[i] = v[i];
  return 0;
}

// d (64, n) s32 = a (64, 32) s8 @ b (n, 32) s8 transposed, by one wgmma of
// the kernel's (n = 32 or 64)
extern "C" int conv3d_int8_wgmma_probe(const void* a, const void* b, void* d, int n,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* A = static_cast<const int8_t*>(a);
  const int8_t* Bm = static_cast<const int8_t*>(b);
  int* D = static_cast<int*>(d);
  if (n == 32)
    probe_kernel<32><<<1, 128, 0, s>>>(A, Bm, D);
  else if (n == 64)
    probe_kernel<64><<<1, 128, 0, s>>>(A, Bm, D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
