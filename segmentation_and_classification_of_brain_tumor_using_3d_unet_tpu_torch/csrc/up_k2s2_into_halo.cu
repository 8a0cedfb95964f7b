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
// traffic, 0.56 GB of it the output (50 FLOP per byte, far below the
// card's ~295 balance point): it is bound by bytes, and the store is the
// kernel. Design for that:
//
//   * A GEMM per tile of 64 input voxels: whole input rows (b, d, h)
//     where W2 <= 64 (two at level 1), else 64 voxels of one row; K = ci,
//     N = a slab of the 8*co phase columns. A slab is P of the four
//     (a, p) pairs, each with both q and CW channels: all 8 phases at
//     level 0 (256 columns), one (a, p) pair at level 1 (128), so that a
//     block's weights, input buffers and staged tile fit two blocks an
//     SM.
//   * The products run on wgmma, both operands read from shared memory
//     (no-swizzle core-matrix layouts), two warpgroups a block, each half
//     of the slab's columns. The tensor cores then take a few instructions
//     a tile, and they run asynchronously: while they multiply tile t, the
//     block's threads send out tile t - 1. (A first design on mma.sync spent
//     as long issuing its ldmatrix and mma instructions as its stores took,
//     and the two did not overlap.)
//   * Persistent blocks, two an SM on the main path. Each is bound to
//     one slab, loads that slab's weights and bias into shared memory
//     once, then walks over tiles; the next S - 1 tiles come in by
//     cp.async into a ring of S buffers. (Where ci is too large for the
//     weights to stay, K is cut into chunks and the weights come in with
//     each chunk.)
//   * The epilogue adds the f32 bias, rounds once to bf16 and stages the
//     tile in shared memory in output order: for pair (a, p), output row
//     (b, 1+2d+a, 1+2h+p) at positions 1+2w+q is exactly the pair's
//     2*CW columns of GEMM row w, so a staged GEMM row is contiguous in
//     the output (where the slab is all of co; else each q half is). Rows
//     are staged at a pitch of 2*CW + 8 (no bank conflicts) and go out by
//     the bulk-copy engine (cp.async.bulk, one copy a staged row), which
//     streams them while the threads go on to the next tile's GEMM; the
//     threads themselves store only the rows' two halo voxels (zeros).
//   * The halo planes pd in {0, Dp-1} and rows ph in {0, Hp-1} are
//     zero-filled by the same blocks, as extra rows of 16 B stores; no
//     memset of the whole output.
//   * Index arithmetic in 32-bit ints, and no division in a tile's work:
//     with two to four warps a scheduler, a chain of integer divisions a
//     tile (tile -> row -> (b, d, h), staged row -> input row) cost as
//     much as the tile's stores. Each divisor's multiply-high constant is
//     worked out on the host. No float atomics: two runs give the same
//     bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper_gemm.cuh"
#include "up_k2s2_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kTwoPerSM = 113 * 1024;  // dynamic shared memory for two blocks an SM
constexpr int kOnePerSM = 227 * 1024;

// K2's launch geometry (up_k2s2_tiles.cuh; KC a multiple of 16, staged
// rows of bf16), with the weights' offset in shared memory
struct Geo : K2Geo {
  int b_off;
  FastDiv by_c8;
};

// d (64 x N, f32, the warpgroup's accumulator) += A (64 x 16 bf16,
// K-major, descriptor) * B (16 x N bf16, MN-major, descriptor: hence the
// transpose bit, the last immediate)
template <int N>
struct MmaSS;

template <>
struct MmaSS<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct MmaSS<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct MmaSS<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// wgmma descriptor of a K-major no-swizzle A tile: core matrices of 8
// rows x 8 k (128 contiguous bytes), 128 B apart along K (the leading
// byte offset) and c8 * 128 B apart along M (the stride byte offset)
__device__ __forceinline__ uint64_t a_desc(uint32_t addr, int c8) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(c8 * 128 >> 4) << 32);
}

template <int NS>
__global__ void __launch_bounds__(kThreads, 2)
up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
          const float* __restrict__ bias, bf16* __restrict__ y, const Geo g) {
  constexpr int NH = NS / 2;  // columns a warpgroup
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int G = gridDim.x, slab = blockIdx.x % g.n_slabs;
  const int pair0 = slab / g.n_cs * g.P, c0 = slab % g.n_cs * g.CW;
  const int c8 = g.KC / 8, pair_cols = 2 * g.CW;
  const uint32_t Bs = smem_u32(smem + g.b_off);  // [1 or S][KC x NS], core matrices
  const uint32_t As = smem_u32(smem + g.a_off);  // [S][64 x KC], core matrices
  bf16* Ss = reinterpret_cast<bf16*>(smem + g.s_off);  // [P][64][pitch]
  float* bias_s = reinterpret_cast<float*>(smem + g.bias_off);  // [NS]

  // slab column n: pair pi = n / (2 CW), then q, then channel c0 + n % CW
  for (int n = tid; n < NS; n += kThreads)
    bias_s[n] = bias != nullptr ? bias[c0 + (n & (g.CW - 1))] : 0.f;

  // weights of K chunk kc: rows k of (8, ci, co) at this slab's columns
  auto load_b = [&](int kc, uint32_t dst) {
    for (int i = tid; i < g.KC * NS / 8; i += kThreads) {
      int kk, n8;
      slab_row<NS>(i, kk, n8);
      const int n = n8 * 8, pi = n >> g.log_pair, r = n & (pair_cols - 1);
      const int k = kc * g.KC + kk, phase = (pair0 + pi) * 2 + (r >= g.CW);
      const bool ok = k < g.ci;
      const bf16* src = ok ? w + ((size_t)phase * g.ci + k) * g.co + c0 + (r & (g.CW - 1)) : w;
      cp_async16(dst + b_offset<NS>(kk, n8), src, ok);
    }
  };
  // input voxels of tile t, K chunk kc, in core-matrix order (chunk i:
  // row 8 (i / 8 / c8) + i % 8, k chunk i / 8 % c8); zeros past the tile's
  // voxels and past ci
  auto load_a = [&](int t, int kc, uint32_t dst) {
    const TileAt tt = tile_at(g, t);
    const bf16* base = x + ((size_t)tt.r0 * g.W2 + tt.w0) * g.ci + kc * g.KC;
    const int n = tt.nr * tt.wn, kleft = g.ci - kc * g.KC;
    for (int i = tid; i < kTM * c8; i += kThreads) {
      const int j = i >> 3, gq = j / g.by_c8, k8 = j - gq * c8, m = gq * 8 + (i & 7);
      const bool ok = m < n && k8 * 8 < kleft;
      cp_async16(dst + i * 16, ok ? base + (size_t)m * g.ci + k8 * 8 : x, ok);
    }
  };

  // steps (tile, K chunk) in order: this block's tiles t0, t0 + Gs, ...
  const int Gs = G / g.n_slabs, S = g.S;
  int t = blockIdx.x / g.n_slabs, kc = 0, slot = 0;  // the step computed
  int lt = t, lk = 0;                                  // the next step loaded
  auto load_next = [&](int into) {
    if (lt < g.n_tiles) {
      load_a(lt, lk, As + into * kTM * g.KC * 2);
      if (g.nK > 1) load_b(lk, Bs + into * g.KC * NS * 2);
    }
    cp_async_commit();
    if (++lk == g.nK) {
      lk = 0;
      lt += Gs;
    }
  };
  if (g.nK == 1) load_b(0, Bs);
  for (int i = 0; i < S - 1; ++i) load_next(i);

  zero_halo_rows(y, g);
  const uint32_t Ss_u = smem_u32(Ss);

  float acc[NH / 2];
  int pending = -1;  // a tile staged and not yet stored
  while (t < g.n_tiles) {
    // the step S - 1 ahead into the buffer freed last step; then wait
    // for this step's
    load_next(slot == 0 ? S - 1 : slot - 1);
    if (S == 4)
      cp_async_wait<3>();
    else if (S == 3)
      cp_async_wait<2>();
    else
      cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    // the staged tile out, by the bulk-copy engine, while this one runs
    if (pending >= 0) send_tile(y, Ss_u, g, pair0, c0, pending);

    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) acc[i] = 0.f;
    }
    const uint32_t Ab = As + slot * kTM * g.KC * 2;
    const uint32_t Bb = Bs + (g.nK > 1 ? slot : 0) * g.KC * NS * 2 + wg * (NH / 8) * 128;
    wgmma_fence();
    for (int ks = 0; ks < g.KC / 16; ++ks)
      MmaSS<NH>::run(acc, a_desc(Ab + ks * 256, c8), b_desc<NS>(Bb + ks * 32 * NS));
    wgmma_commit();
    fence_operands(acc);
    if (pending >= 0) {
      halo_voxels(y, g, pair0, c0, pending);
      pending = -1;
    }
    bulk_wait_read();  // the staging has been read out
    wgmma_wait<0>();
    fence_operands(acc);
    __syncthreads();  // the buffer and the staging are free again

    if (kc == g.nK - 1) {
      // epilogue: + bias, one rounding, staged pair by pair, GEMM row m
      // as its output [q][CW] at a pitch of 2 CW + 8 (no bank conflicts).
      // Accumulator 4 j + e of a thread: row 16 (warp % 4) + lane / 4 +
      // 8 (e / 2), column wg NH + 8 j + 2 (lane % 4) + e % 2
      const int e2 = 2 * (lane & 3), m0 = 16 * (warp & 3) + (lane >> 2);
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {
        const int n = wg * NH + 8 * j, pi = n >> g.log_pair;
        const float b0 = bias_s[n + e2], b1 = bias_s[n + e2 + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<__nv_bfloat162*>(Ss + (pi * kTM + m0 + 8 * hf) * g.pitch +
                                             (n & (pair_cols - 1)) + e2) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hf] + b0, acc[4 * j + 2 * hf + 1] + b1);
      }
      pending = t;
    }
    if (++kc == g.nK) {
      kc = 0;
      t += Gs;
    }
    slot = slot == S - 1 ? 0 : slot + 1;
  }
  if (pending >= 0) {
    fence_proxy_async();
    __syncthreads();
    send_tile(y, Ss_u, g, pair0, c0, pending);
    halo_voxels(y, g, pair0, c0, pending);
  }
  cp_async_wait<0>();
  bulk_wait_all();
}

// weights, S input buffers, the staged tile (P pairs of 64 rows at a
// pitch of 2 CW + 8), bias
int smem_of(int KC, int nK, int P, int CW, int S) {
  const int NS = 2 * P * CW;
  return (nK > 1 ? S : 1) * KC * NS * 2 + S * kTM * KC * 2 + P * kTM * (2 * CW + 8) * 2 + NS * 4;
}

// The slab: CW the largest power of two <= 128 that divides co, P =
// min(4, 128 / CW) pairs (NS = 2 P CW <= 256 columns). Then, for the
// shared memory of two blocks an SM (else one): fewer pairs, then fewer
// channels a slab, down to P CW = 32, and only then K in chunks; then as
// many input buffers (up to 4) as that shared memory holds.
Geo plan(int B, int D2, int H2, int W2, int ci, int co) {
  Geo g;
  plan_tiles(g, B, D2, H2, W2, ci, co);
  int CW0 = 8;
  while (CW0 < 128 && co % (2 * CW0) == 0) CW0 *= 2;
  const int Kp = (ci + 15) / 16 * 16, P0 = CW0 >= 32 ? 128 / CW0 : 4;
  bool found = false;
  for (int limit : {kTwoPerSM, kOnePerSM}) {
    for (int KC = Kp; KC >= 16 && !found; KC = KC > 256 ? 256 : KC / 2) {
      if (KC < Kp && KC % 16) continue;
      const int nK = (Kp + KC - 1) / KC;
      for (int P = P0, CW = CW0; !found; P > 1 ? P /= 2 : CW /= 2) {
        if (smem_of(KC, nK, P, CW, 2) <= limit) {
          g.KC = KC;
          g.nK = nK;
          g.P = P;
          g.CW = CW;
          g.S = 2;
          while (g.S < 4 && smem_of(KC, nK, P, CW, g.S + 1) <= limit) ++g.S;
          found = true;
        }
        if (P * CW == 32) break;
      }
    }
    if (found) break;
  }
  plan_slab(g);
  g.b_off = 0;
  g.a_off = g.b_off + (g.nK > 1 ? g.S : 1) * g.KC * g.NS * 2;
  g.s_off = g.a_off + g.S * kTM * g.KC * 2;
  g.bias_off = g.s_off + g.P * kTM * g.pitch * 2;
  g.smem = g.bias_off + g.NS * 4;
  g.by_c8 = fast_div(g.KC / 8);
  return g;
}

bool valid(int B, int D2, int H2, int W2, int ci, int co) {
  const long Dp = 2L * D2 + 2, Hp = 2L * H2 + 2, Wp = 2L * W2 + 2;
  return B >= 1 && D2 >= 1 && H2 >= 1 && W2 >= 1 && ci >= 8 && ci % 8 == 0 && co >= 8 &&
         co % 8 == 0 && B * Dp * Hp <= 0x7fffffffL && Wp * co <= 0x7fffffffL &&
         (long)B * D2 * H2 * W2 <= 0x7fffffffL;
}

template <int NS>
int blocks_for(const Geo& g, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(up_kernel<NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, up_kernel<NS>, kThreads, g.smem);
  if (err != cudaSuccess) return (int)err;
  const long per_slab = (long)sms * (per_sm > 0 ? per_sm : 1) / g.n_slabs;
  *blocks = g.n_slabs * (int)(per_slab < 1 ? 1 : per_slab < g.n_tiles ? per_slab : g.n_tiles);
  return 0;
}

template <int NS>
int launch(const void* x, const void* w, const void* bias, void* y, const Geo& g,
           cudaStream_t stream) {
  int blocks = 0;
  const int err = blocks_for<NS>(g, &blocks);
  if (err) return err;
  up_kernel<NS><<<blocks, kThreads, g.smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(y), g);
  return (int)cudaGetLastError();
}

int blocks_of(const Geo& g, int* blocks) {
  return g.NS == 256 ? blocks_for<256>(g, blocks)
         : g.NS == 128 ? blocks_for<128>(g, blocks)
                       : blocks_for<64>(g, blocks);
}

}  // namespace

// x (B, D2, H2, W2, ci) bf16; w (8, ci, co) bf16, phase k = (a*2+p)*2+q,
// already flipped; bias (co) f32 or null; y (B, 2D2+2, 2H2+2, 2W2+2, co)
// bf16, every value of which the launch writes. ci and co multiples of 8,
// pointers 16 B aligned (checked by the caller). Returns the launch's
// cudaError_t.
extern "C" int up_k2s2_into_halo(const void* x, const void* w, const void* bias,
                                 void* y, int B, int D2, int H2, int W2, int ci,
                                 int co, void* stream) {
  if (!valid(B, D2, H2, W2, ci, co)) return (int)cudaErrorInvalidValue;
  const Geo g = plan(B, D2, H2, W2, ci, co);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.NS == 256) return launch<256>(x, w, bias, y, g, s);
  if (g.NS == 128) return launch<128>(x, w, bias, y, g, s);
  return launch<64>(x, w, bias, y, g, s);
}

// The launch geometry of up_k2s2_into_halo at these shapes, into out:
// input rows a tile (R) and tiles a row (tpr), KC channels a K chunk and
// nK chunks, P pairs and CW channels a slab (NS = 2 P CW GEMM columns),
// slabs, S input buffers, tiles, halo rows, dynamic shared memory in
// bytes, blocks.
extern "C" int up_k2s2_plan(int B, int D2, int H2, int W2, int ci, int co, int* out) {
  if (!valid(B, D2, H2, W2, ci, co)) return (int)cudaErrorInvalidValue;
  const Geo g = plan(B, D2, H2, W2, ci, co);
  int blocks = 0;
  const int err = blocks_of(g, &blocks);
  if (err) return err;
  const int v[] = {g.R, g.tpr, g.KC, g.nK, g.P, g.CW, g.NS, g.n_slabs, g.S, g.n_tiles,
                   g.n_halo, g.smem, blocks};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}
