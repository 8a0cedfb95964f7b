// K2 in float32: the ConvTranspose(k=2^3, s=2^3) of the decoder-last up,
// plus its bias, written straight into the halo layout, for f32 tensors,
// on the tensor cores.
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
// (B, 2 D2 + 2, 2 H2 + 2, 2 W2 + 2, co); the one-voxel halo is zeros.
//
// Both operands carry f32's 24 significant bits. Each is split EXACTLY
// into three bf16 parts, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v -
// hi - mid) (hi + mid + lo == v for 0 and every 2^-110 <= |v| <= 3.3895e38;
// K7's f32 form, conv3d_same_f32.cu, splits the same way). Of the nine part
// products six are kept, in this order: x_hi w_hi, x_hi w_mid, x_mid w_hi,
// x_hi w_lo, x_mid w_mid, x_lo w_hi (ops/conv.py SPLIT6_PASSES); the three
// dropped are each under 2^-24 of |x w|. Every kept product of two bf16
// values is exact in f32, so six bf16 wgmma passes compute the f32 GEMM to
// within f32 rounding (tests/test_torch_k2_split.py holds the six-pass sum
// within 2^-22 (|x| @ |w|) of float64 on the CPU).
//
// Bound on the H100: at the main path's level 0 ((4, 64^3, 64) -> (4,
// 130^3, 32)) it reads 0.27 GB and writes 1.13 GB (1.39 GB: 0.416 ms at
// 3.35 TB/s) against six bf16 passes of 34 GFLOP (0.209 ms at 989
// TFLOP/s): bound by its bytes, and 81% of them are the f32 output; at
// level 1 ((4, 32^3, 128) -> (4, 66^3, 64)) bytes (0.108 ms) and operations
// (0.104 ms) balance. Design: K2 bf16's persistent GEMM (up_k2s2_into_
// halo.cu) with f32 operands split on the way to the tensor cores:
//
//   * Tiles of 64 input voxels: whole input rows (b, d, h) where W2 <= 64
//     (two at level 1), else 64 voxels of one row; K = ci, zero-padded to
//     a multiple of 32; N = a slab of P of the four (a, p) pairs, each with
//     both q and CW channels (NS = 2 P CW columns: all 8 phases at level
//     0, one pair at level 1); two warpgroups of NS / 2 columns each.
//   * Persistent blocks, one an SM, each bound to one slab. The block
//     loads the slab's f32 weights once, splits them and keeps the three
//     bf16 parts in shared memory in the no-swizzle B layout (96 KB at both
//     request forms). Splitting in the block's one-time staging costs some
//     64 K values a block and keeps the entry's arguments those of the
//     SIMT form before it (no scratch). Where ci is too large for the
//     slabs to stay, K is cut into chunks and each chunk's weights are
//     loaded and split again at each tile (off the main path).
//   * Input tiles land as f32 by cp.async into a ring of S buffers
//     (zero-filled past the tile's voxels and past ci), at a row pitch of
//     KC + 8 floats. Each thread reads its mma A fragment of a k16 step
//     straight from the landed tile (float2 loads, free of bank conflicts
//     at that pitch) and splits it in registers into its hi, mid and lo
//     fragments: the RS form of wgmma, so no split copy of the tile is
//     written to shared memory (SS tiles would not fit beside two f32
//     buffers and the weights at level 1).
//   * Per k16 step six RS wgmmas m64nNk16 (N = NS / 2) in the order above.
//     The tensor cores' f32 accumulation is not round to nearest (K1 f32's
//     finding, ps2d_conv3d_f32.cu), so each group of two k16 steps (twelve
//     wgmmas) sums into a fresh accumulator (scale-d 0), added into an f32
//     total by one round-to-nearest addition a group. On an H100, at the
//     two request forms, this errs 1.50 and 0.84x the plain f32 GEMM
//     against float64; a fresh accumulator every k16 step ran 5-6%
//     slower (1.06 and 0.63x), one every four 4% slower at level 0 and 4%
//     faster at level 1 (2.72 and 1.27x); splitting the next group's
//     fragments while this group's wgmmas run moved the forms by +1.5%
//     and -2.3%, so it is not done (compare_builds.py --kernel k2f32).
//   * Epilogue: the total plus the f32 bias (one addition), staged pair by
//     pair in output order (GEMM row m of pair (a, p) is output voxels
//     1 + 2 w and 2 + 2 w of row (b, 1 + 2 d + a, 1 + 2 h + p): contiguous
//     where the slab is all of co) at a pitch of 2 CW + 8 floats (free of
//     bank conflicts for the float2 stores), then fence.proxy.async and
//     out by the bulk-copy engine (cp.async.bulk, one copy a staged row)
//     while the threads go on to the next tile's GEMM. The threads store
//     the rows' two halo voxels, and the halo planes and rows at the start
//     (no separate halo kernel, no memset). No atomics: two runs give the
//     same bits.
//   * Shared memory at level 0 (KC 64, P 4, CW 32): weights 96 KB, three
//     f32 buffers of 18 KB, staging 72 KB: 223 KB; level 1 (KC 128, P 1,
//     CW 64): 96 KB, two buffers of 34 KB, staging 34 KB: 198.5 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper_gemm.cuh"
#include "up_k2s2_tiles.cuh"

namespace {

constexpr int kThreads = 256;            // two warpgroups
constexpr int kGroup = 2;                // k16 steps a fresh accumulator
constexpr int kKAlign = 16 * kGroup;     // K (and a chunk) a multiple of this
constexpr int kOnePerSM = 227 * 1024;    // dynamic shared memory, one block an SM

// K2's launch geometry (up_k2s2_tiles.cuh; KC a multiple of 32, staged
// rows of f32), with the input buffers' row pitch, KC + 8 floats
struct Geo : K2Geo {
  int a_pitch;
  FastDiv by_c4;
};

template <int NS>
__global__ void __launch_bounds__(kThreads, 1)
up_split6_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y, const Geo g) {
  constexpr int NH = NS / 2;  // columns a warpgroup
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int G = gridDim.x, slab = blockIdx.x % g.n_slabs;
  const int pair0 = slab / g.n_cs * g.P, c0 = slab % g.n_cs * g.CW;
  const int pair_cols = 2 * g.CW;
  const int slab_bytes = g.KC * NS * 2;                  // one bf16 part
  const uint32_t Bs = smem_u32(smem);                    // [3][KC x NS], core matrices
  const uint32_t As = smem_u32(smem + g.a_off);          // [S][64][a_pitch] f32
  const float* Af = reinterpret_cast<const float*>(smem + g.a_off);
  float* Ss = reinterpret_cast<float*>(smem + g.s_off);  // [P][64][pitch]
  float* bias_s = reinterpret_cast<float*>(smem + g.bias_off);  // [NS]

  // slab column n: pair pi = n / (2 CW), then q, then channel c0 + n % CW
  for (int n = tid; n < NS; n += kThreads)
    bias_s[n] = bias != nullptr ? bias[c0 + (n & (g.CW - 1))] : 0.f;

  // the weights of K chunk kc at this slab's columns, rows k of w (ci,
  // 8 co), split into the three bf16 slabs (zeros past ci); 16 B rows
  // (k, n8) in copy order, eight consecutive ones filling a core matrix
  auto split_b = [&](int kc) {
    for (int i = tid; i < g.KC * NS / 8; i += kThreads) {
      int kk, n8;
      slab_row<NS>(i, kk, n8);
      const int n = n8 * 8, pi = n >> g.log_pair, r = n & (pair_cols - 1);
      const int k = kc * g.KC + kk, phase = (pair0 + pi) * 2 + (r >= g.CW);
      float4 v0 = make_float4(0.f, 0.f, 0.f, 0.f), v1 = v0;
      if (k < g.ci) {
        const float4* src = reinterpret_cast<const float4*>(
            w + (size_t)k * 8 * g.co + phase * g.co + c0 + (r & (g.CW - 1)));
        v0 = __ldg(src);
        v1 = __ldg(src + 1);
      }
      uint2 h0, m0, l0, h1, m1, l1;
      split4(v0, h0, m0, l0);
      split4(v1, h1, m1, l1);
      unsigned char* dst = smem + b_offset<NS>(kk, n8);
      *reinterpret_cast<uint4*>(dst) = make_uint4(h0.x, h0.y, h1.x, h1.y);
      *reinterpret_cast<uint4*>(dst + slab_bytes) = make_uint4(m0.x, m0.y, m1.x, m1.y);
      *reinterpret_cast<uint4*>(dst + 2 * slab_bytes) = make_uint4(l0.x, l0.y, l1.x, l1.y);
    }
  };
  // input voxels of tile t, K chunk kc: row m of the buffer, its KC
  // channels as 16 B pieces; zeros past the tile's voxels and past ci
  const int c4 = g.KC / 4, a_bytes = kTM * g.a_pitch * 4;
  auto load_a = [&](int t, int kc, uint32_t dst) {
    const TileAt tt = tile_at(g, t);
    const float* base = x + ((size_t)tt.r0 * g.W2 + tt.w0) * g.ci + kc * g.KC;
    const int n = tt.nr * tt.wn, kleft = g.ci - kc * g.KC;
    for (int i = tid; i < kTM * c4; i += kThreads) {
      const int m = i / g.by_c4, k4 = i - m * c4;
      const bool ok = m < n && k4 * 4 < kleft;
      cp_async16(dst + (m * g.a_pitch + k4 * 4) * 4, ok ? base + (size_t)m * g.ci + k4 * 4 : x,
                 ok);
    }
  };

  // steps (tile, K chunk) in order: this block's tiles t0, t0 + Gs, ...
  const int Gs = G / g.n_slabs, S = g.S;
  int t = blockIdx.x / g.n_slabs, kc = 0, slot = 0;  // the step computed
  int lt = t, lk = 0;                                  // the next step loaded
  auto load_next = [&](int into) {
    if (lt < g.n_tiles) load_a(lt, lk, As + into * a_bytes);
    cp_async_commit();
    if (++lk == g.nK) {
      lk = 0;
      lt += Gs;
    }
  };
  for (int i = 0; i < S - 1; ++i) load_next(i);
  if (g.nK == 1) split_b(0);

  zero_halo_rows(y, g);
  const uint32_t Ss_u = smem_u32(Ss);

  // this thread's A fragment rows (16 (warp % 4) + lane / 4, + 8) and
  // columns (2 (lane % 4), + 1, + 8, + 9) of a k16 step; its B columns,
  // the warpgroup's half of the slab
  const int fr = 16 * (warp & 3) + (lane >> 2), fk = 2 * (lane & 3);
  const uint32_t Bw = Bs + wg * (NH / 8) * 128;

  float acc[NH / 2], tot[NH / 2];
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) acc[i] = tot[i] = 0.f;
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
    // K in chunks: this chunk's weights (every wgmma of the last step has
    // read the slabs: its barrier below)
    if (g.nK > 1) split_b(kc);
    // the staged tile (and the weights split above) to the async proxy
    fence_proxy_async();
    __syncthreads();
    // the staged tile out, by the bulk-copy engine, while this one runs
    if (pending >= 0) {
      send_tile(y, Ss_u, g, pair0, c0, pending);
      halo_voxels(y, g, pair0, c0, pending);
      pending = -1;
    }

    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) tot[i] = 0.f;
    }
    const float* Ab = Af + slot * kTM * g.a_pitch + fr * g.a_pitch + fk;
#pragma unroll 1
    for (int k0 = 0; k0 < g.KC; k0 += kKAlign) {
      // the group's fragments: float2 (k, k + 1) of rows fr, fr + 8 at
      // k0 + 16 s + fk and + 8, each split into hi, mid and lo
      uint32_t f[kGroup][3][4];
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const float* p = Ab + k0 + 16 * s;
        float2 v[4] = {*reinterpret_cast<const float2*>(p),
                       *reinterpret_cast<const float2*>(p + 8 * g.a_pitch),
                       *reinterpret_cast<const float2*>(p + 8),
                       *reinterpret_cast<const float2*>(p + 8 * g.a_pitch + 8)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[s][0][j] = split2(v[j].x, v[j].y);
          f[s][1][j] = split2(v[j].x, v[j].y);
          f[s][2][j] = split2(v[j].x, v[j].y);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const uint32_t b = Bw + (k0 + 16 * s) * 2 * NS;   // k16 step: 32 NS bytes
        const uint64_t wh = b_desc<NS>(b), wm = b_desc<NS>(b + slab_bytes),
                       wl = b_desc<NS>(b + 2 * slab_bytes);
        Mma<NH>::run(acc, f[s][0], wh, s == 0 ? 0 : 1);   // the group's first: fresh
        Mma<NH>::run(acc, f[s][0], wm);
        Mma<NH>::run(acc, f[s][1], wh);
        Mma<NH>::run(acc, f[s][0], wl);
        Mma<NH>::run(acc, f[s][1], wm);
        Mma<NH>::run(acc, f[s][2], wh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) tot[i] = __fadd_rn(tot[i], acc[i]);
    }
    bulk_wait_read();  // the staging has been read out
    __syncthreads();   // the buffer and the staging are free again

    if (kc == g.nK - 1) {
      // epilogue: + bias, staged pair by pair, GEMM row m as its output
      // [q][CW] at a pitch of 2 CW + 8 floats. Total 4 j + e of a thread:
      // row 16 (warp % 4) + lane / 4 + 8 (e / 2), column wg NH + 8 j +
      // 2 (lane % 4) + e % 2
#pragma unroll
      for (int j = 0; j < NH / 8; ++j) {
        const int n = wg * NH + 8 * j, pi = n >> g.log_pair;
        const float b0 = bias_s[n + fk], b1 = bias_s[n + fk + 1];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(Ss + (pi * kTM + fr + 8 * hf) * g.pitch +
                                     (n & (pair_cols - 1)) + fk) =
              make_float2(__fadd_rn(tot[4 * j + 2 * hf], b0),
                          __fadd_rn(tot[4 * j + 2 * hf + 1], b1));
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

// the weights' three bf16 parts, S input buffers (64 rows at a pitch of
// KC + 8 floats), the staged tile (P pairs of 64 rows at a pitch of 2 CW
// + 8 floats), bias
int smem_of(int KC, int P, int CW, int S) {
  const int NS = 2 * P * CW;
  return 3 * KC * NS * 2 + S * kTM * (KC + 8) * 4 + P * kTM * (2 * CW + 8) * 4 + NS * 4;
}

// The slab: CW the largest power of two <= 128 that divides co, P =
// min(4, 128 / CW) pairs (NS = 2 P CW <= 256 columns). Then, within one
// block's shared memory an SM (a warpgroup's total and accumulator of up
// to 64 registers each leave no room for two blocks' registers): K whole
// where it fits, else in chunks of 256, 128, 64 or 32; for each, fewer
// pairs, then fewer channels a slab, down to P CW = 32; then as many input
// buffers (2 to 4) as that shared memory holds. Chunks of 32 with P CW =
// 32 take under 60 KB, so every shape valid() takes has a plan.
Geo plan(int B, int D2, int H2, int W2, int ci, int co) {
  Geo g;
  plan_tiles(g, B, D2, H2, W2, ci, co);
  int CW0 = 8;
  while (CW0 < 128 && co % (2 * CW0) == 0) CW0 *= 2;
  const int Kp = (ci + kKAlign - 1) / kKAlign * kKAlign, P0 = CW0 >= 32 ? 128 / CW0 : 4;
  bool found = false;
  for (int KC : {Kp, 256, 128, 64, 32}) {
    if (found || KC > Kp) continue;
    for (int P = P0, CW = CW0; !found; P > 1 ? P /= 2 : CW /= 2) {
      if (smem_of(KC, P, CW, 2) <= kOnePerSM) {
        g.KC = KC;
        g.nK = (Kp + KC - 1) / KC;
        g.P = P;
        g.CW = CW;
        g.S = 2;
        while (g.S < 4 && smem_of(KC, P, CW, g.S + 1) <= kOnePerSM) ++g.S;
        found = true;
      }
      if (P * CW == 32) break;
    }
  }
  plan_slab(g);
  g.a_pitch = g.KC + 8;
  g.a_off = 3 * g.KC * g.NS * 2;
  g.s_off = g.a_off + g.S * kTM * g.a_pitch * 4;
  g.bias_off = g.s_off + g.P * kTM * g.pitch * 4;
  g.smem = g.bias_off + g.NS * 4;
  g.by_c4 = fast_div(g.KC / 4);
  return g;
}

bool valid(int B, int D2, int H2, int W2, int ci, int co) {
  return B >= 1 && D2 >= 1 && H2 >= 1 && W2 >= 1 && ci >= 8 && co >= 8 && ci % 8 == 0 &&
         co % 8 == 0 && (long)B * D2 * H2 * W2 <= 0x7fffffffL &&
         (long)B * (2 * D2 + 2) * (2 * H2 + 2) <= 0x7fffffffL;
}

template <int NS>
int blocks_for(const Geo& g, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(up_split6_kernel<NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, up_split6_kernel<NS>, kThreads,
                                                        g.smem);
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
  up_split6_kernel<NS><<<blocks, kThreads, g.smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), g);
  return (int)cudaGetLastError();
}

int blocks_of(const Geo& g, int* blocks) {
  return g.NS == 256 ? blocks_for<256>(g, blocks)
         : g.NS == 128 ? blocks_for<128>(g, blocks)
                       : blocks_for<64>(g, blocks);
}

}  // namespace

// x (B, D2, H2, W2, ci) f32; w (ci, 8 co) f32, column k co + o the phase-k
// tap of output channel o (k = (a * 2 + p) * 2 + q, the flax kernel
// flipped); bias (co) f32 or null; y (B, 2 D2 + 2, 2 H2 + 2, 2 W2 + 2, co)
// f32, every value of which the launch writes. ci and co multiples of 8,
// every pointer 16 B aligned (checked by the caller). Returns the launch's
// cudaError_t.
extern "C" int up_k2s2_into_halo_f32(const void* x, const void* w, const void* bias, void* y,
                                     int B, int D2, int H2, int W2, int ci, int co,
                                     void* stream) {
  if (!valid(B, D2, H2, W2, ci, co)) return (int)cudaErrorInvalidValue;
  const Geo g = plan(B, D2, H2, W2, ci, co);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g.NS == 256) return launch<256>(x, w, bias, y, g, s);
  if (g.NS == 128) return launch<128>(x, w, bias, y, g, s);
  return launch<64>(x, w, bias, y, g, s);
}

// The launch geometry of up_k2s2_into_halo_f32 at these shapes, with
// up_k2s2_plan's keys: input rows a tile (R) and tiles a row (tpr), KC
// channels a K chunk and nK chunks, P pairs and CW channels a slab (NS =
// 2 P CW GEMM columns), slabs, S input buffers, tiles, halo rows, dynamic
// shared memory in bytes, blocks.
extern "C" int up_k2s2_f32_plan(int B, int D2, int H2, int W2, int ci, int co, int* out) {
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
