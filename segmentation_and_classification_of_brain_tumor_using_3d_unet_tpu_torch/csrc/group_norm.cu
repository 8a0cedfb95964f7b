// K5: GroupNorm over a channels-last (N, M, C) tensor, f32 or bf16, with
// the DoubleConv tail fused into its second pass:
//   y = relu?(x * scale[n, c] + shift[n, c]) (+ residual), one rounding.
//
// Replaces the Pallas kernels behind ops/pallas/groupnorm.py::
// fused_group_norm (bodies `_stats_kernel` :31-44, `_apply_kernel` :47-52,
// `_apply_res_kernel` :55-62) of the JAX package. The TPU kernel carries
// the sums across sequential grid steps, then runs a second pallas_call;
// here one cooperative launch does both passes, with a grid-wide barrier
// between them.
//
// Bound on the H100: a few operations per value, so bound by bytes: the
// function reads x once (and the residual) and writes y once (0.32 ms at
// (4, 128^3, 32) bf16 at 3.35 TB/s; 0.64 ms in f32). Two passes that each
// read x from HBM cannot go below 1.5x that bound (4/3x with the
// residual). What this design does about it:
//
//   * One persistent block an SM (cooperative launch, the grid no larger
//     than the blocks that fit at once). Block b owns a contiguous range of
//     rows of the flattened (N * M, C) tensor, the ranges balanced and cut
//     at multiples of `gran` rows (16 B); a range that crosses samples
//     holds one item per sample.
//   * Every HBM access of a stage goes through the bulk-copy engine
//     (cp.async.bulk, mbarrier completion), from two threads of their own:
//     a loader (x, and in the apply pass the residual) and a storer (y).
//     Eight consumer warps touch shared memory only.
//   * Statistics pass: the block's first `nres` stages (~32 KB each) land
//     in a resident area of shared memory that is never recycled, the rest
//     pass through a ring of `depth` stages. The consumers reduce each
//     landed stage into per-thread, per-channel f32 sums of x and x*x; each
//     item's sums are reduced over the block in a fixed tree and written to
//     the block's slot of `part` (slot b + n: unique, in block order for a
//     sample).
//   * cooperative_groups grid sync. Then each block sums its samples'
//     partials in block order (no float atomics: all blocks of a sample
//     hold the same bits, two runs give the same bits) and folds them into
//     per-channel scale and shift as ops/norm.py::group_affine does.
//   * Apply pass, in the order that re-reads least: first the ring's last
//     stages, still in shared memory, then the resident stages, then the
//     rest of the range in reverse order, so that the stages loaded last in
//     the statistics pass (with an L2 evict_last policy, `keep` of them a
//     block) are re-read first, from L2. The consumers write y over x in
//     shared memory and the storer sends each stage out (two stores in
//     flight); a buffer whose stage is out takes a reload, so the reloads
//     cycle through all depth + nres buffers. The residual comes through a
//     ring of its own; a residual that is x itself is read from x's stages.
//     Every other load and every store is evict_first, so that neither
//     pushes x's tail out of L2.
//
// C % 8 == 0 takes 16 B or 32 B accesses (8 channels); otherwise one value
// an access, and the rows of an item before its first and after its last
// 16 B boundary (fewer than `gran`) are read and written by the consumers
// directly. ops/groupnorm.py::group_norm_plan mirrors make_plan, and
// group_norm_ranges and group_norm_block_of the walk below.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;                 // eight consumer warps
constexpr int kThreads = kConsumers + 64;       // a loader and a storer warp
constexpr int kStageBytes = 32768;              // a stage, at most (or one row)
constexpr long long kKeepL2 = 24LL << 20;       // x's tail kept in L2, all blocks
constexpr long long kMinBlockBytes = 64LL << 10;

// ---- the launch plan ------------------------------------------------------
struct Plan {
  int V, vpr, TX, TY;       // vector width, vectors a row, threads (TX x TY)
  int row_bytes, res_elt;   // bytes a row of x; of a residual value (0: none)
  int gran;                 // rows a 16 B multiple in x and the residual
  int stage_rows, stage_bytes, res_stage_bytes, depth, nres, keep, grid, smem;
  long long units;          // whole granules in N * M rows
};

int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// coresident: blocks that may run at once; cap: shared memory a block may
// use. False if a stage and the fixed arrays do not fit.
bool make_plan(int N, int M, int C, int elt, int res_elt, int coresident, int cap, Plan& p) {
  p.V = C % 8 == 0 ? 8 : 1;
  p.vpr = C / p.V;
  p.TX = p.vpr < kConsumers ? p.vpr : kConsumers;
  p.TY = kConsumers / p.TX;
  p.row_bytes = C * elt;
  p.res_elt = res_elt;
  p.gran = 16 / gcd_int(p.row_bytes % 16, 16);
  if (res_elt) {
    const int g = 16 / gcd_int(C * res_elt % 16, 16);
    if (g > p.gran) p.gran = g;                 // both powers of 2
  }
  const int per = kStageBytes / (p.row_bytes * p.gran);
  p.stage_rows = (per < 1 ? 1 : per) * p.gran;
  const long long sb = (long long)p.stage_rows * p.row_bytes;
  const long long rsb = (long long)p.stage_rows * C * res_elt;
  const long long red = kConsumers * p.V > 2 * C ? kConsumers * p.V : 2 * C;
  const long long fixed = 4 * red + 8LL * C;    // red + scale/shift
  long long left = -1;
  for (p.depth = 4; p.depth >= 2; --p.depth) {
    left = cap - fixed - p.depth * (sb + rsb + 40);
    if (left >= 0) break;
  }
  if (left < 0 || sb >= (1 << 20) || rsb >= (1 << 20)) return false;
  p.nres = (int)(left / (sb + 24));
  if (p.nres > 32 - p.depth) p.nres = 32 - p.depth;   // a bit a buffer
  p.stage_bytes = (int)sb;
  p.res_stage_bytes = (int)rsb;
  const long long total = (long long)N * M;
  p.units = total / p.gran;
  long long grid = (total * p.row_bytes + kMinBlockBytes - 1) / kMinBlockBytes;
  if (grid > coresident) grid = coresident;
  if (grid > p.units) grid = p.units;
  p.grid = grid < 1 ? 1 : (int)grid;
  p.keep = (int)(kKeepL2 / ((long long)p.grid * sb));
  p.smem = (int)(p.depth * (sb + rsb) + p.nres * sb + fixed + 8LL * (5 * p.depth + 3 * p.nres));
  return true;
}

struct Args {
  const void* x;
  const void* res;          // or null
  void* y;
  const float* gamma;
  const float* beta;
  float* part;              // (grid + N, 2, C) f32 scratch
  long long M, total;       // rows a sample, N * M
  int N, C, groups, relu;
  int res_is_x;             // the residual is x itself (res null)
  float eps;
  Plan p;
};

// ---- PTX: mbarriers, bulk copies, L2 policies -----------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar, int count = 1) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// arrive, and expect `bytes` more of transaction on the current phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// wait on `bar` for the parity in bit k of `bits`, then flip the bit
__device__ __forceinline__ void mbar_wait_flip(uint32_t bar, uint32_t& bits, int k) {
  mbar_wait(bar, (bits >> k) & 1);
  bits ^= 1u << k;
}
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
// bytes global -> shared, completing on `bar`; shared -> global, in this
// thread's bulk group. Addresses 16 B aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes), "l"(policy)
      : "memory");
}
// all but this thread's last N bulk stores have read their shared memory;
// all have completed
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, visible to the bulk-copy engine
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the consumer warps only (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---- V consecutive values <-> float[V] ------------------------------------
// load, store: shared or global memory; load_cs, store_cs: global,
// evict-first
template <int V>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (V == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  return u;
}

template <int V>
__device__ __forceinline__ void load(const bf16* p, float* v) {
  if constexpr (V == 8) {
    unpack8(*reinterpret_cast<const uint4*>(p), v);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store(bf16* p, const float* v) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(p) = pack8(v);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <int V>
__device__ __forceinline__ void load_cs(const float* p, float* v) {
  if constexpr (V == 8) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int V>
__device__ __forceinline__ void load_cs(const bf16* p, float* v) {
  if constexpr (V == 8) {
    unpack8(__ldcs(reinterpret_cast<const uint4*>(p)), v);
  } else {
    v[0] = __bfloat162float(
        __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
  }
}

template <int V>
__device__ __forceinline__ void store_cs(float* p, const float* v) {
  if constexpr (V == 8) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
  } else {
    __stcs(p, v[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_cs(bf16* p, const float* v) {
  if constexpr (V == 8) {
    __stcs(reinterpret_cast<uint4*>(p), pack8(v));
  } else {
    __stcs(reinterpret_cast<unsigned short*>(p),
           __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  }
}

// ---- the block's walk -------------------------------------------------------
// Block b's range [start(b), start(b + 1)) of flat rows; item n is its
// intersection [r0, r1) with sample n: plain head rows [r0, ra), stages
// over [ra, rb) (16 B aligned, stage_rows each, the last shorter), plain
// tail rows [rb, r1). The block's stages are numbered over its items in
// order; a cursor holds one item and moves an item at a time, so that a
// stage's rows cost no division.
__device__ __forceinline__ long long range_start(const Args& a, int b) {
  if (b >= a.p.grid) return a.total;
  return (long long)a.p.gran * ((long long)b * a.p.units / a.p.grid);
}

// the block whose range holds flat row r
__device__ __forceinline__ int block_of(const Args& a, long long r) {
  const long long u = r / a.p.gran;
  if (u >= a.p.units) return a.p.grid - 1;
  const long long b = ((u + 1) * a.p.grid - 1) / a.p.units;
  return b < a.p.grid - 1 ? (int)b : a.p.grid - 1;
}

struct Cursor {
  long long lo, hi;         // the block's range
  int n, first, stages;     // item n holds stages [first, first + stages)
  long long r0, ra, rb, r1;
};

__device__ __forceinline__ void set_item(const Args& a, Cursor& c, int n) {
  c.n = n;
  c.r0 = c.lo > n * a.M ? c.lo : n * a.M;
  c.r1 = c.hi < (n + 1) * a.M ? c.hi : (n + 1) * a.M;
  const long long mask = a.p.gran - 1;          // gran is a power of 2
  c.ra = (c.r0 + mask) & ~mask;
  c.rb = c.r1 & ~mask;
  if (c.ra >= c.rb) {
    c.ra = c.rb = c.r1;
    c.stages = 0;
  } else {                                      // rb - ra <= M < 2^31
    c.stages = (int)(((unsigned)(c.rb - c.ra) + a.p.stage_rows - 1) / (unsigned)a.p.stage_rows);
  }
}

__device__ __forceinline__ Cursor first_item(const Args& a, long long lo, long long hi) {
  Cursor c;
  c.lo = lo;
  c.hi = hi;
  c.first = 0;
  set_item(a, c, (int)(lo / a.M));
  return c;
}

// move c to the item of stage s; its first flat row and rows
__device__ __forceinline__ void seek(const Args& a, Cursor& c, int s, long long& r, int& rows) {
  while (s < c.first) {
    set_item(a, c, c.n - 1);
    c.first -= c.stages;
  }
  while (s >= c.first + c.stages) {
    c.first += c.stages;
    set_item(a, c, c.n + 1);
  }
  r = c.ra + (long long)(s - c.first) * a.p.stage_rows;
  const long long left = c.rb - r;
  rows = left < a.p.stage_rows ? (int)left : a.p.stage_rows;
}

// ---- the consumers' work on rows -------------------------------------------
// Thread (ty, tx) of TY x TX takes vectors tx, tx + TX, ... of rows ty,
// ty + TY, ...; TX < vpr only where a row has more than 256 vectors, and
// then TY == 1 and the sums live in `acc` (2 x C, this thread's columns).
template <typename T, int V>
__device__ __forceinline__ void stats_rows(const Args& a, const T* p, int rows, float* s1,
                                           float* s2, float* acc) {
  const int C = a.C, TX = a.p.TX, TY = a.p.TY;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  if (ty >= TY) return;
  const bool many = a.p.vpr > TX;
  for (int col = tx; col < a.p.vpr; col += TX) {
    if (many) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] = acc[col * V + k];
        s2[k] = acc[C + col * V + k];
      }
    }
    for (int r = ty; r < rows; r += TY) {
      float v[V];
      load<V>(p + (size_t)r * C + col * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] += v[k];
        s2[k] += v[k] * v[k];
      }
    }
    if (many) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        acc[col * V + k] = s1[k];
        acc[C + col * V + k] = s2[k];
      }
    }
  }
}

// the item's sums over the block, in a fixed order, to part[slot]; then
// zeroed for the next item
template <int V>
__device__ void flush(const Args& a, int slot, float* s1, float* s2, float* red) {
  const int C = a.C, TX = a.p.TX, TY = a.p.TY;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float* out = a.part + (size_t)slot * 2 * C;
  if (a.p.vpr > TX) {                           // TY == 1: acc holds the sums
    for (int col = tx; col < a.p.vpr; col += TX)
#pragma unroll
      for (int k = 0; k < V; ++k)
        for (int j = 0; j < 2; ++j) {
          out[j * C + col * V + k] = red[j * C + col * V + k];
          red[j * C + col * V + k] = 0.f;
        }
    return;
  }
  int pow2 = 1;
  while (pow2 < TY) pow2 *= 2;
  for (int j = 0; j < 2; ++j) {
    float* s = j == 0 ? s1 : s2;
    consumers_sync();                           // red is free
    if (ty < TY)
#pragma unroll
      for (int k = 0; k < V; ++k) red[ty * C + tx * V + k] = s[k];
    for (int h = pow2 / 2; h >= 1; h /= 2) {
      consumers_sync();
      for (int i = threadIdx.x; i < h * C; i += kConsumers)
        if (i / C + h < TY) red[i] += red[i + h * C];
    }
    consumers_sync();
    for (int c = threadIdx.x; c < C; c += kConsumers) out[j * C + c] = red[c];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = 0.f;
  }
}

// sample n's partials summed in block order, folded into scale and shift
// (ss[0, C) and ss[C, 2C)) as ops/norm.py::group_affine does
__device__ void fold(const Args& a, int n, float* red, float* ss) {
  const int C = a.C;
  const int b0 = block_of(a, n * a.M), b1 = block_of(a, (n + 1) * a.M - 1);
  const float m = (float)a.M;
  for (int c = threadIdx.x; c < C; c += kConsumers) {
    float t1 = 0.f, t2 = 0.f;
    for (int b = b0; b <= b1; ++b) {
      const float* q = a.part + (size_t)(b + n) * 2 * C;
      t1 += __ldcg(q + c);
      t2 += __ldcg(q + C + c);
    }
    red[c] = t1 / m;
    red[C + c] = t2 / m;
  }
  consumers_sync();
  const int cpg = C / a.groups;
  for (int c = threadIdx.x; c < C; c += kConsumers) {
    const int c0 = c / cpg * cpg;
    float g1 = 0.f, g2 = 0.f;
    for (int j = 0; j < cpg; ++j) {
      g1 += red[c0 + j];
      g2 += red[C + c0 + j];
    }
    g1 /= (float)cpg;
    g2 /= (float)cpg;
    const float var = fmaxf(__fsub_rn(g2, __fmul_rn(g1, g1)), 0.f);
    const float rstd = 1.f / sqrtf(var + a.eps);
    const float gm = a.gamma[c];
    ss[c] = __fmul_rn(rstd, gm);
    ss[C + c] = __fsub_rn(a.beta[c], __fmul_rn(__fmul_rn(g1, rstd), gm));
  }
}

// y over x at p (shared memory: res there too, or null) or, with `global`,
// y to a.y at flat row r0 and the residual from a.res
template <typename T, typename R, int V, bool kGlobal>
__device__ __forceinline__ void apply_rows(const Args& a, T* p, const R* res, long long r0,
                                           int rows, const float* ss) {
  const int C = a.C, TX = a.p.TX, TY = a.p.TY;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  if (ty >= TY) return;
  for (int col = tx; col < a.p.vpr; col += TX) {
    float sc[V], sh[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sc[k] = ss[col * V + k];
      sh[k] = ss[C + col * V + k];
    }
    for (int r = ty; r < rows; r += TY) {
      const size_t off = (size_t)r * C + col * V;
      float v[V], x0[V];
      load<V>(p + off, x0);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[k] = fmaf(x0[k], sc[k], sh[k]);
        if (a.relu) v[k] = fmaxf(v[k], 0.f);
        if (a.res_is_x) v[k] += x0[k];
      }
      if (res != nullptr) {
        float q[V];
        if constexpr (kGlobal) load_cs<V>(res + off, q);
        else load<V>(res + off, q);
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] += q[k];
      }
      if constexpr (kGlobal) store_cs<V>(static_cast<T*>(a.y) + (size_t)r0 * C + off, v);
      else store<V>(p + off, v);
    }
  }
}

// ---- the kernel -------------------------------------------------------------
// Shared memory: nb = depth + nres stage buffers of x (buffer i < depth: the
// ring; depth + j: resident stage j), depth stages of the residual (rring),
// red (max(256 V, 2 C) floats), ss (2 C floats), mbarriers full, empty,
// ready (nb each), rfull, rempty (depth each).
// Statistics pass: stage s lands in buffer depth + s (s < nres, kept) or
// ring buffer (s - nres) % depth. Apply pass: items t = 0 .. S-1 take
// stage S-1-t (t < hot: still in the ring), then t - hot (the resident
// stages), then S-1-(t - nres) (the rest, reloaded); the stages of the
// first two kinds are stored, and their buffers then take the reloads in
// that order, round and round. Item t's residual goes to rring slot
// t % depth.
template <typename T, typename R, int V>
__global__ void __launch_bounds__(kThreads, 1) gn_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan& p = a.p;
  const int C = a.C, sb = p.stage_bytes, rsb = p.res_stage_bytes, d = p.depth;
  const int nb = d + p.nres;
  unsigned char* xbuf = smem;                   // nb stages
  unsigned char* rring = smem + (size_t)nb * sb;
  float* red = reinterpret_cast<float*>(rring + (size_t)d * rsb);
  const int red_floats = kConsumers * V > 2 * C ? kConsumers * V : 2 * C;
  float* ss = red + red_floats;
  const uint32_t bars = smem_u32(ss + 2 * C);
  auto full = [&](int i) { return bars + 8u * i; };
  auto empty = [&](int i) { return bars + 8u * (nb + i); };
  auto ready = [&](int i) { return bars + 8u * (2 * nb + i); };
  auto rfull = [&](int k) { return bars + 8u * (3 * nb + k); };
  auto rempty = [&](int k) { return bars + 8u * (3 * nb + d + k); };

  const int b = blockIdx.x;
  const long long lo = range_start(a, b), hi = range_start(a, b + 1);
  const int n_first = (int)(lo / a.M), n_last = (int)((hi - 1) / a.M);
  int S = 0;
  {
    Cursor c = first_item(a, lo, hi);
    for (int n = n_first; n <= n_last; ++n) {
      set_item(a, c, n);
      S += c.stages;
    }
  }
  const int nres = S < p.nres ? S : p.nres;       // resident stages used
  const int L = S - nres;                         // stages through the ring
  const int hot = L < d ? L : d;                  // still in the ring at the end
  auto buf_of = [&](int s) { return s < nres ? d + s : (s - nres) % d; };   // stats
  auto apply_stage = [&](int t) {
    return t < hot ? S - 1 - t : t < hot + nres ? t - hot : S - 1 - (t - nres);
  };
  auto apply_buf = [&](int t) {
    if (t >= hot + nres) t = (t - hot - nres) % (hot + nres);
    return t < hot ? buf_of(S - 1 - t) : d + (t - hot);
  };
  auto buf_ptr = [&](int i) { return reinterpret_cast<T*>(xbuf + (size_t)i * sb); };
  const T* x = static_cast<const T*>(a.x);
  const R* res = static_cast<const R*>(a.res);
  const bool has_res = res != nullptr;

  if (threadIdx.x == 0) {
    for (int i = 0; i < nb; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kConsumers / 32);
      mbar_init(ready(i), 1);
    }
    for (int k = 0; k < d; ++k) {
      mbar_init(rfull(k), 1);
      mbar_init(rempty(k), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < red_floats; i += kThreads) red[i] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool loader = warp == kConsumers / 32, storer = warp == kConsumers / 32 + 1;

  // ---------------------------------------------------- statistics pass
  if (loader) {
    const uint64_t first = policy_evict_first(), last = policy_evict_last();
    // parity to wait for on empty: the ring's first fills pass at once, a
    // resident buffer's first reload waits for its stage's store
    uint32_t ebits = (1u << d) - 1u, rebits = ~0u;
    Cursor c = first_item(a, lo, hi);
    if (lane == 0) {
      for (int s = 0; s < S; ++s) {
        long long r;
        int rows;
        seek(a, c, s, r, rows);
        const int i = buf_of(s);
        if (s >= nres) mbar_wait_flip(empty(i), ebits, i);
        const int bytes = rows * p.row_bytes;
        const bool keep = s >= nres && s < S - hot && s >= S - hot - p.keep;
        mbar_expect_tx(full(i), bytes);
        bulk_load(smem_u32(buf_ptr(i)), x + (size_t)r * C, bytes, full(i), keep ? last : first);
      }
    }
    __syncwarp();
    cg::this_grid().sync();
    // -------------------------------------------------------- apply pass
    if (lane == 0) {
      for (int t = 0; t < S; ++t) {
        const int s = apply_stage(t);
        long long r;
        int rows;
        seek(a, c, s, r, rows);
        if (has_res) {
          const int q = t % d, bytes = rows * C * p.res_elt;
          mbar_wait_flip(rempty(q), rebits, q);
          mbar_expect_tx(rfull(q), bytes);
          bulk_load(smem_u32(rring + (size_t)q * rsb), res + (size_t)r * C, bytes, rfull(q),
                    first);
        }
        if (t >= hot + nres) {                    // reloaded
          const int i = apply_buf(t), bytes = rows * p.row_bytes;
          mbar_wait_flip(empty(i), ebits, i);
          mbar_expect_tx(full(i), bytes);
          bulk_load(smem_u32(buf_ptr(i)), x + (size_t)r * C, bytes, full(i), first);
        }
      }
    }
    return;
  }
  if (storer) {
    cg::this_grid().sync();
    if (lane == 0) {
      const uint64_t first = policy_evict_first();
      uint32_t rbits = 0u;
      int prev = -1;                              // a buffer whose store is out
      Cursor c = first_item(a, lo, hi);
      for (int t = 0; t < S; ++t) {
        const int s = apply_stage(t), i = apply_buf(t);
        long long r;
        int rows;
        seek(a, c, s, r, rows);
        mbar_wait_flip(ready(i), rbits, i);
        bulk_store(static_cast<T*>(a.y) + (size_t)r * C, smem_u32(buf_ptr(i)),
                   rows * p.row_bytes, first);
        if (prev >= 0) {                          // two stores out at most
          bulk_wait_read<1>();
          mbar_arrive(empty(prev), kConsumers / 32);
        }
        prev = i;
      }
      bulk_wait_all();
    }
    return;
  }

  // consumers
  uint32_t fbits = 0u, rfbits = 0u;               // parity to wait for: full, rfull
  {
    float s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
    Cursor c = first_item(a, lo, hi);
    for (int n = n_first; n <= n_last; ++n) {
      if (n > n_first) {
        c.first += c.stages;
        set_item(a, c, n);
      }
      stats_rows<T, V>(a, x + (size_t)c.r0 * C, (int)(c.ra - c.r0), s1, s2, red);
      for (int s = c.first; s < c.first + c.stages; ++s) {
        long long r;
        int rows;
        seek(a, c, s, r, rows);
        const int i = buf_of(s);
        mbar_wait_flip(full(i), fbits, i);
        stats_rows<T, V>(a, buf_ptr(i), rows, s1, s2, red);
        if (s >= nres && s < S - hot) {           // resident and hot stages stay
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(i));
        }
      }
      stats_rows<T, V>(a, x + (size_t)c.rb * C, (int)(c.r1 - c.rb), s1, s2, red);
      flush<V>(a, b + n, s1, s2, red);
    }
  }

  cg::this_grid().sync();

  // ---------------------------------------------------------- apply pass
  int cur = -1;
  auto use = [&](int n) {                         // scale and shift of n in ss
    if (n == cur) return;
    consumers_sync();
    fold(a, n, red, ss);
    consumers_sync();
    cur = n;
  };
  Cursor c = first_item(a, lo, hi);
  for (int n = n_first; n <= n_last; ++n) {       // the plain rows
    if (n > n_first) {
      c.first += c.stages;
      set_item(a, c, n);
    }
    if (c.ra > c.r0 || c.r1 > c.rb) {
      use(n);
      T* xp = const_cast<T*>(x);
      apply_rows<T, R, V, true>(a, xp + (size_t)c.r0 * C, has_res ? res + (size_t)c.r0 * C : res,
                                c.r0, (int)(c.ra - c.r0), ss);
      apply_rows<T, R, V, true>(a, xp + (size_t)c.rb * C, has_res ? res + (size_t)c.rb * C : res,
                                c.rb, (int)(c.r1 - c.rb), ss);
    }
  }
  for (int t = 0; t < S; ++t) {
    const int s = apply_stage(t), i = apply_buf(t), q = t % d;
    long long r;
    int rows;
    seek(a, c, s, r, rows);
    if (t >= hot + nres) mbar_wait_flip(full(i), fbits, i);
    if (has_res) mbar_wait_flip(rfull(q), rfbits, q);
    use(c.n);
    apply_rows<T, R, V, false>(
        a, buf_ptr(i), has_res ? reinterpret_cast<const R*>(rring + (size_t)q * rsb) : res, r,
        rows, ss);
    fence_proxy_async();
    if (has_res) {
      __syncwarp();
      if (lane == 0) mbar_arrive(rempty(q));
    }
    consumers_sync();
    if (threadIdx.x == 0) mbar_arrive(ready(i));
  }
}

template <typename T, typename R, int V>
int launch(const Args& a, cudaStream_t s) {
  auto kern = gn_kernel<T, R, V>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         a.p.smem);
  if (err != cudaSuccess) return (int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, a.p.smem);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Args*>(&a)};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern), dim3(a.p.grid),
                                          dim3(kThreads), args, (size_t)a.p.smem, s);
}

template <typename T, typename R>
int launch_vec(const Args& a, cudaStream_t s) {
  return a.p.V == 8 ? launch<T, R, 8>(a, s) : launch<T, R, 1>(a, s);
}

// the plan on the current device for at most max_grid blocks
int plan_here(int N, int M, int C, int x_bf16, int res_elt, int max_grid, Plan& p, int& sms,
              int& cap) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (N < 1 || M < 1 || C < 1 || N > 65535 || (long long)M * C >= (1LL << 31) ||
      max_grid < 1 || (res_elt != 0 && res_elt != 2 && res_elt != 4))
    return (int)cudaErrorInvalidValue;
  const int coresident = sms < max_grid ? sms : max_grid;
  if (!make_plan(N, M, C, x_bf16 ? 2 : 4, res_elt, coresident, cap, p))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// y = relu?(GroupNorm(x)) (+ res) in one cooperative launch. x: (N, M, C)
// f32 (x_bf16 = 0) or bf16 (1); res: x's shape, f32 (res_bf16 = 0) or bf16
// (1), or x itself (then read once), or null; y: x's shape and type; gamma,
// beta: (C) f32; part: f32 scratch of (max_grid + N) * 2 * C, max_grid at
// least 1 (the grid is at most max_grid blocks). Pointers 16 B aligned.
// N <= 65535, M * C < 2^31, C % groups == 0. Returns the first cudaError_t
// that is not 0.
extern "C" int group_norm(const void* x, int x_bf16, const void* res, int res_bf16, int relu,
                          const void* gamma, const void* beta, float eps, void* y, void* part,
                          int max_grid, int N, int M, int C, int groups, void* stream) {
  Args a;
  int sms = 0, cap = 0;
  // a residual that is x itself is read from x's stages
  a.res_is_x = res != nullptr && res == x && (res_bf16 != 0) == (x_bf16 != 0);
  if (a.res_is_x) res = nullptr;
  const int res_elt = res == nullptr ? 0 : res_bf16 ? 2 : 4;
  const int err = plan_here(N, M, C, x_bf16, res_elt, max_grid, a.p, sms, cap);
  if (err) return err;
  if (groups < 1 || C % groups) return (int)cudaErrorInvalidValue;
  a.x = x;
  a.res = res;
  a.y = y;
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.part = static_cast<float*>(part);
  a.M = M;
  a.total = (long long)N * M;
  a.N = N;
  a.C = C;
  a.groups = groups;
  a.relu = relu;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return res_bf16 || res == nullptr ? launch_vec<bf16, bf16>(a, s)
                                      : launch_vec<bf16, float>(a, s);
  return res_bf16 ? launch_vec<float, bf16>(a, s) : launch_vec<float, float>(a, s);
}

// The plan group_norm would launch with (res_elt: bytes of a residual
// value, 0 without one or with x as its own residual), into out[15]: grid, V, TX, TY, gran, stage_rows,
// stage_bytes, res_stage_bytes, depth, nres, keep, smem, units (capped at
// 2^31 - 1), the device's SMs and its shared memory a block may opt in to.
extern "C" int group_norm_plan(int N, int M, int C, int x_bf16, int res_elt, int max_grid,
                               int* out) {
  Plan p;
  int sms = 0, cap = 0;
  const int err = plan_here(N, M, C, x_bf16, res_elt, max_grid, p, sms, cap);
  if (err) return err;
  const int v[15] = {p.grid, p.V, p.TX, p.TY, p.gran, p.stage_rows, p.stage_bytes,
                     p.res_stage_bytes, p.depth, p.nres, p.keep, p.smem,
                     (int)(p.units < 2147483647LL ? p.units : 2147483647LL), sms, cap};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}
