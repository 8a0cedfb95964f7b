// PTX helpers of the port's Hopper GEMM kernels, K7 (conv3d_same.cu), K1
// (ps2d_conv3d.cu) and K2 (up_k2s2_into_halo.cu), and their f32 forms
// (*_f32.cu): cp.async copies, bulk (TMA engine) stores from shared
// memory, mbarriers, ldmatrix, the warpgroup MMA (wgmma, RS form: A from
// registers, B from shared memory through a descriptor) and the
// no-swizzle layout of its B operand, a division by a constant worked out
// on the host; for the f32 forms the exact split of f32 values into three
// bf16 parts and their shared-memory budget. Each kernel keeps its own
// main loop; only these pieces are shared. sm_90a only (wgmma).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B global -> shared; zeros (and no read) when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
               : "memory");
}
// arrive on `bar` once every earlier cp.async of this thread has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// wait for the phase of `bar` with this parity to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// bytes shared -> global by the bulk-copy (TMA) engine, asynchronous to
// the issuing thread; 16 B aligned, a multiple of 16 B
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk copies have read their shared memory (or, with
// all, have completed)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across a wait
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ----------------------------------------------------- index arithmetic
// x / d for 0 <= x < 2^31 as a multiply-high and a shift (the round-up
// method: mul = ceil(2^(31 + l) / d), l = ceil(log2 d)), the constant
// worked out on the host
struct FastDiv {
  int d;
  uint32_t mul, shr;
};

inline FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1ll << l) < d) ++l;
    f.mul = (uint32_t)(((1ull << (31 + l)) + d - 1) / d);
    f.shr = l - 1;
  }
  return f;
}

__device__ __forceinline__ int operator/(int x, const FastDiv& f) {
  return f.d == 1 ? x : (int)(__umulhi((uint32_t)x, f.mul) >> f.shr);
}

// ------------------------------------------------------ B operand layout
// A KC x N weight slab (k = input channel, n = output channel) in the
// no-swizzle core-matrix layout: core matrices of 8 k rows x 8 n (16 B a
// row, 128 contiguous bytes); n-groups 128 B apart, k-groups 16 * N bytes
// apart. Byte offset of the 16 B row (k, n8):
template <int N>
__device__ __forceinline__ uint32_t b_offset(int k, int n8) {
  return (uint32_t)((k >> 3) * 16 * N + n8 * 128 + (k & 7) * 16);
}
// wgmma descriptor of the k16 step starting at `addr` in that layout: the
// leading byte offset is the k-group stride, the stride byte offset the
// n-group stride (both in 16 B units); no swizzle, base offset 0.
template <int N>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 * N >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}
// the slab's 16 B row number i in copy order, (k, n8): eight consecutive
// rows fill one core matrix, so eight threads write 128 contiguous bytes
template <int N>
__device__ __forceinline__ void slab_row(int i, int& k, int& n8) {
  n8 = (i >> 3) % (N / 8);
  k = (i >> 3) / (N / 8) * 8 + (i & 7);
}

// ------------------------------------------------------------- wgmma
// d (64 x N, f32, the warpgroup's accumulator) += a (64 x 16 bf16, this
// thread's mma.m16n8k16 A fragment) * B (16 x N bf16, descriptor; MN-major,
// hence the transpose bit, the last immediate); with scale_d = 0,
// d = a * B (d's old values are not read)
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// A thread's accumulator element e of n8 block j lies at row
//   16 * warp + lane / 4 + 8 * (e / 2), column 8 * j + 2 * (lane % 4) + e % 2
// of its warpgroup's 64 x N tile.

// ------------------------------------------------- the f32 forms' split
// shared memory a block may take for two blocks an SM: (228 KB - 2 x 1 KB
// reserved) / 2
constexpr int kSmemBlock = 115712;

// two f32 values -> their bf16 (round to nearest, even), packed low first,
// and the f32 remainders x - bf16(x) (exact)
__device__ __forceinline__ uint32_t split2(float& x, float& y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  x = __fsub_rn(x, f.x);
  y = __fsub_rn(y, f.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the exact three-way split of four f32 values: hi, mid, lo (4 bf16 each)
__device__ __forceinline__ void split4(float4 v, uint2& hi, uint2& mid, uint2& lo) {
  hi.x = split2(v.x, v.y);
  hi.y = split2(v.z, v.w);
  mid.x = split2(v.x, v.y);
  mid.y = split2(v.z, v.w);
  lo.x = split2(v.x, v.y);
  lo.y = split2(v.z, v.w);
}

}  // namespace
