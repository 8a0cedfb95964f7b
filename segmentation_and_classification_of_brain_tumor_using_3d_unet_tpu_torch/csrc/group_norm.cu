// K5: GroupNorm over a channels-last (N, M, C) tensor, f32 or bf16, with
// the DoubleConv tail fused into its second pass:
//   y = relu?(x * scale[n, c] + shift[n, c]) (+ residual), one rounding.
//
// Replaces the Pallas kernels behind ops/pallas/groupnorm.py::
// fused_group_norm (bodies `_stats_kernel` :31-44, `_apply_kernel` :47-52,
// `_apply_res_kernel` :55-62) of the JAX package. Same two passes, not the
// same blocks: the TPU kernel views p voxels as one row of p*C lanes to fill
// its 128 lanes and carries the sums across sequential grid steps; here the
// blocks run in parallel, so the sums are taken per chunk of voxels and
// added in a second, small pass, in a fixed order (no float atomics: two
// runs give the same bits).
//
//   group_norm_stats: stats_partial (grid chunks x N) -> per-chunk f32
//     sums of x and of x*x per channel (squares taken in f32), then
//     stats_final (grid C/32 x N) -> (N, 2, C) sums. Two launches.
//   (the caller folds the sums into per-channel scale and shift: (N, C))
//   group_norm_apply: apply_kernel (grid blocks x N). One launch.
//
// Bound on the H100: a few operations per value, so bound by bytes: the
// function reads x once (and the residual) and writes y once (0.32 ms at
// (4, 128^3, 32) bf16 at 3.35 TB/s; 0.48 ms with the residual). The two
// passes read x twice, so this design cannot go below 1.5x that bound
// (4/3x with the residual). Design for that: 16 B per thread per access
// (8 channels) where C % 8 == 0, neighbouring threads on neighbouring
// addresses, scale and shift staged in shared memory; one value per
// access otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;

// ---- V consecutive values <-> float[V] (V 8: one or two 16 B accesses) --
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

template <int V>
__device__ __forceinline__ void load(const bf16* p, float* v) {
  if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
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
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// ---- pass 1a: per-chunk sums ---------------------------------------------
// Block (chunk, n) sums rows [chunk * chunk_rows, +chunk_rows) of sample n.
// Its threads form a TY x TX grid over (rows, vectors of a row): thread
// (ty, tx) keeps the sums of vector tx (+TX, ...) over rows ty, ty+TY, ...;
// the TY partial sums of each channel are then added in order of ty.
// part: (N, chunks, 2, C) f32.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stats_partial(const T* __restrict__ x, float* __restrict__ part, int M, int C,
              int chunk_rows) {
  __shared__ float red[2][kThreads * kMaxVec];   // (TY, TX * V) each
  const int n = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int vpr = C / V;                          // vectors per row
  const int TX = vpr < 32 ? vpr : 32, TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const bool active = ty < TY;
  const int r0 = chunk * chunk_rows;
  const int r1 = min(M, r0 + chunk_rows);
  const T* xs = x + (size_t)n * M * C;
  for (int g0 = 0; g0 < vpr; g0 += TX) {
    const int g = g0 + tx;
    float s1[V], s2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
    if (active && g < vpr) {
      for (int r = r0 + ty; r < r1; r += TY) {
        float v[V];
        load<V>(xs + (size_t)r * C + g * V, v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s1[k] += v[k];
          s2[k] += v[k] * v[k];
        }
      }
    }
    if (active) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        red[0][ty * TX * V + tx * V + k] = s1[k];
        red[1][ty * TX * V + tx * V + k] = s2[k];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * TX * V; i += kThreads) {
      const int j = i / (TX * V), col = i % (TX * V);
      const int c = g0 * V + col;
      if (c < C) {
        float s = 0.f;
        for (int t = 0; t < TY; ++t) s += red[j][t * TX * V + col];
        part[(((size_t)n * chunks + chunk) * 2 + j) * C + c] = s;
      }
    }
    __syncthreads();
  }
}

// ---- pass 1b: sums over the chunks, in a fixed order ---------------------
// Block (channel tile of 32, n), threads (32 channels, 8 strides of chunks).
// sums: (N, 2, C) f32.
__global__ void __launch_bounds__(kThreads)
stats_final(const float* __restrict__ part, float* __restrict__ sums, int C,
            int chunks) {
  __shared__ float red[2][8][32];
  const int n = blockIdx.y, tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  float s[2] = {0.f, 0.f};
  if (c < C)
    for (int k = ty; k < chunks; k += 8)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s[j] += part[(((size_t)n * chunks + k) * 2 + j) * C + c];
  red[0][ty][tx] = s[0];
  red[1][ty][tx] = s[1];
  __syncthreads();
  if (ty < 2 && c < C) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += red[ty][k][tx];
    sums[((size_t)n * 2 + ty) * C + c] = t;
  }
}

// ---- pass 2: y = relu?(x * scale + shift) (+ residual) --------------------
// Block (i, n) walks sample n's vectors with a stride of the grid's width.
// scale, shift: (N, C) f32, staged in shared memory (2 * C floats).
template <typename T, typename R, int V>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ shift, const R* __restrict__ res,
             int relu, T* __restrict__ y, int M, int C) {
  extern __shared__ float ss[];                   // scale[C], shift[C]
  const int n = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    ss[c] = scale[(size_t)n * C + c];
    ss[C + c] = shift[(size_t)n * C + c];
  }
  __syncthreads();
  const unsigned vpr = C / V;
  const unsigned total = (unsigned)M * vpr;       // the caller keeps it < 2^31
  const size_t base = (size_t)n * M * C;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < total;
       i += gridDim.x * kThreads) {
    const int c = (int)(i % vpr) * V;
    const size_t off = base + (size_t)i * V;
    float v[V];
    load<V>(x + off, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float t = v[k] * ss[c + k] + ss[C + c + k];
      if (relu) t = fmaxf(t, 0.f);
      v[k] = t;
    }
    if (res != nullptr) {
      float r[V];
      load<V>(res + off, r);
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] += r[k];
    }
    store<V>(y + off, v);
  }
}

template <typename T, int V>
int launch_stats(const void* x, void* part, void* sums, int N, int M, int C,
                 int chunk_rows, int chunks, cudaStream_t s) {
  stats_partial<T, V><<<dim3(chunks, N), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(part), M, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_final<<<dim3((C + 31) / 32, N), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(sums), C, chunks);
  return (int)cudaGetLastError();
}

template <typename T, typename R, int V>
int launch_apply(const void* x, const float* scale, const float* shift,
                 const void* res, int relu, void* y, int N, int M, int C,
                 cudaStream_t s) {
  const size_t smem = 2 * (size_t)C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        apply_kernel<T, R, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long vecs = (long long)M * (C / V);
  const long long want = (vecs + kThreads - 1) / kThreads;
  // enough blocks to fill the card (132 SMs x 8 blocks of 256), split
  // over the samples; each walks its sample with a stride
  const long long per_n = (1056 + N - 1) / N;
  const int blocks = (int)(want < per_n ? want : per_n);
  apply_kernel<T, R, V><<<dim3(blocks, N), kThreads, smem, s>>>(
      static_cast<const T*>(x), scale, shift, static_cast<const R*>(res),
      relu, static_cast<T*>(y), M, C);
  return (int)cudaGetLastError();
}

template <typename T, typename R>
int apply_vec(const void* x, const float* scale, const float* shift,
              const void* res, int relu, void* y, int N, int M, int C,
              cudaStream_t s) {
  if (C % 8 == 0) return launch_apply<T, R, 8>(x, scale, shift, res, relu, y, N, M, C, s);
  return launch_apply<T, R, 1>(x, scale, shift, res, relu, y, N, M, C, s);
}

}  // namespace

// x: (N, M, C) f32 (x_bf16 = 0) or bf16 (1); part: (N, chunks, 2, C) f32
// scratch; sums: (N, 2, C) f32 out, the per-channel sums of x and of x*x.
// chunk_rows * chunks >= M. Pointers 16 B aligned where C % 8 == 0.
// Launches two kernels; returns the first cudaError_t that is not 0.
extern "C" int group_norm_stats(const void* x, int x_bf16, void* part,
                                void* sums, int N, int M, int C,
                                int chunk_rows, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || M < 1 || C < 1 || chunks < 1 || chunks > 65535 ||
      N > 65535 || (long long)chunk_rows * chunks < M)
    return (int)cudaErrorInvalidValue;
  const bool vec = C % 8 == 0;
  if (x_bf16)
    return vec ? launch_stats<bf16, 8>(x, part, sums, N, M, C, chunk_rows, chunks, s)
               : launch_stats<bf16, 1>(x, part, sums, N, M, C, chunk_rows, chunks, s);
  return vec ? launch_stats<float, 8>(x, part, sums, N, M, C, chunk_rows, chunks, s)
             : launch_stats<float, 1>(x, part, sums, N, M, C, chunk_rows, chunks, s);
}

// y = relu?(x * scale + shift) (+ res), y of x's type; scale, shift (N, C)
// f32; res (N, M, C) f32 (res_bf16 = 0) or bf16 (1), or null. M * C below
// 2^31. One launch; returns its cudaError_t.
extern "C" int group_norm_apply(const void* x, int x_bf16, const void* scale,
                                const void* shift, const void* res,
                                int res_bf16, int relu, void* y, int N, int M,
                                int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || M < 1 || C < 1 || N > 65535 || (long long)M * C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (x_bf16)
    return res_bf16 || res == nullptr
               ? apply_vec<bf16, bf16>(x, sc, sh, res, relu, y, N, M, C, s)
               : apply_vec<bf16, float>(x, sc, sh, res, relu, y, N, M, C, s);
  return res_bf16 ? apply_vec<float, bf16>(x, sc, sh, res, relu, y, N, M, C, s)
                  : apply_vec<float, float>(x, sc, sh, res, relu, y, N, M, C, s);
}
