// K2's tile walk, shared by its two forms, up_k2s2_into_halo.cu (bf16) and
// up_k2s2_into_halo_f32.cu (f32): the launch geometry both plans fill in,
// the input's tiling into GEMM tiles of 64 voxels, and the stores into the
// halo layout (the halo planes and rows, a staged tile's rows by bulk
// copy, its rows' two halo voxels), for output elements of type T. Each
// form keeps its own GEMM, shared-memory layout and slab search.
#pragma once

#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kTM = 64;  // GEMM rows (input voxels) a tile

// Launch geometry: tiles of R whole input rows (W2 <= 64) or of 64
// voxels of one row (tpr tiles a row); K in nK chunks of KC (zeros past
// ci); slabs of P of the four (a, p) pairs x CW channels (NS = 2 P CW
// columns, CW a power of two), n_cs channel slabs a group of pairs; S
// input buffers; staged rows at a pitch of 2 CW + 8 elements; the form's
// shared-memory offsets.
struct K2Geo {
  int D2, H2, W2, ci, co, Dp, Hp, Wp;
  int R, tpr, KC, nK, P, CW, NS, n_cs, n_slabs, S, pitch, log_pair;
  int rows, n_tiles, n_halo;
  int a_off, s_off, bias_off, smem;
  FastDiv by_tpr, by_W2, by_H2, by_D2;
};

inline int log2_of(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// the output's shape and the input's tiling, before the slab is chosen
inline void plan_tiles(K2Geo& g, int B, int D2, int H2, int W2, int ci, int co) {
  g.D2 = D2;
  g.H2 = H2;
  g.W2 = W2;
  g.ci = ci;
  g.co = co;
  g.Dp = 2 * D2 + 2;
  g.Hp = 2 * H2 + 2;
  g.Wp = 2 * W2 + 2;
  g.rows = B * D2 * H2;
  g.R = W2 <= kTM ? kTM / W2 : 1;
  g.tpr = W2 <= kTM ? 1 : (W2 + kTM - 1) / kTM;
  g.n_tiles = g.tpr == 1 ? (g.rows + g.R - 1) / g.R : g.rows * g.tpr;
  g.n_halo = B * (2 * g.Hp + 4 * D2);
  g.by_tpr = fast_div(g.tpr);
  g.by_W2 = fast_div(W2);
  g.by_H2 = fast_div(H2);
  g.by_D2 = fast_div(D2);
}

// what follows from the slab (P, CW) once it is chosen
inline void plan_slab(K2Geo& g) {
  g.NS = 2 * g.P * g.CW;
  g.n_cs = g.co / g.CW;
  g.n_slabs = 4 / g.P * g.n_cs;
  g.log_pair = log2_of(2 * g.CW);
  g.pitch = 2 * g.CW + 8;
}

// One tile: input rows [r0, r0 + nr) (the first is (b, d, h)), voxels
// [w0, w0 + wn) of each.
struct TileAt {
  int r0, nr, w0, wn, b, d, h;
};

// input row r -> (b, d, h)
__device__ __forceinline__ void row_at(const K2Geo& g, int r, int& b, int& d, int& h) {
  const int bd = r / g.by_H2;
  h = r - bd * g.H2;
  b = bd / g.by_D2;
  d = bd - b * g.D2;
}

__device__ __forceinline__ TileAt tile_at(const K2Geo& g, int t) {
  TileAt o;
  if (g.tpr == 1) {
    o.r0 = t * g.R;
    o.nr = min(g.R, g.rows - o.r0);
    o.w0 = 0;
    o.wn = g.W2;
  } else {
    o.r0 = t / g.by_tpr;
    o.nr = 1;
    o.w0 = (t - o.r0 * g.tpr) * kTM;
    o.wn = min(kTM, g.W2 - o.w0);
  }
  row_at(g, o.r0, o.b, o.d, o.h);
  return o;
}

// output row (b, 1 + 2 d + a, 1 + 2 h + p) of pair (a, p) = pair of input
// row (b, d, h)
__device__ __forceinline__ int out_row(const K2Geo& g, int b, int d, int h, int pair) {
  return (b * g.Dp + 1 + 2 * d + (pair >> 1)) * g.Hp + 1 + 2 * h + (pair & 1);
}

// the halo rows, this block's share: the planes pd = 0 and Dp-1, then rows
// ph = 0 and Hp-1 of every other plane, B (2 Hp + 4 D2) rows of Wp * co
// zeros, in 16 B stores
template <class T>
__device__ __forceinline__ void zero_halo_rows(T* y, const K2Geo& g) {
  constexpr int kV = 16 / sizeof(T);  // elements a 16 B store
  const size_t row_len = (size_t)g.Wp * g.co;
  const int per_b = 2 * g.Hp + 4 * g.D2;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int hr = blockIdx.x; hr < g.n_halo; hr += gridDim.x) {
    const int b = hr / per_b, e = hr - b * per_b;
    int pd, ph;
    if (e < 2 * g.Hp) {
      pd = e < g.Hp ? 0 : g.Dp - 1;
      ph = e < g.Hp ? e : e - g.Hp;
    } else {
      pd = 1 + (e - 2 * g.Hp) / 2;
      ph = (e & 1) ? g.Hp - 1 : 0;
    }
    T* o = y + (size_t)((b * g.Dp + pd) * g.Hp + ph) * row_len;
    for (size_t i = threadIdx.x * kV; i < row_len; i += blockDim.x * kV)
      *reinterpret_cast<uint4*>(o + i) = z;
  }
}

// A staged tile out (shared address `staged`: P pairs of 64 rows at the
// pitch), issued by this block's threads to the bulk-copy engine: GEMM
// row m of pair pi is output voxels 1+2w and 2+2w of row (b, 1+2d+a,
// 1+2h+p), channels [c0, c0 + CW) of each: one copy where the slab is all
// of co (the two voxels contiguous), else one a voxel.
template <class T>
__device__ __forceinline__ void send_tile(T* y, uint32_t staged, const K2Geo& g, int pair0,
                                          int c0, int tile) {
  const TileAt tt = tile_at(g, tile);
  const bool whole = g.CW == g.co;
  const int per_pair = tt.nr * tt.wn << !whole;
  const int bytes = (whole ? 2 : 1) * g.CW * (int)sizeof(T);
  for (int i = threadIdx.x; i < g.P * per_pair; i += blockDim.x) {
    int pi = 0, j = i;  // (pair, staged row or half of it); P <= 4
    while (j >= per_pair) {
      j -= per_pair;
      ++pi;
    }
    const int m = whole ? j : j >> 1, q = whole ? 0 : j & 1;
    const int rr = g.tpr == 1 ? m / g.by_W2 : 0, w = tt.w0 + m - rr * tt.wn;
    int b, d, h;
    row_at(g, tt.r0 + rr, b, d, h);
    bulk_store(y + (size_t)out_row(g, b, d, h, pair0 + pi) * g.Wp * g.co +
                   (size_t)(1 + 2 * w + q) * g.co + c0,
               staged + ((pi * kTM + m) * g.pitch + q * g.CW) * (int)sizeof(T), bytes);
  }
  bulk_commit();
}

// the tile's rows' halo voxels, positions 0 (the tile starts the row) and
// Wp - 1 (it ends it), channels [c0, c0 + CW): zeros, in 16 B stores
template <class T>
__device__ __forceinline__ void halo_voxels(T* y, const K2Geo& g, int pair0, int c0, int tile) {
  constexpr int kLogV = sizeof(T) == 2 ? 3 : 2;  // log2(elements a 16 B store)
  const TileAt tt = tile_at(g, tile);
  const bool lead = tt.w0 == 0, trail = tt.w0 + tt.wn == g.W2;
  const int lv = g.log_pair - 1 - kLogV;  // log2(stores a voxel's CW channels)
  for (int i = threadIdx.x; i < g.P * tt.nr * 2 << lv; i += blockDim.x) {
    const int side = (i >> lv) & 1;
    if (side ? !trail : !lead) continue;
    int pi = 0, rr = i >> (lv + 1);  // (pair, row of the tile)
    while (rr >= tt.nr) {
      rr -= tt.nr;
      ++pi;
    }
    int b, d, h;
    row_at(g, tt.r0 + rr, b, d, h);
    *reinterpret_cast<uint4*>(y + (size_t)out_row(g, b, d, h, pair0 + pi) * g.Wp * g.co +
                              (size_t)(side ? g.Wp - 1 : 0) * g.co + c0 +
                              ((i & ((1 << lv) - 1)) << kLogV)) = make_uint4(0u, 0u, 0u, 0u);
  }
}

}  // namespace
