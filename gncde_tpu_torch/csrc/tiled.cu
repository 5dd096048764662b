// K3, K4, K5a, K5b: the plane sweeps of the tiled regime (n > 640); K5c:
// the 4-slab apply behind tiled_abar_apply; K6a, K6b: the plane-pair sweeps
// of the enc_idx path.
//
// Replace the TPU kernels of gncde_tpu/ops/pallas/tiled.py:
//   K3  _fwd2_kernel / _fwd2_call   rowpart = B1 M, colpart = B2^T M
//   K5c _fwd_kernel / _fwd_call     rowpart = B(w_row) M, colpart =
//                                   B(w_col)^T M, B(w) = sum_j w_j slab_j
//                                   over the four Hermite slabs (d, c, b, a)
//   K4  _bwd2_kernel / _bwd2_call   A g, dA g, A^T g, dA^T g in one sweep,
//                                   dM parts and the four c cotangents
//   K5a _dw2_kernel / _dw2_call     <A|dA, G M^T>, <A|dA, M G^T>
//   K5b _dw_kernel / _dw_call       <slab_j, G M^T>, <slab_j, M G^T>
//   K6a _pair_kernel / _pair_call   rowpart = B1 Mk, colpart = B2^T Mi
//   K6b _pair_dw_kernel / _pair_dw_call
//                                   <A|dA, Gr Mk^T>, <A|dA, Mi Gc^T>
// K5c: B(w) formed in f32 from the f32 or bf16 slabs, each product and sum
// rounded once in _fwd_kernel's order ((w0 d + w1 c) + w2 b) + w3 a, entries
// beyond n zero, then rounded to bf16 (the matmul operand), M in bf16.
// K3-K5b: B1 = cr0 A + cr1 dA and B2 = cc0 A + cc1 dA formed in bf16 from
// the bf16 interval planes A = A(t), dA = dA(t) (the coefficients rounded
// to bf16, every product and sum rounded to bf16, as _fwd2_kernel does).
// K6a/K6b: f32 planes (the modulated A(t), dA(t), functions of trainable
// parameters), B1/B2 formed in f32, f32 vectors, rectangular (nr, nc)
// extents (the enc_idx path passes square ones). Every product is
// accumulated in f32. K6a-bf/K6b-bf (fusion_precision bf16): bf16 planes,
// B1/B2 formed in bf16 as K3 forms them (_pair_kernel casts the
// coefficients to the planes' dtype); K6a-bf takes f32 vectors (the
// forward's M: the products of bf16-rounded B values and f32 vectors, in
// f32, as JAX promotes the dot) or bf16 ones (the backward's cotangents),
// K6b-bf bf16 vectors (_ppa_bwd's mm_dtype).
//
// Layout. Planes are (B, n, n) and vectors M, G (B, n, H) bf16 (K6: f32 or
// bf16 as above, (B, nr, nc) and (B, nr | nc, H)), unpadded:
// every tile load is bound-checked against n, and a tile's overhang is
// staged as zero. One CTA owns BO indices of one batch element and sweeps
// the whole reduce extent in BR-deep tiles staged in shared memory as f32:
//   row pass (blockIdx.y == 0): owns rows i, out[i] = sum_k S[i, k] V[k]
//   col pass (blockIdx.y == 1): owns cols k, out[k] = sum_i S[i, k] V[i]
// The TPU kernels accumulate colpart into one VMEM-resident (NP, H) buffer
// over a sequential grid. Here CTAs run in parallel, so the column sums get
// CTAs of their own that own column blocks (the col pass) instead of
// per-row-block partials: every output element is written by exactly one
// CTA, summed in one fixed order, with no float atomics, so results are
// bitwise repeatable. The price is a second read of the planes (by the col
// pass), which mostly hits the 50 MB L2 (two bf16 planes at n = 1505 are
// 9.1 MB). Scalar cotangents (K4, K5a, K5b) are per-CTA partials, reduced in
// a fixed order by a second kernel.
//
// What bounds it on the card: bytes. One sweep must read the two bf16
// planes (4 n^2 bytes); the products are 4 n^2 H (K3) or 8 n^2 H (K4)
// FLOPs, under the H100's bf16 ridge point for H <= 128. This first version
// multiplies with f32 FMAs from shared memory (the products of bf16 values
// are exact in f32) and overlaps the next tile's global loads with the
// current tile's FMAs through registers; it has no tensor cores, TMA or
// shared-memory double buffering (later work), and runs far above that
// bound: at H = 128 it is bound by shared-memory loads and issue, at small H
// by the latency of its 47 sequential tiles (n = 1505).
//
// Widths: any H >= 1. Each kernel is compiled for feature chunks of HC = 8,
// 32 and 128 columns and launched with the smallest that holds H (or 128),
// so a narrow layer runs no idle loop iterations; H > 128 re-reads the
// planes once per 128 columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace tl {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;  // threads per CTA
constexpr int BR = 32;   // depth of one reduce tile
constexpr int HCMAX = 128;  // widest feature chunk of one sweep

// Owned-block size of a kernel with NSV = NS * NV accumulator sets at chunk
// width HC: 16 accumulators a thread (NSV * BO * HC / NT = 16), at most 32.
__host__ __device__ constexpr int bo_for(int nsv, int hc) {
  return 16 * NT / (nsv * hc) < 32 ? 16 * NT / (nsv * hc) : 32;
}

__device__ __forceinline__ float ldf(const bf16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float ldf(const float* p, long long i) { return p[i]; }
// Round to bf16 and back (round to nearest even, as a bf16 op does).
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sum over the CTA in one fixed order; the total is valid in thread 0.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < NT / 32; ++i) s += red[i];
  return s;
}

struct Sweep {
  const void* p[4];   // NPL plane pointers (bf16; f32 for K5b's slabs and K6)
  int nr, nc;         // planes (B, nr, nc); K3-K5b are square, nr = nc = n
  const void* v[2];   // NV vector operands (bf16; f32 for K6): (B, nc, H) in
                      // the row pass, (B, nr, H) in the column pass
  int H;
  float w[4];         // the four slab weights of a COMBO_SLAB4 tile (K5c)
};

// How a sweep forms its plane tile from the NPL raw planes.
enum Combo { RAW = 0, COMBO_BF16 = 1, COMBO_F32 = 2, COMBO_SLAB4 = 3 };

// Shared tiles of one CTA: NS plane tiles (BO x BR, padded rows) and NV
// vector tiles (BR x HC), both f32.
template <int NS, int NV, int BO, int HC>
struct Smem {
  float S[NS][BO][BR + 1];
  float V[NV][BR][HC];
  float red[NT / 32];
};

// One sweep of a CTA over the reduce extent for owned indices o0 .. o0+BO-1
// and feature columns h0 .. h0+hc-1:
//   acc[s * NV + v][j] += sum_r S_s[a_j][r] * V_v[r][h_j]
// for the (a_j, h_j) = divmod(tid + j NT, hc) pairs of this thread. The row
// pass owns rows and reduces over the nc columns, the column pass (trans)
// owns columns and reduces over the nr rows. With COMBO_BF16 the NPL = 2
// raw planes form one tile S_0 = bf16(bf16(c0 x0) + bf16(c1 x1)) (K3), with
// COMBO_F32 the f32 tile S_0 = c0 x0 + c1 x1 (K6, each product and the sum
// rounded once); with RAW each raw plane is its own tile (NS = NPL).
// The next tile's global loads are issued into registers before the current
// tile is multiplied, so their latency overlaps the FMAs; all loads of one
// tile are in flight together (unrolled, fixed trip counts).
template <int NPL, int NS, int NV, int BO, int HC, int COMBO, typename PT,
          typename VT>
__device__ void sweep(const Sweep& g, Smem<NS, NV, BO, HC>& sm, int b, bool trans,
                      int o0, int h0, int hc, float c0, float c1,
                      float (&acc)[NS * NV][(BO * HC + NT - 1) / NT]) {
  constexpr int PPT = (BO * HC + NT - 1) / NT;      // output pairs per thread
  constexpr int PE = (BO * BR + NT - 1) / NT;       // plane elements per thread
  constexpr int VE = (BR * HC + NT - 1) / NT;       // vector elements per thread
  int pa[PPT], ph[PPT];
  bool pv[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = threadIdx.x + j * NT;
    pv[j] = p < BO * hc;
    pa[j] = pv[j] ? p / hc : 0;
    ph[j] = pv[j] ? p % hc : 0;
#pragma unroll
    for (int s = 0; s < NS * NV; ++s) acc[s][j] = 0.f;
  }
  // When hc divides NT, every pair of a thread has the same column h.
  const bool one_h = NT % hc == 0;
  const int ext = trans ? g.nr : g.nc;  // reduce extent
  const long long pbase = (long long)b * g.nr * g.nc;
  const long long vbase = (long long)b * ext * g.H;
  float px[NPL][PE], vx[NV][VE];

  auto fetch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < PE; ++i) {
      // Consecutive threads read consecutive columns of a plane row.
      const int e = threadIdx.x + i * NT;
      const int a = trans ? e % BO : e / BR;
      const int r = trans ? e / BO : e % BR;
      const int row = trans ? r0 + r : o0 + a;
      const int col = trans ? o0 + a : r0 + r;
      const bool ok = e < BO * BR && row < g.nr && col < g.nc;
      const long long off = pbase + (long long)row * g.nc + col;
#pragma unroll
      for (int q = 0; q < NPL; ++q)
        px[q][i] = ok ? ldf(static_cast<const PT*>(g.p[q]), off) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < VE; ++i) {
      const int e = threadIdx.x + i * NT;
      const int r = e / hc, h = e % hc;
      const bool ok = e < BR * hc && r0 + r < ext;
      const long long off = vbase + (long long)(r0 + r) * g.H + h0 + h;
#pragma unroll
      for (int q = 0; q < NV; ++q)
        vx[q][i] = ok ? ldf(static_cast<const VT*>(g.v[q]), off) : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < PE; ++i) {
      const int e = threadIdx.x + i * NT;
      if (e >= BO * BR) continue;
      const int a = trans ? e % BO : e / BR;
      const int r = trans ? e / BO : e % BR;
      if (COMBO == COMBO_BF16) {
        sm.S[0][a][r] = rbf(rbf(c0 * px[0][i]) + rbf(c1 * px[1][i]));
      } else if (COMBO == COMBO_F32) {
        sm.S[0][a][r] = __fadd_rn(__fmul_rn(c0, px[0][i]), __fmul_rn(c1, px[1][i]));
      } else if (COMBO == COMBO_SLAB4) {
        float x = __fmul_rn(g.w[0], px[0][i]);
#pragma unroll
        for (int q = 1; q < 4; ++q) x = __fadd_rn(x, __fmul_rn(g.w[q], px[q][i]));
        sm.S[0][a][r] = rbf(x);
      } else {
#pragma unroll
        for (int q = 0; q < NS; ++q) sm.S[q][a][r] = px[q][i];
      }
    }
#pragma unroll
    for (int i = 0; i < VE; ++i) {
      const int e = threadIdx.x + i * NT;
      if (e >= BR * hc) continue;
#pragma unroll
      for (int q = 0; q < NV; ++q) sm.V[q][e / hc][e % hc] = vx[q][i];
    }
  };

  fetch(0);
  for (int r0 = 0; r0 < ext; r0 += BR) {
    stash();
    __syncthreads();
    if (r0 + BR < ext) fetch(r0 + BR);
    if (one_h) {
#pragma unroll 4
      for (int r = 0; r < BR; ++r) {
        float v[NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) v[q] = sm.V[q][r][ph[0]];
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          if (!pv[j]) continue;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float sv = sm.S[s][pa[j]][r];
#pragma unroll
            for (int q = 0; q < NV; ++q)
              acc[s * NV + q][j] = fmaf(sv, v[q], acc[s * NV + q][j]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < BR; ++r) {
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          if (!pv[j]) continue;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float sv = sm.S[s][pa[j]][r];
#pragma unroll
            for (int q = 0; q < NV; ++q)
              acc[s * NV + q][j] = fmaf(sv, sm.V[q][r][ph[j]], acc[s * NV + q][j]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// (a, h) of a thread's j-th pair, or false when the pair is idle.
__device__ __forceinline__ bool pair(int j, int hc, int bo, int& a, int& h) {
  const int p = threadIdx.x + j * NT;
  if (p >= bo * hc) return false;
  a = p / hc;
  h = p % hc;
  return true;
}

// ---- K3 ------------------------------------------------------------------
template <int HC>
__global__ void __launch_bounds__(NT) fwd2_kernel(Sweep g, const float* cvec,
                                                  float* row_out, float* col_out) {
  constexpr int BO = bo_for(1, HC), PPT = (BO * HC + NT - 1) / NT;
  __shared__ Smem<1, 1, BO, HC> sm;
  const int b = blockIdx.z;
  const bool trans = blockIdx.y == 1;
  const int o0 = blockIdx.x * BO;
  // The coefficients are cast to the planes' dtype first (_fwd2_kernel).
  const float c0 = rbf(__ldg(cvec + (trans ? 2 : 0)));
  const float c1 = rbf(__ldg(cvec + (trans ? 3 : 1)));
  float* out = (trans ? col_out : row_out) + (long long)b * g.nr * g.H;
  float acc[1][PPT];
  for (int h0 = 0; h0 < g.H; h0 += HC) {
    const int hc = min(HC, g.H - h0);
    sweep<2, 1, 1, BO, HC, COMBO_BF16, bf16, bf16>(g, sm, b, trans, o0, h0, hc, c0, c1,
                                                 acc);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      int a, h;
      if (pair(j, hc, BO, a, h) && o0 + a < g.nr)
        out[(long long)(o0 + a) * g.H + h0 + h] = acc[0][j];
    }
  }
}

// ---- K5c -----------------------------------------------------------------
// wvec: (B, 8) f32, per element (w_row, w_col). Slabs of type PT (f32 or
// bf16), M (B, n, H) bf16; row_out, col_out (B, n, H) f32.
template <int HC, typename PT>
__global__ void __launch_bounds__(NT) abar_kernel(Sweep g, const float* wvec,
                                                  float* row_out, float* col_out) {
  constexpr int BO = bo_for(1, HC), PPT = (BO * HC + NT - 1) / NT;
  __shared__ Smem<1, 1, BO, HC> sm;
  const int b = blockIdx.z;
  const bool trans = blockIdx.y == 1;
  const int o0 = blockIdx.x * BO;
#pragma unroll
  for (int q = 0; q < 4; ++q) g.w[q] = __ldg(wvec + b * 8 + (trans ? 4 : 0) + q);
  float* out = (trans ? col_out : row_out) + (long long)b * g.nr * g.H;
  float acc[1][PPT];
  for (int h0 = 0; h0 < g.H; h0 += HC) {
    const int hc = min(HC, g.H - h0);
    sweep<4, 1, 1, BO, HC, COMBO_SLAB4, PT, bf16>(g, sm, b, trans, o0, h0, hc, 0.f, 0.f,
                                                  acc);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      int a, h;
      if (pair(j, hc, BO, a, h) && o0 + a < g.nr)
        out[(long long)(o0 + a) * g.H + h0 + h] = acc[0][j];
    }
  }
}

// ---- K4 ------------------------------------------------------------------
// cvec = (c_col0, c_col1, c_row0, c_row1): row pass dM rows
// c_col . (A g, dA g); col pass dM rows c_row . (A^T g, dA^T g).
// part: (B, 2 * gridDim.x, 4) partial sums of
// (<A^T g, M>, <dA^T g, M>, <A g, M>, <dA g, M>).
template <int HC>
__global__ void __launch_bounds__(NT) bwd2_kernel(Sweep g, const float* cvec,
                                                  const bf16* M, float* row_out,
                                                  float* col_out, float* part) {
  constexpr int BO = bo_for(2, HC), PPT = (BO * HC + NT - 1) / NT;
  __shared__ Smem<2, 1, BO, HC> sm;
  const int b = blockIdx.z;
  const bool trans = blockIdx.y == 1;
  const int o0 = blockIdx.x * BO;
  const float c0 = __ldg(cvec + (trans ? 2 : 0));
  const float c1 = __ldg(cvec + (trans ? 3 : 1));
  float* out = (trans ? col_out : row_out) + (long long)b * g.nr * g.H;
  const bf16* Mb = M + (long long)b * g.nr * g.H;
  float acc[2][PPT];
  float dot0 = 0.f, dot1 = 0.f;
  for (int h0 = 0; h0 < g.H; h0 += HC) {
    const int hc = min(HC, g.H - h0);
    sweep<2, 2, 1, BO, HC, RAW, bf16, bf16>(g, sm, b, trans, o0, h0, hc, 0.f, 0.f, acc);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      int a, h;
      if (!pair(j, hc, BO, a, h) || o0 + a >= g.nr) continue;
      const long long o = (long long)(o0 + a) * g.H + h0 + h;
      out[o] = c0 * acc[0][j] + c1 * acc[1][j];
      const float m = __bfloat162float(Mb[o]);
      dot0 = fmaf(acc[0][j], m, dot0);
      dot1 = fmaf(acc[1][j], m, dot1);
    }
  }
  dot0 = block_sum(dot0, sm.red);
  dot1 = block_sum(dot1, sm.red);
  if (threadIdx.x == 0) {
    float* pp = part + ((long long)b * 2 * gridDim.x + blockIdx.y * gridDim.x +
                        blockIdx.x) * 4;
    pp[0] = trans ? dot0 : 0.f;
    pp[1] = trans ? dot1 : 0.f;
    pp[2] = trans ? 0.f : dot0;
    pp[3] = trans ? 0.f : dot1;
  }
}

// ---- K5a -----------------------------------------------------------------
// Row pass only. Sets (A M, A G, dA M, dA G) for the owned rows i; part:
// (B, gridDim.x, 4) partials of (<A, G M^T>, <dA, G M^T>, <A, M G^T>,
// <dA, M G^T>) = sum_i (G . A M, G . dA M, M . A G, M . dA G).
template <int HC>
__global__ void __launch_bounds__(NT) dw2_kernel(Sweep g, float* part) {
  constexpr int BO = bo_for(4, HC), PPT = (BO * HC + NT - 1) / NT;
  __shared__ Smem<2, 2, BO, HC> sm;
  const int b = blockIdx.z;
  const int o0 = blockIdx.x * BO;
  const bf16* Mb = static_cast<const bf16*>(g.v[0]) + (long long)b * g.nr * g.H;
  const bf16* Gb = static_cast<const bf16*>(g.v[1]) + (long long)b * g.nr * g.H;
  float acc[4][PPT];
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int h0 = 0; h0 < g.H; h0 += HC) {
    const int hc = min(HC, g.H - h0);
    sweep<2, 2, 2, BO, HC, RAW, bf16, bf16>(g, sm, b, false, o0, h0, hc, 0.f, 0.f, acc);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      int a, h;
      if (!pair(j, hc, BO, a, h) || o0 + a >= g.nr) continue;
      const long long o = (long long)(o0 + a) * g.H + h0 + h;
      const float m = __bfloat162float(Mb[o]), gg = __bfloat162float(Gb[o]);
      dot[0] = fmaf(acc[0][j], gg, dot[0]);
      dot[1] = fmaf(acc[2][j], gg, dot[1]);
      dot[2] = fmaf(acc[1][j], m, dot[2]);
      dot[3] = fmaf(acc[3][j], m, dot[3]);
    }
  }
  float* pp = part + ((long long)b * gridDim.x + blockIdx.x) * 4;
  for (int q = 0; q < 4; ++q) {
    const float s = block_sum(dot[q], sm.red);
    if (threadIdx.x == 0) pp[q] = s;
  }
}

// ---- K5b -----------------------------------------------------------------
// Row pass only over the four f32 slabs (d, c, b, a). Sets (S_j M, S_j G);
// part: (B, gridDim.x, 8) partials of <S_j, G M^T> (j < 4) and
// <S_j, M G^T> (4 + j).
template <int HC>
__global__ void __launch_bounds__(NT) dw_kernel(Sweep g, float* part) {
  constexpr int BO = bo_for(8, HC), PPT = (BO * HC + NT - 1) / NT;
  __shared__ Smem<4, 2, BO, HC> sm;
  const int b = blockIdx.z;
  const int o0 = blockIdx.x * BO;
  const bf16* Mb = static_cast<const bf16*>(g.v[0]) + (long long)b * g.nr * g.H;
  const bf16* Gb = static_cast<const bf16*>(g.v[1]) + (long long)b * g.nr * g.H;
  float acc[8][PPT];
  float dot[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) dot[q] = 0.f;
  for (int h0 = 0; h0 < g.H; h0 += HC) {
    const int hc = min(HC, g.H - h0);
    sweep<4, 4, 2, BO, HC, RAW, float, bf16>(g, sm, b, false, o0, h0, hc, 0.f, 0.f, acc);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      int a, h;
      if (!pair(j, hc, BO, a, h) || o0 + a >= g.nr) continue;
      const long long o = (long long)(o0 + a) * g.H + h0 + h;
      const float m = __bfloat162float(Mb[o]), gg = __bfloat162float(Gb[o]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        dot[s] = fmaf(acc[2 * s][j], gg, dot[s]);
        dot[4 + s] = fmaf(acc[2 * s + 1][j], m, dot[4 + s]);
      }
    }
  }
  float* pp = part + ((long long)b * gridDim.x + blockIdx.x) * 8;
  for (int q = 0; q < 8; ++q) {
    const float s = block_sum(dot[q], sm.red);
    if (threadIdx.x == 0) pp[q] = s;
  }
}

// ---- K6a -----------------------------------------------------------------
// The rectangular pair apply of the enc_idx path: planes A, dA (B, nr, nc)
// of type PT, B1 = cr0 A + cr1 dA, B2 = cc0 A + cc1 dA formed in f32 (PT =
// float) or in bf16 (PT = bf16: the coefficients rounded to bf16, each
// product and the sum rounded, COMBO_BF16), vectors of type VT,
//   row pass: rowpart = B1 Mk   (B, nr, H), Mk (B, nc, H)
//   col pass: colpart = B2^T Mi (B, nc, H), Mi (B, nr, H)
// cvec = (cr0, cr1, cc0, cc1). The grid covers max(nr, nc) owned indices;
// CTAs past their pass's extent exit at once.
template <int HC, typename PT, typename VT>
__global__ void __launch_bounds__(NT) pair_kernel(Sweep g, const float* cvec,
                                                  const VT* Mk, const VT* Mi,
                                                  float* row_out, float* col_out) {
  constexpr int BO = bo_for(1, HC), PPT = (BO * HC + NT - 1) / NT;
  constexpr bool BF = std::is_same<PT, bf16>::value;
  __shared__ Smem<1, 1, BO, HC> sm;
  const int b = blockIdx.z;
  const bool trans = blockIdx.y == 1;
  const int o0 = blockIdx.x * BO;
  const int own = trans ? g.nc : g.nr;
  if (o0 >= own) return;
  g.v[0] = trans ? Mi : Mk;
  float c0 = __ldg(cvec + (trans ? 2 : 0));
  float c1 = __ldg(cvec + (trans ? 3 : 1));
  if (BF) {
    c0 = rbf(c0);
    c1 = rbf(c1);
  }
  float* out = (trans ? col_out : row_out) + (long long)b * own * g.H;
  float acc[1][PPT];
  for (int h0 = 0; h0 < g.H; h0 += HC) {
    const int hc = min(HC, g.H - h0);
    sweep<2, 1, 1, BO, HC, BF ? COMBO_BF16 : COMBO_F32, PT, VT>(g, sm, b, trans, o0, h0,
                                                               hc, c0, c1, acc);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      int a, h;
      if (pair(j, hc, BO, a, h) && o0 + a < own)
        out[(long long)(o0 + a) * g.H + h0 + h] = acc[0][j];
    }
  }
}

// ---- K6b -----------------------------------------------------------------
// The c cotangents of K6a, per element: (<A, Gr Mk^T>, <dA, Gr Mk^T>,
// <A, Mi Gc^T>, <dA, Mi Gc^T>) = sum_i (Gr . A Mk, Gr . dA Mk, Mi . A Gc,
// Mi . dA Gc)[i]. Row pass only, vectors (Mk, Gc) over the nc columns, so
// the rank-H products Gr Mk^T and Mi Gc^T are never formed. Planes of type
// PT and all four vectors of type T (K6b-bf: both bf16, read as the exact
// f32 values of their bf16 entries). part: (B, gridDim.x, 4) per-CTA
// partials.
template <int HC, typename PT, typename T>
__global__ void __launch_bounds__(NT) pair_dw_kernel(Sweep g, const T* Gr, const T* Mi,
                                                     float* part) {
  constexpr int BO = bo_for(4, HC), PPT = (BO * HC + NT - 1) / NT;
  __shared__ Smem<2, 2, BO, HC> sm;
  const int b = blockIdx.z;
  const int o0 = blockIdx.x * BO;
  const T* Grb = Gr + (long long)b * g.nr * g.H;
  const T* Mib = Mi + (long long)b * g.nr * g.H;
  float acc[4][PPT];  // (A Mk, A Gc, dA Mk, dA Gc)
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int h0 = 0; h0 < g.H; h0 += HC) {
    const int hc = min(HC, g.H - h0);
    sweep<2, 2, 2, BO, HC, RAW, PT, T>(g, sm, b, false, o0, h0, hc, 0.f, 0.f, acc);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      int a, h;
      if (!pair(j, hc, BO, a, h) || o0 + a >= g.nr) continue;
      const long long o = (long long)(o0 + a) * g.H + h0 + h;
      const float gr = ldf(Grb, o), mi = ldf(Mib, o);
      dot[0] = fmaf(acc[0][j], gr, dot[0]);
      dot[1] = fmaf(acc[2][j], gr, dot[1]);
      dot[2] = fmaf(acc[1][j], mi, dot[2]);
      dot[3] = fmaf(acc[3][j], mi, dot[3]);
    }
  }
  float* pp = part + ((long long)b * gridDim.x + blockIdx.x) * 4;
  for (int q = 0; q < 4; ++q) {
    const float s = block_sum(dot[q], sm.red);
    if (threadIdx.x == 0) pp[q] = s;
  }
}

// out[b, q] = sum over blocks of part[b, blk, q], in block order.
__global__ void reduce_parts_kernel(const float* part, int nblk, int nq,
                                    float* out) {
  const int b = blockIdx.x, q = threadIdx.x;
  if (q >= nq) return;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += part[((long long)b * nblk + k) * nq + q];
  out[b * nq + q] = s;
}

inline int launch_reduce(const float* part, int B, int nblk, int nq, float* out,
                         cudaStream_t stream) {
  reduce_parts_kernel<<<B, 32, 0, stream>>>(part, nblk, nq, out);
  return (int)cudaGetLastError();
}

inline bool dims_ok(int B, int n, int H) { return B >= 1 && n >= 1 && H >= 1; }
inline bool dims_ok(int B, int nr, int nc, int H) {
  return dims_ok(B, nr, H) && nc >= 1;
}

inline Sweep make_sweep(const void* p0, const void* p1, const void* p2,
                        const void* p3, int nr, int nc, const void* v0,
                        const void* v1, int H) {
  Sweep g;
  g.p[0] = p0;
  g.p[1] = p1;
  g.p[2] = p2;
  g.p[3] = p3;
  g.nr = nr;
  g.nc = nc;
  g.v[0] = v0;
  g.v[1] = v1;
  g.H = H;
  for (int q = 0; q < 4; ++q) g.w[q] = 0.f;
  return g;
}

// Calls f(HC) with the narrowest compiled chunk width that holds H (or the
// widest, 128, which then sweeps H in chunks).
template <class F>
int by_width(int H, F f) {
  if (H <= 8) return f(std::integral_constant<int, 8>());
  if (H <= 32) return f(std::integral_constant<int, 32>());
  return f(std::integral_constant<int, HCMAX>());
}

}  // namespace tl

using namespace tl;

// K3. A, dA: (B, n, n) bf16; M: (B, n, H) bf16; cvec: device (cr0, cr1,
// cc0, cc1) f32; row_out, col_out: (B, n, H) f32.
extern "C" int gncde_tiled_fwd2(const void* A, const void* dA, int n,
                                const float* cvec, const void* M, int B, int H,
                                float* row_out, float* col_out,
                                cudaStream_t stream) {
  if (!dims_ok(B, n, H)) return (int)cudaErrorInvalidValue;
  const Sweep g = make_sweep(A, dA, nullptr, nullptr, n, n, M, nullptr, H);
  return by_width(H, [&](auto hc) {
    constexpr int HC = decltype(hc)::value, BO = bo_for(1, HC);
    fwd2_kernel<HC><<<dim3((n + BO - 1) / BO, 2, B), NT, 0, stream>>>(
        g, cvec, row_out, col_out);
    return (int)cudaGetLastError();
  });
}

// K5c. d, c, b, a: (B, n, n) slabs, f32 (slab_bf16 = 0) or bf16 (1);
// wvec: device (B, 8) f32 = (w_row, w_col) per element; M: (B, n, H) bf16;
// row_out, col_out: (B, n, H) f32.
extern "C" int gncde_tiled_abar(const void* d, const void* c, const void* b,
                                const void* a, int slab_bf16, int n, const float* wvec,
                                const void* M, int B, int H, float* row_out,
                                float* col_out, cudaStream_t stream) {
  if (!dims_ok(B, n, H)) return (int)cudaErrorInvalidValue;
  const Sweep g = make_sweep(d, c, b, a, n, n, M, nullptr, H);
  return by_width(H, [&](auto hc) {
    constexpr int HC = decltype(hc)::value, BO = bo_for(1, HC);
    const dim3 grid((n + BO - 1) / BO, 2, B);
    if (slab_bf16)
      abar_kernel<HC, bf16><<<grid, NT, 0, stream>>>(g, wvec, row_out, col_out);
    else
      abar_kernel<HC, float><<<grid, NT, 0, stream>>>(g, wvec, row_out, col_out);
    return (int)cudaGetLastError();
  });
}

// K4. cvec: device (c_col0, c_col1, c_row0, c_row1) f32; G, M: (B, n, H)
// bf16; part: scratch of at least B * 2 * ceil(n / 16) * 4 floats; dw: (B, 4).
extern "C" int gncde_tiled_bwd2(const void* A, const void* dA, int n,
                                const float* cvec, const void* G, const void* M,
                                int B, int H, float* row_out, float* col_out,
                                float* part, float* dw, cudaStream_t stream) {
  if (!dims_ok(B, n, H)) return (int)cudaErrorInvalidValue;
  const Sweep g = make_sweep(A, dA, nullptr, nullptr, n, n, G, nullptr, H);
  return by_width(H, [&](auto hc) {
    constexpr int HC = decltype(hc)::value, BO = bo_for(2, HC);
    const int nb = (n + BO - 1) / BO;
    bwd2_kernel<HC><<<dim3(nb, 2, B), NT, 0, stream>>>(
        g, cvec, static_cast<const bf16*>(M), row_out, col_out, part);
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : launch_reduce(part, B, 2 * nb, 4, dw, stream);
  });
}

// K5a. A, dA: (B, n, n) bf16; G, M: (B, n, H) bf16; part: at least
// B * ceil(n / 8) * 4 floats; dw: (B, 4) f32.
extern "C" int gncde_tiled_dw2(const void* A, const void* dA, int n, const void* G,
                               const void* M, int B, int H, float* part, float* dw,
                               cudaStream_t stream) {
  if (!dims_ok(B, n, H)) return (int)cudaErrorInvalidValue;
  const Sweep g = make_sweep(A, dA, nullptr, nullptr, n, n, M, G, H);
  return by_width(H, [&](auto hc) {
    constexpr int HC = decltype(hc)::value, BO = bo_for(4, HC);
    const int nb = (n + BO - 1) / BO;
    dw2_kernel<HC><<<dim3(nb, 1, B), NT, 0, stream>>>(g, part);
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : launch_reduce(part, B, nb, 4, dw, stream);
  });
}

// K5b. d, c, b, a: (B, n, n) f32 slabs; G, M: (B, n, H) bf16;
// part: at least B * ceil(n / 4) * 8 floats; dw: (B, 8) f32.
extern "C" int gncde_tiled_dw(const float* d, const float* c, const float* b,
                              const float* a, int n, const void* G, const void* M,
                              int B, int H, float* part, float* dw,
                              cudaStream_t stream) {
  if (!dims_ok(B, n, H)) return (int)cudaErrorInvalidValue;
  const Sweep g = make_sweep(d, c, b, a, n, n, M, G, H);
  return by_width(H, [&](auto hc) {
    constexpr int HC = decltype(hc)::value, BO = bo_for(8, HC);
    const int nb = (n + BO - 1) / BO;
    dw_kernel<HC><<<dim3(nb, 1, B), NT, 0, stream>>>(g, part);
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : launch_reduce(part, B, nb, 8, dw, stream);
  });
}

// K6a and K6a-bf. A, dA: (B, nr, nc), f32 (planes_bf16 = 0) or bf16 (1);
// cvec: device (cr0, cr1, cc0, cc1) f32; Mk: (B, nc, H), Mi: (B, nr, H),
// f32 (vecs_bf16 = 0) or bf16 (1, with bf16 planes only); row_out:
// (B, nr, H) f32; col_out: (B, nc, H) f32.
extern "C" int gncde_pair(const void* A, const void* dA, int nr, int nc,
                          const float* cvec, const void* Mk, const void* Mi, int B,
                          int H, int planes_bf16, int vecs_bf16, float* row_out,
                          float* col_out, cudaStream_t stream) {
  if (!dims_ok(B, nr, nc, H) || (vecs_bf16 && !planes_bf16))
    return (int)cudaErrorInvalidValue;
  const Sweep g = make_sweep(A, dA, nullptr, nullptr, nr, nc, nullptr, nullptr, H);
  const int nmax = nr > nc ? nr : nc;
  return by_width(H, [&](auto hc) {
    constexpr int HC = decltype(hc)::value, BO = bo_for(1, HC);
    const dim3 grid((nmax + BO - 1) / BO, 2, B);
    if (!planes_bf16)
      pair_kernel<HC, float, float><<<grid, NT, 0, stream>>>(
          g, cvec, static_cast<const float*>(Mk), static_cast<const float*>(Mi),
          row_out, col_out);
    else if (!vecs_bf16)
      pair_kernel<HC, bf16, float><<<grid, NT, 0, stream>>>(
          g, cvec, static_cast<const float*>(Mk), static_cast<const float*>(Mi),
          row_out, col_out);
    else
      pair_kernel<HC, bf16, bf16><<<grid, NT, 0, stream>>>(
          g, cvec, static_cast<const bf16*>(Mk), static_cast<const bf16*>(Mi), row_out,
          col_out);
    return (int)cudaGetLastError();
  });
}

// K6b and K6b-bf. A, dA: (B, nr, nc); Gr, Mi: (B, nr, H); Mk, Gc: (B, nc,
// H); all f32 (bf16 = 0) or all bf16 (1); part: at least
// B * ceil(nr / 8) * 4 floats; dw: (B, 4) f32.
extern "C" int gncde_pair_dw(const void* A, const void* dA, int nr, int nc,
                             const void* Gr, const void* Mk, const void* Mi,
                             const void* Gc, int B, int H, int bf16_in, float* part,
                             float* dw, cudaStream_t stream) {
  if (!dims_ok(B, nr, nc, H)) return (int)cudaErrorInvalidValue;
  const Sweep g = make_sweep(A, dA, nullptr, nullptr, nr, nc, Mk, Gc, H);
  return by_width(H, [&](auto hc) {
    constexpr int HC = decltype(hc)::value, BO = bo_for(4, HC);
    const int nb = (nr + BO - 1) / BO;
    if (bf16_in)
      pair_dw_kernel<HC, bf16, bf16><<<dim3(nb, 1, B), NT, 0, stream>>>(
          g, static_cast<const bf16*>(Gr), static_cast<const bf16*>(Mi), part);
    else
      pair_dw_kernel<HC, float, float><<<dim3(nb, 1, B), NT, 0, stream>>>(
          g, static_cast<const float*>(Gr), static_cast<const float*>(Mi), part);
    const int err = (int)cudaGetLastError();
    return err != 0 ? err : launch_reduce(part, B, nb, 4, dw, stream);
  });
}
