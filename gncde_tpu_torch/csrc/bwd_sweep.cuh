// K2's reverse sweep (K2 and K2d: bwd_sweep_kernel<DIR, CC, PROBE>; K2bf
// and K2dbf: bwd_sweep_bf_kernel<DIR, PROBE>; each with bwd_finish_kernel,
// then bwd_reduce_kernel), on a launch plan of its own per layer
// (ops/megakernel_bwd.py bwd_row_plan). The f32 instantiation computes what
// _make_bwd_kernel computes, in another summation order: for layer l with
// input x (n x hin), M = Linear(RMSNorm(x)) (n x H) and the output cotangent
// g (n x H),
//
//   dM = C^T g + dvec g + 1 (u^T g) + (v + c7) (1^T g)          (the dM rows)
//   <A|dA|ddA, g M^T>, <A|dA|ddA, M g^T>                     (basis dots)
//   dz = dM W -> RMSNorm backward -> g_prev (masked for l > 0)
//   dW = dM^T zn, dlin_b = 1^T dM, dnorm, the rank terms' row dots, dtau.
//
// The plan: grid (ceil(n / bm), groups, B); a CTA owns bm rows (16, 8 or 4)
// and one group of cw = 512 CC / bm output columns (32, 64 or 128).
//  * It forms its bm rows of C^T and of A, dA (ddA for dtau) at (i, k) and
//    at (k, i) over all n columns once, into dynamic shared memory (a sweep
//    of row tiles would regenerate them from the planes for every 64-column
//    chunk: 8 times a layer at the trade's 512-wide layer).
//  * M's and g's tiles of KT = 32 rows and the group's columns come through
//    a ring of three stages, two tiles ahead (16-byte cp.async; 4-byte where
//    a row is not 16-byte aligned). The column sums s = 1^T M, gcol = 1^T g
//    and u^T g are taken from the same tiles as they pass, once a layer.
//  * Two products per tile, on register tiles: C^T g (each thread 2 rows x
//    CC columns, as rows_kernel's C M; for a group of up to 32 columns each
//    warp 4 of the tile's rows, its parts summed after the sweep), and P =
//    g M^T for the CTA's rows and
//    the tile's 32 rows (each thread 2 rows x 4 k over a slice of the
//    group's columns, the slices summed by shuffles). The basis dots are
//    <A, P>, <dA, P>, <A^T, P>, <dA^T, P> (and ddA's) of the CTA's rows: two
//    products where row dots take five (seven), A M, dA M, A g, dA g (ddA
//    M, ddA g) beside C^T g.
//  * Where a layer spans several groups, each CTA writes its rows' partial
//    dz and row dots and its partial basis dots; bwd_finish_kernel sums them
//    in group order and finishes the rows (RMSNorm backward, g_prev, dnorm,
//    the rank-term dots). A one-group layer finishes in the sweep CTA. dW
//    and dlin_b rows stay local to their group.
//  * Per-CTA partial blocks per layer, (B, ceil(n / bm), ptot_l), summed over
//    the row blocks by bwd_reduce_kernel in a fixed order: no atomics, so two
//    launches are bitwise equal.
// What bounds it: the f32 FMA products, 2 x 2 n^2 H per element and layer
// against 32 n^2 bytes of planes per group read mostly from L2; in practice
// each CTA's serial chain (forming, ring, products), as in rows_kernel.
//
// The bf16 instantiation (BF, megakernel_bwd_bf.cu) computes what
// _make_bwd_kernel(bf16=True) computes (ops/megakernel_bwd.py
// plain_vf_bwd_bf16), on the same plan and the same shared code:
//  * the planes are bf16 and A(t), dA(t) (ddA) are evaluated from them in f32
//    with every product and sum rounded once (megakernel_common.cuh herm3);
//    the basis dots take these f32 values;
//  * C^T = ((b1_0 Ah^T + b1_1 dAh^T) + b2_0 Ah) + b2_1 dAh is formed in bf16
//    in that order (the coefficients and each product and sum rounded) and
//    kept as bf16 (its rows take half the f32 sweep's bytes);
//  * M's and g's tiles still arrive as f32 (the column sums and the dM rows'
//    rank terms are f32) and are rounded to bf16 once as they land, as are
//    the CTA's rows of g;
//  * both products run as bf16 mma.sync m16n8k16 with f32 accumulation
//    (products of bf16 values are exact in f32): C^T gb as (gb^T C)^T, its
//    16-column blocks of the group by 8-row blocks of the CTA's rows, each
//    block one warp's over the whole reduce extent; P = Mb gb^T, the tile's
//    32 rows by the CTA's rows, each tile's P dotted with the row operands
//    at once (never stored).
// Everything else is the f32 sweep's code. What bounds it: each CTA's
// serial chain (forming, ring, conversion); its products are a few
// mma.sync a warp per tile.
//
// The ablation (tools/kernel_times_torch.py K2-ablation and K2bf-ablation;
// csrc/bwd_probe.cu gncde_mk_bwd_probe, csrc/bwd_bf_probe.cu
// gncde_mk_bwd_bf16_probe): PROBE bits, 0 on every launch of the main path.
#pragma once

#include "megakernel_common.cuh"

namespace mk {

enum BwdProbe {
  BP_NO_PLANES = 1,   // form the row operands from their indices, no plane reads
  BP_NO_FORM = 2,     // no forming of the row operands at all
  BP_NO_PRODUCT = 4,  // no C^T g and no P products (BF: nor the tiles' rounding)
  BP_NO_RING = 8,     // no copies of M's and g's tiles
  BP_NO_COLSUM = 16   // no column sums
};

constexpr int BSTAGES = 3;              // ring stages
constexpr int BWD_SMEM_MAX = 204800;    // dynamic shared memory a plan may take
constexpr int BWD_LMAX = 16;            // most layers of one K2 call

// Row operands a CTA forms: C^T, A, dA at (i, k) and (k, i), and ddA at
// both for dtau (tau).
__host__ __device__ constexpr int bwd_nrow(bool tau) { return tau ? 7 : 5; }
// Row stride of the CTA's g rows: the ring width plus 64 / bm floats, so the
// P product's lane groups (one a row pair) fall on other banks.
__host__ __device__ constexpr int bwd_gstride(int rw, int bm) { return rw + 64 / bm; }
// Dynamic shared memory of one sweep CTA, in floats: u over n, the row
// operands (bm x (npad + 4) each), the CTA's g rows, and the ring of M and
// g tiles (whose space C^T g's parts, NW bm rw at most, and the dM rows reuse
// after the products: 9 bm rw <= 144 rw < 2 BSTAGES RKT rw).
__host__ __device__ constexpr int bwd_smem_floats(int n, int bm, int rw, bool tau) {
  return rows_npad(n) + bwd_nrow(tau) * bm * (rows_npad(n) + 4) + bm * bwd_gstride(rw, bm) +
         BSTAGES * 2 * RKT * rw;
}
// The bf16 sweep's bf16 tiles: megakernel_common.cuh mma_hw and mma_rows.
// Dynamic shared memory of one bf16 sweep CTA, in bytes: the f32 sweep's
// minus its f32 C^T rows, then C^T's rows in bf16 (npad + 8 halves), the
// CTA's rows of gb, and the bf16 M and g tiles of the current ring tile.
__host__ __device__ constexpr int bwd_smem_bytes_bf(int n, int bm, int rw, bool tau) {
  return 4 * (bwd_smem_floats(n, bm, rw, tau) - bm * (rows_npad(n) + 4)) +
         2 * (mma_rows(bm) * (rows_npad(n) + 8) +
              (mma_rows(bm) + 2 * RKT) * (mma_hw(rw) + 8));
}

// One layer's sweep arguments (BF: bf16 planes). part: the layer's partial blocks, (B, nrb,
// ptot) with nrb = ceil(n / bm), each [dnorm_w (hin) | dnorm_b (hin) | dW
// (H hin) | dlin_b (H) | dbasis (2 nbasis) | dtau]; work (groups > 1): the
// groups' partial rows (B, groups, n, hin + 3) [dz | g.m, g.s, m.gcol], then
// their partial sums (B, nrb, groups, 8) [<A,P>, <dA,P>, <A^T,P>, <dA^T,P>,
// <ddA,P>, <ddA^T,P>, gcol.s, 0].
template <bool BF>
struct BwdArgsT {
  Planes<BF> P;
  const int* idx;
  const float* tau;
  const float* stats;
  Layer lp;
  const float* X;
  const float* Mc;
  const float* G;
  float* Gp;
  float* part;
  float* work;
  int n, ldx, ldm, ldg, ldgp, mask_prev, ptot, bm, groups, vec;
  int tau_on;  // dtau wanted: ddA's operands and dots (a runtime flag: one build for both)
  int cc;      // the plan's cc (BF: the group's width 512 cc / bm; f32: the template's CC)
};
using BwdArgs = BwdArgsT<false>;

// Statically allocated shared memory of the sweep and the finish.
struct BwdShared {
  float colS[128], colG[128], colU[128];
  float red[3][NT];
  float scratch[NW];
  float zn[BM][MAXIN];
  float dz[BM][MAXIN];
  float inv[BM];
  float rowd[BM][3];  // per row: g . m, g . s, m . gcol
  float dvv[BM][2];   // per row: dvec, v
  float wred[NW][14];
};

// The element's global sums sA, sdA (sddA for dtau) and its layer's basis
// q; the CTA's rows' 1 / rms and normalised inputs zn. Every thread.
template <bool DIR, bool BF>
__device__ __forceinline__ void bwd_rows_prologue(const BwdArgsT<BF>& a, BwdShared& sh, int b,
                                                  int r0, float* q, float& sA, float& sdA,
                                                  float& sddA) {
  const bool need_dd = a.tau_on;
  const int n = a.n, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* st = a.stats + (long long)b * NSTAT * n;
  constexpr int NQ = 2 * nbasis<DIR>();
#pragma unroll
  for (int k = 0; k < NQ; ++k) q[k] = __ldg(a.lp.basis + k);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int k = tid; k < n; k += NT) {
    a0 += st[RA * n + k];
    a1 += st[RDA * n + k];
    if (need_dd) a2 += st[RDDA * n + k];
  }
  sA = block_sum(a0, sh.scratch);
  sdA = block_sum(a1, sh.scratch);
  sddA = need_dd ? block_sum(a2, sh.scratch) : 0.f;
  const int hin = a.lp.hin;
  for (int i = warp; i < a.bm; i += NW) {
    const int gi = r0 + i;
    if (gi >= n) {
      for (int j = lane; j < MAXIN; j += 32) sh.zn[i][j] = 0.f;
      if (lane == 0) sh.inv[i] = 0.f;
      continue;
    }
    const float* x = a.X + ((long long)b * n + gi) * a.ldx;
    float ss = 0.f;
    for (int j = lane; j < hin; j += 32) ss += x[j] * x[j];
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / (float)hin + EPS);
    for (int j = lane; j < hin; j += 32)
      sh.zn[i][j] = x[j] * inv * __ldg(a.lp.nw + j) + __ldg(a.lp.nb + j);
    if (lane == 0) sh.inv[i] = inv;
  }
}

// The rows' finish, once dz = dM W (sh.dz), the row dots (sh.rowd), the
// basis dots tp[0 .. 5] and gcol . s (dc7) are whole: the rank-term dots,
// the RMSNorm backward and g_prev, and the row block's partial block's
// dnorm and dbasis / dtau entries (dW, dlin_b are the sweep's). The
// expressions of _make_bwd_kernel's tail (megakernel_bwd.py:249-302 for the
// directed rank terms and dtau). Every thread.
template <bool DIR, bool BF>
__device__ __forceinline__ void bwd_finish_rows(const BwdArgsT<BF>& a, BwdShared& sh, int b, int rb,
                                                const float* q, float sA, float sdA,
                                                float sddA, const float* tp, float dc7) {
  const bool need_dd = a.tau_on;
  constexpr int NWR = DIR ? 14 : 10;
  const int n = a.n, bm = a.bm, r0 = rb * bm, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int H = a.lp.hout, hin = a.lp.hin;
  const float fn = (float)n, fn2 = fn * fn;
  const float* st = a.stats + (long long)b * NSTAT * n;
  const float* rA = st + RA * n;
  const float* rdA = st + RDA * n;
  float* pout = a.part + ((long long)b * ((n + bm - 1) / bm) + rb) * a.ptot;
  const int rend = min(bm, n - r0);
  float w[NWR];
#pragma unroll
  for (int k = 0; k < NWR; ++k) w[k] = 0.f;
  for (int i = warp; i < bm; i += NW) {
    const int gi = r0 + i;
    if (gi >= n) continue;
    const float gm = sh.rowd[i][0], du = sh.rowd[i][1], dv = sh.rowd[i][2];
    const float rAi = rA[gi], rdAi = rdA[gi];
    const float dgA = st[DGA * n + gi], dgdA = st[DGDA * n + gi];
    if constexpr (DIR) {
      const float cAi = st[CA * n + gi], cdAi = st[CDA * n + gi];
      w[0] += gm;
      w[1] += gm * dgA;
      w[2] += gm * dgdA;
      w[3] += du * cAi;
      w[4] += du * cdAi;
      w[5] += dv * rAi;
      w[6] += dv * cdAi;
      w[7] += dv * cAi;
      w[8] += dv * rdAi;
      w[9] += gm * cAi;
      w[10] += gm * cdAi;
      w[11] += gm * rAi;
      w[12] += gm * rdAi;
      if (need_dd) {
        const float rddAi = st[RDDA * n + gi], dgddA = st[DGDDA * n + gi];
        const float cddAi = st[CDDA * n + gi];
        const float ddvec = q[4] * dgdA + q[5] * dgddA + (q[14] * cdAi + q[15] * cddAi) / fn +
                            (q[16] * rdAi + q[17] * rddAi) / fn +
                            (q[20] * sdA + q[21] * sddA) / fn2;
        const float du_dt = (q[6] * cdAi + q[7] * cddAi) / fn;
        const float dv_dt = (q[8] * rdAi + q[9] * cddAi + q[10] * cdAi + q[11] * cddAi +
                             q[12] * rdAi + q[13] * rddAi) / fn;
        w[13] += gm * ddvec + du * du_dt + dv * dv_dt;
      }
    } else {
      w[0] += gm;
      w[1] += gm * dgA;
      w[2] += gm * dgdA;
      w[3] += du * rAi;
      w[4] += du * rdAi;
      w[5] += dv * rAi;
      w[6] += dv * rdAi;
      w[7] += gm * rAi;
      w[8] += gm * rdAi;
      if (need_dd) {
        const float rddAi = st[RDDA * n + gi], dgddA = st[DGDDA * n + gi];
        const float ddvec = q[4] * dgdA + q[5] * dgddA +
                            (q[10] * rdAi + q[11] * rddAi) / fn +
                            (q[14] * sdA + q[15] * sddA) / fn2;
        const float du_dt = (q[6] * rdAi + q[7] * rddAi) / fn;
        const float dv_dt = (q[8] * rdAi + q[9] * rddAi) / fn;
        w[9] += gm * ddvec + du * du_dt + dv * dv_dt;
      }
    }

    // RMSNorm backward: g_prev = (dz nw) inv - x inv^3 / hin (dz nw . x).
    const float* x = a.X + ((long long)b * n + gi) * a.ldx;
    const float inv = sh.inv[i];
    float hx = 0.f;
    for (int j = lane; j < hin; j += 32) hx += sh.dz[i][j] * __ldg(a.lp.nw + j) * x[j];
    hx = warp_sum(hx);
    const float k3 = inv * inv * inv / (float)hin;
    for (int j = lane; j < hin; j += 32) {
      const float xj = x[j];
      float gp = sh.dz[i][j] * __ldg(a.lp.nw + j) * inv - xj * k3 * hx;
      if (a.mask_prev && !(xj > 0.f)) gp = 0.f;
      a.Gp[((long long)b * n + gi) * a.ldgp + j] = gp;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NWR; ++k) sh.wred[warp][k] = w[k];
  }
  __syncthreads();

  for (int j = tid; j < hin; j += NT) {
    float dw = 0.f, db = 0.f;
    for (int i = 0; i < rend; ++i) {
      const float xj = a.X[((long long)b * n + r0 + i) * a.ldx + j];
      dw += sh.dz[i][j] * xj * sh.inv[i];
      db += sh.dz[i][j];
    }
    pout[j] = dw;
    pout[hin + j] = db;
  }
  if (tid == 0) {
    float tot[NWR];
    for (int k = 0; k < NWR; ++k) {
      tot[k] = 0.f;
      for (int ww = 0; ww < NW; ++ww) tot[k] += sh.wred[ww][k];
    }
    const bool first = rb == 0;
    float* db = pout + 2 * hin + H * hin + H;
    db[0] = tp[0];
    db[1] = tp[1];
    db[2] = tp[2];
    db[3] = tp[3];
    db[4] = tot[1];
    db[5] = tot[2];
    float dtau = 0.f;
    if constexpr (DIR) {
      db[6] = tot[3] / fn;
      db[7] = tot[4] / fn;
      db[8] = tot[5] / fn;
      db[9] = tot[6] / fn;
      db[10] = tot[7] / fn;
      db[11] = tot[6] / fn;
      db[12] = tot[5] / fn;
      db[13] = tot[8] / fn;
      db[14] = tot[9] / fn;
      db[15] = tot[10] / fn;
      db[16] = tot[11] / fn;
      db[17] = tot[12] / fn;
      const float p7 = first ? dc7 * sA / fn2 : 0.f;
      db[18] = p7;
      db[19] = p7;
      db[20] = tot[0] * sA / fn2;
      db[21] = tot[0] * sdA / fn2;
      if (need_dd) {
        dtau = (1.f + q[0]) * tp[1] + (1.f + q[1]) * tp[4] + q[2] * tp[3] + q[3] * tp[5] +
               tot[13];
        if (first) dtau += dc7 * (q[18] + q[19]) * sdA / fn2;
      }
      db[22] = dtau;
    } else {
      db[6] = tot[3] / fn;
      db[7] = tot[4] / fn;
      db[8] = tot[5] / fn;
      db[9] = tot[6] / fn;
      db[10] = tot[7] / fn;
      db[11] = tot[8] / fn;
      const float p7 = first ? dc7 * sA / fn2 : 0.f;
      db[12] = p7;
      db[13] = p7;
      db[14] = tot[0] * sA / fn2;
      db[15] = tot[0] * sdA / fn2;
      if (need_dd) {
        dtau = (1.f + q[0]) * tp[1] + (1.f + q[1]) * tp[4] + q[2] * tp[3] + q[3] * tp[5] +
               tot[9];
        if (first) dtau += dc7 * (q[12] + q[13]) * sdA / fn2;
      }
      db[16] = dtau;
    }
  }
}

// One sweep CTA: rows blockIdx.x bm .., column group blockIdx.y, element
// blockIdx.z; dyn the plan's dynamic shared memory. BF: the bf16 sweep
// (its plan's width from a.cc; CC unused).
template <bool DIR, int CC, int PROBE, bool BF>
__device__ __forceinline__ void bwd_sweep_body(const BwdArgsT<BF>& a, float* __restrict__ dyn,
                                               BwdShared& sh) {
  const bool need_dd = a.tau_on;
  const int b = blockIdx.z, rb = blockIdx.x, gr = blockIdx.y;
  const int n = a.n, bm = a.bm, r0 = rb * bm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = a.lp.hout, hin = a.lp.hin;
  const int cw = 512 * (BF ? a.cc : CC) / bm, g0 = gr * cw, wg = min(cw, H - g0);  // the group's columns
  const int rw = rows_width(cw, H), gs = bwd_gstride(rw, bm);
  const int npad = rows_npad(n), ldc = npad + 4;
  const long long base = plane_base(a.P, a.idx, b, n);
  const float t = __ldg(a.tau + b);
  const float fn = (float)n, fn2 = fn * fn;
  const float* st = a.stats + (long long)b * NSTAT * n;
  const float* Mb = a.Mc + (long long)b * n * a.ldm;
  const float* Gb = a.G + (long long)b * n * a.ldg;
  float* uvec = dyn;                            // [npad] u
  float* Ct = uvec + npad;                      // [bm][ldc] C^T[i, k] (f32 only)
  float* Ar = Ct + (BF ? 0 : bm * ldc);         // A[i, k]
  float* dAr = Ar + bm * ldc;                   // dA[i, k]
  float* Ac = dAr + bm * ldc;                   // A[k, i]
  float* dAc = Ac + bm * ldc;                   // dA[k, i]
  float* ddAr = dAc + bm * ldc;                 // dtau: ddA[i, k]
  float* ddAc = ddAr + (need_dd ? bm * ldc : 0);    // dtau: ddA[k, i]
  float* grow = ddAc + (need_dd ? bm * ldc : 0);    // [bm][gs] g[r0 + i, g0 + c]
  float* ring = grow + bm * gs;                 // [BSTAGES][2][RKT][rw]: M, g tiles
  // BF: C^T's rows [nbr][ldcb], the rows of gb [nbr][hwp], and the current
  // tile's Mb and gb [RKT][hwp], bf16 bit patterns.
  const int nbr = mma_rows(bm), ldcb = npad + 8, hw = mma_hw(rw), hwp = hw + 8;
  unsigned short* Ctb = reinterpret_cast<unsigned short*>(ring + BSTAGES * 2 * RKT * rw);
  unsigned short* growb = Ctb + nbr * ldcb;
  unsigned short* Mtb = growb + nbr * hwp;
  unsigned short* gtb = Mtb + RKT * hwp;
  constexpr bool ring_on = !(PROBE & BP_NO_RING);

  // Tile t of M and g: rows t RKT .., the group's columns, into stage t %
  // BSTAGES.
  auto fetch = [&](int tile) {
    float* TM = ring + (tile % BSTAGES) * 2 * RKT * rw;
    const int k0 = tile * RKT;
    if (a.vec) {
      const int gpr = rw / 4, per = RKT * gpr;
      for (int e = tid; e < 2 * per; e += NT) {
        const int wh = e >= per, e2 = e - wh * per, kk = e2 / gpr, c = 4 * (e2 - kk * gpr);
        const int k = k0 + kk;
        const int nbytes = (k < n && c < wg) ? 4 * min(4, wg - c) : 0;
        const float* src = wh ? Gb + (long long)k * a.ldg + g0 + c
                              : Mb + (long long)k * a.ldm + g0 + c;
        cp_async16(TM + wh * RKT * rw + kk * rw + c, nbytes ? src : a.Mc, nbytes);
      }
    } else {
      const int per = RKT * rw;
      for (int e = tid; e < 2 * per; e += NT) {
        const int wh = e >= per, e2 = e - wh * per, kk = e2 / rw, c = e2 - kk * rw;
        const int k = k0 + kk;
        const bool ok = k < n && c < wg;
        const float* src = wh ? Gb + (long long)k * a.ldg + g0 + c
                              : Mb + (long long)k * a.ldm + g0 + c;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         smem_u32(TM + wh * RKT * rw + kk * rw + c)),
                     "l"(ok ? src : a.Mc), "r"(ok ? 4 : 0));
      }
    }
  };
  const int ntiles = npad / RKT;
  if (ring_on) fetch(0);
  cp_commit();
  if (ntiles > 1 && ring_on) fetch(1);
  cp_commit();

  constexpr int NQ = 2 * nbasis<DIR>();
  float q[NQ];
  float sA, sdA, sddA;
  bwd_rows_prologue<DIR>(a, sh, b, r0, q, sA, sdA, sddA);
  const float b10 = 1.f + q[0], b11 = 1.f + q[1], b20 = q[2], b21 = q[3];
  float c7, c8;
  if constexpr (DIR) {
    c7 = (q[18] + q[19]) * sA / fn2;
    c8 = (q[20] * sA + q[21] * sdA) / fn2;
  } else {
    c7 = (q[12] + q[13]) * sA / fn2;
    c8 = (q[14] * sA + q[15] * sdA) / fn2;
  }
  for (int k = tid; k < npad; k += NT) {
    float u = 0.f;
    if (k < n) {
      if constexpr (DIR)
        u = dir_u(q, st, n, k, fn);
      else
        u = (q[6] * st[RA * n + k] + q[7] * st[RDA * n + k]) / fn;
    }
    uvec[k] = u;
  }
  // The rows' dvec and v (the dM epilogue's), once.
  for (int i = tid; i < bm; i += NT) {
    const int gi = r0 + i;
    float dvec = 0.f, v = 0.f;
    if (gi < n) {
      if constexpr (DIR) {
        dvec = dir_dvec(q, st, n, gi, fn, c8);
        v = dir_v(q, st, n, gi, fn);
      } else {
        dvec = q[4] * st[DGA * n + gi] + q[5] * st[DGDA * n + gi] +
               (q[10] * st[RA * n + gi] + q[11] * st[RDA * n + gi]) / fn + c8 + 1.f;
        v = (q[8] * st[RA * n + gi] + q[9] * st[RDA * n + gi]) / fn;
      }
    }
    sh.dvv[i][0] = dvec;
    sh.dvv[i][1] = v;
  }
  // The CTA's rows of g over the group's columns (zero past n and wg).
  for (int e = tid; e < bm * gs; e += NT) {
    const int i = e / gs, c = e - i * gs, gi = r0 + i;
    grow[e] = (gi < n && c < wg) ? Gb[(long long)gi * a.ldg + g0 + c] : 0.f;
  }
  if constexpr (BF) {  // gb's rows, and C^T's rows past bm, zero past their extents
    for (int e = tid; e < nbr * hwp; e += NT) {
      const int i = e / hwp, c = e - i * hwp, gi = r0 + i;
      growb[e] = (i < bm && gi < n && c < wg) ? bf16_bits(Gb[(long long)gi * a.ldg + g0 + c])
                                              : (unsigned short)0;
    }
    for (int e = bm * ldcb + tid; e < nbr * ldcb; e += NT) Ctb[e] = 0;
  }

  // The row operands, once: at (i, k) from plane row r0 + i (coalesced
  // along k), then at (k, i) from plane column r0 + i (coalesced along i),
  // C^T = b2_0 A[i, k] + b2_1 dA[i, k] + b1_0 A[k, i] + b1_1 dA[k, i] (BF:
  // formed in pass 1 from both, in bf16 in _make_bwd_kernel's order). Each
  // thread loads RU elements' four plane values before it evaluates any
  // (32 loads in flight: the pass is bound by their latency). Zero past n,
  // so the products need no masks.
  constexpr bool form = !(PROBE & BP_NO_FORM), planes = !(PROBE & BP_NO_PLANES);
  const float cb0 = rbf(b10), cb1 = rbf(b11), cb2 = rbf(b20), cb3 = rbf(b21);  // BF
  for (int pass = 0; pass < 2 && form; ++pass) {
    for (int e0 = tid; e0 < bm * npad; e0 += NT * RU) {
      float pd[RU], pc[RU], pb[RU], pa[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int e = e0 + u * NT;
        int i, k;
        if (pass == 0) {
          i = e / npad;
          k = e - i * npad;
        } else {
          k = e / bm;
          i = e - k * bm;
        }
        const int gi = r0 + i;
        const bool ok = e < bm * npad && gi < n && k < n;
        const long long off =
            pass == 0 ? base + (long long)gi * n + k : base + (long long)k * n + gi;
        pd[u] = ok && planes ? ldp(a.P.d + off) : 1e-3f * e;
        pc[u] = ok && planes ? ldp(a.P.c + off) : 0.f;
        pb[u] = ok && planes ? ldp(a.P.b + off) : 0.f;
        pa[u] = ok && planes ? ldp(a.P.a + off) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int e = e0 + u * NT;
        if (e >= bm * npad) continue;
        int i, k;
        if (pass == 0) {
          i = e / npad;
          k = e - i * npad;
        } else {
          k = e / bm;
          i = e - k * bm;
        }
        float A = 0.f, dA = 0.f, ddA = 0.f;
        if (r0 + i < n && k < n) {
          const float tt = t;
          if constexpr (BF) {  // each product and sum rounded once (herm3)
            const float d = pd[u], c = pc[u];
            A = __fadd_rn(
                __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(d, tt), c), tt), pb[u]), tt),
                pa[u]);
            dA = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(3.0f, d), tt),
                                               __fmul_rn(2.0f, c)), tt), pb[u]);
            if (need_dd) ddA = __fadd_rn(__fmul_rn(__fmul_rn(6.0f, d), tt), __fmul_rn(2.0f, c));
          } else {
            A = ((pd[u] * tt + pc[u]) * tt + pb[u]) * tt + pa[u];
            dA = (3.0f * pd[u] * tt + 2.0f * pc[u]) * tt + pb[u];
            if (need_dd) ddA = 6.0f * pd[u] * tt + 2.0f * pc[u];
          }
        }
        const int o = i * ldc + k;
        if (pass == 0) {
          Ar[o] = A;
          dAr[o] = dA;
          if (need_dd) ddAr[o] = ddA;
          if constexpr (!BF) Ct[o] = b20 * A + b21 * dA;
        } else {
          Ac[o] = A;
          dAc[o] = dA;
          if (need_dd) ddAc[o] = ddA;
          if constexpr (BF) {
            float v = rbf(__fadd_rn(bmul(cb0, A), bmul(cb1, dA)));
            v = rbf(__fadd_rn(v, bmul(cb2, Ar[o])));
            Ctb[i * ldcb + k] = bf16_bits(__fadd_rn(v, bmul(cb3, dAr[o])));
          } else {
            Ct[o] += b10 * A + b11 * dA;
          }
        }
      }
    }
    __syncthreads();  // pass 1 adds to what pass 0 wrote
  }

  // Column sums: thread (h, sl) = (tid % rw, tid / rw) sums rows k = sl, sl
  // + nsl, ... (nsl = NT / rw) in order; the slices are summed in order.
  const int nsl = NT / rw, hcol = tid % rw, slc = tid / rw;
  int knext = slc < nsl ? slc : npad;
  float s_ = 0.f, g_ = 0.f, u_ = 0.f;

  // Product 1, C^T g. A group of up to 32 columns (narrow): warp w takes
  // the tile's rows 4 w .. 4 w + 3, like P below, and its lanes the (row,
  // column) pairs: column h = lane % lw (lw the power of 2 at or above wg),
  // rows lane / lw + (32 / lw) m below bm; the warps' parts are summed in
  // warp order after the sweep, so each output is the sum of eight chains
  // of n / 8 terms, not one of n (phase 17's K11d backward at the bench
  // shape: 3.7e-4 of its scale against 1.4e-3). Wider (wide): each thread
  // owns rows rg, rg + bm / 2 and columns cb .. cb + CC - 1 over every k.
  const bool narrow = !BF && wg <= 32;
  int lw = 1;
  while (lw < wg) lw <<= 1;
  const int nh = lane % lw, nr0 = lane / lw, nrs = 32 / lw;
  float nacc[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) nacc[m] = 0.f;
  const int rgw = bm / 2, cgw = 32 / rgw;
  const int rg = lane / cgw, cb = (warp * cgw + lane % cgw) * CC;
  float acc[2][CC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;
  const float* C0 = Ct + rg * ldc;
  const float* C1 = Ct + (rg + rgw) * ldc;
  // Product 2, P = g M^T: warp w takes the tile's rows 4 w .. 4 w + 3; its
  // lane groups of hs = 64 / bm lanes each take a row pair (rp, rp + bm / 2)
  // and the group's columns h = hl, hl + hs, ...
  const int hs = 64 / bm, rp = lane / hs, hl = lane % hs;
  const float* gA = grow + rp * gs;
  const float* gB = grow + (rp + rgw) * gs;
  float tp[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // BF: C^T g's blocks, (16 columns of the group) x (8 of the CTA's rows),
  // nb1 of them, block j on warp j % NW (two a warp at most); P's blocks,
  // (16 of the tile's rows) x (8 of the CTA's rows), block j on warp NW - 1
  // - j.
  const int nnb = (bm + 7) / 8, nb1 = hw / 16 * nnb;
  float acc1[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_wait1();
    __syncthreads();  // tile's stage landed; the operands complete (first tile)
    if (tile + 2 < ntiles && ring_on) fetch(tile + 2);
    cp_commit();
    const float* TM = ring + (tile % BSTAGES) * 2 * RKT * rw;
    const float* TG = TM + RKT * rw;
    const int k0 = tile * RKT, kend = min(k0 + RKT, n);
    for (; knext < kend && !(PROBE & BP_NO_COLSUM); knext += nsl) {
      const float m = TM[(knext - k0) * rw + hcol], g = TG[(knext - k0) * rw + hcol];
      s_ += m;
      g_ += g;
      u_ += uvec[knext] * g;
    }
    if constexpr ((PROBE & BP_NO_PRODUCT) != 0) {
    } else if constexpr (BF) {
      // The tile's M and g rounded to bf16 once (columns past rw zero).
      const int hp2 = hw / 2;
      for (int e = tid; e < 2 * RKT * hp2; e += NT) {
        const int wh = e >= RKT * hp2, e2 = e - wh * RKT * hp2, kk = e2 / hp2;
        const int c = 2 * (e2 - kk * hp2);
        const float* src = (wh ? TG : TM) + kk * rw + c;
        *reinterpret_cast<__nv_bfloat162*>((wh ? gtb : Mtb) + kk * hwp + c) =
            __floats2bfloat162_rn(c < rw ? src[0] : 0.f, c + 1 < rw ? src[1] : 0.f);
      }
      __syncthreads();
      const int m = lane >> 3, r = lane & 7, gid = lane >> 2, q4 = lane & 3;
      // C^T g += (gb^T C)^T over the tile's 32 rows: A = gb^T (the tile,
      // transposed by ldmatrix), B = C^T's rows ([n][k] as stored).
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = warp + jj * NW;
        if (j >= nb1) break;
        const int mb = j / nnb, nb = j - mb * nnb;
#pragma unroll
        for (int ks = 0; ks < RKT; ks += 16) {
          uint32_t a0, a1, a2, a3, b0, b1;
          ldsm_x4_t(a0, a1, a2, a3, gtb + (ks + (m >> 1) * 8 + r) * hwp + mb * 16 + (m & 1) * 8);
          ldsm_x2(b0, b1, Ctb + (nb * 8 + r) * ldcb + k0 + ks + (m & 1) * 8);
          mma_bf16(acc1[jj], a0, a1, a2, a3, b0, b1);
        }
      }
      // P = Mb gb^T for the tile's rows (A = Mb, B = gb's rows), then its
      // inner products with the row operands: entry f is tile row mb 16 +
      // gid + 8 (f >> 1), CTA row nb 8 + 2 q4 + (f & 1).
      const int j2 = NW - 1 - warp;
      if (j2 < 2 * nnb) {
        const int mb = j2 / nnb, nb = j2 - mb * nnb;
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        for (int hs = 0; hs < hw; hs += 16) {
          uint32_t a0, a1, a2, a3, b0, b1;
          ldsm_x4(a0, a1, a2, a3, Mtb + (mb * 16 + (m & 1) * 8 + r) * hwp + hs + (m >> 1) * 8);
          ldsm_x2(b0, b1, growb + (nb * 8 + r) * hwp + hs + (m & 1) * 8);
          mma_bf16(pv, a0, a1, a2, a3, b0, b1);
        }
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int i = nb * 8 + 2 * q4 + (f & 1);
          if (i >= bm) continue;
          const int o = i * ldc + k0 + mb * 16 + gid + 8 * (f >> 1);
          tp[0] = fmaf(Ar[o], pv[f], tp[0]);
          tp[1] = fmaf(dAr[o], pv[f], tp[1]);
          tp[2] = fmaf(Ac[o], pv[f], tp[2]);
          tp[3] = fmaf(dAc[o], pv[f], tp[3]);
          if (need_dd) {
            tp[4] = fmaf(ddAr[o], pv[f], tp[4]);
            tp[5] = fmaf(ddAc[o], pv[f], tp[5]);
          }
        }
      }
    } else {
      if (narrow) {
        if (nh < wg) {
          const int kq = k0 + 4 * warp;
          float gk[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) gk[j] = TG[(4 * warp + j) * rw + nh];
#pragma unroll
          for (int m = 0; m < 16; ++m) {
            if (nr0 + nrs * m >= bm) break;
            const float4 c = *reinterpret_cast<const float4*>(Ct + (nr0 + nrs * m) * ldc + kq);
            nacc[m] = fmaf(c.x, gk[0], nacc[m]);
            nacc[m] = fmaf(c.y, gk[1], nacc[m]);
            nacc[m] = fmaf(c.z, gk[2], nacc[m]);
            nacc[m] = fmaf(c.w, gk[3], nacc[m]);
          }
        }
      } else if (cb < wg) {
#pragma unroll
        for (int kk = 0; kk < RKT; kk += 4) {
          const float4 x0 = *reinterpret_cast<const float4*>(C0 + k0 + kk);
          const float4 x1 = *reinterpret_cast<const float4*>(C1 + k0 + kk);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float* grw = TG + (kk + u) * rw + cb;
            float m[CC];
            if constexpr (CC == 4) {
              const float4 v = *reinterpret_cast<const float4*>(grw);
              m[0] = v.x; m[1] = v.y; m[2] = v.z; m[3] = v.w;
            } else if constexpr (CC == 2) {
              const float2 v = *reinterpret_cast<const float2*>(grw);
              m[0] = v.x; m[1] = v.y;
            } else {
              m[0] = grw[0];
            }
            const float c0 = u == 0 ? x0.x : u == 1 ? x0.y : u == 2 ? x0.z : x0.w;
            const float c1 = u == 0 ? x1.x : u == 1 ? x1.y : u == 2 ? x1.z : x1.w;
#pragma unroll
            for (int c = 0; c < CC; ++c) {
              acc[0][c] = fmaf(c0, m[c], acc[0][c]);
              acc[1][c] = fmaf(c1, m[c], acc[1][c]);
            }
          }
        }
      }
      float pr[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const float* Mk = TM + 4 * warp * rw;
      for (int h = hl; h < wg; h += hs) {
        const float ga = gA[h], gb = gB[h];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float m = Mk[j * rw + h];
          pr[0][j] = fmaf(ga, m, pr[0][j]);
          pr[1][j] = fmaf(gb, m, pr[1][j]);
        }
      }
      for (int o = hs / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) pr[r][j] += __shfl_xor_sync(0xffffffffu, pr[r][j], o);
      }
      // Lane hl of the group takes pairs p = hl, hl + hs, ... of its 8.
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if ((p & (hs - 1)) != hl) continue;
        const int i = rp + (p >> 2) * rgw, o = i * ldc + k0 + 4 * warp + (p & 3);
        const float pv = pr[p >> 2][p & 3];
        tp[0] = fmaf(Ar[o], pv, tp[0]);
        tp[1] = fmaf(dAr[o], pv, tp[1]);
        tp[2] = fmaf(Ac[o], pv, tp[2]);
        tp[3] = fmaf(dAc[o], pv, tp[3]);
        if (need_dd) {
          tp[4] = fmaf(ddAr[o], pv, tp[4]);
          tp[5] = fmaf(ddAc[o], pv, tp[5]);
        }
      }
    }
  }
  cp_wait0();

  // The column sums' slices, in slice order.
  sh.red[0][tid] = s_;
  sh.red[1][tid] = g_;
  sh.red[2][tid] = u_;
  __syncthreads();  // also: every thread is done with the ring
  if (tid < rw) {
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    for (int s2 = 0; s2 < nsl; ++s2) {
      x0 += sh.red[0][s2 * rw + tid];
      x1 += sh.red[1][s2 * rw + tid];
      x2 += sh.red[2][s2 * rw + tid];
    }
    sh.colS[tid] = x0;
    sh.colG[tid] = x1;
    sh.colU[tid] = x2;
  }
  __syncthreads();

  // C^T g into the ring (done with): the warps' parts [NW][bm][rw] (narrow)
  // or the one whole product [bm][rw] (wide; BF: from its blocks'
  // accumulators, entry f at column mb 16 + gid + 8 (f >> 1), row nb 8 + 2
  // q4 + (f & 1)); then the group's dM rows after them.
  float* cg = ring;
  const int nparts = narrow ? NW : 1;
  float* dMs = ring + nparts * bm * rw;  // [bm][rw]
  if constexpr (BF) {
    const int gid = lane >> 2, q4 = lane & 3;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = warp + jj * NW;
      if (j >= nb1) break;
      const int mb = j / nnb, nb = j - mb * nnb;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int h = mb * 16 + gid + 8 * (f >> 1), i = nb * 8 + 2 * q4 + (f & 1);
        if (i < bm && h < rw) cg[i * rw + h] = acc1[jj][f];
      }
    }
  } else if (narrow) {
#pragma unroll
    for (int m = 0; m < 16; ++m)
      if (nr0 + nrs * m < bm && nh < wg) cg[(warp * bm + nr0 + nrs * m) * rw + nh] = nacc[m];
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (cb + c < wg) cg[(rg + r * rgw) * rw + cb + c] = acc[r][c];
  }
  __syncthreads();
  for (int e = tid; e < bm * wg; e += NT) {
    const int i = e / wg, h = e - i * wg, gi = r0 + i;
    float dm = 0.f;
    if (gi < n) {
      float ctg = 0.f;
      for (int w = 0; w < nparts; ++w) ctg += cg[(w * bm + i) * rw + h];
      const float g = grow[i * gs + h];
      dm = ctg + sh.dvv[i][0] * g + sh.colU[h] + sh.dvv[i][1] * sh.colG[h] +
           c7 * sh.colG[h];
    }
    dMs[i * rw + h] = dm;
  }
  __syncthreads();

  // One warp per row: the group's part of the row dots and of dz = dM W.
  for (int i = warp; i < bm; i += NW) {
    const int gi = r0 + i;
    if (gi >= n) {
      for (int j = lane; j < MAXIN; j += 32) sh.dz[i][j] = 0.f;
      if (lane < 3) sh.rowd[i][lane] = 0.f;
      continue;
    }
    float gm = 0.f, du = 0.f, dv = 0.f;
    for (int h = lane; h < wg; h += 32) {
      const float g = grow[i * gs + h];
      const float m = Mb[(long long)gi * a.ldm + g0 + h];
      gm += g * m;
      du += g * sh.colS[h];
      dv += m * sh.colG[h];
    }
    gm = warp_sum(gm);
    du = warp_sum(du);
    dv = warp_sum(dv);
    if (lane == 0) {
      sh.rowd[i][0] = gm;
      sh.rowd[i][1] = du;
      sh.rowd[i][2] = dv;
    }
    for (int j = lane; j < hin; j += 32) {
      float dz = 0.f;
      for (int h = 0; h < wg; ++h)
        dz += dMs[i * rw + h] * __ldg(a.lp.W + (long long)(g0 + h) * hin + j);
      sh.dz[i][j] = dz;
    }
  }

  // The row block's partial dW rows (g0 .. g0 + wg - 1) and dlin_b.
  const int nrb = (n + bm - 1) / bm, rend = min(bm, n - r0);
  float* pout = a.part + ((long long)b * nrb + rb) * a.ptot;
  for (int e = tid; e < wg * hin; e += NT) {
    const int h = e / hin, j = e - h * hin;
    float s = 0.f;
    for (int i = 0; i < rend; ++i) s += dMs[i * rw + h] * sh.zn[i][j];
    pout[2 * hin + g0 * hin + e] = s;
  }
  for (int h = tid; h < wg; h += NT) {
    float s = 0.f;
    for (int i = 0; i < rend; ++i) s += dMs[i * rw + h];
    pout[2 * hin + H * hin + g0 + h] = s;
  }
  float dc7 = 0.f;
  for (int h = 0; h < wg; ++h) dc7 += sh.colG[h] * sh.colS[h];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    if (need_dd || k < 4) tp[k] = block_sum(tp[k], sh.scratch);  // also a barrier

  if (a.groups == 1) {
    bwd_finish_rows<DIR>(a, sh, b, rb, q, sA, sdA, sddA, tp, dc7);
    return;
  }
  // Several groups: this group's part of the rows and of the sums.
  float* wrow = a.work + ((long long)(b * a.groups + gr) * n) * (hin + 3);
  for (int i = warp; i < rend; i += NW) {
    float* dst = wrow + (long long)(r0 + i) * (hin + 3);
    for (int j = lane; j < hin; j += 32) dst[j] = sh.dz[i][j];
    if (lane < 3) dst[hin + lane] = sh.rowd[i][lane];
  }
  if (tid == 0) {
    float* rec = a.work + (long long)gridDim.z * a.groups * n * (hin + 3) +
                 (((long long)b * nrb + rb) * a.groups + gr) * 8;
#pragma unroll
    for (int k = 0; k < 6; ++k) rec[k] = need_dd || k < 4 ? tp[k] : 0.f;
    rec[6] = dc7;
    rec[7] = 0.f;
  }
}

template <bool DIR, int CC, int PROBE>
__global__ void __launch_bounds__(NT) bwd_sweep_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ BwdShared sh;
  bwd_sweep_body<DIR, CC, PROBE, false>(a, dyn, sh);
}

// The bf16 sweep (K2bf, K2dbf): at most 128 registers, two CTAs an SM
// (ops/megakernel_bwd.py BWD_CTAS_BY_REGISTERS).
template <bool DIR, int PROBE>
__global__ void __launch_bounds__(NT, 2) bwd_sweep_bf_kernel(const BwdArgsT<true> a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ BwdShared sh;
  bwd_sweep_body<DIR, 1, PROBE, true>(a, dyn, sh);
}

// A layer of several groups: the groups' partial rows and sums added in
// group order, then the rows' finish. Grid (ceil(n / bm), B).
template <bool DIR, bool BF>
__global__ void __launch_bounds__(NT) bwd_finish_kernel(const BwdArgsT<BF> a, int B) {
  __shared__ BwdShared sh;
  const int b = blockIdx.y, rb = blockIdx.x, n = a.n, bm = a.bm, r0 = rb * bm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, hin = a.lp.hin;
  const int nrb = (n + bm - 1) / bm;
  constexpr int NQ = 2 * nbasis<DIR>();
  float q[NQ];
  float sA, sdA, sddA;
  bwd_rows_prologue<DIR>(a, sh, b, r0, q, sA, sdA, sddA);
  for (int i = warp; i < bm; i += NW) {
    const int gi = r0 + i;
    for (int j = lane; j < hin + 3; j += 32) {
      float s = 0.f;
      if (gi < n)
        for (int g = 0; g < a.groups; ++g)
          s += a.work[((long long)(b * a.groups + g) * n + gi) * (hin + 3) + j];
      if (j < hin)
        sh.dz[i][j] = s;
      else
        sh.rowd[i][j - hin] = s;
    }
  }
  float tp[6];
  float dc7 = 0.f;
  const float* rec = a.work + (long long)B * a.groups * n * (hin + 3) +
                     ((long long)b * nrb + rb) * a.groups * 8;
#pragma unroll
  for (int k = 0; k < 6; ++k) tp[k] = 0.f;
  for (int g = 0; g < a.groups; ++g) {
#pragma unroll
    for (int k = 0; k < 6; ++k) tp[k] += rec[g * 8 + k];
    dc7 += rec[g * 8 + 6];
  }
  __syncthreads();
  bwd_finish_rows<DIR>(a, sh, b, rb, q, sA, sdA, sddA, tp, dc7);
}

// The per-layer partial blocks summed over their row blocks, in order:
// red[b, off_l + p] = sum_rb part_l[b, rb, p]. Grid (ceil(ptot / NT), B).
struct BwdReduce {
  int L;
  int off[BWD_LMAX + 1];        // layer l's entries in red: off[l] .. off[l + 1]
  long long pbase[BWD_LMAX];    // layer l's partial blocks in part
  int nrb[BWD_LMAX];
};

__global__ void __launch_bounds__(NT) bwd_reduce_kernel(const float* __restrict__ part,
                                                       const BwdReduce r, int ptot,
                                                       float* __restrict__ red) {
  const int b = blockIdx.y, p = blockIdx.x * NT + threadIdx.x;
  if (p >= ptot) return;
  int l = 0;
  while (l + 1 < r.L && p >= r.off[l + 1]) ++l;
  const int pl = r.off[l + 1] - r.off[l];
  const float* src = part + r.pbase[l] + (long long)b * r.nrb[l] * pl + (p - r.off[l]);
  float acc = 0.f;
  for (int k = 0; k < r.nrb[l]; ++k) acc += src[(long long)k * pl];
  red[(long long)b * ptot + p] = acc;
}

// One sweep launch (and, for several groups, its finish) on the layer's
// plan; the shared-memory allowance (BWD_SMEM_MAX) is set once per device
// and instantiation.
template <bool DIR, int CC, int PROBE, bool BF>
static int launch_sweep_cc(const BwdArgsT<BF>& a, int B, int smem, cudaStream_t stream) {
  static bool allowed[64];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= 64 || !allowed[dev]) {
    if constexpr (BF)
      err = (int)cudaFuncSetAttribute(bwd_sweep_bf_kernel<DIR, PROBE>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      BWD_SMEM_MAX);
    else
      err = (int)cudaFuncSetAttribute(bwd_sweep_kernel<DIR, CC, PROBE>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      BWD_SMEM_MAX);
    if (err != 0) return err;
    if (dev < 64) allowed[dev] = true;
  }
  const int nrb = (a.n + a.bm - 1) / a.bm;
  if constexpr (BF)
    bwd_sweep_bf_kernel<DIR, PROBE><<<dim3(nrb, a.groups, B), NT, smem, stream>>>(a);
  else
    bwd_sweep_kernel<DIR, CC, PROBE><<<dim3(nrb, a.groups, B), NT, smem, stream>>>(a);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (a.groups > 1) {
    bwd_finish_kernel<DIR, BF><<<dim3(nrb, B), NT, 0, stream>>>(a, B);
    err = (int)cudaGetLastError();
  }
  return err;
}

// A probe takes no plan of cc = 2 (none of the ablation's shapes has one);
// the bf16 sweep takes cc at run time (one instantiation for every plan).
template <bool DIR, int PROBE, bool BF>
static int launch_sweep(const BwdArgsT<BF>& a, int B, int cc, int smem, cudaStream_t stream) {
  if constexpr (BF) {
    return launch_sweep_cc<DIR, 1, PROBE, true>(a, B, smem, stream);
  } else {
    switch (cc) {
      case 1:
        return launch_sweep_cc<DIR, 1, PROBE, false>(a, B, smem, stream);
      case 2:
        if constexpr (PROBE == 0) return launch_sweep_cc<DIR, 2, 0, false>(a, B, smem, stream);
        return (int)cudaErrorInvalidValue;
      default:
        return launch_sweep_cc<DIR, 4, PROBE, false>(a, B, smem, stream);
    }
  }
}

// The entry points' shape checks: positive extents, the layer stack's
// widths (megakernel_common.cuh dims_ok), and ptot the sum of the layers'
// partial blocks, 2 hin + hout hin + hout + 2 nbasis + 1 floats each
// (dnorm_w, dnorm_b, dW, dlin_b, dbasis, dtau).
inline bool bwd_dims_ok(int B, int n, int L, const int* dims, int ldm, int directed, int ptot) {
  if (L < 1 || B < 1 || n < 1 || !dims_ok(dims, L, ldm)) return false;
  const int nb = directed ? NBASIS_D : NBASIS_U;
  int want = 0;
  for (int l = 0; l < L; ++l)
    want += 2 * dims[2 * l] + dims[2 * l + 1] * dims[2 * l] + dims[2 * l + 1] + 2 * nb + 1;
  return want == ptot;
}

// K2 (K2d; BF: K2bf, K2dbf): the forward recompute, then the reverse sweep
// on bplan + 3 l (bm, cc, groups) and the reduction. The recompute runs
// K1's row pass on K1's plan (plan + 3 l; BF: K1bf's prep and bf16 row pass
// on K1bf's plan), so M_l and x_l are K1's (K1bf's) bit for bit, and would
// be on any plan. part: the layers' partial blocks in order,
// part_floats of them; work: the several-group layers' scratch,
// work_floats. The rest as megakernel_bwd.cu's gncde_mk_bwd. PROBE: the
// sweep's BwdProbe bits.
template <bool DIR, bool BF, int PROBE = 0>
static int mk_bwd(const Planes<BF>& P, const int* idx, const float* tau, const float* Z,
                  const float* G, int B, int n, int L, const int* dims, const void* const* ptrs,
                  const int* plan, const int* bplan, int need_tau, float* stats, float* Mbuf,
                  float* Xbuf, float* gbuf, int ldm, float* dZ, float* part,
                  long long part_floats, float* work, long long work_floats, int ptot,
                  float* red, cudaStream_t stream) {
  if (L > BWD_LMAX || n > MAXN || plan == nullptr || bplan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int nb = DIR ? NBASIS_D : NBASIS_U;
  // The plans, each layer's partial blocks and scratch, checked first.
  BwdReduce rt;
  rt.L = L;
  long long pb = 0;
  int off = 0;
  for (int l = 0; l < L; ++l) {
    const int hin = dims[2 * l], hout = dims[2 * l + 1];
    const int bm = bplan[3 * l], cc = bplan[3 * l + 1], groups = bplan[3 * l + 2];
    if ((bm != 4 && bm != 8 && bm != 16) || (cc != 1 && cc != 2 && cc != 4))
      return (int)cudaErrorInvalidValue;
    const int cw = 512 * cc / bm, rw = rows_width(cw, hout);
    const long long smem = BF ? bwd_smem_bytes_bf(n, bm, rw, need_tau != 0)
                              : 4LL * bwd_smem_floats(n, bm, rw, need_tau != 0);
    if (cw < 32 || cw > 128 || groups < 1 || (long long)groups * cw < hout ||
        (long long)(groups - 1) * cw >= hout || smem > BWD_SMEM_MAX)
      return (int)cudaErrorInvalidValue;
    const int pl = 2 * hin + hout * hin + hout + 2 * nb + 1;  // dnorm, dW, dlin_b, dbasis, dtau
    const int nrb = (n + bm - 1) / bm;
    rt.off[l] = off;
    rt.pbase[l] = pb;
    rt.nrb[l] = nrb;
    off += pl;
    pb += (long long)B * nrb * pl;
    if (groups > 1 &&
        (long long)B * groups * ((long long)n * (hin + 3) + (long long)nrb * 8) > work_floats)
      return (int)cudaErrorInvalidValue;
  }
  rt.off[L] = off;
  if (off != ptot || pb > part_floats) return (int)cudaErrorInvalidValue;

  const dim3 grid((n + BM - 1) / BM, B);
  const long long lstride = (long long)B * n * ldm;
  prep_kernel<DIR, BF><<<grid, NT, 0, stream>>>(P, idx, tau, n, Z, dims[0],
                                                layer_from(ptrs, dims, 0), Mbuf, ldm, stats);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int l = 0; l + 1 < L; ++l) {  // M_l, x_l bitwise the forward kernel's
    const int e = launch_rows<DIR, 0, BF>(P, idx, tau, B, n, stats, layer_from(ptrs, dims, l),
                                          Mbuf + l * lstride, ldm, Xbuf + (l + 1) * lstride,
                                          ldm, 1, 1, layer_from(ptrs, dims, l + 1),
                                          Mbuf + (l + 1) * lstride, ldm, plan + 3 * l, stream);
    if (e != 0) return e;
  }

  const float* g_in = G;
  int ldg = dims[2 * (L - 1) + 1];
  for (int l = L - 1; l >= 0; --l) {
    BwdArgsT<BF> a;
    a.P = P;
    a.idx = idx;
    a.tau = tau;
    a.stats = stats;
    a.lp = layer_from(ptrs, dims, l);
    a.X = l == 0 ? Z : Xbuf + l * lstride;
    a.ldx = l == 0 ? dims[0] : ldm;
    a.Mc = Mbuf + l * lstride;
    a.ldm = ldm;
    a.G = g_in;
    a.ldg = ldg;
    a.Gp = l == 0 ? dZ : gbuf + l * lstride;
    a.ldgp = l == 0 ? dims[0] : ldm;
    a.mask_prev = l > 0;
    a.part = part + rt.pbase[l];
    a.ptot = rt.off[l + 1] - rt.off[l];
    a.work = work;
    a.n = n;
    a.bm = bplan[3 * l];
    a.groups = bplan[3 * l + 2];
    a.vec = ldm % 4 == 0 && ldg % 4 == 0 && ((uintptr_t)a.Mc & 15) == 0 &&
            ((uintptr_t)g_in & 15) == 0;
    const int cc = bplan[3 * l + 1], hout = dims[2 * l + 1];
    const int rw = rows_width(512 * cc / a.bm, hout);
    const int smem = BF ? bwd_smem_bytes_bf(n, a.bm, rw, need_tau != 0)
                        : bwd_smem_floats(n, a.bm, rw, need_tau != 0) * (int)sizeof(float);
    a.tau_on = need_tau != 0;
    a.cc = cc;
    const int e = launch_sweep<DIR, PROBE, BF>(a, B, cc, smem, stream);
    if (e != 0) return e;
    g_in = a.Gp;
    ldg = a.ldgp;
  }
  bwd_reduce_kernel<<<dim3((ptot + NT - 1) / NT, B), NT, 0, stream>>>(part, rt, ptot, red);
  return (int)cudaGetLastError();
}

}  // namespace mk
