// K4, K6a (K6a-bf) and K6b (K6b-bf) on the tensor cores: the plane sweeps
// of the tiled training backward and of the enc_idx pair apply, and the
// pair apply's coefficient cotangents.
//
// Replace the TPU kernels of gncde_tpu/ops/pallas/tiled.py:
//   K4  _bwd2_kernel / _bwd2_call   A g, dA g, A^T g, dA^T g in one sweep
//                                   over bf16 planes (four bf16 products,
//                                   f32 sums); dM parts rowp = c_col . (A g,
//                                   dA g), colp = c_row . (A^T g, dA^T g),
//                                   and the four c cotangents (<A^T g, M>,
//                                   <dA^T g, M>, <A g, M>, <dA g, M>)
//   K6a _pair_kernel / _pair_call   rowpart = B1 Mk, colpart = B2^T Mi over
//                                   rectangular (nr, nc) planes, B1 = cr0 A +
//                                   cr1 dA, B2 = cc0 A + cc1 dA formed in the
//                                   planes' dtype (bf16: the coefficients
//                                   rounded first, each product and the sum
//                                   rounded), f32 sums
//   K6b _pair_dw_kernel /           per element (<A, Gr Mk^T>, <dA, Gr Mk^T>,
//       _pair_dw_call               <A, Mi Gc^T>, <dA, Mi Gc^T>) over
//                                   rectangular planes: f32 planes and
//                                   vectors, or (K6b-bf) bf16 planes and
//                                   vectors, f32 sums (its own kernel,
//                                   pair_dw_kernel below)
//
// One pass owns BO = 64 indices of one batch element, one chunk of HB output
// columns (8, 32 or 64: the least that holds H, wider H in chunks of 64,
// each its own CTAs) and one of S parts of its reduce extent:
//   row pass (blockIdx.y even): owns rows i of the planes, reduces over their
//     nc columns: out[i] = sum_k X[i, k] V[k] (X the raw planes (K4) or B1,
//     V the vector of that pass: g (K4) or Mk);
//   col pass: owns columns k, reduces over the nr rows: out[k] = sum_i X[i, k]
//     V[i] (X^T: the same row-major plane tile fed transposed).
// Its 8 warps are 4 row groups of 16 owned indices times WC column halves
// (HB = 64) or times WK = 2 halves of each 32-deep reduce tile (HB <= 32).
//
// The planes are unpadded (B, nr, nc), so a row starts on an element
// boundary only (n = 1505: 3,010 bytes a bf16 row) and TMA cannot read them.
// As K3 does (tiled.cu namespace k3), each row of a plane tile is copied raw
// by 16-byte cp.async as the aligned granules that hold it, only the planes'
// own bytes (the base is 16-byte aligned: the wrappers copy planes that are
// not; the last granule is copied up to the planes' end), three tiles in a
// ring, two tiles ahead of the products, with the vector tiles (cp.async
// where the row length is a multiple of 16 bytes, scalar loads otherwise).
// Each tile is then formed, every element read at its row's shift within its
// first granule, into an aligned tile:
//   K4: both raw planes as they are (bf16), two tiles sharing the g tile's
//     fragments: two mma.sync m16n8k16 bf16 products a fragment, f32 sums;
//   K6a-bf with bf16 vectors (the backward's cotangents): B1/B2 in bf16, one
//     mma.sync m16n8k16 a fragment (K3's arithmetic);
//   K6a on f32 planes, and K6a-bf with f32 vectors (the forward's M): the
//     result must be the f32 product (TILED_TOL of the plain version's f32
//     matmul), which one TF32 or bf16 pass is not (about 1e-3 off). B1/B2 are
//     formed in f32 (f32 planes: c0 a and c1 d and their sum each rounded
//     once, as the plain version; bf16 planes: the bf16 chain, exact in f32)
//     and multiplied as 3xTF32 (mma.sync m16n8k8): each f32 operand x is
//     split into big = tf32(x) and small = tf32(x - big), and the product
//     summed as big_a small_b + small_a big_b + big_a big_b; the dropped
//     small_a small_b and the split's residuals are about 2^-21 of each
//     product, f32 rounding territory. A bf16-formed B is exact in TF32
//     (small_a = 0), so it takes two products, not three.
//
// Every output element is summed by one warp in one fixed order (the MMA's
// own order within a step, the steps in order; WK halves added half 0 + half
// 1), each part writes its own slab of `part`, summed in part order by a
// second launch, and K4's per-CTA inner products are summed in block order by
// a third: no float atomics, so two launches are bitwise equal. Only the
// order of the f32 sums differs from the plain versions (and, for 3xTF32,
// the split's residuals).
//
// Bound on the card, at genre n = 1505: K4 by bytes (the two bf16 planes once,
// 9.1 MB); K6a on f32 planes by its f32 operations (4 n^2 H, the function's
// own count) at the 3xTF32 rate, a third of the 495 TFLOP/s TF32 peak (the
// least time products of f32 accuracy take on the tensor cores), and on
// bf16 planes with bf16 vectors by bytes.
// The products here run on the tensor cores, so what is left is the plane
// traffic (each pass reads the planes; the second read mostly hits the 50 MB
// L2), the forming of each tile in shared memory, and, at B = 1, spreading
// 24 row blocks over 132 SMs: the split of the reduce extent (ops/tiled.py
// mma_splits) keeps about two CTAs per SM busy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "megakernel_common.cuh"

namespace pk {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;
constexpr int BO = 64;  // owned indices per CTA
constexpr int BK = 32;  // depth of one reduce tile
constexpr int RS = 3;   // raw plane tiles in the ring
constexpr int VS = 3;   // vector tiles in the ring

enum Op { OP_K4 = 0, OP_PAIR = 1 };

template <int HB>
struct Cfg {
  static constexpr int WC = HB == 64 ? 2 : 1;  // column groups of warps
  static constexpr int WK = 8 / (4 * WC);       // reduce halves of warps
  static constexpr int NB = HB / (8 * WC);      // 8-wide column blocks a warp
};

// Dynamic shared memory of one instantiation: RS raw stages of the two
// planes, NA formed tiles, VS vector tiles. Row strides are chosen so that
// the fragment loads hit distinct banks: bf16 tiles read by ldmatrix have
// rows of an odd number of 16-byte units, f32 tiles read element by element
// rows of 4 (row-major A) or 8 (transposed A, B) words mod 32.
template <int OP, typename PT, typename VT, int HB>
struct Lay {
  static constexpr bool BFV = std::is_same<VT, bf16>::value;  // bf16 MMA; else 3xTF32
  static constexpr int NA = OP == OP_K4 ? 2 : 1;               // formed tiles, products
  static constexpr int ES = sizeof(PT), EPG = 16 / ES;         // plane element, per granule
  static constexpr int RLD = (BK * ES / 16 + 1) * EPG;         // raw row, row pass
  static constexpr int RTLD = (BO * ES / 16 + 1) * EPG;        // raw row, col pass
  static constexpr int RPS = BO * RLD > BK * RTLD ? BO * RLD : BK * RTLD;
  static constexpr int FLD = BFV ? BK + 8 : BK + 4;            // formed row, row pass
  static constexpr int FTLD = BO + 8;                          // formed row, col pass
  static constexpr int FPS = BO * FLD > BK * FTLD ? BO * FLD : BK * FTLD;
  static constexpr int FES = BFV ? 2 : 4;
  static constexpr int VES = sizeof(VT);
  static constexpr int VLD = HB == 8 ? (BFV ? 24 : 8) : HB + 8;  // vector tile row
  static constexpr int RAW_BYTES = RS * 2 * RPS * ES;
  static constexpr int FORM_BYTES = NA * FPS * FES;
  static constexpr int BYTES = RAW_BYTES + FORM_BYTES + VS * BK * VLD * VES;
};

struct Args {
  const void* A;       // planes (B, nr, nc), bf16 or f32, 16-byte aligned
  const void* dA;
  const float* cvec;   // row pass (cvec[0], cvec[1]), col pass (cvec[2], cvec[3])
  const void* vrow;    // the row pass's vector (B, nc, H): K4 g, K6a Mk
  const void* vcol;    // the col pass's vector (B, nr, H): K4 g, K6a Mi
  const bf16* M;       // K4: M (B, n, H), for the c cotangents
  float* row_out;      // (B, nr, H)
  float* col_out;      // (B, nc, H)
  float* part;         // S > 1: (S, B (nr + nc) H) part slabs
  float* dwpart;       // K4: (B, gridDim.y, gridDim.x, 4) per-CTA inner products
  int nr, nc, H, B, S;
  bool vvec;           // vector rows a multiple of 16 bytes, 16-byte aligned
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D: the ablation flags of gncde_pair_probe (plane_probe.cu; 0 in every
// kernel of the main path): each set bit drops one part of the work (D_*
// below), so a run of the variants shows what a sweep's time is spent on.
enum Drop { D_MMA = 1, D_FORM = 2, D_PLANES = 4, D_VECS = 8, D_COLS = 16, D_ROWS = 32 };

template <int OP, typename PT, typename VT, int HB, bool TR, int D = 0>
__device__ __forceinline__ void pass(const Args& g, unsigned char* sm, float* red, int b,
                                     int o0, int h0, int s) {
  using C = Cfg<HB>;
  using Y = Lay<OP, PT, VT, HB>;
  constexpr bool BFV = Y::BFV, BFP = std::is_same<PT, bf16>::value;
  constexpr int NA = Y::NA, ES = Y::ES;
  constexpr int LD = TR ? Y::RTLD : Y::RLD;   // raw row stride
  constexpr int FL = TR ? Y::FTLD : Y::FLD;   // formed row stride
  constexpr int TROWS = TR ? BK : BO;         // rows of a plane tile
  constexpr int GR = LD / Y::EPG;             // granules a raw row
  typedef typename std::conditional<BFP, unsigned short, float>::type PS;  // plane storage
  typedef typename std::conditional<BFV, unsigned short, float>::type VW;  // vector storage
  PS* raw = reinterpret_cast<PS*>(sm);                            // [RS][2][RPS]
  unsigned char* formed = sm + Y::RAW_BYTES;                      // [NA][FPS]
  VW* Vring = reinterpret_cast<VW*>(formed + Y::FORM_BYTES);      // [VS][BK * VLD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = (warp >> 2) % C::WC, wk = (warp >> 2) / C::WC;
  const int nr = g.nr, nc = g.nc, H = g.H;
  const int own = TR ? nc : nr, ext = TR ? nr : nc;
  float c0 = __ldg(g.cvec + (TR ? 2 : 0)), c1 = __ldg(g.cvec + (TR ? 3 : 1));
  if (OP == OP_PAIR && BFP) {
    c0 = mk::rbf(c0);
    c1 = mk::rbf(c1);
  }
  const long long pbase = (long long)b * nr * nc;
  const uintptr_t plane_end = (uintptr_t)ES * (uintptr_t)((long long)g.B * nr * nc);
  const VW* Vb = static_cast<const VW*>(TR ? g.vcol : g.vrow) + (long long)b * ext * H;
  const int ntiles = (ext + BK - 1) / BK;
  const int t0 = (int)((long long)s * ntiles / g.S), t1 = (int)((long long)(s + 1) * ntiles / g.S);

  // Copies: each thread serves one (plane, tile row) and every TPR-th
  // granule of it, so its source address advances by a fixed step from
  // tile to tile (BK columns, or BK rows: both multiples of 16 bytes, so a
  // row's granule alignment does not change) and only the row's bounds are
  // checked per tile.
  constexpr int ROWS2 = 2 * TROWS, TPR = NT / ROWS2, KG = (GR + TPR - 1) / TPR;
  const int cq = (tid % ROWS2) / TROWS, ctr = tid % TROWS, cg0 = tid / ROWS2;
  const PS* cX = static_cast<const PS*>(cq ? g.dA : g.A);
  const uintptr_t cfirst = reinterpret_cast<uintptr_t>(
      cX + pbase + (long long)(TR ? ctr : o0 + ctr) * nc + (TR ? o0 : 0));
  const uintptr_t cg = (cfirst & ~(uintptr_t)15) + 16 * cg0;  // granule cg0 at tile 0
  const long long cstep = (long long)BK * ES * (TR ? nc : 1);
  const uintptr_t cend = reinterpret_cast<uintptr_t>(cX) + plane_end;
  PS* const cdst = raw + cq * Y::RPS + ctr * LD + cg0 * Y::EPG;
  // The raw granules of tile t's rows (both planes) into raw stage `st`.
  auto issue_planes = [&](int t, int st) {
    const int row = TR ? t * BK + ctr : o0 + ctr;
    const uintptr_t src = cg + t * cstep;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      if (cg0 + k * TPR >= GR) break;
      const uintptr_t ga = src + 16 * k * TPR;
      // Only the planes' bytes: none past the last row, and in the planes'
      // last row (the only one whose granules can reach past their end)
      // none past their end; cp.async zero-fills what it does not copy.
      int bytes = row < nr ? 16 : 0;
      if (row == nr - 1 && b == g.B - 1) {
        const long long left = (long long)(cend - ga);
        bytes = left <= 0 ? 0 : left < 16 ? (int)left : 16;
      }
      mk::cp_async16(cdst + st * 2 * Y::RPS + k * TPR * Y::EPG,
                     bytes ? reinterpret_cast<const void*>(ga) : static_cast<const void*>(cX),
                     bytes);
    }
  };
  auto issue_v = [&](int t, int slot) {
    constexpr int EV = 16 / sizeof(VW);  // elements a granule
    const int r0 = t * BK;
    VW* Vt = Vring + slot * BK * Y::VLD;
    if (g.vvec) {
      for (int e = tid; e < BK * HB / EV; e += NT) {
        const int kr = e / (HB / EV), hc = (e % (HB / EV)) * EV;
        const bool ok = r0 + kr < ext && h0 + hc < H;
        mk::cp_async16(Vt + kr * Y::VLD + hc,
                       ok ? static_cast<const void*>(Vb + (long long)(r0 + kr) * H + h0 + hc)
                          : static_cast<const void*>(Vb),
                       ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BK * HB; e += NT) {
        const int kr = e / HB, hc = e % HB;
        Vt[kr * Y::VLD + hc] = r0 + kr < ext && h0 + hc < H
                                   ? __ldg(Vb + (long long)(r0 + kr) * H + h0 + hc)
                                   : (VW)0;
      }
    }
  };
  // Forming: four element pairs a thread, at fixed tile positions, each read
  // at its row's offset within its first granule; the offsets (both planes,
  // all four pairs: 4 bits each) do not change from tile to tile.
  auto pair_at = [&](int j, int& tr, int& pc) {
    const int p = tid + j * NT;
    // Row pass tile: BO plane rows x BK columns; col pass: BK x BO.
    tr = TR ? p >> 5 : p >> 4;
    pc = TR ? (p & 31) * 2 : (p & 15) * 2;
  };
  uint32_t shifts = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int tr, pc;
    pair_at(j, tr, pc);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const PS* X = static_cast<const PS*>(q ? g.dA : g.A);
      const uintptr_t a0 = reinterpret_cast<uintptr_t>(
          X + pbase + (long long)(TR ? tr : o0 + tr) * nc + (TR ? o0 : 0));
      shifts |= (uint32_t)((a0 & 15) / ES) << (4 * (2 * j + q));
    }
  }
  // Tile t from raw stage `st` into the formed tiles.
  auto form = [&](int t, int st) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int tr, pc;
      pair_at(j, tr, pc);
      const int row = TR ? t * BK + tr : o0 + tr, col = TR ? o0 : t * BK;
      const bool ok0 = row < nr && col + pc < nc, ok1 = row < nr && col + pc + 1 < nc;
      PS w[2][2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int sh = (shifts >> (4 * (2 * j + q))) & 15;
        const PS* rp = raw + (st * 2 + q) * Y::RPS + tr * LD + sh + pc;
        w[q][0] = ok0 ? rp[0] : (PS)0;
        w[q][1] = ok1 ? rp[1] : (PS)0;
      }
      if constexpr (OP == OP_K4) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned short*>(formed) + q * Y::FPS +
                                       tr * FL + pc) = w[q][0] | ((uint32_t)w[q][1] << 16);
      } else if constexpr (BFV) {
        *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned short*>(formed) + tr * FL + pc) =
            mk::form_two(w[0][0] | ((uint32_t)w[0][1] << 16), w[1][0] | ((uint32_t)w[1][1] << 16),
                         c0, c1);
      } else {
        float2 v;
        if constexpr (BFP) {  // the bf16 chain: exact in f32
          const uint32_t f = mk::form_two(w[0][0] | ((uint32_t)w[0][1] << 16),
                                          w[1][0] | ((uint32_t)w[1][1] << 16), c0, c1);
          v = make_float2(__uint_as_float(f << 16), __uint_as_float(f & 0xffff0000u));
        } else {
          v = make_float2(__fadd_rn(__fmul_rn(c0, w[0][0]), __fmul_rn(c1, w[1][0])),
                          __fadd_rn(__fmul_rn(c0, w[0][1]), __fmul_rn(c1, w[1][1])));
        }
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(formed) + tr * FL + pc) = v;
      }
    }
  };

  float acc[NA][C::NB][4];
#pragma unroll
  for (int x = 0; x < NA; ++x)
#pragma unroll
    for (int j = 0; j < C::NB; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[x][j][q] = 0.f;

  const int m = lane >> 3, r = lane & 7;    // ldmatrix address roles
  const int gid = lane >> 2, q4 = lane & 3;  // fragment roles
  const int nc0 = wc * (HB / C::WC);
  // Tile t (l = t - t0 tiles in): its raw planes sit in stage l % RS and its
  // vector in slot l % VS, copied two tiles earlier. After the wait and the
  // first barrier the copies of tile t + 2 go out (their stage and slot were
  // last read by tile t - 1, before that barrier), tile t is formed, and
  // after the second barrier multiplied.
  for (int i = 0; i < 2; ++i) {
    if (t0 + i < t1) {
      if (!(D & D_PLANES)) issue_planes(t0 + i, i);
      if (!(D & D_VECS)) issue_v(t0 + i, i);
    }
    mk::cp_commit();
  }
  for (int t = t0; t < t1; ++t) {
    const int l = t - t0;
    mk::cp_wait1();
    __syncthreads();
    if (t + 2 < t1) {
      if (!(D & D_PLANES)) issue_planes(t + 2, (l + 2) % RS);
      if (!(D & D_VECS)) issue_v(t + 2, (l + 2) % VS);
    }
    mk::cp_commit();
    if (!(D & D_FORM)) form(t, l % RS);
    __syncthreads();
    const VW* Vt = Vring + (l % VS) * BK * Y::VLD;
    if constexpr (D & D_MMA) {
    } else if constexpr (BFV) {
#pragma unroll
      for (int kk = 0; kk < BK / 16 / C::WK; ++kk) {
        const int ks = (kk * C::WK + wk) * 16;
        uint32_t a[NA][4];
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          const unsigned short* P = reinterpret_cast<const unsigned short*>(formed) + x * Y::FPS;
          if (TR)
            mk::ldsm_x4_t(a[x][0], a[x][1], a[x][2], a[x][3],
                          P + (ks + (m >> 1) * 8 + r) * FL + wr * 16 + (m & 1) * 8);
          else
            mk::ldsm_x4(a[x][0], a[x][1], a[x][2], a[x][3],
                        P + (wr * 16 + (m & 1) * 8 + r) * FL + ks + (m >> 1) * 8);
        }
        if constexpr (C::NB == 1) {
          uint32_t b0, b1;
          mk::ldsm_x2_t(b0, b1, Vt + (ks + (m & 1) * 8 + r) * Y::VLD + nc0);
#pragma unroll
          for (int x = 0; x < NA; ++x)
            mk::mma_bf16(acc[x][0], a[x][0], a[x][1], a[x][2], a[x][3], b0, b1);
        } else {
#pragma unroll
          for (int jp = 0; jp < C::NB / 2; ++jp) {
            uint32_t b0, b1, b2, b3;
            mk::ldsm_x4_t(b0, b1, b2, b3,
                          Vt + (ks + (m & 1) * 8 + r) * Y::VLD + nc0 + (2 * jp + (m >> 1)) * 8);
#pragma unroll
            for (int x = 0; x < NA; ++x) {
              mk::mma_bf16(acc[x][2 * jp], a[x][0], a[x][1], a[x][2], a[x][3], b0, b1);
              mk::mma_bf16(acc[x][2 * jp + 1], a[x][0], a[x][1], a[x][2], a[x][3], b2, b3);
            }
          }
        }
      }
    } else {
      const float* P = reinterpret_cast<const float*>(formed);
#pragma unroll
      for (int kk = 0; kk < BK / 8 / C::WK; ++kk) {
        const int ks = (kk * C::WK + wk) * 8;
        // A fragment of m16n8k8: (gid, q4), (gid + 8, q4), (gid, q4 + 4),
        // (gid + 8, q4 + 4) of the warp's 16 owned rows by 8 reduce steps.
        float af[4];
        const int i0 = wr * 16 + gid;
        if (TR) {
          af[0] = P[(ks + q4) * FL + i0];
          af[1] = P[(ks + q4) * FL + i0 + 8];
          af[2] = P[(ks + q4 + 4) * FL + i0];
          af[3] = P[(ks + q4 + 4) * FL + i0 + 8];
        } else {
          af[0] = P[i0 * FL + ks + q4];
          af[1] = P[(i0 + 8) * FL + ks + q4];
          af[2] = P[i0 * FL + ks + q4 + 4];
          af[3] = P[(i0 + 8) * FL + ks + q4 + 4];
        }
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ab[i] = tf32(af[i]);
          as[i] = BFP ? 0u : tf32(af[i] - __uint_as_float(ab[i]));
        }
#pragma unroll
        for (int j = 0; j < C::NB; ++j) {
          // B fragment: (k = q4, n = gid), (q4 + 4, gid).
          const float* vp = Vt + (ks + q4) * Y::VLD + nc0 + j * 8 + gid;
          const float v0 = vp[0], v1 = vp[4 * Y::VLD];
          const uint32_t bb0 = tf32(v0), bb1 = tf32(v1);
          const uint32_t bs0 = tf32(v0 - __uint_as_float(bb0));
          const uint32_t bs1 = tf32(v1 - __uint_as_float(bb1));
          mma_tf32(acc[0][j], ab, bs0, bs1);
          if (!BFP) mma_tf32(acc[0][j], as, bb0, bb1);
          mma_tf32(acc[0][j], ab, bb0, bb1);
        }
      }
    }
  }

  // With WK = 2 the second reduce half's accumulators go through the shared
  // memory (the rings are done: the last copies were empty) and its warps
  // sit out the epilogue, still reaching every barrier.
  bool live = true;
  if constexpr (C::WK > 1) {
    mk::cp_wait0();
    __syncthreads();
    float* spill = reinterpret_cast<float*>(sm);  // [4 WC][32][NA NB 4]
    constexpr int PER = NA * C::NB * 4;
    const int grp = wr * C::WC + wc;
    if (wk == 1)
#pragma unroll
      for (int x = 0; x < NA; ++x)
#pragma unroll
        for (int j = 0; j < C::NB; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            spill[(grp * 32 + lane) * PER + (x * C::NB + j) * 4 + q] = acc[x][j][q];
    __syncthreads();
    live = wk == 0;
    if (live)
#pragma unroll
      for (int x = 0; x < NA; ++x)
#pragma unroll
        for (int j = 0; j < C::NB; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[x][j][q] += spill[(grp * 32 + lane) * PER + (x * C::NB + j) * 4 + q];
  }

  float* dst = g.S == 1 ? (TR ? g.col_out : g.row_out) + (long long)b * own * H
                        : g.part + (long long)s * g.B * (nr + nc) * H +
                              (TR ? (long long)g.B * nr * H : 0) + (long long)b * own * H;
  float dot0 = 0.f, dot1 = 0.f;
  if (live) {
#pragma unroll
    for (int j = 0; j < C::NB; ++j) {
      const int h = h0 + nc0 + j * 8 + 2 * q4;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = o0 + wr * 16 + gid + hf * 8;
        if (i >= own) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (h + e >= H) continue;
          const long long o = (long long)i * H + h + e;
          const float v0 = acc[0][j][2 * hf + e];
          if constexpr (OP == OP_K4) {
            const float v1 = acc[NA - 1][j][2 * hf + e];
            dst[o] = c0 * v0 + c1 * v1;
            const float mv = __bfloat162float(g.M[(long long)b * own * H + o]);
            dot0 = fmaf(v0, mv, dot0);
            dot1 = fmaf(v1, mv, dot1);
          } else {
            dst[o] = v0;
          }
        }
      }
    }
  }
  if constexpr (OP == OP_K4) {
    // The CTA's inner products, summed in warp order.
    dot0 = mk::warp_sum(dot0);
    dot1 = mk::warp_sum(dot1);
    if (lane == 0) {
      red[2 * warp] = dot0;
      red[2 * warp + 1] = dot1;
    }
    __syncthreads();
    if (tid == 0) {
      float s0 = 0.f, s1 = 0.f;
      for (int w = 0; w < NT / 32; ++w) {
        s0 += red[2 * w];
        s1 += red[2 * w + 1];
      }
      float* pp = g.dwpart +
                  (((long long)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 4;
      pp[0] = TR ? s0 : 0.f;
      pp[1] = TR ? s1 : 0.f;
      pp[2] = TR ? 0.f : s0;
      pp[3] = TR ? 0.f : s1;
    }
  }
}

// grid (ceil(max(nr, nc) / BO), 2 S chunks, B): blockIdx.y = (chunk S + s) 2
// + pass; Lay<...>::BYTES of dynamic shared memory. CTAs past their pass's
// extent exit at once (K6a's rectangular planes).
template <int OP, typename PT, typename VT, int HB, int D = 0>
__global__ void __launch_bounds__(NT, 2) sweep_mma_kernel(Args g) {
  extern __shared__ __align__(16) unsigned char pk_smem[];
  __shared__ float red[2 * NT / 32];
  const int y = blockIdx.y, tr = y & 1, s = (y >> 1) % g.S, chunk = (y >> 1) / g.S;
  const int o0 = blockIdx.x * BO;
  if (o0 >= (tr ? g.nc : g.nr) || (tr ? D & D_COLS : D & D_ROWS)) return;
  if (tr)
    pass<OP, PT, VT, HB, true, D>(g, pk_smem, red, blockIdx.z, o0, chunk * HB, s);
  else
    pass<OP, PT, VT, HB, false, D>(g, pk_smem, red, blockIdx.z, o0, chunk * HB, s);
}

// row_out / col_out = the S part slabs summed in part order.
__global__ void sum_parts_kernel(const float* __restrict__ part, int S, long long total,
                                 long long nrow, float* __restrict__ row_out,
                                 float* __restrict__ col_out) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float v = part[e];
    for (int k = 1; k < S; ++k) v += part[k * total + e];
    if (e < nrow)
      row_out[e] = v;
    else
      col_out[e - nrow] = v;
  }
}

// dw[b, q] = sum over blocks of dwpart[b, blk, q], in block order.
__global__ void sum_blocks_kernel(const float* dwpart, int nblk, float* dw) {
  const int b = blockIdx.x, q = threadIdx.x;
  if (q >= 4) return;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += dwpart[((long long)b * nblk + k) * 4 + q];
  dw[b * 4 + q] = s;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---- K6b -------------------------------------------------------------------
// The c cotangents of K6a, per element: (<A, P>, <dA, P>, <A, Q>, <dA, Q>)
// with P = Gr Mk^T and Q = Mi Gc^T, as _pair_dw_kernel computes them: a CTA
// owns one DT x DT plane tile (rows i, columns k) and one part of the H
// extent, forms its tiles of P and Q over that part on the tensor cores,
// and takes the four inner products with the plane tile, whose values it
// loads straight into the accumulators' fragment layout. P and Q never
// leave registers, and each plane element is read once whatever H is (once
// per part where the plan splits H). Gr, Mi (rows i) and Mk, Gc (rows k)
// come through a ring of DS stages of DHK columns each (16-byte cp.async
// where a row is a multiple of 16 bytes, plain loads otherwise), two stages
// ahead of the products. Its 8 warps each own 32 rows x 16 columns of the
// tile: two m16 blocks by two n8 blocks of P and of Q.
//   K6b-bf: bf16 vectors, mma.sync m16n8k16 (products of bf16 values are
//     exact in f32, f32 sums);
//   K6b: f32 vectors as 3xTF32 (m16n8k8 on the big/small TF32 splits of both
//     operands, as K6a's f32 products): one TF32 pass would be about 1e-3
//     off.
// Each CTA writes its four sums (the warps' in warp order) to its own slot
// of `part`, (B, tiles * S, 4), and sum_blocks_kernel adds them in slot
// order: no float atomics, so two launches are bitwise equal.
// Bound on the card: K6b at genre n = 1505, H = 128 by its f32 operations
// (4 n^2 H at the 3xTF32 rate, as K6a's), K6b-bf by
// the planes' bytes; at the trade's n = 255 the 16 tiles of an element are
// too few CTAs, so the plan (ops/pair.py pair_dw_plan) splits H.
// D: the ablation's drop flags (gncde_pair_dw_probe, plane_probe.cu), 0 on the
// main path.
constexpr int DT = 64;   // plane tile: DT rows x DT columns a CTA
constexpr int DHK = 32;  // columns of H a ring stage holds
constexpr int DS = 3;    // ring stages
enum DwDrop { DW_NO_MMA = 1, DW_NO_VECS = 2, DW_NO_PLANES = 4 };

template <typename T>
struct DwLay {
  static constexpr bool BF = std::is_same<T, bf16>::value;
  // Row strides (elements): ldmatrix rows of an odd number of 16-byte
  // units (bf16), rows of 4 words mod 32 for the scalar fragment loads (f32).
  static constexpr int LD = BF ? DHK + 8 : DHK + 4;
  static constexpr int MAT = DT * LD;  // one vector tile of a stage
  static constexpr int BYTES = DS * 4 * MAT * (int)sizeof(T);
};

struct DwArgs {
  const void* A;   // planes (B, nr, nc)
  const void* dA;
  const void* v[4];  // Gr, Mi (B, nr, H); Mk, Gc (B, nc, H)
  float* part;       // (B, tiles * S, 4)
  int nr, nc, H, B, S;
  bool vvec;  // vector rows a multiple of 16 bytes, 16-byte aligned
};

template <typename T, int D = 0>
__global__ void __launch_bounds__(NT, 2) pair_dw_kernel(const DwArgs g) {
  using Y = DwLay<T>;
  constexpr bool BF = Y::BF;
  typedef typename std::conditional<BF, unsigned short, float>::type ST;  // storage
  extern __shared__ __align__(16) unsigned char pk_smem[];
  __shared__ float red[4 * NT / 32];
  ST* ring = reinterpret_cast<ST*>(pk_smem);  // [DS][Gr, Mi, Mk, Gc][DT][LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nr = g.nr, nc = g.nc, H = g.H;
  const int ntk = (nc + DT - 1) / DT, tile = blockIdx.x, s = blockIdx.y, b = blockIdx.z;
  const int i0 = tile / ntk * DT, k0 = tile % ntk * DT;
  const int nch = (H + DHK - 1) / DHK;
  const int c0 = (int)((long long)s * nch / g.S), c1 = (int)((long long)(s + 1) * nch / g.S);
  const ST* V[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    V[m] = static_cast<const ST*>(g.v[m]) + (long long)b * (m < 2 ? nr : nc) * H;

  // Columns c DHK .. of the tile's rows of the four vectors into stage st;
  // rows past their extent and columns past H zero.
  auto issue = [&](int c, int st) {
    const int h0 = c * DHK;
    ST* dst = ring + st * 4 * Y::MAT;
    if (g.vvec) {
      constexpr int EG = 16 / sizeof(ST), GPR = DHK / EG;
      for (int e = tid; e < 4 * DT * GPR; e += NT) {
        const int m = e / (DT * GPR), r = e / GPR % DT, h = h0 + e % GPR * EG;
        const int row = (m < 2 ? i0 : k0) + r;
        const bool ok = row < (m < 2 ? nr : nc) && h < H;
        mk::cp_async16(dst + m * Y::MAT + r * Y::LD + h - h0,
                       ok ? static_cast<const void*>(V[m] + (long long)row * H + h)
                          : static_cast<const void*>(V[m]),
                       ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < 4 * DT * DHK; e += NT) {
        const int m = e / (DT * DHK), r = e / DHK % DT, h = h0 + e % DHK;
        const int row = (m < 2 ? i0 : k0) + r;
        dst[m * Y::MAT + r * Y::LD + h - h0] =
            row < (m < 2 ? nr : nc) && h < H ? __ldg(V[m] + (long long)row * H + h) : (ST)0;
      }
    }
  };

  float acc[2][2][2][4];  // [P, Q][m block][n block][fragment]
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[x][mb][nb][q] = 0.f;

  const int wm = warp & 1, wn = warp >> 1;   // the warp's 32 rows, 16 columns
  const int m = lane >> 3, r = lane & 7;     // ldmatrix address roles
  const int gid = lane >> 2, q4 = lane & 3;  // fragment roles
  for (int i = 0; i < 2; ++i) {
    if (c0 + i < c1 && !(D & DW_NO_VECS)) issue(c0 + i, i);
    mk::cp_commit();
  }
  for (int c = c0; c < c1; ++c) {
    const int l = c - c0;
    mk::cp_wait1();
    __syncthreads();  // stage l % DS landed; stage (l + 2) % DS was read by c - 1
    if (c + 2 < c1 && !(D & DW_NO_VECS)) issue(c + 2, (l + 2) % DS);
    mk::cp_commit();
    if constexpr ((D & DW_NO_MMA) != 0) continue;
    const ST* St = ring + (l % DS) * 4 * Y::MAT;
#pragma unroll
    for (int x = 0; x < 2; ++x) {  // P: Gr and Mk; Q: Mi and Gc
      const ST* Am = St + x * Y::MAT + wm * 32 * Y::LD;
      const ST* Bm = St + (2 + x) * Y::MAT + wn * 16 * Y::LD;
      if constexpr (BF) {
#pragma unroll
        for (int ks = 0; ks < DHK; ks += 16) {
          uint32_t a[2][4], bb[4];
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
            mk::ldsm_x4(a[mb][0], a[mb][1], a[mb][2], a[mb][3],
                        Am + (mb * 16 + (m & 1) * 8 + r) * Y::LD + ks + (m >> 1) * 8);
          // Matrix m: n block m >> 1, k half m & 1 (B stored [n][k]).
          mk::ldsm_x4(bb[0], bb[1], bb[2], bb[3],
                      Bm + ((m >> 1) * 8 + r) * Y::LD + ks + (m & 1) * 8);
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
              mk::mma_bf16(acc[x][mb][nb], a[mb][0], a[mb][1], a[mb][2], a[mb][3],
                           bb[2 * nb], bb[2 * nb + 1]);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < DHK; ks += 8) {
          // A fragment of m16n8k8: (gid, q4), (gid + 8, q4), (gid, q4 + 4),
          // (gid + 8, q4 + 4); B fragment: (k = q4, n = gid), (q4 + 4, gid).
          uint32_t ab[2][4], as[2][4];
#pragma unroll
          for (int mb = 0; mb < 2; ++mb) {
            const float* p = Am + (mb * 16 + gid) * Y::LD + ks + q4;
            const float af[4] = {p[0], p[8 * Y::LD], p[4], p[8 * Y::LD + 4]};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ab[mb][i] = tf32(af[i]);
              as[mb][i] = tf32(af[i] - __uint_as_float(ab[mb][i]));
            }
          }
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
            const float* p = Bm + (nb * 8 + gid) * Y::LD + ks + q4;
            const float v0 = p[0], v1 = p[4];
            const uint32_t bb0 = tf32(v0), bb1 = tf32(v1);
            const uint32_t bs0 = tf32(v0 - __uint_as_float(bb0));
            const uint32_t bs1 = tf32(v1 - __uint_as_float(bb1));
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) {
              mma_tf32(acc[x][mb][nb], ab[mb], bs0, bs1);
              mma_tf32(acc[x][mb][nb], as[mb], bb0, bb1);
              mma_tf32(acc[x][mb][nb], ab[mb], bb0, bb1);
            }
          }
        }
      }
    }
  }
  mk::cp_wait0();

  // The plane tile's values at the accumulators' positions, all loads in
  // flight before the dots: (mb, nb, half, e) is row i0 + 32 wm + 16 mb +
  // gid + 8 half, column k0 + 16 wn + 8 nb + 2 q4 + e.
  const ST* Ab = static_cast<const ST*>(g.A) + (long long)b * nr * nc;
  const ST* dAb = static_cast<const ST*>(g.dA) + (long long)b * nr * nc;
  float pa[16], pd[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int mb = j >> 3, nb = (j >> 2) & 1, hf = (j >> 1) & 1, e = j & 1;
    const int i = i0 + wm * 32 + mb * 16 + gid + 8 * hf;
    const int k = k0 + wn * 16 + nb * 8 + 2 * q4 + e;
    const bool ok = i < nr && k < nc && !(D & DW_NO_PLANES);
    const long long o = (long long)i * nc + k;
    if constexpr (BF) {
      pa[j] = ok ? __uint_as_float((uint32_t)__ldg(Ab + o) << 16) : 0.f;
      pd[j] = ok ? __uint_as_float((uint32_t)__ldg(dAb + o) << 16) : 0.f;
    } else {
      pa[j] = ok ? __ldg(Ab + o) : 0.f;
      pd[j] = ok ? __ldg(dAb + o) : 0.f;
    }
  }
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int mb = j >> 3, nb = (j >> 2) & 1, f = j & 3;
    const float p = acc[0][mb][nb][f], q = acc[1][mb][nb][f];
    dot[0] = fmaf(pa[j], p, dot[0]);
    dot[1] = fmaf(pd[j], p, dot[1]);
    dot[2] = fmaf(pa[j], q, dot[2]);
    dot[3] = fmaf(pd[j], q, dot[3]);
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float v = mk::warp_sum(dot[x]);
    if (lane == 0) red[warp * 4 + x] = v;
  }
  __syncthreads();
  if (tid < 4) {
    float t = 0.f;
    for (int w = 0; w < NT / 32; ++w) t += red[w * 4 + tid];
    g.part[(((long long)b * gridDim.x + tile) * g.S + s) * 4 + tid] = t;
  }
}

// K6b's launch: grid (plane tiles, S parts of H, B), then the slots summed
// in order into dw (B, 4).
template <typename T, int D = 0>
int launch_pair_dw(const DwArgs& g, float* dw, cudaStream_t stream) {
  constexpr int bytes = DwLay<T>::BYTES;
  static_assert(bytes <= 113 * 1024, "two CTAs an SM");
  static bool allowed[64];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= 64 || !allowed[dev]) {
    err = (int)cudaFuncSetAttribute(pair_dw_kernel<T, D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != 0) return err;
    if (dev < 64) allowed[dev] = true;
  }
  const int tiles = (g.nr + DT - 1) / DT * ((g.nc + DT - 1) / DT);
  pair_dw_kernel<T, D><<<dim3(tiles, g.S, g.B), NT, bytes, stream>>>(g);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  sum_blocks_kernel<<<g.B, 32, 0, stream>>>(g.part, tiles * g.S, dw);
  return (int)cudaGetLastError();
}

// K6b's arguments, or false where the extents, the split or the scratch are
// out of range (S parts of the ceil(H / DHK) column chunks, 1 <= S <= them).
inline bool dw_args(DwArgs& g, const void* A, const void* dA, int nr, int nc, const void* Gr,
                    const void* Mk, const void* Mi, const void* Gc, int B, int H, int S,
                    float* part, int ev) {
  if (B < 1 || nr < 1 || nc < 1 || H < 1 || S < 1 || S > (H + DHK - 1) / DHK || !part)
    return false;
  g = DwArgs{A, dA, {Gr, Mi, Mk, Gc}, part, nr, nc, H, B, S,
             H % ev == 0 && aligned16(Gr) && aligned16(Mi) && aligned16(Mk) &&
                 aligned16(Gc)};
  return true;
}

template <int OP, typename PT, typename VT, int HB, int D = 0>
int launch_sweep(const Args& g, int chunks, cudaStream_t stream) {
  constexpr int bytes = Lay<OP, PT, VT, HB>::BYTES;
  static_assert(bytes <= 113 * 1024, "two CTAs an SM");
  // The shared memory allowance is set once per device.
  static bool allowed[64];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= 64 || !allowed[dev]) {
    err = (int)cudaFuncSetAttribute(sweep_mma_kernel<OP, PT, VT, HB, D>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != 0) return err;
    if (dev < 64) allowed[dev] = true;
  }
  const int nmax = g.nr > g.nc ? g.nr : g.nc;
  sweep_mma_kernel<OP, PT, VT, HB, D>
      <<<dim3((nmax + BO - 1) / BO, 2 * g.S * chunks, g.B), NT, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

// Calls f(HB) with the chunk width of H: the least of 8, 32, 64 that holds
// it, else 64 (in ceil(H / 64) chunks).
template <class F>
int by_chunk(int H, F f) {
  if (H <= 8) return f(std::integral_constant<int, 8>());
  if (H <= 32) return f(std::integral_constant<int, 32>());
  return f(std::integral_constant<int, 64>());
}

inline int chunk_of(int H) { return H <= 8 ? 8 : H <= 32 ? 32 : 64; }

// The part slabs summed into row_out / col_out (S > 1).
inline int finish_parts(const Args& g, cudaStream_t stream) {
  if (g.S == 1) return 0;
  const long long total = (long long)g.B * (g.nr + g.nc) * g.H;
  const long long blocks = (total + 255) / 256;
  sum_parts_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      g.part, g.S, total, (long long)g.B * g.nr * g.H, g.row_out, g.col_out);
  return (int)cudaGetLastError();
}

// Arguments every entry point checks: positive extents, 1 <= S <= the
// reduce tiles of the shorter extent, scratch where S > 1, aligned planes.
inline bool args_ok(const void* A, const void* dA, int nr, int nc, int B, int H, int S,
                    const float* part) {
  const int nmin = nr < nc ? nr : nc;
  return B >= 1 && nr >= 1 && nc >= 1 && H >= 1 && S >= 1 && S <= (nmin + BK - 1) / BK &&
         (S == 1 || part) && aligned16(A) && aligned16(dA);
}

}  // namespace pk
