// The megakernel design probes on Hopper: the kernels that P1, P3, P4 and P5
// need beside K1bf (P2 and P6 need none: P2's three arrangements are K1bf's
// own launch, P6's fused step is K11bf).
//
// Replaces the TPU probe kernels
//   benchmarks/mk_probe.py  make_restructured_kernel / restructured_forward (P1),
//   benchmarks/mk_probe6.py make_kernel(variant) / bg_call (P5: v4mm, v4mm_mt,
//                           v4mm_bf16),
//   benchmarks/mk_probe4.py make_kernel(use_red, no_tr) / bg_call (P3),
//   benchmarks/mk_probe5.py make_kernel(drop) / bg_call (P4, the ablation).
// Each TPU probe keeps one element's n x n operands in VMEM; here, as in K1
// (megakernel_common.cuh), rows are split over CTAs: grid (ceil(n/16), B),
// one prep pass and one pass per layer.
//
// Two families, both undirected basis, bf16 planes, bf16 tensor-core
// products (mma.sync m16n8k16) with f32 sums:
//
// K1-4mm (P1, P5 v4mm*): no B1/B2 builds. A prep pass evaluates A(t), dA(t)
// once per eval and writes them rounded to bf16 (Ah, dAh: 2 n^2 x 2 B an
// element, 0.64 MB at n = 400, zero-padded to a multiple of 32) with the
// f32 row sums and diagonals; each layer's pass then runs four products per
// 16-row block, Ah Mh, dAh Mh (row side: row-major tiles of Ah) and Ah^T Mh,
// dAh^T Mh (column side), combined in f32 with (1 + p1) and p2. The column
// side either reads tiles of Ah in their natural layout and transposes them
// in the fragment load (ldmatrix .trans; v4mm, P1) or forms (Mh^T Ah)^T, Mh^T
// the product's row operand and the tile of Ah its column operand, written
// back transposed (v4mm_mt). v4mm_bf16 evaluates the Hermite in bf16 (every
// product and sum rounded, tau rounded). What bounds it: bytes. The prep
// reads the bf16 planes once (8 n^2 B) and writes Ah, dAh (4 n^2 B); each
// layer re-reads Ah and dAh twice (row and column tiles, 8 n^2 B) -- one
// batch's Ah, dAh (B x 0.64 MB) stay in the 50 MB L2 -- against 8 n^2 H
// tensor-core FLOPs per layer, far below the card's 295 FLOP per byte. The
// design trades K1bf's regeneration of C tiles from four planes per layer
// (8 plane reads and the Hermite per element of C) for one evaluation per
// eval and two bf16 reads per layer.
//
// K1bf's first row pass with the probe flags (P3 red / notr, P4's
// ablations): no code of its own. run_probe launches K1bf's prep_kernel and
// the first row pass, fwd_rows_kernel (megakernel_common.cuh), instantiated
// with the compile-time flags RED, NOTR and D there; P3 current and P4 full
// are the same launches with every flag off, so each ablation reads against
// the pass it ablates (K1bf itself runs the redesigned row pass, rows_body;
// P2, P5 full and P6 follow it). Only those instantiations and
// dma_only's kernel (the plane reads alone) are compiled here, so K1bf's
// build does not grow. It is bound by bytes as K1bf is; the flags move
// work, not bytes, except no_hermite (two planes read) and dma_only (no Z,
// no products).
#include "megakernel_common.cuh"

using namespace mk;

namespace mkp {

// c += Mt[hb .. hb+15][k] T[k][ib .. ib+7] over one BK-deep tile: a 16 x 8
// block of (Mh^T Ah) (rows h, columns i), Mt the row operand (row-major),
// T[k][i] the column operand read by k pairs through the transposing load.
__device__ __forceinline__ void mma_tile_mt(const unsigned short (*Mt)[BKP], int hb,
                                            const unsigned short (*T)[BMP], int ib,
                                            float c[4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = 2 * (lane & 3);
  const int m = (lane >> 3) & 1, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t b0, b1;
    ldsm_x2_t(b0, b1, &T[ks + m * 8 + r][ib]);
    mma_bf16(c, ld_pair(&Mt[hb + g][ks + q]), ld_pair(&Mt[hb + g + 8][ks + q]),
             ld_pair(&Mt[hb + g][ks + q + 8]), ld_pair(&Mt[hb + g + 8][ks + q + 8]), b0, b1);
  }
}

// A(t), dA(t) evaluated in bf16 (mk_probe6.py:52-59): tau rounded, every
// product and sum rounded to bf16 (exact f32 products of bf16 values).
__device__ __forceinline__ void herm_bf16(const Planes<true>& P, long long off, float t,
                                          float& A, float& dA) {
  const float d = ldp(P.d + off), c = ldp(P.c + off);
  const float b = ldp(P.b + off), a = ldp(P.a + off);
  const float tb = rbf(t);
  float x = rbf(__fmul_rn(d, tb));
  x = rbf(__fadd_rn(x, c));
  x = rbf(__fmul_rn(x, tb));
  x = rbf(__fadd_rn(x, b));
  x = rbf(__fmul_rn(x, tb));
  A = rbf(__fadd_rn(x, a));
  float y = rbf(__fmul_rn(3.0f, d));
  y = rbf(__fmul_rn(y, tb));
  y = rbf(__fadd_rn(y, __fmul_rn(2.0f, c)));
  y = rbf(__fmul_rn(y, tb));
  dA = rbf(__fadd_rn(y, b));
}

// Column sums s, w = sum_k v_k M[k, h0 + h] of one chunk into colS/colW
// (megakernel_common.cuh fwd_rows); v(k) gives the rank vector v at row k.
template <class V>
__device__ __forceinline__ void col_sums(const float* Mb, int ldm, int n, int h0, int hc,
                                         V v, float (*red)[NT], float* colS, float* colW) {
  const int tid = threadIdx.x;
  const int nsl = NT / hc, h = tid % hc, sl = tid / hc;
  float s_ = 0.f, w_ = 0.f;
  if (sl < nsl) {
    for (int k = sl; k < n; k += nsl) {
      const float m = Mb[(long long)k * ldm + h0 + h];
      s_ += m;
      w_ += v(k) * m;
    }
  }
  red[0][tid] = s_;
  red[1][tid] = w_;
  __syncthreads();
  if (tid < hc) {
    float ss = 0.f, ww = 0.f;
    for (int s2 = 0; s2 < nsl; ++s2) {
      ss += red[0][s2 * hc + tid];
      ww += red[1][s2 * hc + tid];
    }
    colS[tid] = ss;
    colW[tid] = ww;
  }
  __syncthreads();
}

// ---- K1-4mm ------------------------------------------------------------------

// Prep: one warp per row i of element b (rows up to np, zero beyond n):
// A(t), dA(t) (HB: in bf16) rounded into Ah, dAh (B, np, np); the f32 row
// sums and diagonals into stats (B, 4, n) rows RA, RDA, DGA, DGDA; layer 0's
// M row.
template <bool HB>
__global__ void __launch_bounds__(NT)
prep4_kernel(Planes<true> P, const int* __restrict__ idx, const float* __restrict__ tau,
             int n, int np, const float* __restrict__ Z, int ldz, Layer l0,
             float* __restrict__ M0, int ldm, float* __restrict__ stats,
             unsigned short* __restrict__ Ah, unsigned short* __restrict__ dAh) {
  __shared__ float zn[NW][MAXIN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, r0 = blockIdx.x * BM;
  const long long base = plane_base(P, idx, b, n);
  const float t = __ldg(tau + b);
  float* st = stats + (long long)b * 4 * n;
  for (int i = r0 + warp; i < r0 + BM; i += NW) {
    unsigned short* ra = Ah + ((long long)b * np + i) * np;
    unsigned short* rd = dAh + ((long long)b * np + i) * np;
    if (i >= n) {
      for (int k = lane; k < np; k += 32) ra[k] = rd[k] = 0;
      continue;
    }
    float rA = 0.f, rdA = 0.f, gA = 0.f, gdA = 0.f;
    const long long row = base + (long long)i * n;
    for (int k = lane; k < np; k += 32) {
      float A = 0.f, dA = 0.f;
      if (k < n) {
        if constexpr (HB)
          herm_bf16(P, row + k, t, A, dA);
        else
          herm<true>(P, row + k, t, A, dA);
        rA += A;
        rdA += dA;
        if (k == i) {
          gA = A;
          gdA = dA;
        }
      }
      ra[k] = bf16_bits(A);
      rd[k] = bf16_bits(dA);
    }
    rA = warp_sum(rA);
    rdA = warp_sum(rdA);
    gA = warp_sum(gA);
    gdA = warp_sum(gdA);
    if (lane == 0) {
      st[RA * n + i] = rA;
      st[RDA * n + i] = rdA;
      st[DGA * n + i] = gA;
      st[DGDA * n + i] = gdA;
    }
    transform_row(Z + ((long long)b * n + i) * ldz, l0, zn[warp],
                  M0 + ((long long)b * n + i) * ldm);
  }
}

// One layer for rows r0 .. r0+BM-1 of element b (hout <= HC): the four
// products into Pr, then out = (1 + p1_0) AM + (1 + p1_1) dAM + p2_0 AtM +
// p2_1 dAtM + rank terms (+ relu), and the next layer's M rows.
template <bool MT>
__global__ void __launch_bounds__(NT)
rows4_kernel(const unsigned short* __restrict__ Ah, const unsigned short* __restrict__ dAh,
             int np, int n, const float* __restrict__ stats, Layer lp,
             const float* __restrict__ Mc, int ldm, float* __restrict__ F, int ldf,
             int relu, int has_next, Layer ln, float* __restrict__ Mn, int ldmn) {
  __shared__ __align__(16) unsigned short sRow[2][BM][BKP];  // Ah, dAh rows r0 ..
  __shared__ __align__(16) unsigned short sCol[2][BK][BMP];  // Ah, dAh columns r0 ..
  __shared__ __align__(16) unsigned short Mt[HC][BKP];
  __shared__ float Pr[4][BM][HC + 1];  // AM, dAM, AtM, dAtM
  __shared__ float Fs[BM][HC];
  __shared__ float colS[HC], colW[HC];
  __shared__ float red[2][NT];
  __shared__ float scratch[NW];
  __shared__ float zn[NW][MAXIN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, qq = 2 * (lane & 3);
  const int b = blockIdx.y, r0 = blockIdx.x * BM, H = lp.hout;
  const float fn = (float)n, fn2 = fn * fn;
  const float* st = stats + (long long)b * 4 * n;
  const float* rA = st + RA * n;
  const float* rdA = st + RDA * n;
  const float* Mb = Mc + (long long)b * n * ldm;
  const unsigned short* Ab[2] = {Ah + (long long)b * np * np, dAh + (long long)b * np * np};
  float q[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) q[k] = __ldg(lp.basis + k);

  float a0 = 0.f, a1 = 0.f;
  for (int k = tid; k < n; k += NT) {
    a0 += rA[k];
    a1 += rdA[k];
  }
  const float sA = block_sum(a0, scratch);
  const float sdA = block_sum(a1, scratch);
  const float c7 = (q[12] + q[13]) * sA / fn2;
  const float c8 = (q[14] * sA + q[15] * sdA) / fn2;
  col_sums(Mb, ldm, n, 0, H, [&](int k) { return (q[8] * rA[k] + q[9] * rdA[k]) / fn; }, red,
           colS, colW);

  float c[4][4] = {};
  const int nb0 = warp * 8;
  const int ncombo = 4 * ((H + 15) / 16);  // mt: (h tile, i half, plane) blocks
  for (int k0 = 0; k0 < n; k0 += BK) {
    // Row tiles: BM rows x BK halves of Ah, dAh (16-byte loads; np pads k).
    for (int e = tid; e < 2 * BM * (BK / 8); e += NT) {
      const int p = e / (BM * (BK / 8)), rem = e % (BM * (BK / 8));
      const int i = rem / (BK / 8), v = rem % (BK / 8);
      *reinterpret_cast<uint4*>(&sRow[p][i][v * 8]) = *reinterpret_cast<const uint4*>(
          Ab[p] + (long long)(r0 + i) * np + k0 + v * 8);
    }
    // Column tiles: BK rows (k) x BM halves (i), in their natural layout.
    for (int e = tid; e < 2 * BK * (BM / 8); e += NT) {
      const int p = e / (BK * (BM / 8)), rem = e % (BK * (BM / 8));
      const int kk = rem / (BM / 8), v = rem % (BM / 8);
      *reinterpret_cast<uint4*>(&sCol[p][kk][v * 8]) = *reinterpret_cast<const uint4*>(
          Ab[p] + (long long)(k0 + kk) * np + r0 + v * 8);
    }
    for (int e = tid; e < BK * HC; e += NT) {
      const int kk = e / HC, h = e % HC, gk = k0 + kk;
      Mt[h][kk] = bf16_bits(gk < n && h < H ? Mb[(long long)gk * ldm + h] : 0.f);
    }
    __syncthreads();
    if (nb0 < H) {
      mma_tile(sRow[0], Mt, nb0, c[0]);
      mma_tile(sRow[1], Mt, nb0, c[1]);
      if constexpr (!MT) {
        mma_tile_t(sCol[0], Mt, nb0, c[2]);
        mma_tile_t(sCol[1], Mt, nb0, c[3]);
      }
    }
    if constexpr (MT) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int cb = warp + j * NW;
        if (cb < ncombo)
          mma_tile_mt(Mt, (cb >> 2) * 16, sCol[cb & 1], ((cb >> 1) & 1) * 8, c[2 + j]);
      }
    }
    __syncthreads();
  }
  if (nb0 < H) {
#pragma unroll
    for (int p = 0; p < (MT ? 2 : 4); ++p) {
      Pr[p][g][nb0 + qq] = c[p][0];
      Pr[p][g][nb0 + qq + 1] = c[p][1];
      Pr[p][g + 8][nb0 + qq] = c[p][2];
      Pr[p][g + 8][nb0 + qq + 1] = c[p][3];
    }
  }
  if constexpr (MT) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cb = warp + j * NW;
      if (cb < ncombo) {
        const int p = 2 + (cb & 1), ib = ((cb >> 1) & 1) * 8 + qq, hb = (cb >> 2) * 16 + g;
        Pr[p][ib][hb] = c[2 + j][0];
        Pr[p][ib + 1][hb] = c[2 + j][1];
        Pr[p][ib][hb + 8] = c[2 + j][2];
        Pr[p][ib + 1][hb + 8] = c[2 + j][3];
      }
    }
  }
  __syncthreads();

  const float b10 = 1.f + q[0], b11 = 1.f + q[1], b20 = q[2], b21 = q[3];
  for (int pp = tid; pp < BM * H; pp += NT) {
    const int i = pp / H, h = pp % H, gi = r0 + i;
    float val = 0.f;
    if (gi < n) {
      const float dvec = q[4] * st[DGA * n + gi] + q[5] * st[DGDA * n + gi] +
                         (q[10] * rA[gi] + q[11] * rdA[gi]) / fn + c8 + 1.f;
      const float u = (q[6] * rA[gi] + q[7] * rdA[gi]) / fn;
      const float m = Mb[(long long)gi * ldm + h];
      const float rowpart = b10 * Pr[0][i][h] + b11 * Pr[1][i][h];
      const float colpart = b20 * Pr[2][i][h] + b21 * Pr[3][i][h];
      val = rowpart + colpart + dvec * m + u * colS[h] + (colW[h] + c7 * colS[h]);
      if (relu) val = fmaxf(val, 0.f);
      if (F != nullptr) F[((long long)b * n + gi) * ldf + h] = val;
    }
    Fs[i][h] = val;
  }
  if (has_next) {
    __syncthreads();
    for (int i = warp; i < BM; i += NW) {
      const int gi = r0 + i;
      if (gi < n) transform_row(Fs[i], ln, zn[warp], Mn + ((long long)b * n + gi) * ldmn);
    }
  }
}

template <bool MT, bool HB>
int run4mm(const Planes<true>& P, const int* idx, const float* tau, const float* Z, int B,
           int n, int L, const int* dims, const void* const* ptrs, unsigned short* Ah,
           unsigned short* dAh, int np, float* stats, float* Mbuf, int ldm, float* out,
           cudaStream_t stream) {
  const long long mstride = (long long)B * n * ldm;
  prep4_kernel<HB><<<dim3(np / BM, B), NT, 0, stream>>>(
      P, idx, tau, n, np, Z, dims[0], layer_from(ptrs, dims, 0), Mbuf, ldm, stats, Ah, dAh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BM - 1) / BM, B);
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const Layer lp = layer_from(ptrs, dims, l);
    const Layer ln = last ? lp : layer_from(ptrs, dims, l + 1);
    rows4_kernel<MT><<<grid, NT, 0, stream>>>(
        Ah, dAh, np, n, stats, lp, Mbuf + l * mstride, ldm, last ? out : nullptr,
        dims[2 * l + 1], last ? 0 : 1, last ? 0 : 1, ln,
        last ? nullptr : Mbuf + (l + 1) * mstride, ldm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---- K1bf with the probe flags ---------------------------------------------------

// dma_only: each output row is the row sum of d + c + b + a, on every column.
__global__ void __launch_bounds__(NT)
dma_only_kernel(Planes<true> P, const int* __restrict__ idx, int n, int hout,
                float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y, r0 = blockIdx.x * BM;
  const long long base = plane_base(P, idx, b, n);
  const int rend = min(r0 + BM, n);
  for (int i = r0 + warp; i < rend; i += NW) {
    const long long row = base + (long long)i * n;
    float s = 0.f;
    for (int k = lane; k < n; k += 32)
      s += ((ldp(P.d + row + k) + ldp(P.c + row + k)) + ldp(P.b + row + k)) +
           ldp(P.a + row + k);
    s = warp_sum(s);
    for (int h = lane; h < hout; h += 32) out[((long long)b * n + i) * hout + h] = s;
  }
}

// One eval of K1bf's first passes (megakernel_common.cuh prep_kernel,
// fwd_rows_kernel at BF, undirected) with the flags D, RED and NOTR (all off:
// P3 current, P4 full), under RED the (B, n, 4) operand rvec in place of the
// stats buffer.
template <int D, bool RED, bool NOTR>
int run_probe(const Planes<true>& P, const int* idx, const float* tau, const float* Z, int B,
              int n, int L, const int* dims, const void* const* ptrs, const float* rvec,
              float* stats, float* Mbuf, int ldm, float* out, cudaStream_t stream) {
  const dim3 grid((n + BM - 1) / BM, B);
  const long long mstride = (long long)B * n * ldm;
  prep_kernel<false, true, D, RED><<<grid, NT, 0, stream>>>(
      P, idx, tau, n, Z, dims[0], layer_from(ptrs, dims, 0), Mbuf, ldm, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* S = RED ? rvec : stats;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const Layer lp = layer_from(ptrs, dims, l);
    const Layer ln = last ? lp : layer_from(ptrs, dims, l + 1);
    fwd_rows_kernel<false, true, D, RED, NOTR><<<grid, NT, 0, stream>>>(
        P, idx, tau, n, S, lp, Mbuf + l * mstride, ldm, last ? out : nullptr,
        dims[2 * l + 1], last ? 0 : 1, last ? 0 : 1, ln,
        last ? nullptr : Mbuf + (l + 1) * mstride, ldm);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

Planes<true> bf16_planes(const void* d, const void* c, const void* b, const void* a,
                         long long bstride) {
  return Planes<true>{static_cast<const bf16*>(d), static_cast<const bf16*>(c),
                      static_cast<const bf16*>(b), static_cast<const bf16*>(a), bstride};
}

}  // namespace mkp

using namespace mkp;

// K1-4mm: planes bf16; mt selects the (Mh^T Ah)^T column side, hbf the bf16
// Hermite (not both); Ah, dAh (B, np, np) bf16 scratch, np >= n a multiple
// of 32; stats (B, 4, n); Mbuf L (B, n, ldm) buffers (layer l's M in the
// l-th); every layer's output at most HC wide. Returns the first CUDA error.
extern "C" int gncde_mk4mm(const void* d, const void* c, const void* b, const void* a,
                           long long plane_bstride, const int* idx, const float* tau,
                           const float* Z, int B, int n, int L, const int* dims,
                           const void* const* ptrs, int mt, int hbf, unsigned short* Ah,
                           unsigned short* dAh, int np, float* stats, float* Mbuf, int ldm,
                           float* out, cudaStream_t stream) {
  if (L < 1 || B < 1 || n < 1 || np < n || np % 32 != 0 || !dims_ok(dims, L, ldm))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (dims[2 * l + 1] > HC) return (int)cudaErrorInvalidValue;
  const Planes<true> P = bf16_planes(d, c, b, a, plane_bstride);
  if (mt && hbf) return (int)cudaErrorInvalidValue;
  if (mt)
    return run4mm<true, false>(P, idx, tau, Z, B, n, L, dims, ptrs, Ah, dAh, np, stats, Mbuf,
                               ldm, out, stream);
  if (hbf)
    return run4mm<false, true>(P, idx, tau, Z, B, n, L, dims, ptrs, Ah, dAh, np, stats, Mbuf,
                               ldm, out, stream);
  return run4mm<false, false>(P, idx, tau, Z, B, n, L, dims, ptrs, Ah, dAh, np, stats, Mbuf,
                              ldm, out, stream);
}

// K1bf's first passes with the probe flags: planes bf16; drop one of
// mk_probe5.py's ablations (DMA_ONLY launches only dma_only_kernel); red
// (rvec (B, n, 4)) and notr only with FULL (FULL alone: every flag off, P3
// current and P4 full); no_norm needs square layers. stats (B, NSTAT, n);
// Mbuf as for K1bf. Returns the first CUDA error.
extern "C" int gncde_mkprobe(const void* d, const void* c, const void* b, const void* a,
                             long long plane_bstride, const int* idx, const float* tau,
                             const float* Z, int B, int n, int L, const int* dims,
                             const void* const* ptrs, int drop, int red, int notr,
                             const float* rvec, float* stats, float* Mbuf, int ldm,
                             float* out, cudaStream_t stream) {
  if (L < 1 || B < 1 || n < 1 || !dims_ok(dims, L, ldm) || drop < FULL || drop > DMA_ONLY)
    return (int)cudaErrorInvalidValue;
  if ((red || notr) && drop != FULL) return (int)cudaErrorInvalidValue;
  if (red && rvec == nullptr) return (int)cudaErrorInvalidValue;
  if (drop == NO_NORM)
    for (int l = 0; l < L; ++l)
      if (dims[2 * l] != dims[2 * l + 1]) return (int)cudaErrorInvalidValue;
  const Planes<true> P = bf16_planes(d, c, b, a, plane_bstride);
#define RUN(D_, RED_, NOTR_)                                                                 \
  return run_probe<D_, RED_, NOTR_>(P, idx, tau, Z, B, n, L, dims, ptrs, rvec, stats, Mbuf, \
                                    ldm, out, stream)
  if (red && notr) RUN(FULL, true, true);
  if (red) RUN(FULL, true, false);
  if (notr) RUN(FULL, false, true);
  switch (drop) {
    case FULL: RUN(FULL, false, false);
    case NO_HERMITE: RUN(NO_HERMITE, false, false);
    case NO_REDUCE: RUN(NO_REDUCE, false, false);
    case NO_TRANSPOSE: RUN(NO_TRANSPOSE, false, false);
    case NO_BBUILD: RUN(NO_BBUILD, false, false);
    case NO_ROWMM: RUN(NO_ROWMM, false, false);
    case NO_COLMM: RUN(NO_COLMM, false, false);
    case NO_NORM: RUN(NO_NORM, false, false);
    case NO_GLUE: RUN(NO_GLUE, false, false);
    default: {
      const dim3 grid((n + BM - 1) / BM, B);
      dma_only_kernel<<<grid, NT, 0, stream>>>(P, idx, n, dims[2 * L - 1], out);
      return (int)cudaGetLastError();
    }
  }
#undef RUN
}
