// K2: the fused backward of one vector-field eval of the perm-equiv field,
// on the undirected 8-term basis or the directed 11-term one.
//
// Replaces gncde_tpu/ops/pallas/megakernel_bwd.py (_make_bwd_kernel /
// bwd_call / bwd_call_batched, both values of its ``directed`` flag),
// which holds about 38 n^2 bytes per eval in
// one TensorCore's VMEM. Here the forward is recomputed by K1's own row
// pass on K1's plan (megakernel_common.cuh rows_kernel; K2bf: fwd_rows),
// so M_l and x_l are K1's bit for bit, keeping each layer's M and input x in
// device memory ((L, B, n, H) floats of scratch), then one row pass per
// layer walks the stack in reverse.
//
// The f32 kernels (K2, K2d) run the reverse sweep of bwd_sweep.cuh on a
// plan of their own per layer (ops/megakernel_bwd.py bwd_row_plan): each
// CTA forms its rows of C^T and of the planes' values once a layer, M's
// and g's tiles come through a cp.async ring, and the basis cotangents are
// inner products of A, dA (ddA) with P = g M^T.
//
// K2bf (BF, _make_bwd_kernel(bf16=True)), bwd_rows_kernel below: for its BM
// rows a CTA regenerates the row and column tiles of A and dA (and ddA when
// tau needs a gradient) from the planes and accumulates, in one sweep over
// k,
//
//   C^T g  (the dM operand),  A M, dA M, A g, dA g  (the basis dots),
//   ddA M, ddA g                                     (only for dtau),
//
// so the basis cotangents <A, g M^T>, <A, M g^T>, ... come out as row dots
// instead of n x n products. A wide layer (output > HC = 64) repeats the
// sweep per chunk of HC output columns, summing dz = dM W, the row dots and
// the basis dots over the chunks and writing its chunk's rows of dW and
// dlin_b; up to 64 columns it is one chunk, in the unchunked order. dW, dlin_b, dnorm and the basis terms are
// written as per-CTA partial sums and reduced over CTAs in a second pass
// (deterministic, no atomics). The per-element parameter cotangents are
// summed over the batch by the wrapper, as the JAX side does.
//
// The directed basis (DIR) changes only O(n) terms: the recomputed forward
// reads the column sums of K1's directed prep pass, and the rank-term
// cotangents (p4 .. p6', megakernel_bwd.py:249-268) and the directed dtau
// chain (:292-302) are row dots against the column sums cA, cdA, cddA
// beside the row sums. The reduction vector's basis block grows from 16 to
// 22 entries.
//
// K2bf's planes are bfloat16, the forward recomputed as K1bf computes it;
// per layer C^T = ((b1_0 Ah^T + b1_1 dAh^T)
// + b2_0 Ah) + b2_1 dAh is formed in bf16 in that order (each product and
// sum rounded) and dM's product C^T gb runs on the tensor cores with g
// rounded to bf16; the basis dots <A|dA|ddA, gb Mb^T> keep the f32 planes
// and take g and M rounded (P and Q of the JAX kernel are products of the
// rounded g and M), multiplied in f32. Everything else is f32. What bounds
// it on the card: bytes, 4 plane reads per tile element per layer and
// chunk (6 with ddA), mostly from L2.
#include "bwd_sweep.cuh"

using namespace mk;

template <bool TAU, bool DIR, bool BF>
__global__ void __launch_bounds__(NT)
bwd_rows_kernel(Planes<BF> P, const int* __restrict__ idx,
                const float* __restrict__ tau, int n,
                const float* __restrict__ stats, Layer lp,
                const float* __restrict__ X, int ldx,
                const float* __restrict__ Mc, int ldm,
                const float* __restrict__ G, int ldg, float* __restrict__ Gp,
                int ldgp, int mask_prev, float* __restrict__ part, int ptot,
                int poff) {
  static_assert(BF, "the f32 sweep is bwd_sweep_kernel (bwd_sweep.cuh)");
  __shared__ float Ar[BM][BK + 1];
  __shared__ float dAr[BM][BK + 1];
  __shared__ float ddAr[TAU ? BM : 1][BK + 1];
  __shared__ float Ms[BK][HC];
  __shared__ float Gs[BK][HC];
  __shared__ float dMs[BM][HC];
  __shared__ float znS[BM][MAXIN];
  __shared__ float dznS[BM][MAXIN];
  __shared__ float invS[BM];
  __shared__ float rowd[BM][3];  // per row: g . m, g . colS, m . colG
  __shared__ float colS[HC], colG[HC], colU[HC];
  __shared__ float red[3][NT];
  __shared__ float scratch[NW];
  constexpr int NWR = DIR ? 14 : 10;  // per-warp row dots (below)
  __shared__ float wred[NW][NWR];

  const int b = blockIdx.y, r0 = blockIdx.x * BM, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int H = lp.hout, hin = lp.hin;
  const float fn = (float)n, fn2 = fn * fn;
  const long long base = plane_base(P, idx, b, n);
  const float t = __ldg(tau + b);
  const float* st = stats + (long long)b * NSTAT * n;
  const float* rA = st + RA * n;
  const float* rdA = st + RDA * n;
  const float* Mb = Mc + (long long)b * n * ldm;
  const float* Gb = G + (long long)b * n * ldg;
  constexpr int NQ = 2 * nbasis<DIR>();
  float q[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) q[k] = __ldg(lp.basis + k);

  // Global sums every CTA needs: sA, sdA, sddA.
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int k = tid; k < n; k += NT) {
    a0 += rA[k];
    a1 += rdA[k];
    if (TAU) a2 += st[RDDA * n + k];
  }
  const float sA = block_sum(a0, scratch);
  const float sdA = block_sum(a1, scratch);
  const float sddA = TAU ? block_sum(a2, scratch) : 0.f;

  // One warp per row: the row's normalised input zn and 1/rms; dz and the
  // row dots start at zero and are summed over the output chunks.
  for (int i = warp; i < BM; i += NW) {
    const int gi = r0 + i;
    if (lane < 3) rowd[i][lane] = 0.f;
    if (gi >= n) {
      for (int j = lane; j < MAXIN; j += 32) {
        znS[i][j] = 0.f;
        dznS[i][j] = 0.f;
      }
      if (lane == 0) invS[i] = 0.f;
      continue;
    }
    const float* x = X + ((long long)b * n + gi) * ldx;
    float ss = 0.f;
    for (int j = lane; j < hin; j += 32) ss += x[j] * x[j];
    ss = warp_sum(ss);
    const float inv = rsqrtf(ss / (float)hin + EPS);
    for (int j = lane; j < hin; j += 32) {
      znS[i][j] = x[j] * inv * __ldg(lp.nw + j) + __ldg(lp.nb + j);
      dznS[i][j] = 0.f;
    }
    if (lane == 0) invS[i] = inv;
  }

  const float b10 = 1.f + q[0], b11 = 1.f + q[1], b20 = q[2], b21 = q[3];
  float c7, c8;
  if constexpr (DIR) {
    c7 = (q[18] + q[19]) * sA / fn2;
    c8 = (q[20] * sA + q[21] * sdA) / fn2;
  } else {
    c7 = (q[12] + q[13]) * sA / fn2;
    c8 = (q[14] * sA + q[15] * sdA) / fn2;
  }
  float* pout = part + ((long long)b * gridDim.x + blockIdx.x) * ptot + poff;
  const int rend = min(BM, n - r0);
  float tp1a = 0.f, tp1b = 0.f, tp2a = 0.f, tp2b = 0.f, tddP = 0.f, tddQ = 0.f;
  float dc7 = 0.f;

  for (int h0 = 0; h0 < H; h0 += HC) {
    const int hc = min(HC, H - h0);
    // The chunk's column sums: s = 1^T M, gcol = 1^T g, utg = u^T g (the
    // previous chunk has read colS/colG/dMs before this barrier).
    __syncthreads();
    {
      const int nsl = NT / hc, h = tid % hc, sl = tid / hc;
      float s_ = 0.f, g_ = 0.f, u_ = 0.f;
      if (sl < nsl) {
        for (int k = sl; k < n; k += nsl) {
          const float m = Mb[(long long)k * ldm + h0 + h];
          const float g = Gb[(long long)k * ldg + h0 + h];
          float u;
          if constexpr (DIR)
            u = dir_u(q, st, n, k, fn);
          else
            u = (q[6] * rA[k] + q[7] * rdA[k]) / fn;
          s_ += m;
          g_ += g;
          u_ += u * g;
        }
      }
      red[0][tid] = s_;
      red[1][tid] = g_;
      red[2][tid] = u_;
      __syncthreads();
      if (tid < hc) {
        float x0 = 0.f, x1 = 0.f, x2 = 0.f;
        for (int s2 = 0; s2 < nsl; ++s2) {
          x0 += red[0][s2 * hc + tid];
          x1 += red[1][s2 * hc + tid];
          x2 += red[2][s2 * hc + tid];
        }
        colS[tid] = x0;
        colG[tid] = x1;
        colU[tid] = x2;
      }
      __syncthreads();
    }

    float aDM[PPT], aAM[PPT], adAM[PPT], aAg[PPT], adAg[PPT], addAM[PPT],
        addAg[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j)
      aDM[j] = aAM[j] = adAM[j] = aAg[j] = adAg[j] = addAM[j] = addAg[j] = 0.f;

    {
      // Row tiles of A, dA (ddA) in f32 and the chunk's M and g rounded to
      // bf16 (held in f32) for the basis dots; g's bit patterns transposed
      // as the MMA's right operand; then C^T in bf16 from the column tiles
      // and the row tiles. dM's product accumulates per warp and is staged
      // through dMs (each thread reads its own pairs back).
      __shared__ __align__(16) unsigned short CopS[BM][BKP];
      __shared__ __align__(16) unsigned short Gt[HC][BKP];
      const float cb0 = rbf(b10), cb1 = rbf(b11), cb2 = rbf(b20), cb3 = rbf(b21);
      const int nb0 = warp * 8;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < n; k0 += BK) {
        for (int e = tid; e < BM * BK; e += NT) {
          const int i = e / BK, kk = e % BK, gi = r0 + i, gk = k0 + kk;
          float A = 0.f, dA = 0.f, ddA = 0.f;
          if (gi < n && gk < n) {
            const long long off = base + (long long)gi * n + gk;
            if (TAU)
              herm3(P, off, t, A, dA, ddA);
            else
              herm(P, off, t, A, dA);
          }
          Ar[i][kk] = A;
          dAr[i][kk] = dA;
          if (TAU) ddAr[i][kk] = ddA;
        }
        for (int e = tid; e < BK * HC; e += NT) {
          const int kk = e / HC, h = e % HC, gk = k0 + kk;
          const bool ok = gk < n && h < hc;
          const float g = ok ? rbf(Gb[(long long)gk * ldg + h0 + h]) : 0.f;
          Ms[kk][h] = ok ? rbf(Mb[(long long)gk * ldm + h0 + h]) : 0.f;
          Gs[kk][h] = g;
          Gt[h][kk] = bf16_bits(g);
        }
        __syncthreads();
        for (int e = tid; e < BM * BK; e += NT) {
          const int kk = e / BM, i = e % BM, gi = r0 + i, gk = k0 + kk;
          float v = 0.f;
          if (gi < n && gk < n) {
            float A, dA;
            herm(P, base + (long long)gk * n + gi, t, A, dA);
            v = rbf(__fadd_rn(bmul(cb0, A), bmul(cb1, dA)));
            v = rbf(__fadd_rn(v, bmul(cb2, Ar[i][kk])));
            v = __fadd_rn(v, bmul(cb3, dAr[i][kk]));
          }
          CopS[i][kk] = bf16_bits(v);
        }
        __syncthreads();
        if (nb0 < hc) mma_tile(CopS, Gt, nb0, c);
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const int pp = tid + j * NT;
          if (pp < BM * hc) {
            const int i = pp / hc, h = pp % hc;
            float x1 = aAM[j], x2 = adAM[j], x3 = aAg[j], x4 = adAg[j];
            float x5 = addAM[j], x6 = addAg[j];
#pragma unroll 4
            for (int kk = 0; kk < BK; ++kk) {
              const float g = Gs[kk][h], m = Ms[kk][h];
              const float ar = Ar[i][kk], dar = dAr[i][kk];
              x1 += ar * m;
              x2 += dar * m;
              x3 += ar * g;
              x4 += dar * g;
              if (TAU) {
                const float ddar = ddAr[i][kk];
                x5 += ddar * m;
                x6 += ddar * g;
              }
            }
            aAM[j] = x1;
            adAM[j] = x2;
            aAg[j] = x3;
            adAg[j] = x4;
            addAM[j] = x5;
            addAg[j] = x6;
          }
        }
        __syncthreads();
      }
      if (nb0 < hc) mma_store(c, nb0, dMs);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int pp = tid + j * NT;
        if (pp < BM * hc) aDM[j] = dMs[pp / hc][pp % hc];
      }
    }

    // The chunk's dM rows and matmul-part basis dots.
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int pp = tid + j * NT;
      if (pp < BM * hc) {
        const int i = pp / hc, h = pp % hc, gi = r0 + i;
        float dm = 0.f;
        if (gi < n) {
          const long long o = (long long)gi * ldm + h0 + h;
          const float g = Gb[(long long)gi * ldg + h0 + h];
          const float m = Mb[o];
          float gq = g, mq = m;  // the dots' rounded g and M (BF)
          if constexpr (BF) {
            gq = rbf(g);
            mq = rbf(m);
          }
          tp1a += gq * aAM[j];
          tp1b += gq * adAM[j];
          tp2a += mq * aAg[j];
          tp2b += mq * adAg[j];
          if (TAU) {
            tddP += gq * addAM[j];
            tddQ += mq * addAg[j];
          }
          float dvec, v;
          if constexpr (DIR) {
            dvec = dir_dvec(q, st, n, gi, fn, c8);
            v = dir_v(q, st, n, gi, fn);
          } else {
            dvec = q[4] * st[DGA * n + gi] + q[5] * st[DGDA * n + gi] +
                   (q[10] * rA[gi] + q[11] * rdA[gi]) / fn + c8 + 1.f;
            v = (q[8] * rA[gi] + q[9] * rdA[gi]) / fn;
          }
          dm = aDM[j] + dvec * g + colU[h] + v * colG[h] + c7 * colG[h];
        }
        dMs[i][h] = dm;
      }
    }
    __syncthreads();

    // One warp per row: the chunk's part of the row dots and of
    // dz = dM W (Linear backward).
    for (int i = warp; i < BM; i += NW) {
      const int gi = r0 + i;
      if (gi >= n) continue;
      float gm = 0.f, du = 0.f, dv = 0.f;
      for (int h = lane; h < hc; h += 32) {
        const float g = Gb[(long long)gi * ldg + h0 + h];
        const float m = Mb[(long long)gi * ldm + h0 + h];
        gm += g * m;
        du += g * colS[h];
        dv += m * colG[h];
      }
      gm = warp_sum(gm);
      du = warp_sum(du);
      dv = warp_sum(dv);
      if (lane == 0) {
        rowd[i][0] += gm;
        rowd[i][1] += du;
        rowd[i][2] += dv;
      }
      for (int j = lane; j < hin; j += 32) {
        float dz = dznS[i][j];
        for (int h = 0; h < hc; ++h)
          dz += dMs[i][h] * __ldg(lp.W + (long long)(h0 + h) * hin + j);
        dznS[i][j] = dz;
      }
    }

    // Per-CTA partials of this chunk's rows of dW (hout x hin) and dlin_b.
    for (int e = tid; e < hc * hin; e += NT) {
      const int h = e / hin, j = e % hin;
      float acc = 0.f;
      for (int i = 0; i < rend; ++i) acc += dMs[i][h] * znS[i][j];
      pout[2 * hin + h0 * hin + e] = acc;
    }
    for (int h = tid; h < hc; h += NT) {
      float acc = 0.f;
      for (int i = 0; i < rend; ++i) acc += dMs[i][h];
      pout[2 * hin + H * hin + h0 + h] = acc;
    }
    if (tid == 0)
      for (int h = 0; h < hc; ++h) dc7 += colG[h] * colS[h];
  }
  __syncthreads();
  tp1a = block_sum(tp1a, scratch);
  tp1b = block_sum(tp1b, scratch);
  tp2a = block_sum(tp2a, scratch);
  tp2b = block_sum(tp2b, scratch);
  if (TAU) {
    tddP = block_sum(tddP, scratch);
    tddQ = block_sum(tddQ, scratch);
  }

  // One warp per row: rank-term dots, RMSNorm backward, g_prev. The row
  // dots gm = g . m, du = g . colS, dv = m . colG against the row's O(n)
  // statistics; undirected w[0 .. 9]: gm, gm dgA, gm dgdA, du rA, du rdA,
  // dv rA, dv rdA, gm rA, gm rdA, the dtau part; directed w[0 .. 13]: gm,
  // gm dgA, gm dgdA, du cA, du cdA, dv rA, dv cdA, dv cA, dv rdA, gm cA,
  // gm cdA, gm rA, gm rdA, the dtau part.
  float w[NWR];
#pragma unroll
  for (int k = 0; k < NWR; ++k) w[k] = 0.f;
  for (int i = warp; i < BM; i += NW) {
    const int gi = r0 + i;
    if (gi >= n) continue;
    const float gm = rowd[i][0], du = rowd[i][1], dv = rowd[i][2];
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
      if (TAU) {
        // megakernel_bwd.py:292-302: the tau derivatives of dvec, u, v.
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
      if (TAU) {
        const float rddAi = st[RDDA * n + gi], dgddA = st[DGDDA * n + gi];
        const float ddvec = q[4] * dgdA + q[5] * dgddA +
                            (q[10] * rdAi + q[11] * rddAi) / fn +
                            (q[14] * sdA + q[15] * sddA) / fn2;
        const float du_dt = (q[6] * rdAi + q[7] * rddAi) / fn;
        const float dv_dt = (q[8] * rdAi + q[9] * rddAi) / fn;
        w[9] += gm * ddvec + du * du_dt + dv * dv_dt;
      }
    }

    const float* x = X + ((long long)b * n + gi) * ldx;
    const float inv = invS[i];
    float hx = 0.f;
    for (int j = lane; j < hin; j += 32) hx += dznS[i][j] * __ldg(lp.nw + j) * x[j];
    hx = warp_sum(hx);
    const float k3 = inv * inv * inv / (float)hin;
    for (int j = lane; j < hin; j += 32) {
      const float xj = x[j];
      float gp = dznS[i][j] * __ldg(lp.nw + j) * inv - xj * k3 * hx;
      if (mask_prev && !(xj > 0.f)) gp = 0.f;
      Gp[((long long)b * n + gi) * ldgp + j] = gp;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NWR; ++k) wred[warp][k] = w[k];
  }
  __syncthreads();

  // Per-CTA partials: [dnorm_w (hin) | dnorm_b (hin) | dW (H*hin, written
  // above) | dlin_b (H, above) | dbasis (16, or 22 directed) | dtau (1)].
  for (int j = tid; j < hin; j += NT) {
    float dw = 0.f, db = 0.f;
    for (int i = 0; i < rend; ++i) {
      const float xj = X[((long long)b * n + r0 + i) * ldx + j];
      dw += dznS[i][j] * xj * invS[i];
      db += dznS[i][j];
    }
    pout[j] = dw;
    pout[hin + j] = db;
  }
  if (tid == 0) {
    float tot[NWR];
    for (int k = 0; k < NWR; ++k) {
      tot[k] = 0.f;
      for (int ww = 0; ww < NW; ++ww) tot[k] += wred[ww][k];
    }
    const bool first = blockIdx.x == 0;
    float* db = pout + 2 * hin + H * hin + H;
    db[0] = tp1a;
    db[1] = tp1b;
    db[2] = tp2a;
    db[3] = tp2b;
    db[4] = tot[1];
    db[5] = tot[2];
    float dtau = 0.f;
    if constexpr (DIR) {
      // megakernel_bwd.py:249-268: p4 (du . cA, du . cdA), p4' (dv . rA,
      // dv . cdA), p5 (dv . cA, dv . cdA), p5' (dv . rA, dv . rdA), p6
      // (gm . cA, gm . cdA), p6' (gm . rA, gm . rdA), each over n.
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
      if (TAU) {
        dtau = (1.f + q[0]) * tp1b + (1.f + q[1]) * tddP + q[2] * tp2b +
               q[3] * tddQ + tot[13];
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
      if (TAU) {
        dtau = (1.f + q[0]) * tp1b + (1.f + q[1]) * tddP + q[2] * tp2b +
               q[3] * tddQ + tot[9];
        if (first) dtau += dc7 * (q[12] + q[13]) * sdA / fn2;
      }
      db[16] = dtau;
    }
  }
}

__global__ void reduce_blocks_kernel(const float* __restrict__ part, int nblk,
                                     int ptot, float* __restrict__ out) {
  const int b = blockIdx.y, p = blockIdx.x * NT + threadIdx.x;
  if (p >= ptot) return;
  float acc = 0.f;
  for (int k = 0; k < nblk; ++k) acc += part[((long long)b * nblk + k) * ptot + p];
  out[(long long)b * ptot + p] = acc;
}

// Layer l's partial block has 2*hin + hout*hin + hout + 2*nb + 1 floats
// (nb basis 2-vectors and dtau).
static int layer_ptot(const int* dims, int l, int nb) {
  const int hin = dims[2 * l], hout = dims[2 * l + 1];
  return 2 * hin + hout * hin + hout + 2 * nb + 1;
}

// K2bf: Mbuf, Xbuf: (L, B, n, ldm) scratch for the recomputed forward
// (Xbuf[0] unused: layer 0 reads Z), ldm >= every layer's width. gbuf: (L,
// B, n, ldm), gbuf[l] the masked cotangent of x_l for l >= 1 (gbuf[0]
// unused: layer 0 writes dZ), so the caller can read every layer's inputs
// back. stats: (B, NSTAT, n). part: (B, nblk, ptot) partials; red: (B,
// ptot) reduced per-element grads, layer blocks in order. dZ: (B, n, hin0).
template <bool DIR>
static int mk_bwd_bf16(const Planes<true>& P, const int* idx, const float* tau, const float* Z,
                       const float* G, int B, int n, int L, const int* dims,
                       const void* const* ptrs, int need_tau, float* stats, float* Mbuf,
                       float* Xbuf, float* gbuf, int ldm, float* dZ, float* part, int ptot,
                       float* red, cudaStream_t stream) {
  const int nblk = (n + BM - 1) / BM;
  const dim3 grid(nblk, B);
  const long long lstride = (long long)B * n * ldm;
  cudaError_t err;

  // Forward recompute: M_l for every layer, x_l for l >= 1.
  prep_kernel<DIR, true><<<grid, NT, 0, stream>>>(P, idx, tau, n, Z, dims[0],
                                                  layer_from(ptrs, dims, 0), Mbuf, ldm, stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int l = 0; l + 1 < L; ++l) {
    fwd_rows_kernel<DIR, true><<<grid, NT, 0, stream>>>(
        P, idx, tau, n, stats, layer_from(ptrs, dims, l), Mbuf + l * lstride, ldm,
        Xbuf + (l + 1) * lstride, ldm, 1, 1, layer_from(ptrs, dims, l + 1),
        Mbuf + (l + 1) * lstride, ldm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  // Reverse sweep.
  int poff = ptot;
  const float* g_in = G;
  int ldg = dims[2 * (L - 1) + 1];
  for (int l = L - 1; l >= 0; --l) {
    poff -= layer_ptot(dims, l, nbasis<DIR>());
    const Layer lp = layer_from(ptrs, dims, l);
    const float* X = l == 0 ? Z : Xbuf + l * lstride;
    const int ldx = l == 0 ? dims[0] : ldm;
    float* Gp = l == 0 ? dZ : gbuf + l * lstride;
    const int ldgp = l == 0 ? dims[0] : ldm;
    if (need_tau)
      bwd_rows_kernel<true, DIR, true><<<grid, NT, 0, stream>>>(
          P, idx, tau, n, stats, lp, X, ldx, Mbuf + l * lstride, ldm, g_in, ldg,
          Gp, ldgp, l > 0, part, ptot, poff);
    else
      bwd_rows_kernel<false, DIR, true><<<grid, NT, 0, stream>>>(
          P, idx, tau, n, stats, lp, X, ldx, Mbuf + l * lstride, ldm, g_in, ldg,
          Gp, ldgp, l > 0, part, ptot, poff);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    g_in = Gp;
    ldg = ldgp;
  }
  reduce_blocks_kernel<<<dim3((ptot + NT - 1) / NT, B), NT, 0, stream>>>(
      part, nblk, ptot, red);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}

// directed: the layers' basis is the (11, 2) directed stack (else (8, 2));
// planes float32 (K2, K2d: bwd_sweep.cuh mk_bwd_f32), or bfloat16 when bf16
// (K2bf). plan: host array of K1's row-pass plan per layer (bm, cc, groups;
// ops/megakernel.py row_plan), the f32 forward recompute's; bplan: host
// array of the f32 reverse sweep's plan per layer (bm, cc, groups;
// ops/megakernel_bwd.py bwd_row_plan). part: f32, the layers' partial
// blocks (ops/megakernel_bwd.py bwd_layout), part_floats of them; bf16,
// (B, ceil(n / 16), ptot). work: the f32 sweep's scratch for its layers of
// several column groups, work_floats (may be NULL when none has). Both
// plans, work and the sizes are unread for bf16.
extern "C" int gncde_mk_bwd(const void* d, const void* c, const void* b,
                            const void* a, long long plane_bstride,
                            const int* idx, const float* tau, const float* Z,
                            const float* G, int B, int n, int L,
                            const int* dims, const void* const* ptrs, const int* plan,
                            const int* bplan, int directed, int bf16, int need_tau,
                            float* stats, float* Mbuf, float* Xbuf, float* gbuf, int ldm,
                            float* dZ, float* part, long long part_floats, float* work,
                            long long work_floats, int ptot, float* red,
                            cudaStream_t stream) {
  if (L < 1 || B < 1 || n < 1 || !dims_ok(dims, L, ldm)) return (int)cudaErrorInvalidValue;
  const int nb = directed ? NBASIS_D : NBASIS_U;
  int want = 0;
  for (int l = 0; l < L; ++l) want += layer_ptot(dims, l, nb);
  if (want != ptot) return (int)cudaErrorInvalidValue;
  if (bf16) {
    const Planes<true> P{static_cast<const mk::bf16*>(d), static_cast<const mk::bf16*>(c),
                         static_cast<const mk::bf16*>(b), static_cast<const mk::bf16*>(a),
                         plane_bstride};
    if (directed)
      return mk_bwd_bf16<true>(P, idx, tau, Z, G, B, n, L, dims, ptrs, need_tau, stats, Mbuf,
                               Xbuf, gbuf, ldm, dZ, part, ptot, red, stream);
    return mk_bwd_bf16<false>(P, idx, tau, Z, G, B, n, L, dims, ptrs, need_tau, stats, Mbuf,
                              Xbuf, gbuf, ldm, dZ, part, ptot, red, stream);
  }
  const Planes<false> P{static_cast<const float*>(d), static_cast<const float*>(c),
                        static_cast<const float*>(b), static_cast<const float*>(a),
                        plane_bstride};
  if (directed)
    return mk_bwd_f32<true>(P, idx, tau, Z, G, B, n, L, dims, ptrs, plan, bplan, need_tau,
                            stats, Mbuf, Xbuf, gbuf, ldm, dZ, part, part_floats, work,
                            work_floats, ptot, red, stream);
  return mk_bwd_f32<false>(P, idx, tau, Z, G, B, n, L, dims, ptrs, plan, bplan, need_tau,
                           stats, Mbuf, Xbuf, gbuf, ldm, dZ, part, part_floats, work,
                           work_floats, ptot, red, stream);
}
