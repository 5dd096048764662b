// Shared device code of the vector-field kernels K1 (megakernel_fwd.cu) and
// K2 (megakernel_bwd.cu): Hermite plane evaluation, the per-row statistics
// pass, the forward row pass and the row-local RMSNorm -> Linear transform.
//
// One vector-field eval of the undirected perm-equiv field, per batch
// element b, with A = A(tau_b), dA = dA(tau_b) taken from the four Hermite
// interval planes d, c, b, a of interval idx_b:
//
//   M_l   = Linear_l(RMSNorm_l(x_l))                          (n, H)
//   out_l = C_l M_l + dvec_l * M_l + u_l s_l^T + 1 (w_l + c7_l s_l)^T
//   x_l+1 = relu(out_l)                (no relu after the last layer)
//
// with C = B1 + B2^T = b1_0 A + b1_1 dA + b2_0 A^T + b2_1 dA^T and the O(n)
// vectors of gncde_tpu/ops/equiv_basis.py (the residual identity folded
// into dvec). Layout: CTAs own BM rows of one batch element (grid
// (ceil(n/BM), B)); the n x n operands never reach device memory -- each
// CTA regenerates its (BM x BK) tiles of C from the planes, in shared
// memory, once per layer and chunk of HC output columns. All reductions are
// in a fixed order, so results are bitwise reproducible run to run.
//
// Widths: a layer's input is at most MAXIN = 64 wide; its output any width
// up to MAXOUT, swept in chunks of HC = 64 columns (one chunk, and the
// arithmetic of the unchunked kernel, for outputs up to 64). The configs'
// wide layers are CDE-wrapper outputs, H * E * 2 columns (512 for the trade
// configs, 1024 for england), and always last, so a layer that feeds
// another is at most 64 wide.
#pragma once

#include <cuda_runtime.h>

namespace mk {

constexpr int BM = 16;     // rows per CTA
constexpr int BK = 32;     // k-tile width
constexpr int NT = 256;    // threads per CTA
constexpr int NW = NT / 32;
constexpr int MAXIN = 64;    // widest layer input
constexpr int HC = 64;       // output columns per sweep
constexpr int MAXOUT = 4096; // widest layer output
constexpr int PPT = (BM * HC + NT - 1) / NT;  // (row, col) pairs per thread
constexpr float EPS = 1e-6f;

struct Planes {
  const float* d;
  const float* c;
  const float* b;
  const float* a;
  long long bstride;  // floats between batch elements' plane stacks (0: shared)
};

// One layer's parameters; basis is the (8, 2) stack [p1 .. p8].
struct Layer {
  const float* nw;
  const float* nb;
  const float* W;  // (hout, hin), torch / equinox layout
  const float* lb;
  const float* basis;
  int hin;
  int hout;
};

// Statistic rows of the (B, 6, n) stats buffer.
enum Stat { RA = 0, RDA = 1, DGA = 2, DGDA = 3, RDDA = 4, DGDDA = 5 };

__device__ __forceinline__ long long plane_base(const Planes& P, const int* idx,
                                                int b, int n) {
  return (long long)b * P.bstride + (long long)__ldg(idx + b) * n * n;
}

__device__ __forceinline__ void herm(const Planes& P, long long off, float t,
                                     float& A, float& dA) {
  const float d = __ldg(P.d + off), c = __ldg(P.c + off);
  const float b = __ldg(P.b + off), a = __ldg(P.a + off);
  A = ((d * t + c) * t + b) * t + a;
  dA = (3.0f * d * t + 2.0f * c) * t + b;
}

__device__ __forceinline__ void herm3(const Planes& P, long long off, float t,
                                      float& A, float& dA, float& ddA) {
  const float d = __ldg(P.d + off), c = __ldg(P.c + off);
  const float b = __ldg(P.b + off), a = __ldg(P.a + off);
  A = ((d * t + c) * t + b) * t + a;
  dA = (3.0f * d * t + 2.0f * c) * t + b;
  ddA = 6.0f * d * t + 2.0f * c;
}

// Sum over the warp; every lane gets lane 0's total (one rounding order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Sum over the CTA, returned to every thread. Must be reached by all threads.
__device__ __forceinline__ float block_sum(float v, float* scratch /*[NW]*/) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) tot += scratch[w];
  __syncthreads();
  return tot;
}

// One warp: RMSNorm (eps 1e-6, with bias) then Linear of one node row.
// x: hin features (global or shared); zn: per-warp scratch of MAXIN floats;
// any hout.
__device__ __forceinline__ void transform_row(const float* x, const Layer& lp,
                                              float* zn, float* out) {
  const int lane = threadIdx.x % 32;
  float ss = 0.f;
  for (int j = lane; j < lp.hin; j += 32) {
    const float v = x[j];
    ss += v * v;
  }
  ss = warp_sum(ss);
  const float inv = rsqrtf(ss / (float)lp.hin + EPS);
  for (int j = lane; j < lp.hin; j += 32)
    zn[j] = x[j] * inv * __ldg(lp.nw + j) + __ldg(lp.nb + j);
  __syncwarp();
  for (int h = lane; h < lp.hout; h += 32) {
    const float* Wr = lp.W + (long long)h * lp.hin;
    float acc = 0.f;
    for (int j = 0; j < lp.hin; ++j) acc += zn[j] * __ldg(Wr + j);
    out[h] = acc + __ldg(lp.lb + h);
  }
  __syncwarp();
}

// Pass 1 of one CTA: per-row statistics of A, dA (and ddA) -- row sums and
// diagonals -- plus layer 0's M rows, for rows r0 .. r0+BM-1 of element b
// whose interval planes start at ``base``, at offset t. One warp per row;
// lanes stride over columns. A device function so that K1 (prep_kernel) and
// the fused RK step K11 (fused_step.cu) run the same arithmetic.
__device__ __forceinline__ void prep_rows(const Planes& P, long long base, float t,
                                          int b, int r0, int n,
                                          const float* __restrict__ Z, int ldz,
                                          const Layer& l0, float* __restrict__ M0,
                                          int ldm, float* __restrict__ stats) {
  __shared__ float zn[NW][MAXIN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stats + (long long)b * 6 * n;
  const int rend = min(r0 + BM, n);
  for (int i = r0 + warp; i < rend; i += NW) {
    float rA = 0.f, rdA = 0.f, rddA = 0.f, gA = 0.f, gdA = 0.f, gddA = 0.f;
    const long long row = base + (long long)i * n;
    for (int k = lane; k < n; k += 32) {
      float A, dA, ddA;
      herm3(P, row + k, t, A, dA, ddA);
      rA += A;
      rdA += dA;
      rddA += ddA;
      if (k == i) {
        gA = A;
        gdA = dA;
        gddA = ddA;
      }
    }
    rA = warp_sum(rA);
    rdA = warp_sum(rdA);
    rddA = warp_sum(rddA);
    gA = warp_sum(gA);
    gdA = warp_sum(gdA);
    gddA = warp_sum(gddA);
    if (lane == 0) {
      st[RA * n + i] = rA;
      st[RDA * n + i] = rdA;
      st[DGA * n + i] = gA;
      st[DGDA * n + i] = gdA;
      st[RDDA * n + i] = rddA;
      st[DGDDA * n + i] = gddA;
    }
    transform_row(Z + ((long long)b * n + i) * ldz, l0, zn[warp],
                  M0 + ((long long)b * n + i) * ldm);
  }
}

__global__ void __launch_bounds__(NT)
prep_kernel(Planes P, const int* __restrict__ idx, const float* __restrict__ tau,
            int n, const float* __restrict__ Z, int ldz, Layer l0,
            float* __restrict__ M0, int ldm, float* __restrict__ stats) {
  const int b = blockIdx.y;
  prep_rows(P, plane_base(P, idx, b, n), __ldg(tau + b), b, blockIdx.x * BM, n, Z,
            ldz, l0, M0, ldm, stats);
}

// Pass 2 of one CTA (one per layer): out rows = C M + rank terms (+ relu),
// optionally stored to F, and -- when a next layer exists (then H <= HC) --
// that layer's M rows; rows r0 .. r0+BM-1 of element b, planes at ``base``,
// offset t. The output columns are swept in chunks of HC. Shared by K1
// (fwd_rows_kernel) and K11.
__device__ __forceinline__ void fwd_rows(const Planes& P, long long base, float t,
                                         int b, int r0, int n,
                                         const float* __restrict__ stats,
                                         const Layer& lp, const float* __restrict__ Mc,
                                         int ldm, float* __restrict__ F, int ldf,
                                         int relu, int has_next, const Layer& ln,
                                         float* __restrict__ Mn, int ldmn) {
  __shared__ float Cs[BM][BK + 1];
  __shared__ float Ms[BK][HC];
  __shared__ float Fs[BM][HC];
  __shared__ float colS[HC], colW[HC];
  __shared__ float red[2][NT];
  __shared__ float scratch[NW];
  __shared__ float zn[NW][MAXIN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int H = lp.hout;
  const float fn = (float)n, fn2 = fn * fn;
  const float* st = stats + (long long)b * 6 * n;
  const float* rA = st + RA * n;
  const float* rdA = st + RDA * n;
  const float* Mb = Mc + (long long)b * n * ldm;
  float q[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) q[k] = __ldg(lp.basis + k);

  // Global sums every CTA needs: sA, sdA.
  float a0 = 0.f, a1 = 0.f;
  for (int k = tid; k < n; k += NT) {
    a0 += rA[k];
    a1 += rdA[k];
  }
  const float sA = block_sum(a0, scratch);
  const float sdA = block_sum(a1, scratch);
  const float b10 = 1.f + q[0], b11 = 1.f + q[1], b20 = q[2], b21 = q[3];
  const float c7 = (q[12] + q[13]) * sA / fn2;
  const float c8 = (q[14] * sA + q[15] * sdA) / fn2;

  for (int h0 = 0; h0 < H; h0 += HC) {
    const int hc = min(HC, H - h0);
    // The chunk's column sums s, w of M (the previous chunk's epilogue has
    // read colS/colW before this barrier).
    __syncthreads();
    {
      const int nsl = NT / hc, h = tid % hc, sl = tid / hc;
      float s_ = 0.f, w_ = 0.f;
      if (sl < nsl) {
        for (int k = sl; k < n; k += nsl) {
          const float m = Mb[(long long)k * ldm + h0 + h];
          const float v = (q[8] * rA[k] + q[9] * rdA[k]) / fn;
          s_ += m;
          w_ += v * m;
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

    float acc[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) acc[j] = 0.f;

    for (int k0 = 0; k0 < n; k0 += BK) {
      // Row part: B1[i, k] for the CTA's rows (coalesced along k).
      for (int e = tid; e < BM * BK; e += NT) {
        const int i = e / BK, kk = e % BK, gi = r0 + i, gk = k0 + kk;
        float v = 0.f;
        if (gi < n && gk < n) {
          float A, dA;
          herm(P, base + (long long)gi * n + gk, t, A, dA);
          v = b10 * A + b11 * dA;
        }
        Cs[i][kk] = v;
      }
      for (int e = tid; e < BK * hc; e += NT) {
        const int kk = e / hc, h = e % hc, gk = k0 + kk;
        Ms[kk][h] = gk < n ? Mb[(long long)gk * ldm + h0 + h] : 0.f;
      }
      __syncthreads();
      // Column part: B2[k, i] (coalesced along i).
      for (int e = tid; e < BM * BK; e += NT) {
        const int kk = e / BM, i = e % BM, gi = r0 + i, gk = k0 + kk;
        if (gi < n && gk < n) {
          float A, dA;
          herm(P, base + (long long)gk * n + gi, t, A, dA);
          Cs[i][kk] += b20 * A + b21 * dA;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int pp = tid + j * NT;
        if (pp < BM * hc) {
          const int i = pp / hc, h = pp % hc;
          float a = acc[j];
#pragma unroll 8
          for (int kk = 0; kk < BK; ++kk) a += Cs[i][kk] * Ms[kk][h];
          acc[j] = a;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int pp = tid + j * NT;
      if (pp < BM * hc) {
        const int i = pp / hc, h = pp % hc, gi = r0 + i;
        float val = 0.f;
        if (gi < n) {
          const float dvec = q[4] * st[DGA * n + gi] + q[5] * st[DGDA * n + gi] +
                             (q[10] * rA[gi] + q[11] * rdA[gi]) / fn + c8 + 1.f;
          const float u = (q[6] * rA[gi] + q[7] * rdA[gi]) / fn;
          const float m = Mb[(long long)gi * ldm + h0 + h];
          val = acc[j] + dvec * m + u * colS[h] + (colW[h] + c7 * colS[h]);
          if (relu) val = fmaxf(val, 0.f);
          if (F != nullptr) F[((long long)b * n + gi) * ldf + h0 + h] = val;
        }
        Fs[i][h] = val;
      }
    }
  }
  if (has_next) {
    __syncthreads();
    for (int i = warp; i < BM; i += NW) {
      const int gi = r0 + i;
      if (gi < n)
        transform_row(Fs[i], ln, zn[warp], Mn + ((long long)b * n + gi) * ldmn);
    }
  }
}

__global__ void __launch_bounds__(NT)
fwd_rows_kernel(Planes P, const int* __restrict__ idx,
                const float* __restrict__ tau, int n,
                const float* __restrict__ stats, Layer lp,
                const float* __restrict__ Mc, int ldm, float* __restrict__ F,
                int ldf, int relu, int has_next, Layer ln,
                float* __restrict__ Mn, int ldmn) {
  const int b = blockIdx.y;
  fwd_rows(P, plane_base(P, idx, b, n), __ldg(tau + b), b, blockIdx.x * BM, n, stats,
           lp, Mc, ldm, F, ldf, relu, has_next, ln, Mn, ldmn);
}

inline Layer layer_from(const void* const* ptrs, const int* dims, int l) {
  Layer lp;
  lp.nw = static_cast<const float*>(ptrs[5 * l + 0]);
  lp.nb = static_cast<const float*>(ptrs[5 * l + 1]);
  lp.W = static_cast<const float*>(ptrs[5 * l + 2]);
  lp.lb = static_cast<const float*>(ptrs[5 * l + 3]);
  lp.basis = static_cast<const float*>(ptrs[5 * l + 4]);
  lp.hin = dims[2 * l];
  lp.hout = dims[2 * l + 1];
  return lp;
}

// Host-side shape checks shared by both entry points: inputs up to MAXIN,
// outputs up to MAXOUT, consecutive layers chained; the M/X scratch rows
// (ldm) hold the widest layer.
inline bool dims_ok(const int* dims, int L, int ldm) {
  for (int l = 0; l < L; ++l) {
    if (dims[2 * l] < 1 || dims[2 * l] > MAXIN) return false;
    if (dims[2 * l + 1] < 1 || dims[2 * l + 1] > MAXOUT) return false;
    if (dims[2 * l + 1] > ldm || dims[2 * l] > ldm) return false;
    if (l > 0 && dims[2 * l] != dims[2 * l - 1]) return false;
  }
  return true;
}

}  // namespace mk
