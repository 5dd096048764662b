// Shared device code of the vector-field kernels K1 (megakernel_fwd.cu) and
// K2 (megakernel_bwd.cu): Hermite plane evaluation, the per-row statistics
// pass, the forward row pass and the row-local RMSNorm -> Linear transform.
//
// One vector-field eval of the perm-equiv field, per batch element b, with
// A = A(tau_b), dA = dA(tau_b) taken from the four Hermite interval planes
// d, c, b, a of interval idx_b:
//
//   M_l   = Linear_l(RMSNorm_l(x_l))                          (n, H)
//   out_l = C_l M_l + dvec_l * M_l + u_l s_l^T + 1 (w_l + c7_l s_l)^T
//   x_l+1 = relu(out_l)                (no relu after the last layer)
//
// with C = B1 + B2^T = b1_0 A + b1_1 dA + b2_0 A^T + b2_1 dA^T and the O(n)
// vectors of gncde_tpu/ops/equiv_basis.py (the residual identity folded
// into dvec). The basis is a compile-time parameter DIR of the device
// functions: the undirected 8-term basis (DIR = false) or the directed
// 11-term one (DIR = true), whose dvec, u and v also read the column sums
// cA, cdA of A and dA (fused_coeffs_directed, with its two reference
// quirks: v takes p4'[0] rA + p4'[1] cdA, and c7 scales both of its
// operands by sum(A)). The undirected instantiation computes bit for bit
// what it computed before the directed basis existed.
//
// Layout: the n x n operands never reach device memory. The row pass of
// every vector-field kernel is rows_body (below), on a launch plan of its
// own per layer (ops/megakernel.py row_plan): a CTA forms its rows of C (or
// of B1 and B2^T in bf16) over all n columns once a layer, in shared
// memory, and M streams through a cp.async ring. rows_kernel runs it for
// K1's and K2's f32 passes, rows_bf_kernel for K1bf's and K2bf's (BF), and
// K11's and K11bf's stages run it inside their cooperative launch. The
// first row pass, fwd_rows (CTAs of BM rows regenerating their (BM x BK)
// tiles of C from the planes for every chunk of HC output columns), stays
// only for the design probes (csrc/mk_probe.cu), whose flags are ablations
// of it. All reductions are in a fixed order, so results are bitwise
// reproducible run to run.
//
// Widths: a layer's input is at most MAXIN = 64 wide; its output any width
// up to MAXOUT, swept in chunks of HC = 64 columns (one chunk, and the
// arithmetic of the unchunked kernel, for outputs up to 64). The configs'
// wide layers are CDE-wrapper outputs, H * E * 2 columns (512 for the trade
// configs, 1024 for england), and always last, so a layer that feeds
// another is at most 64 wide.
//
// Precision: a second compile-time parameter BF selects fusion_precision
// bf16 (gncde_tpu/ops/pallas/megakernel.py _make_vf_body(bf16=True)). The
// planes are then bfloat16 stacks, read at half the bytes and evaluated in
// f32 with every product and sum rounded once (no FMA contraction, so the
// bf16 operands equal the plain version's bit for bit); the row sums,
// diagonals and totals stay f32; the directed column sums are sums of the
// bf16-rounded A(t), dA(t), as JAX takes them. Per layer B1 = b1_0 Ah +
// b1_1 dAh and B2^T = b2_0 Ah^T + b2_1 dAh^T are formed in bf16 (the
// coefficients rounded, each product and the sum rounded), separately --
// their sum would round again -- and multiplied with M rounded to bf16 on
// the tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulation),
// both products into one accumulator per output. The rank terms are f32 on
// the unrounded M. The f32 instantiations (BF = false) compute bit for bit
// what they computed before BF existed.
//
// The design probes (csrc/mk_probe.cu, benchmarks/mk_probe4.py and
// mk_probe5.py) run K1bf's first row pass, fwd_rows, with three more
// compile-time parameters of prep_rows / fwd_rows, all off by default (the
// instantiations of the main path's prep passes): D, one of mk_probe5.py's
// ablations (enum Drop), replaces one component; RED takes the statistics
// from a (B, n, 4) operand [rA, rdA, diagA, diagdA] made outside, and the
// prep pass then only transforms layer 0's rows; NOTR stages B2 in its
// natural layout and feeds it transposed to the product (ldmatrix .trans)
// instead of forming B2^T tiles. They exist only for BF on the undirected
// basis.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace mk {

typedef __nv_bfloat16 bf16;

constexpr int BM = 16;     // rows per CTA
constexpr int BK = 32;     // k-tile width
constexpr int NT = 256;    // threads per CTA
constexpr int NW = NT / 32;
constexpr int MAXIN = 64;    // widest layer input
constexpr int HC = 64;       // output columns per sweep
constexpr int MAXOUT = 4096; // widest layer output
constexpr int PPT = (BM * HC + NT - 1) / NT;  // (row, col) pairs per thread
constexpr float EPS = 1e-6f;
constexpr int MAXN = 640;    // largest n (ops/megakernel.py MEGAKERNEL_MAX_N)
constexpr int BKP = BK + 8;  // padded k extent of the bf16 MMA tiles
constexpr int BMP = BM + 8;  // padded i extent of [k][i] tiles: 48-byte rows

// The probes' ablations, in mk_probe5.py's order (ops/mk_probe.py DROPS):
// the Hermite (A := a, dA := b), the reductions (:= 1), the transposes
// (B2^T := B2), the B builds (B1 := Ah, B2^T := dAh^T), the row or the
// column product (:= M), the norm and linear (M := x), the rank terms, or
// everything but the plane reads (dma_only, csrc/mk_probe.cu's own kernel).
enum Drop {
  FULL = 0, NO_HERMITE, NO_REDUCE, NO_TRANSPOSE, NO_BBUILD, NO_ROWMM, NO_COLMM, NO_NORM,
  NO_GLUE, DMA_ONLY
};

// The four Hermite interval plane stacks: float32, or bfloat16 when BF.
template <bool BF>
struct Planes {
  using T = std::conditional_t<BF, bf16, float>;
  const T* d;
  const T* c;
  const T* b;
  const T* a;
  long long bstride;  // elements between batch elements' plane stacks (0: shared)
};

// Basis entries (2-vectors) of the undirected and the directed basis.
constexpr int NBASIS_U = 8;
constexpr int NBASIS_D = 11;
template <bool DIR>
__host__ __device__ constexpr int nbasis() { return DIR ? NBASIS_D : NBASIS_U; }

// One layer's parameters; basis is the (8, 2) stack [p1 .. p8] or the
// directed (11, 2) stack [p1, p2, p3, p4, p4', p5, p5', p6, p6', p7, p8].
struct Layer {
  const float* nw;
  const float* nb;
  const float* W;  // (hout, hin), torch / equinox layout
  const float* lb;
  const float* basis;
  int hin;
  int hout;
};

// Statistic rows of the (B, NSTAT, n) stats buffer: row sums and
// diagonals of A, dA, ddA, and (directed basis only) their column sums.
enum Stat { RA = 0, RDA = 1, DGA = 2, DGDA = 3, RDDA = 4, DGDDA = 5, CA = 6, CDA = 7,
            CDDA = 8 };
constexpr int NSTAT = 9;

template <bool BF>
__device__ __forceinline__ long long plane_base(const Planes<BF>& P, const int* idx,
                                                int b, int n) {
  return (long long)b * P.bstride + (long long)__ldg(idx + b) * n * n;
}

__device__ __forceinline__ float ldp(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldp(const bf16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Round to bf16 (to nearest even) and back.
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// The bf16 bit pattern of x rounded (to nearest even).
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// A(t), dA(t) of f32 plane values (the row pass evaluates values it
// loaded ahead).
__device__ __forceinline__ void herm_vals(float d, float c, float b, float a, float t,
                                          float& A, float& dA) {
  A = ((d * t + c) * t + b) * t + a;
  dA = (3.0f * d * t + 2.0f * c) * t + b;
}
// The same of bf16 plane values, each product and sum rounded once (herm's
// BF chain).
__device__ __forceinline__ void herm_vals_bf(float d, float c, float b, float a, float t,
                                             float& A, float& dA) {
  A = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(d, t), c), t), b), t), a);
  dA = __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(3.0f, d), t), __fmul_rn(2.0f, c)), t), b);
}

// A(t), dA(t) (and d(dA)/dt) at one plane element. BF: each product and sum
// rounded once, in the plain version's order.
template <bool BF>
__device__ __forceinline__ void herm(const Planes<BF>& P, long long off, float t,
                                     float& A, float& dA) {
  const float d = ldp(P.d + off), c = ldp(P.c + off);
  const float b = ldp(P.b + off), a = ldp(P.a + off);
  if constexpr (BF) {
    A = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(d, t), c), t), b), t), a);
    dA = __fadd_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(3.0f, d), t), __fmul_rn(2.0f, c)), t), b);
  } else {
    herm_vals(d, c, b, a, t, A, dA);
  }
}

template <bool BF>
__device__ __forceinline__ void herm3(const Planes<BF>& P, long long off, float t,
                                      float& A, float& dA, float& ddA) {
  const float d = ldp(P.d + off), c = ldp(P.c + off);
  const float b = ldp(P.b + off), a = ldp(P.a + off);
  if constexpr (BF) {
    A = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(d, t), c), t), b), t), a);
    dA = __fadd_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(3.0f, d), t), __fmul_rn(2.0f, c)), t), b);
    ddA = __fadd_rn(__fmul_rn(__fmul_rn(6.0f, d), t), __fmul_rn(2.0f, c));
  } else {
    A = ((d * t + c) * t + b) * t + a;
    dA = (3.0f * d * t + 2.0f * c) * t + b;
    ddA = 6.0f * d * t + 2.0f * c;
  }
}

// herm / herm3 under the probes' ablation D: no_hermite takes the planes
// a and b as A and dA (and reads no other plane; ddA := 0).
template <int D, bool BF>
__device__ __forceinline__ void herm_d(const Planes<BF>& P, long long off, float t, float& A,
                                       float& dA) {
  if constexpr (D == NO_HERMITE) {
    A = ldp(P.a + off);
    dA = ldp(P.b + off);
  } else {
    herm(P, off, t, A, dA);
  }
}

template <int D, bool BF>
__device__ __forceinline__ void herm3_d(const Planes<BF>& P, long long off, float t,
                                        float& A, float& dA, float& ddA) {
  if constexpr (D == NO_HERMITE) {
    herm_d<D>(P, off, t, A, dA);
    ddA = 0.f;
  } else {
    herm3(P, off, t, A, dA, ddA);
  }
}

// Statistic K (RA, RDA, DGA or DGDA) of node i from an element's stats
// rows st: the (NSTAT, n) rows of the prep pass (a row pointer for the
// sums, one index for the diagonals, as the rank terms read them), or under
// RED the (n, 4) operand (its columns in the same order); 1 under
// no_reduce.
template <int D, bool RED, int K>
__device__ __forceinline__ float stat_at(const float* st, int n, int i) {
  if constexpr (D == NO_REDUCE)
    return 1.f;
  else if constexpr (RED)
    return st[(long long)i * 4 + K];
  else if constexpr (K == DGA || K == DGDA)
    return st[K * n + i];
  else
    return (st + K * n)[i];
}

// One bf16 operand of a product, its coefficient already rounded: round(c *
// round(x)), exact in f32 before the rounding (8-bit significands).
__device__ __forceinline__ float bmul(float c, float x) { return rbf(c * rbf(x)); }

// ---- Tensor-core products (BF) ---------------------------------------------
// A tiles S[i][k] (BM rows, BK deep) are the MMA's row-major A operand; a B
// tile Bt[h][k] holds the (BK x HC) right operand transposed, so a lane's
// two consecutive k values are one 32-bit word. Both hold bf16 bit patterns;
// rows padded to BKP halves keep the fragment loads free of bank conflicts.

__device__ __forceinline__ uint32_t ld_pair(const unsigned short* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b, one m16n8k16 bf16 product with f32 accumulation.
__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += S Bt^T over one BK-deep tile for the warp's 16 x 8 output block
// (columns nb0 .. nb0 + 7): two k16 steps. Fragment layout of the PTX ISA:
// lane = 4 g + q; A rows g, g + 8 and k pairs 2q, 2q + 8; B column g.
__device__ __forceinline__ void mma_tile(const unsigned short (*S)[BKP],
                                         const unsigned short (*Bt)[BKP], int nb0,
                                         float c[4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = 2 * (lane & 3);
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16)
    mma_bf16(c, ld_pair(&S[g][ks + q]), ld_pair(&S[g + 8][ks + q]),
             ld_pair(&S[g][ks + q + 8]), ld_pair(&S[g + 8][ks + q + 8]),
             ld_pair(&Bt[nb0 + g][ks + q]), ld_pair(&Bt[nb0 + g][ks + q + 8]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices from shared memory, transposed on the way into
// the fragment: lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// Four 8 x 8 bf16 matrices from shared memory into an A fragment (lane l
// gives the row address of matrix l / 8), and two transposed on the way.
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}
// ldmatrix .x2 (no transpose): two 8 x 8 bf16 matrices, lanes 0-15 giving
// the row addresses (lane l of matrix l / 8).
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

// The bf16 passes' tiles (rows_body's and bwd_sweep.cuh's): a group's
// columns rounded up to the MMA's 16 (mma_hw), in rows of hw + 8 halves (an
// odd number of 16-byte units, so ldmatrix rows fall on distinct banks); a
// CTA's bf16 row operands are at least one 8-row block (mma_rows; rows past
// bm zero).
__host__ __device__ constexpr int mma_hw(int rw) { return (rw + 15) / 16 * 16; }
__host__ __device__ constexpr int mma_rows(int bm) { return bm < 8 ? 8 : bm; }

// 16-byte cp.async of src_bytes (0-16) from global memory; the rest of the
// 16 bytes is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_wait0() { asm volatile("cp.async.wait_all;\n" ::); }

// bf16(bf16(c0 a) + bf16(c1 d)) for both halves of the bf16 words a and d
// (the B1/B2 rounding chain of the tiled kernels).
__device__ __forceinline__ uint32_t form_two(uint32_t a, uint32_t d, float c0, float c1) {
  const float a0 = __uint_as_float(a << 16), a1 = __uint_as_float(a & 0xffff0000u);
  const float d0 = __uint_as_float(d << 16), d1 = __uint_as_float(d & 0xffff0000u);
  const float s0 = __fadd_rn(rbf(__fmul_rn(c0, a0)), rbf(__fmul_rn(c1, d0)));
  const float s1 = __fadd_rn(rbf(__fmul_rn(c0, a1)), rbf(__fmul_rn(c1, d1)));
  const __nv_bfloat162 v = __floats2bfloat162_rn(s0, s1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += T^T Bt^T over one BK-deep tile for the warp's 16 x 8 block (columns
// nb0 .. nb0 + 7), the row operand held transposed: T[k][i]. Matrix m of
// the x4 load is rows i (m & 1) * 8 .., k (m >> 1) * 8 .. of the operand,
// i.e. fragment registers a0 .. a3 of mma_tile.
__device__ __forceinline__ void mma_tile_t(const unsigned short (*T)[BMP],
                                           const unsigned short (*Bt)[BKP], int nb0,
                                           float c[4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = 2 * (lane & 3);
  const int m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4_t(a0, a1, a2, a3, &T[ks + (m >> 1) * 8 + r][(m & 1) * 8]);
    mma_bf16(c, a0, a1, a2, a3, ld_pair(&Bt[nb0 + g][ks + q]),
             ld_pair(&Bt[nb0 + g][ks + q + 8]));
  }
}

// The warp's accumulator block into D (BM x HC f32): rows g, g + 8, columns
// nb0 + 2q, nb0 + 2q + 1.
__device__ __forceinline__ void mma_store(const float c[4], int nb0, float (*D)[HC]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, q = 2 * (lane & 3);
  D[g][nb0 + q] = c[0];
  D[g][nb0 + q + 1] = c[1];
  D[g + 8][nb0 + q] = c[2];
  D[g + 8][nb0 + q + 1] = c[3];
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

// The directed basis's O(n) vectors at node i (fused_coeffs_directed): q
// is the flattened (11, 2) stack, st the element's NSTAT stats rows, c8 the
// p8 term. The undirected ones are written inline where they are used.
__device__ __forceinline__ float dir_u(const float* q, const float* st, int n, int i,
                                       float fn) {
  return (q[6] * st[CA * n + i] + q[7] * st[CDA * n + i]) / fn;
}

__device__ __forceinline__ float dir_v(const float* q, const float* st, int n, int i,
                                       float fn) {
  const float rA = st[RA * n + i], rdA = st[RDA * n + i];
  const float cA = st[CA * n + i], cdA = st[CDA * n + i];
  return (q[8] * rA + q[9] * cdA + q[10] * cA + q[11] * cdA + q[12] * rA +
          q[13] * rdA) / fn;
}

__device__ __forceinline__ float dir_dvec(const float* q, const float* st, int n, int i,
                                          float fn, float c8) {
  return q[4] * st[DGA * n + i] + q[5] * st[DGDA * n + i] +
         (q[14] * st[CA * n + i] + q[15] * st[CDA * n + i]) / fn +
         (q[16] * st[RA * n + i] + q[17] * st[RDA * n + i]) / fn + c8 + 1.f;
}

// Pass 1 of one CTA: per-row statistics of A, dA (and ddA) -- row sums and
// diagonals -- plus layer 0's M rows, for rows r0 .. r0+BM-1 of element b
// whose interval planes start at ``base``, at offset t. One warp per row;
// lanes stride over columns. With the directed basis the CTA also owns
// columns r0 .. r0+BM-1 and writes their sums cA, cdA, cddA: it sweeps all
// n rows of those columns (BM consecutive floats a row, NT / BM row slices
// in parallel) and sums the slices in a fixed order -- no atomics, so the
// column sums are bitwise repeatable like everything else. A device
// function so that K1 (prep_kernel) and the fused RK step K11
// (fused_step.cu) run the same arithmetic; it ends on a CTA barrier when
// DIR, so every thread must reach it. The probe flags (BF, undirected):
// RED and no_reduce take no statistics, no_hermite takes them of A := a,
// dA := b, and no_norm stores layer 0's input rows as its M.
template <bool DIR, bool BF, int D = FULL, bool RED = false>
__device__ __forceinline__ void prep_rows(const Planes<BF>& P, long long base, float t,
                                          int b, int r0, int n,
                                          const float* __restrict__ Z, int ldz,
                                          const Layer& l0, float* __restrict__ M0,
                                          int ldm, float* __restrict__ stats) {
  static_assert((D == FULL && !RED) || (BF && !DIR), "probe flags are K1bf's");
  __shared__ float zn[NW][MAXIN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stats + (long long)b * NSTAT * n;
  const int rend = min(r0 + BM, n);
  for (int i = r0 + warp; i < rend; i += NW) {
    if constexpr (D != NO_REDUCE && !RED) {
      float rA = 0.f, rdA = 0.f, rddA = 0.f, gA = 0.f, gdA = 0.f, gddA = 0.f;
      const long long row = base + (long long)i * n;
      for (int k = lane; k < n; k += 32) {
        float A, dA, ddA;
        herm3_d<D>(P, row + k, t, A, dA, ddA);
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
    }
    const float* z = Z + ((long long)b * n + i) * ldz;
    float* m0 = M0 + ((long long)b * n + i) * ldm;
    if constexpr (D == NO_NORM) {
      for (int h = lane; h < l0.hin; h += 32) m0[h] = z[h];
      __syncwarp();
    } else {
      transform_row(z, l0, zn[warp], m0);
    }
  }
  if constexpr (DIR) {
    constexpr int NSL = NT / BM;  // row slices
    __shared__ float cred[3][NT];
    const int c = threadIdx.x % BM, sl = threadIdx.x / BM, gc = r0 + c;
    float cA = 0.f, cdA = 0.f, cddA = 0.f;
    if (gc < n) {
      for (int k = sl; k < n; k += NSL) {
        float A, dA, ddA;
        herm3(P, base + (long long)k * n + gc, t, A, dA, ddA);
        if constexpr (BF) {  // column sums of the rounded planes (JAX's At)
          A = rbf(A);
          dA = rbf(dA);
        }
        cA += A;
        cdA += dA;
        cddA += ddA;
      }
    }
    cred[0][threadIdx.x] = cA;
    cred[1][threadIdx.x] = cdA;
    cred[2][threadIdx.x] = cddA;
    __syncthreads();
    if (threadIdx.x < BM && r0 + (int)threadIdx.x < n) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int q = 0; q < NSL; ++q) {
        s0 += cred[0][q * BM + threadIdx.x];
        s1 += cred[1][q * BM + threadIdx.x];
        s2 += cred[2][q * BM + threadIdx.x];
      }
      const int gi = r0 + threadIdx.x;
      st[CA * n + gi] = s0;
      st[CDA * n + gi] = s1;
      st[CDDA * n + gi] = s2;
    }
    __syncthreads();
  }
}

template <bool DIR, bool BF, int D = FULL, bool RED = false>
__global__ void __launch_bounds__(NT)
prep_kernel(Planes<BF> P, const int* __restrict__ idx, const float* __restrict__ tau,
            int n, const float* __restrict__ Z, int ldz, Layer l0,
            float* __restrict__ M0, int ldm, float* __restrict__ stats) {
  const int b = blockIdx.y;
  prep_rows<DIR, BF, D, RED>(P, plane_base(P, idx, b, n), __ldg(tau + b), b,
                             blockIdx.x * BM, n, Z, ldz, l0, M0, ldm, stats);
}

// Pass 2 of one CTA (one per layer): out rows = C M + rank terms (+ relu),
// optionally stored to F, and -- when a next layer exists (then H <= HC) --
// that layer's M rows; rows r0 .. r0+BM-1 of element b, planes at ``base``,
// offset t. The output columns are swept in chunks of HC. The first row
// pass (fwd_rows_kernel), which the main path no longer runs: the design
// probes' P3 and P4 (csrc/mk_probe.cu run_probe) ablate it. The probe flags
// (BF, undirected; see the top of this file) read ``stats`` as the (B, n,
// 4) operand under RED.
template <bool DIR, bool BF, int D = FULL, bool RED = false, bool NOTR = false>
__device__ __forceinline__ void fwd_rows(const Planes<BF>& P, long long base, float t,
                                         int b, int r0, int n,
                                         const float* __restrict__ stats,
                                         const Layer& lp, const float* __restrict__ Mc,
                                         int ldm, float* __restrict__ F, int ldf,
                                         int relu, int has_next, const Layer& ln,
                                         float* __restrict__ Mn, int ldmn) {
  static_assert((D == FULL && !RED && !NOTR) || (BF && !DIR), "probe flags are K1bf's");
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
  const float* st = stats + (long long)b * (RED ? 4 : NSTAT) * n;
  const float* Mb = Mc + (long long)b * n * ldm;
  constexpr int NQ = 2 * nbasis<DIR>();
  float q[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) q[k] = __ldg(lp.basis + k);

  // Global sums every CTA needs: sA, sdA.
  float sA = 1.f, sdA = 1.f;
  if constexpr (D != NO_REDUCE) {
    float a0 = 0.f, a1 = 0.f;
    for (int k = tid; k < n; k += NT) {
      a0 += stat_at<D, RED, RA>(st, n, k);
      a1 += stat_at<D, RED, RDA>(st, n, k);
    }
    sA = block_sum(a0, scratch);
    sdA = block_sum(a1, scratch);
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

  for (int h0 = 0; h0 < H; h0 += HC) {
    const int hc = min(HC, H - h0);
    // The chunk's column sums s, w of M (the previous chunk's epilogue has
    // read colS/colW before this barrier).
    __syncthreads();
    if constexpr (D != NO_GLUE) {
      const int nsl = NT / hc, h = tid % hc, sl = tid / hc;
      float s_ = 0.f, w_ = 0.f;
      if (sl < nsl) {
        for (int k = sl; k < n; k += nsl) {
          const float m = Mb[(long long)k * ldm + h0 + h];
          float v;
          if constexpr (DIR)
            v = dir_v(q, st, n, k, fn);
          else
            v = (q[8] * stat_at<D, RED, RA>(st, n, k) +
                 q[9] * stat_at<D, RED, RDA>(st, n, k)) / fn;
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

    if constexpr (BF) {
      // B1 and B2^T tiles in bf16 (JAX's roundings), M rounded, both
      // products on the tensor cores into the warp's one accumulator, which
      // is staged through Fs (each thread then reads its own (row, col)
      // pairs, and the epilogue rewrites only those). The probes: NOTR
      // stages B2 as S2n[k][i]; no_transpose reads B2^T's planes row-major;
      // no_bbuild takes B1 := Ah, B2^T := dAh^T; no_rowmm / no_colmm skip
      // a product (the epilogue adds M for it).
      __shared__ __align__(16) unsigned short S1[BM][BKP];
      __shared__ __align__(16) unsigned short S2[BM][BKP];
      __shared__ __align__(16) unsigned short Mt[HC][BKP];
      const float cb0 = rbf(b10), cb1 = rbf(b11), cb2 = rbf(b20), cb3 = rbf(b21);
      const int nb0 = warp * 8;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < n; k0 += BK) {
        if constexpr (D != NO_ROWMM) {
          for (int e = tid; e < BM * BK; e += NT) {
            const int i = e / BK, kk = e % BK, gi = r0 + i, gk = k0 + kk;
            float v = 0.f;
            if (gi < n && gk < n) {
              float A, dA;
              herm_d<D>(P, base + (long long)gi * n + gk, t, A, dA);
              v = D == NO_BBUILD ? A : __fadd_rn(bmul(cb0, A), bmul(cb1, dA));
            }
            S1[i][kk] = bf16_bits(v);
          }
        }
        if constexpr (NOTR) {  // S2n[k][i] = B2[k, i], fed transposed
          __shared__ __align__(16) unsigned short S2n[BK][BMP];
          for (int e = tid; e < BM * BK; e += NT) {
            const int kk = e / BM, i = e % BM, gi = r0 + i, gk = k0 + kk;
            float v = 0.f;
            if (gi < n && gk < n) {
              float A, dA;
              herm_d<D>(P, base + (long long)gk * n + gi, t, A, dA);
              v = __fadd_rn(bmul(cb2, A), bmul(cb3, dA));
            }
            S2n[kk][i] = bf16_bits(v);
          }
          for (int e = tid; e < BK * HC; e += NT) {
            const int kk = e / HC, h = e % HC, gk = k0 + kk;
            Mt[h][kk] = bf16_bits(gk < n && h < hc ? Mb[(long long)gk * ldm + h0 + h] : 0.f);
          }
          __syncthreads();
          if (nb0 < hc) {
            mma_tile(S1, Mt, nb0, c);
            mma_tile_t(S2n, Mt, nb0, c);
          }
          __syncthreads();
          continue;
        } else if constexpr (D != NO_COLMM) {
          for (int e = tid; e < BM * BK; e += NT) {
            float v = 0.f;
            if constexpr (D == NO_TRANSPOSE) {  // B2^T := B2: the planes at (i, k)
              const int i = e / BK, kk = e % BK, gi = r0 + i, gk = k0 + kk;
              if (gi < n && gk < n) {
                float A, dA;
                herm_d<D>(P, base + (long long)gi * n + gk, t, A, dA);
                v = __fadd_rn(bmul(cb2, A), bmul(cb3, dA));
              }
              S2[i][kk] = bf16_bits(v);
            } else {
              const int kk = e / BM, i = e % BM, gi = r0 + i, gk = k0 + kk;
              if (gi < n && gk < n) {
                float A, dA;
                herm_d<D>(P, base + (long long)gk * n + gi, t, A, dA);
                v = D == NO_BBUILD ? dA : __fadd_rn(bmul(cb2, A), bmul(cb3, dA));
              }
              S2[i][kk] = bf16_bits(v);
            }
          }
        }
        for (int e = tid; e < BK * HC; e += NT) {
          const int kk = e / HC, h = e % HC, gk = k0 + kk;
          Mt[h][kk] = bf16_bits(gk < n && h < hc ? Mb[(long long)gk * ldm + h0 + h] : 0.f);
        }
        __syncthreads();
        if (nb0 < hc) {
          if constexpr (D != NO_ROWMM) mma_tile(S1, Mt, nb0, c);
          if constexpr (D != NO_COLMM) mma_tile(S2, Mt, nb0, c);
        }
        __syncthreads();
      }
      if (nb0 < hc) mma_store(c, nb0, Fs);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int pp = tid + j * NT;
        if (pp < BM * hc) acc[j] = Fs[pp / hc][pp % hc];
      }
    } else {
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
    }

#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int pp = tid + j * NT;
      if (pp < BM * hc) {
        const int i = pp / hc, h = pp % hc, gi = r0 + i;
        float val = 0.f;
        if (gi < n) {
          float dvec, u;
          if constexpr (DIR) {
            dvec = dir_dvec(q, st, n, gi, fn, c8);
            u = dir_u(q, st, n, gi, fn);
          } else if constexpr (D != NO_GLUE) {
            dvec = q[4] * stat_at<D, RED, DGA>(st, n, gi) +
                   q[5] * stat_at<D, RED, DGDA>(st, n, gi) +
                   (q[10] * stat_at<D, RED, RA>(st, n, gi) +
                    q[11] * stat_at<D, RED, RDA>(st, n, gi)) / fn + c8 + 1.f;
            u = (q[6] * stat_at<D, RED, RA>(st, n, gi) +
                 q[7] * stat_at<D, RED, RDA>(st, n, gi)) / fn;
          }
          const float m = Mb[(long long)gi * ldm + h0 + h];
          float part = acc[j];
          if constexpr (D == NO_ROWMM || D == NO_COLMM) part = m + part;  // the dropped one := M
          if constexpr (D == NO_GLUE)
            val = part;
          else
            val = part + dvec * m + u * colS[h] + (colW[h] + c7 * colS[h]);
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
      if (gi < n) {
        float* mrow = Mn + ((long long)b * n + gi) * ldmn;
        if constexpr (D == NO_NORM) {  // M := x
          for (int h = tid % 32; h < ln.hin; h += 32) mrow[h] = Fs[i][h];
          __syncwarp();
        } else {
          transform_row(Fs[i], ln, zn[warp], mrow);
        }
      }
    }
  }
}

template <bool DIR, bool BF, int D = FULL, bool RED = false, bool NOTR = false>
__global__ void __launch_bounds__(NT)
fwd_rows_kernel(Planes<BF> P, const int* __restrict__ idx,
                const float* __restrict__ tau, int n,
                const float* __restrict__ stats, Layer lp,
                const float* __restrict__ Mc, int ldm, float* __restrict__ F,
                int ldf, int relu, int has_next, Layer ln,
                float* __restrict__ Mn, int ldmn) {
  const int b = blockIdx.y;
  fwd_rows<DIR, BF, D, RED, NOTR>(P, plane_base(P, idx, b, n), __ldg(tau + b), b,
                                  blockIdx.x * BM, n, stats, lp, Mc, ldm, F, ldf, relu,
                                  has_next, ln, Mn, ldmn);
}

// ---- The f32 row pass of K1, K2's forward recompute and K11's stages -----
// rows_kernel<DIR, CC> computes what fwd_rows<DIR, false> computes, bit for
// bit (the same expressions, each output one FMA chain over k in order, the
// column sums in fwd_rows's slices and order), on another plan
// (ops/megakernel.py row_plan, one per layer):
//  * grid (ceil(n / bm), groups, B): a CTA owns bm rows (16, 8 or 4) and
//    one group of cw = 512 CC / bm output columns (32, 64 or 128; wider
//    outputs take several groups, so the trade's 512-wide last layer runs
//    256 CTAs, not 64);
//  * it forms its bm rows of C = B1 + B2^T over all n columns once, into
//    dynamic shared memory (fwd_rows regenerates them from the planes for
//    every 64-column chunk: 8 times a layer at the trade's last layer),
//    while the first tiles of M arrive;
//  * M comes in KT = 32-row tiles of the group's columns through a ring of
//    three stages, two tiles ahead (16-byte cp.async; 4-byte copies where
//    M's rows are not 16-byte aligned), and the column sums s, w of M are
//    taken from the same tiles as they pass (each thread's slice of rows,
//    in fwd_rows's order), with v precomputed once per CTA;
//  * each thread owns 2 rows x CC columns and reads C as float4 along k:
//    two C loads and four M loads (CC-vectors) per 8 CC FMAs;
//  * the next layer's transform (RMSNorm -> Linear, transform_row's
//    arithmetic) stages W in chunks of RWCH rows through shared memory,
//    read coalesced, one output column a thread: transform_row reads W
//    row-strided from every lane, which took 0.13 ms of the trade's layer
//    before its 512-wide last one (NVIDIA H100 80GB HBM3, 700.00 W).
// Its device time is the CTA's serial chain (plane loads, ring, products),
// not the card's throughput: the trade's 316 MFLOP are 4.7 us at an H100's
// f32 peak, and the planes 2 MB an element read twice, mostly from L2.
//
// The bf16 instantiation (BF: rows_bf_kernel, K1bf and K1dbf, K2bf's
// recompute, K11bf's stages) computes what fwd_rows<DIR, true> computes
// (_make_vf_body(bf16=True), ops/megakernel.py plain_vf_eval_bf16) on the
// same plans and the same code but for three parts:
//  * the CTA forms its bm rows of B1 = b1_0 Ah + b1_1 dAh and of B2^T = b2_0
//    Ah^T + b2_1 dAh^T over all n columns once a layer, in bf16 (JAX's
//    rounding points), into two arrays of dynamic shared memory, zero past
//    n and past bm; B2^T's half reads the planes at (k, i) once a layer,
//    where fwd_rows read them, 16 elements wide, once a 64-column chunk;
//  * each ring tile of M, whose column sums are taken from its f32 values
//    as in the f32 pass, is then rounded to bf16 once;
//  * the products run as bf16 mma.sync m16n8k16 on the output's transpose,
//    out^T = Mh^T [B1 | B2^T]^T: blocks of 16 of the group's columns by 8 of
//    the CTA's rows (Mh^T the A operand through ldmatrix .trans, the CTA's
//    bf16 rows the 8-wide B operand, so 8- and 4-row CTAs fill the
//    fragment), at most two blocks a warp, each over the whole reduce
//    extent. Every output's f32 accumulator takes B1's then B2^T's
//    fragment at k16 step 0, 16, ..., npad - 16, whatever the plan: any bm,
//    cc or column group gives the same bits. The accumulators go through
//    shared memory to an epilogue of one (row, column) a thread, coalesced.
// Its cc is a launch argument (one instantiation serves every plan).
constexpr int RKT = 32;     // rows of M per ring tile
constexpr int RSTAGES = 3;  // ring stages
constexpr int RWCH = 128;   // rows of the next layer's W per staged chunk
constexpr int RU = 8;       // plane elements a thread loads before it forms them

// The row pass's design probes (tools/kernel_times_torch.py K1-ablation,
// csrc/row_probe.cu gncde_mk_fwd_probe): the template parameter PROBE of
// rows_kernel, 0 on every launch of the main path. Bits 1-32 drop one part
// of its work each, so the device time of what remains can be read; RP_TF32
// takes the products as 3xTF32 on the tensor cores (mma.sync m16n8k8 on
// big/small TF32 splits, K6a's arithmetic in csrc/plane_mma.cu) in place of
// the f32 FMA loop: an f32-accurate product in another summation order.
// The bf16 pass takes bits 1-32 (K1bf-ablation, gncde_mk_fwd_bf16_probe).
enum RowProbe {
  RP_NO_PLANES = 1,   // form C from its indices, without the plane reads
  RP_NO_FORM = 2,     // no forming of C at all
  RP_NO_PRODUCT = 4,  // no C M products (BF: nor the tiles' rounding)
  RP_NO_RING = 8,     // no copies of M's tiles
  RP_NO_COLSUM = 16,  // no column sums
  RP_NO_NEXT = 32,    // no transform of the next layer's M
  RP_TF32 = 64        // the products as 3xTF32 mma.sync
};

__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// c += a b on one m16n8k8 TF32 fragment (f32 accumulation).
__device__ __forceinline__ void mma_tf32x1(float c[4], const uint32_t a[4], uint32_t b0,
                                           uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int rows_npad(int n) { return (n + RKT - 1) / RKT * RKT; }
// The ring's row width: the group's columns, or H rounded up to 4 where
// one group holds the whole layer. Its row stride: the width, plus 8 floats
// under RP_TF32 (so that a B fragment's rows q and q + 4 fall on other
// banks).
__host__ __device__ constexpr int rows_width(int cw, int H) {
  return cw < ((H + 3) & ~3) ? cw : ((H + 3) & ~3);
}
__host__ __device__ constexpr int rows_stride(int cw, int H, bool mma) {
  return rows_width(cw, H) + (mma ? 8 : 0);
}
// Dynamic shared memory of one CTA, in floats: v, then C's rows bm x (npad
// + 4) and the ring, which the next layer's W chunks (RWCH x (H + 1): H is
// that layer's input, so at most MAXIN) reuse once the products are done.
__host__ __device__ constexpr int rows_wchunk_floats(int H) {
  return H <= MAXIN ? RWCH * (H + 1) : 0;
}
__host__ __device__ constexpr int rows_smem_floats(int n, int bm, int rs, int H) {
  return rows_npad(n) + (bm * (rows_npad(n) + 4) + RSTAGES * RKT * rs > rows_wchunk_floats(H)
                             ? bm * (rows_npad(n) + 4) + RSTAGES * RKT * rs
                             : rows_wchunk_floats(H));
}
// The bf16 pass's, in bytes: v, then B1's and B2^T's bf16 rows (mma_rows(bm)
// x (npad + 8) halves each), the f32 ring (rows of rw = rows_width(cw, H))
// and one bf16 tile of it (RKT x (mma_hw(rw) + 8) halves), or the W chunks.
__host__ __device__ constexpr int rows_smem_bytes_bf(int n, int bm, int rw, int H) {
  return 4 * rows_npad(n) +
         (4 * mma_rows(bm) * (rows_npad(n) + 8) + 4 * RSTAGES * RKT * rw +
                      2 * RKT * (mma_hw(rw) + 8) > 4 * rows_wchunk_floats(H)
              ? 4 * mma_rows(bm) * (rows_npad(n) + 8) + 4 * RSTAGES * RKT * rw +
                    2 * RKT * (mma_hw(rw) + 8)
              : 4 * rows_wchunk_floats(H));
}
// Dynamic shared memory of one row-pass CTA on plan (bm, cw) of an H-wide
// layer, in bytes (mma: RP_TF32's padded ring).
__host__ __device__ constexpr int rows_smem_bytes(bool bf, int n, int bm, int cw, int H,
                                                  bool mma = false) {
  return bf ? rows_smem_bytes_bf(n, bm, rows_width(cw, H), H)
            : rows_smem_floats(n, bm, rows_stride(cw, H, mma), H) * 4;
}

// The row pass's static shared memory, declared once by each kernel that
// runs it (rows_kernel, rows_bf_kernel; K11's step_rows_kernel for every
// layer and plan).
struct RowShared {
  float colS[128], colW[128];
  float red[2][2][NT];
  float scratch[NW];
  float Fs[BM][HC];
  float zrows[BM][MAXIN];
};

// One CTA of the row pass: rows rb bm .. of element b (planes at ``base``,
// offset t), column group gr; dyn the plan's dynamic shared memory. A
// device function so that rows_kernel, rows_bf_kernel and K11 (fused_step.cu)
// run the same arithmetic; every thread of the CTA must reach it. BF: the
// bf16 pass, its plan's cc the argument cc (CC unused).
template <bool DIR, int CC, int PROBE, bool BF = false>
__device__ __forceinline__ void rows_body(RowShared& sh, float* __restrict__ dyn,
                                          const Planes<BF>& P, long long base, float t,
                                          int b, int rb, int gr, int n,
                                          const float* __restrict__ stats, const Layer& lp,
                                          const float* __restrict__ Mc, int ldm,
                                          float* __restrict__ F, int ldf, int relu,
                                          int has_next, const Layer& ln,
                                          float* __restrict__ Mn, int ldmn, int bm, int vec_m,
                                          int cc = CC) {
  constexpr bool MMA = (PROBE & RP_TF32) != 0;
  static_assert(!(BF && MMA), "the bf16 pass's products are bf16 mma.sync");
  float* colS = sh.colS;
  float* colW = sh.colW;
  float(*red)[2][NT] = sh.red;
  float* scratch = sh.scratch;
  float(*Fs)[HC] = sh.Fs;
  float(*zrows)[MAXIN] = sh.zrows;

  const int r0 = rb * bm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = lp.hout;
  const int cw = 512 * (BF ? cc : CC) / bm;
  const int g0 = gr * cw, wg = min(cw, H - g0);  // the group's columns
  const int rw = rows_width(cw, H), rs = rows_stride(cw, H, MMA);
  const int npad = rows_npad(n), ldc = npad + 4;
  float* vsh = dyn;               // [npad]
  float* Cs = vsh + npad;         // [bm][ldc]
  // BF: B1's and B2^T's rows [nbr][ldcb] as bf16 bit patterns where Cs
  // would be, then the ring, then the current tile rounded, [RKT][hwp].
  const int nbr = mma_rows(bm), ldcb = npad + 8, hw = mma_hw(rw), hwp = hw + 8;
  unsigned short* B1b = reinterpret_cast<unsigned short*>(Cs);
  unsigned short* B2b = B1b + nbr * ldcb;
  float* ring = BF ? reinterpret_cast<float*>(B2b + nbr * ldcb)
                   : Cs + bm * ldc;  // [RSTAGES][RKT][rs]
  unsigned short* Mtb = reinterpret_cast<unsigned short*>(ring + RSTAGES * RKT * rs);
  const float fn = (float)n, fn2 = fn * fn;
  const float* st = stats + (long long)b * NSTAT * n;
  const float* Mb = Mc + (long long)b * n * ldm;
  constexpr int NQ = 2 * nbasis<DIR>();
  float q[NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k) q[k] = __ldg(lp.basis + k);

  // Tile t of M: rows t RKT .., the group's columns, into stage t % RSTAGES.
  auto fetch = [&](int tile) {
    float* T = ring + (tile % RSTAGES) * RKT * rs;
    const int k0 = tile * RKT;
    if (vec_m) {
      const int gpr = rw / 4;
      for (int e = tid; e < RKT * gpr; e += NT) {
        const int kk = e / gpr, c = 4 * (e - kk * gpr), k = k0 + kk;
        const int nbytes = (k < n && c < wg) ? 4 * min(4, wg - c) : 0;
        cp_async16(T + kk * rs + c, nbytes ? Mb + (long long)k * ldm + g0 + c : Mc, nbytes);
      }
    } else {
      for (int e = tid; e < RKT * rw; e += NT) {
        const int kk = e / rw, c = e - kk * rw, k = k0 + kk;
        const bool ok = k < n && c < wg;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                         smem_u32(T + kk * rs + c)),
                     "l"(ok ? Mb + (long long)k * ldm + g0 + c : Mc), "r"(ok ? 4 : 0));
      }
    }
  };
  const int ntiles = npad / RKT;
  constexpr bool ring_on = !(PROBE & RP_NO_RING);
  if (ring_on) fetch(0);
  cp_commit();
  if (ntiles > 1 && ring_on) fetch(1);
  cp_commit();

  // Global sums every CTA needs: sA, sdA (fwd_rows's order).
  float a0 = 0.f, a1 = 0.f;
  for (int k = tid; k < n; k += NT) {
    a0 += (st + RA * n)[k];
    a1 += (st + RDA * n)[k];
  }
  const float sA = block_sum(a0, scratch);
  const float sdA = block_sum(a1, scratch);
  const float b10 = 1.f + q[0], b11 = 1.f + q[1], b20 = q[2], b21 = q[3];
  float c7, c8;
  if constexpr (DIR) {
    c7 = (q[18] + q[19]) * sA / fn2;
    c8 = (q[20] * sA + q[21] * sdA) / fn2;
  } else {
    c7 = (q[12] + q[13]) * sA / fn2;
    c8 = (q[14] * sA + q[15] * sdA) / fn2;
  }
  for (int k = tid; k < n; k += NT) {
    float v;
    if constexpr (DIR)
      v = dir_v(q, st, n, k, fn);
    else
      v = (q[8] * (st + RA * n)[k] + q[9] * (st + RDA * n)[k]) / fn;
    vsh[k] = v;
  }
  // C's rows, once: the row part B1[i, k] (coalesced along k), then the
  // column part B2[k, i] added (coalesced along i). Each thread loads RU
  // elements' four plane values before it evaluates any (4 RU loads in
  // flight: the pass is bound by their latency).
  constexpr bool form = !(PROBE & RP_NO_FORM), planes = !(PROBE & RP_NO_PLANES);
  if constexpr (BF) {
    // B1[i, k] from plane row r0 + i (pass 0, coalesced along k) and B2^T[i,
    // k] = B2[k, i] from plane column r0 + i (pass 1, coalesced along i),
    // each in bf16 (fwd_rows's chain), into arrays of their own; zero past n
    // and (bm < 8) past bm. No barrier between: the tile loop's first one.
    const float cb0 = rbf(b10), cb1 = rbf(b11), cb2 = rbf(b20), cb3 = rbf(b21);
    for (int e = bm * ldcb + tid; e < nbr * ldcb; e += NT) B1b[e] = B2b[e] = 0;
    for (int pass = 0; pass < 2 && form; ++pass) {
      unsigned short* Bb = pass == 0 ? B1b : B2b;
      const float c0 = pass == 0 ? cb0 : cb2, c1 = pass == 0 ? cb1 : cb3;
      for (int e0 = tid; e0 < bm * npad; e0 += NT * RU) {
        float pd[RU], pc[RU], pb[RU], pa[RU];
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          const int e = e0 + u * NT;
          const int i = pass == 0 ? e / npad : e % bm, k = pass == 0 ? e - i * npad : e / bm;
          const int gi = r0 + i;
          const bool ok = e < bm * npad && gi < n && k < n;
          const long long off =
              pass == 0 ? base + (long long)gi * n + k : base + (long long)k * n + gi;
          pd[u] = ok && planes ? ldp(P.d + off) : 1e-3f * e;
          pc[u] = ok && planes ? ldp(P.c + off) : 0.f;
          pb[u] = ok && planes ? ldp(P.b + off) : 0.f;
          pa[u] = ok && planes ? ldp(P.a + off) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < RU; ++u) {
          const int e = e0 + u * NT;
          if (e >= bm * npad) continue;
          const int i = pass == 0 ? e / npad : e % bm, k = pass == 0 ? e - i * npad : e / bm;
          float v = 0.f;
          if (r0 + i < n && k < n) {
            float A, dA;
            herm_vals_bf(pd[u], pc[u], pb[u], pa[u], t, A, dA);
            v = __fadd_rn(bmul(c0, A), bmul(c1, dA));
          }
          Bb[i * ldcb + k] = bf16_bits(v);
        }
      }
    }
  } else {
    for (int e0 = tid; form && e0 < bm * npad; e0 += NT * RU) {
      float pd[RU], pc[RU], pb[RU], pa[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int e = e0 + u * NT, i = e / npad, k = e - i * npad, gi = r0 + i;
        const bool ok = e < bm * npad && gi < n && k < n;
        const long long off = base + (long long)gi * n + k;
        pd[u] = ok && planes ? __ldg(P.d + off) : 1e-3f * e;
        pc[u] = ok && planes ? __ldg(P.c + off) : 0.f;
        pb[u] = ok && planes ? __ldg(P.b + off) : 0.f;
        pa[u] = ok && planes ? __ldg(P.a + off) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int e = e0 + u * NT, i = e / npad, k = e - i * npad, gi = r0 + i;
        if (e >= bm * npad) continue;
        float v = 0.f;
        if (gi < n && k < n) {
          float A, dA;
          herm_vals(pd[u], pc[u], pb[u], pa[u], t, A, dA);
          v = b10 * A + b11 * dA;
        }
        Cs[i * ldc + k] = v;
      }
    }
    __syncthreads();
    for (int e0 = tid; form && e0 < bm * n; e0 += NT * RU) {
      float pd[RU], pc[RU], pb[RU], pa[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int e = e0 + u * NT, k = e / bm, i = e - k * bm, gi = r0 + i;
        const bool ok = e < bm * n && gi < n;
        const long long off = base + (long long)k * n + gi;
        pd[u] = ok && planes ? __ldg(P.d + off) : 1e-3f * e;
        pc[u] = ok && planes ? __ldg(P.c + off) : 0.f;
        pb[u] = ok && planes ? __ldg(P.b + off) : 0.f;
        pa[u] = ok && planes ? __ldg(P.a + off) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const int e = e0 + u * NT, k = e / bm, i = e - k * bm, gi = r0 + i;
        if (e >= bm * n || gi >= n) continue;
        float A, dA;
        herm_vals(pd[u], pc[u], pb[u], pa[u], t, A, dA);
        Cs[i * ldc + k] += b20 * A + b21 * dA;
      }
    }
  }

  // The column sums' slices of fwd_rows: per 64-column chunk of the group
  // (hc its width), thread (h, sl) = (tid % hc, tid / hc) sums rows k = sl,
  // sl + nsl, ... (nsl = NT / hc) in order.
  const int nchunk = (wg + HC - 1) / HC;
  int hcw[2], knext[2];
  float s_[2] = {0.f, 0.f}, w_[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    hcw[c] = c < nchunk ? min(HC, wg - c * HC) : 1;
    const int nsl = NT / hcw[c], sl = tid / hcw[c];
    knext[c] = (c < nchunk && sl < nsl) ? sl : n;
  }

  // The thread's outputs: rows rg, rg + bm / 2; columns cb .. cb + CC - 1.
  const int rgw = bm / 2, cgw = 32 / rgw;
  const int rg = lane / cgw, cb = (warp * cgw + lane % cgw) * CC;
  float acc[2][CC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[r][c] = 0.f;
  const float* C0 = Cs + rg * ldc;
  const float* C1 = Cs + (rg + rgw) * ldc;

  // RP_TF32: the group's ntn n-tiles of 8 columns and each ring tile's 4
  // k-steps of 8 rows are dealt to the warps, ksp k-step slots of nwn warps
  // (ksp = 1, 2 or 4 as ntn falls, so every warp has work; at most 2
  // n-tiles a warp). A fragment: rows gid, gid + 8 of C (zero at or past
  // bm); B fragment: rows q4, q4 + 4 of the tile, column gid of the n-tile.
  const int ntn = (wg + 7) / 8;
  const int ksp = ntn >= NW ? 1 : ntn >= NW / 2 ? 2 : 4, nwn = NW / ksp;
  const int gid = lane / 4, q4 = lane % 4, mwn = warp % nwn, mks = warp / nwn;
  const bool ra = gid < bm, rb8 = gid + 8 < bm;
  float cm[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cm[j][e] = 0.f;
  auto tf32_tile = [&](const float* T, int k0) {
    const float* Ca = Cs + gid * ldc + k0 + q4;
    for (int ks = mks; ks < RKT / 8; ks += ksp) {
      const float* ca = Ca + ks * 8;
      float af[4];
      af[0] = ra ? ca[0] : 0.f;
      af[1] = rb8 ? ca[8 * ldc] : 0.f;
      af[2] = ra ? ca[4] : 0.f;
      af[3] = rb8 ? ca[8 * ldc + 4] : 0.f;
      uint32_t ab[4], as[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ab[e] = tf32_of(af[e]);
        as[e] = tf32_of(af[e] - __uint_as_float(ab[e]));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = (mwn + j * nwn) * 8 + gid;
        if (mwn + j * nwn >= ntn) break;  // warp-uniform
        const float* tp = T + (ks * 8 + q4) * rs + col;
        const float v0 = col < wg ? tp[0] : 0.f, v1 = col < wg ? tp[4 * rs] : 0.f;
        const uint32_t bb0 = tf32_of(v0), bb1 = tf32_of(v1);
        const uint32_t bs0 = tf32_of(v0 - __uint_as_float(bb0));
        const uint32_t bs1 = tf32_of(v1 - __uint_as_float(bb1));
        mma_tf32x1(cm[j], ab, bs0, bs1);
        mma_tf32x1(cm[j], as, bb0, bb1);
        mma_tf32x1(cm[j], ab, bb0, bb1);
      }
    }
  };

  // BF: the output's transpose in blocks of (16 of the group's columns) x
  // (8 of the CTA's rows), nblk of them, block j on warp j % NW (two a warp
  // at most); entry f of a block's accumulator is column mb 16 + gid + 8 (f
  // >> 1), row nb 8 + 2 q4 + (f & 1).
  const int nnb = (bm + 7) / 8, nblk = hw / 16 * nnb;
  float bacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  auto bf16_tile = [&](const float* T, int k0) {
    // The tile rounded to bf16 once (columns past rw zero).
    const int hp2 = hw / 2;
    for (int e = tid; e < RKT * hp2; e += NT) {
      const int kk = e / hp2, c = 2 * (e - kk * hp2);
      const float* src = T + kk * rs + c;
      *reinterpret_cast<__nv_bfloat162*>(Mtb + kk * hwp + c) =
          __floats2bfloat162_rn(c < rw ? src[0] : 0.f, c + 1 < rw ? src[1] : 0.f);
    }
    __syncthreads();
    const int m = lane >> 3, r = lane & 7;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = warp + jj * NW;
      if (j >= nblk) break;  // warp-uniform
      const int mb = j / nnb, nb = j - mb * nnb;
#pragma unroll
      for (int ks = 0; ks < RKT; ks += 16) {
        uint32_t a0, a1, a2, a3, b0, b1;
        ldsm_x4_t(a0, a1, a2, a3, Mtb + (ks + (m >> 1) * 8 + r) * hwp + mb * 16 + (m & 1) * 8);
        const int o = (nb * 8 + r) * ldcb + k0 + ks + (m & 1) * 8;
        ldsm_x2(b0, b1, B1b + o);
        mma_bf16(bacc[jj], a0, a1, a2, a3, b0, b1);
        ldsm_x2(b0, b1, B2b + o);
        mma_bf16(bacc[jj], a0, a1, a2, a3, b0, b1);
      }
    }
  };

  for (int tile = 0; tile < ntiles; ++tile) {
    cp_wait1();
    __syncthreads();  // tile's stage landed; C and v complete (first tile)
    if (tile + 2 < ntiles && ring_on) fetch(tile + 2);
    cp_commit();
    const float* T = ring + (tile % RSTAGES) * RKT * rs;
    const int k0 = tile * RKT, kend = min(k0 + RKT, n);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int nsl = NT / hcw[c], h = c * HC + tid % hcw[c];
      for (; knext[c] < kend && !(PROBE & RP_NO_COLSUM); knext[c] += nsl) {
        const float m = T[(knext[c] - k0) * rs + h];
        s_[c] += m;
        w_[c] += vsh[knext[c]] * m;
      }
    }
    if constexpr (BF) {
      if constexpr (!(PROBE & RP_NO_PRODUCT)) bf16_tile(T, k0);
    } else if constexpr (MMA) {
      tf32_tile(T, k0);
    } else if (cb < wg && !(PROBE & RP_NO_PRODUCT)) {
#pragma unroll
      for (int kk = 0; kk < RKT; kk += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(C0 + k0 + kk);
        const float4 x1 = *reinterpret_cast<const float4*>(C1 + k0 + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* mrow = T + (kk + u) * rs + cb;
          float m[CC];
          if constexpr (CC == 4) {
            const float4 v = *reinterpret_cast<const float4*>(mrow);
            m[0] = v.x; m[1] = v.y; m[2] = v.z; m[3] = v.w;
          } else if constexpr (CC == 2) {
            const float2 v = *reinterpret_cast<const float2*>(mrow);
            m[0] = v.x; m[1] = v.y;
          } else {
            m[0] = mrow[0];
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
  }

  if constexpr (MMA) {
    // The fragments to shared memory (over the ring, done with: its last
    // groups were empty), the k-step slots' parts added in slot order, then
    // read back in the FMA loop's layout for the epilogue.
    __syncthreads();
    float* Pm = ring;  // [bm][rs]
    for (int sl = 0; sl < ksp; ++sl) {
      if (mks == sl) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int nt = mwn + j * nwn;
          if (nt >= ntn) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = gid + (e >= 2 ? 8 : 0), c = nt * 8 + 2 * q4 + (e & 1);
            if (i < bm && c < wg) Pm[i * rs + c] = sl == 0 ? cm[j][e] : Pm[i * rs + c] + cm[j][e];
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < CC; ++c)
        if (cb + c < wg) acc[r][c] = Pm[(rg + r * rgw) * rs + cb + c];
  }
  if constexpr (BF) {
    // The blocks' accumulators to shared memory over the ring (done with),
    // [bm][rs], for the epilogue.
    cp_wait0();
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = warp + jj * NW;
      if (j >= nblk) break;
      const int mb = j / nnb, nb = j - mb * nnb;
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int h = mb * 16 + gid + 8 * (f >> 1), i = nb * 8 + 2 * q4 + (f & 1);
        if (i < bm && h < rw) ring[i * rs + h] = bacc[jj][f];
      }
    }
  }

  // The slices' sums, in slice order.
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    red[c][0][tid] = s_[c];
    red[c][1][tid] = w_[c];
  }
  __syncthreads();
  for (int c = 0; c < nchunk; ++c) {
    const int hc = hcw[c], nsl = NT / hc;
    if (tid < hc) {
      float ss = 0.f, ww = 0.f;
      for (int s2 = 0; s2 < nsl; ++s2) {
        ss += red[c][0][s2 * hc + tid];
        ww += red[c][1][s2 * hc + tid];
      }
      colS[c * HC + tid] = ss;
      colW[c * HC + tid] = ww;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; !BF && r < 2; ++r) {
    const int i = rg + r * rgw, gi = r0 + i;
    if (gi >= n || cb >= wg) continue;
    float dvec, u;
    if constexpr (DIR) {
      dvec = dir_dvec(q, st, n, gi, fn, c8);
      u = dir_u(q, st, n, gi, fn);
    } else {
      dvec = q[4] * st[DGA * n + gi] + q[5] * st[DGDA * n + gi] +
             (q[10] * (st + RA * n)[gi] + q[11] * (st + RDA * n)[gi]) / fn + c8 + 1.f;
      u = (q[6] * (st + RA * n)[gi] + q[7] * (st + RDA * n)[gi]) / fn;
    }
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const int hl = cb + c, h = g0 + hl;
      if (hl >= wg) continue;
      const float m = Mb[(long long)gi * ldm + h];
      float val = acc[r][c] + dvec * m + u * colS[hl] + (colW[hl] + c7 * colS[hl]);
      if (relu) val = fmaxf(val, 0.f);
      if (F != nullptr) F[((long long)b * n + gi) * ldf + h] = val;
      if (has_next) Fs[i][hl] = val;
    }
  }
  // BF: one (row, column) a thread, the f32 epilogue's expression.
  for (int e = tid; BF && e < bm * wg; e += NT) {
    const int i = e / wg, hl = e - i * wg, gi = r0 + i, h = g0 + hl;
    if (gi >= n) continue;
    float dvec, u;
    if constexpr (DIR) {
      dvec = dir_dvec(q, st, n, gi, fn, c8);
      u = dir_u(q, st, n, gi, fn);
    } else {
      dvec = q[4] * st[DGA * n + gi] + q[5] * st[DGDA * n + gi] +
             (q[10] * (st + RA * n)[gi] + q[11] * (st + RDA * n)[gi]) / fn + c8 + 1.f;
      u = (q[6] * (st + RA * n)[gi] + q[7] * (st + RDA * n)[gi]) / fn;
    }
    const float m = Mb[(long long)gi * ldm + h];
    float val = ring[i * rs + hl] + dvec * m + u * colS[hl] + (colW[hl] + c7 * colS[hl]);
    if (relu) val = fmaxf(val, 0.f);
    if (F != nullptr) F[((long long)b * n + gi) * ldf + h] = val;
    if (has_next) Fs[i][hl] = val;
  }
  if (has_next && !(PROBE & RP_NO_NEXT)) {  // then H <= MAXIN: one group a row
    __syncthreads();
    // transform_row's RMSNorm, one warp a row.
    const int hin = ln.hin;
    for (int i = warp; i < bm; i += NW) {
      if (r0 + i >= n) continue;
      float ss = 0.f;
      for (int j = lane; j < hin; j += 32) {
        const float v = Fs[i][j];
        ss += v * v;
      }
      ss = warp_sum(ss);
      const float inv = rsqrtf(ss / (float)hin + EPS);
      for (int j = lane; j < hin; j += 32)
        zrows[i][j] = Fs[i][j] * inv * __ldg(ln.nw + j) + __ldg(ln.nb + j);
    }
    // Its Linear, W in chunks of RWCH rows (over C and the ring, done with).
    float* Ws = Cs;  // [RWCH][hin + 1]
    const int ldw = hin + 1, hh = tid % RWCH;
    for (int h0 = 0; h0 < ln.hout; h0 += RWCH) {
      const int rows_w = min(RWCH, ln.hout - h0);
      __syncthreads();  // the previous chunk consumed (first: zrows written)
      for (int e = tid; e < rows_w * hin; e += NT) {
        const int r = e / hin, j = e - r * hin;
        Ws[r * ldw + j] = __ldg(ln.W + (long long)h0 * hin + e);
      }
      __syncthreads();
      if (hh < rows_w) {
        const float lb = __ldg(ln.lb + h0 + hh);
        for (int i = tid / RWCH; i < bm; i += NT / RWCH) {
          const int gi = r0 + i;
          if (gi >= n) continue;
          float acc = 0.f;
          for (int j = 0; j < hin; ++j) acc += zrows[i][j] * Ws[hh * ldw + j];
          Mn[((long long)b * n + gi) * ldmn + h0 + hh] = acc + lb;
        }
      }
    }
  }
}

template <bool DIR, int CC, int PROBE>
__global__ void __launch_bounds__(NT)
rows_kernel(Planes<false> P, const int* __restrict__ idx, const float* __restrict__ tau,
            int n, const float* __restrict__ stats, Layer lp,
            const float* __restrict__ Mc, int ldm, float* __restrict__ F, int ldf,
            int relu, int has_next, Layer ln, float* __restrict__ Mn, int ldmn, int bm,
            int vec_m) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ RowShared sh;
  const int b = blockIdx.z;
  rows_body<DIR, CC, PROBE>(sh, dyn, P, plane_base(P, idx, b, n), __ldg(tau + b), b,
                            blockIdx.x, blockIdx.y, n, stats, lp, Mc, ldm, F, ldf, relu,
                            has_next, ln, Mn, ldmn, bm, vec_m);
}

// The bf16 row pass (K1bf, K1dbf, K2bf's recompute): the plan's cc an
// argument; at most 128 registers, two CTAs an SM where shared memory
// allows.
template <bool DIR, int PROBE>
__global__ void __launch_bounds__(NT, 2)
rows_bf_kernel(Planes<true> P, const int* __restrict__ idx, const float* __restrict__ tau,
               int n, const float* __restrict__ stats, Layer lp,
               const float* __restrict__ Mc, int ldm, float* __restrict__ F, int ldf,
               int relu, int has_next, Layer ln, float* __restrict__ Mn, int ldmn, int bm,
               int vec_m, int cc) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ RowShared sh;
  const int b = blockIdx.z;
  rows_body<DIR, 1, PROBE, true>(sh, dyn, P, plane_base(P, idx, b, n), __ldg(tau + b), b,
                                 blockIdx.x, blockIdx.y, n, stats, lp, Mc, ldm, F, ldf, relu,
                                 has_next, ln, Mn, ldmn, bm, vec_m, cc);
}

// One row pass of layer l on plan (bm, cc, groups): rows_kernel<DIR, cc,
// PROBE> (BF: rows_bf_kernel<DIR, PROBE>) on grid (ceil(n / bm), groups,
// B). The shared-memory allowance (the largest plan's, n = MAXN, with
// RP_TF32's padded ring) is set once per device and instantiation.
template <bool DIR, int CC, int PROBE, bool BF>
static int launch_rows_cc(const Planes<BF>& P, const int* idx, const float* tau, int B,
                          int n, const float* stats, const Layer& lp, const float* Mc,
                          int ldm, float* F, int ldf, int relu, int has_next,
                          const Layer& ln, float* Mn, int ldmn, int bm, int cc, int groups,
                          cudaStream_t stream) {
  static bool allowed[64];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= 64 || !allowed[dev]) {
    constexpr int most = rows_smem_bytes(BF, MAXN, BM, 128, MAXOUT, !BF);
    if constexpr (BF)
      err = (int)cudaFuncSetAttribute(rows_bf_kernel<DIR, PROBE>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    else
      err = (int)cudaFuncSetAttribute(rows_kernel<DIR, CC, PROBE>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != 0) return err;
    if (dev < 64) allowed[dev] = true;
  }
  const int cw = 512 * cc / bm;
  const int vec_m = ldm % 4 == 0 && ((uintptr_t)Mc & 15) == 0;
  const int bytes = rows_smem_bytes(BF, n, bm, cw, lp.hout, (PROBE & RP_TF32) != 0);
  const dim3 grid((n + bm - 1) / bm, groups, B);
  if constexpr (BF)
    rows_bf_kernel<DIR, PROBE><<<grid, NT, bytes, stream>>>(
        P, idx, tau, n, stats, lp, Mc, ldm, F, ldf, relu, has_next, ln, Mn, ldmn, bm, vec_m,
        cc);
  else
    rows_kernel<DIR, CC, PROBE><<<grid, NT, bytes, stream>>>(
        P, idx, tau, n, stats, lp, Mc, ldm, F, ldf, relu, has_next, ln, Mn, ldmn, bm, vec_m);
  return (int)cudaGetLastError();
}

// plan: (bm, cc, groups) of this layer; refused unless cw = 512 cc / bm is
// 32, 64 or 128, the groups cover H, and a layer that feeds another is one
// group. PROBE: RowProbe bits, 0 on the main path; an f32 probe takes no
// plan of cc = 2 (none of the ablation's shapes has one). BF: the bf16 pass,
// one instantiation for every cc.
template <bool DIR, int PROBE = 0, bool BF = false>
static int launch_rows(const Planes<BF>& P, const int* idx, const float* tau, int B, int n,
                       const float* stats, const Layer& lp, const float* Mc, int ldm,
                       float* F, int ldf, int relu, int has_next, const Layer& ln, float* Mn,
                       int ldmn, const int* plan, cudaStream_t stream) {
  const int bm = plan[0], cc = plan[1], groups = plan[2];
  if ((bm != 4 && bm != 8 && bm != 16) || (cc != 1 && cc != 2 && cc != 4) || groups < 1 ||
      groups > 65535 || n > MAXN)
    return (int)cudaErrorInvalidValue;
  const int cw = 512 * cc / bm;
  if (cw < 32 || cw > 128 || (long long)groups * cw < lp.hout ||
      (long long)(groups - 1) * cw >= lp.hout || (has_next && groups != 1))
    return (int)cudaErrorInvalidValue;
  if constexpr (BF) {
    return launch_rows_cc<DIR, 1, PROBE, true>(P, idx, tau, B, n, stats, lp, Mc, ldm, F, ldf,
                                               relu, has_next, ln, Mn, ldmn, bm, cc, groups,
                                               stream);
  } else {
    switch (cc) {
      case 1:
        return launch_rows_cc<DIR, 1, PROBE, false>(P, idx, tau, B, n, stats, lp, Mc, ldm, F,
                                                    ldf, relu, has_next, ln, Mn, ldmn, bm, cc,
                                                    groups, stream);
      case 2:
        if constexpr (PROBE == 0)
          return launch_rows_cc<DIR, 2, 0, false>(P, idx, tau, B, n, stats, lp, Mc, ldm, F,
                                                  ldf, relu, has_next, ln, Mn, ldmn, bm, cc,
                                                  groups, stream);
        return (int)cudaErrorInvalidValue;
      default:
        return launch_rows_cc<DIR, 4, PROBE, false>(P, idx, tau, B, n, stats, lp, Mc, ldm, F,
                                                    ldf, relu, has_next, ln, Mn, ldmn, bm, cc,
                                                    groups, stream);
    }
  }
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

// K1's passes: the prep pass, then one row pass per layer on the layer's
// plan, plan + 3 l (BF: the bf16 row pass), layer l's M in Mbuf's l-th (B,
// n, ldm) buffer, the last layer's output in out. PROBE: the row passes'
// RowProbe bits (0 on the main path). Returns the first CUDA error.
template <bool DIR, bool BF, int PROBE = 0>
static int mk_fwd(const Planes<BF>& P, const int* idx, const float* tau, const float* Z,
                  int B, int n, int L, const int* dims, const void* const* ptrs,
                  const int* plan, float* stats, float* Mbuf, int ldm, float* out,
                  cudaStream_t stream) {
  const dim3 grid((n + BM - 1) / BM, B);
  const long long mstride = (long long)B * n * ldm;
  Layer l0 = layer_from(ptrs, dims, 0);
  prep_kernel<DIR, BF><<<grid, NT, 0, stream>>>(P, idx, tau, n, Z, dims[0], l0, Mbuf,
                                                ldm, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    Layer lp = layer_from(ptrs, dims, l);
    Layer ln = last ? lp : layer_from(ptrs, dims, l + 1);
    float* Mc = Mbuf + l * mstride;
    float* Mn = last ? nullptr : Mbuf + (l + 1) * mstride;
    const int e = launch_rows<DIR, PROBE, BF>(P, idx, tau, B, n, stats, lp, Mc, ldm,
                                              last ? out : nullptr, dims[2 * l + 1],
                                              last ? 0 : 1, last ? 0 : 1, ln, Mn, ldm,
                                              plan + 3 * l, stream);
    if (e != 0) return e;
  }
  return 0;
}

}  // namespace mk
