// K11: one explicit FSAL Runge-Kutta step of the perm-equiv field (the
// undirected 8-term basis or the directed 11-term one) in one cooperative
// launch.
//
// Replaces gncde_tpu/ops/pallas/fused_step.py (_make_step_kernel /
// _step_call, both values of its ``directed`` flag): one pallas_call per
// solver step, grid (batch, stages), the
// stage derivatives k_1 .. k_S in VMEM. On the TPU that grid runs in order
// on one core. Here one cooperative launch runs the step; the phases that
// need every row of the previous one are separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()). Per stage s (0-based, the
// tableau's stage s + 1):
//
//   1. per 16-row block of each element: the block's rows of the stage
//      input  Yi = y + h sum_{j<=s} a[s][j] k_j  (k_0 = f0; row-local), then
//      prep_rows at (idx[b, s], tau[b, s]): the row statistics and layer
//      0's M rows;                                          -- grid sync --
//   2. L row passes (each layer reads every row of the previous M); the
//      last writes k_{s+1} into ks[b, s].       -- grid sync after each
//      layer (the next stage's prep overwrites the statistics that the
//      last layer still reads in other CTAs) --
//
// and after the last stage the row-local y1 = y + h sum_j b_j k_j,
// err = h sum_j e_j k_j and f1 = k_S. The tableau rows are kernel
// arguments, so one build serves Tsit5, Dopri5 and Bosh3. The basis is the
// kernel's template parameter DIR, passed on to prep_rows and the row
// pass: the directed prep also writes the column sums of the stage's
// planes, before the grid barrier that already follows it.
//
// The step (K11, K11d; under fusion_precision bf16 K11bf, K11dbf:
// step_rows_kernel<DIR, BF>) has G CTAs, at most the resident capacity, and
// each phase is a list of virtual CTAs that they walk in order: the 16-row
// blocks for the stage input and the prep, and for each layer the (row
// block, column group) CTAs of its row-pass plan (ops/fused_step.py
// step_plans: K1's row_plan on CTAs of 8 or 4 rows), each running
// rows_kernel's own device function (megakernel_common.cuh rows_body). So
// each stage derivative is one K1 eval's arithmetic on its plan, bit for
// bit (any plan gives the same bits), and the dynamic shared memory is the
// largest of the layers' plans.
//
// The stage combinations are formed in the per-stage solver's order (terms
// in stage order, every product and sum rounded once: __fmul_rn / __fadd_rn,
// no contraction), so a step's y1, err and f1 equal the per-stage K1
// route's bit for bit. No atomics: every output element is written by one
// thread in a fixed order, so two launches are bitwise equal, as the
// checkpointed adjoint's recomputation of a step needs. One code path
// writes ks whether or not the caller differentiates. Stage s reads only
// the slots k_1 .. k_s, which it has written (an explicit tableau's a[s][j]
// vanishes for j > s), so no unset slot, and no 0 * inf, reaches a stage
// input; the TPU kernel zeroes its VMEM scratch for the same reason.
//
// What bounds it on the card: per stage and layer the row pass forms its
// rows of C from the four planes (one element's planes are 2.56 MB at n =
// 400, so the re-reads after the first mostly hit L2) and does 4 n^2 H
// FLOPs per element in f32 FMA; the least time is set by the S L (4 n^2 H)
// f32 FLOPs per element. In practice a row pass is a CTA's serial chain,
// so the step costs about its S (1 + L) launches of K1's kernels, plus the
// grid barriers; gncde_fused_step_capacity gives how many CTAs fit at once
// with the plans' shared memory, and the wrapper launches the batch in
// chunks of whole elements' 16-row blocks that do.
//
// K11bf (BF, fusion_precision bf16, _make_step_kernel(bf16=True)): the same
// step on bfloat16 planes, each stage's eval K1bf's device code (prep_rows
// and the bf16 rows_body: B1 and B2^T formed in bf16 once a layer, the n x
// n products on the tensor cores), so bit for bit the per-stage K1bf route
// on any plan; the stage combinations stay f32. Its backward is one K2bf
// per stage.
#include <cooperative_groups.h>

#include "megakernel_common.cuh"

namespace cg = cooperative_groups;
using namespace mk;

namespace fs {

constexpr int SMAX = 8;  // most evaluated stages (Tsit5, Dopri5: 6; Bosh3: 3)
constexpr int LMAX = 8;  // most layers

// The stages' row-pass plan per layer (ops/megakernel.py row_plan): CTA
// height bm, columns per thread cc, column groups.
struct StepPlan {
  int bm[LMAX], cc[LMAX], groups[LMAX];
};

template <bool BF>
struct StepArgs {
  Planes<BF> P;
  const int* idx;    // (B, S) interval of each stage's node
  const float* tau;  // (B, S) offset into it
  const float* h;    // (B,)
  const float* y;    // (B, n, H)
  const float* f0;   // (B, n, H)
  float a[SMAX][SMAX];  // a[s][j]: weight of k_j (k_0 = f0) in stage s's input
  float bw[SMAX + 1];   // solution weights of k_0 .. k_S
  float ew[SMAX + 1];   // error weights of k_0 .. k_S
  Layer layers[LMAX];
  int S, n, H, L, ldm;
  int b0;        // first batch element of this launch (blockIdx.y offset)
  int Btot;      // batch size of the buffers
  float* stats;  // (B, NSTAT, n)
  float* Mbuf;   // (2, B, n, ldm)
  float* Yi;     // (B, n, H) stage input
  float* ks;     // (B, S, n, H): k_1 .. k_S
  float* y1;     // (B, n, H)
  float* err;
  float* f1;
  int nb;        // batch elements of this launch
  StepPlan plan; // each layer's row-pass plan
};

// The stages' dynamic shared memory: the largest of the layers' row-pass
// plans (megakernel_common.cuh rows_smem_bytes), in bytes.
inline int step_smem_bytes(bool bf, const int* dims, int L, int n, const StepPlan& pl) {
  int most = 0;
  for (int l = 0; l < L; ++l) {
    const int f = rows_smem_bytes(bf, n, pl.bm[l], 512 * pl.cc[l] / pl.bm[l], dims[2 * l + 1]);
    most = f > most ? f : most;
  }
  return most;
}
// The most any plan can ask for (n = MAXN, CTAs of 8 rows, 64 columns: the
// stages' plans take CTAs of 8 or 4 rows, one column a thread, which hold
// any layer of the step, at most MAXIN wide, in one group; the bf16 pass's
// 4-row CTAs take 8 rows of B1 and B2^T and 128 columns, so both heights
// are counted).
constexpr int step_smem_most(bool bf) {
  return rows_smem_bytes(bf, MAXN, 8, 64, MAXIN) > rows_smem_bytes(bf, MAXN, 4, 128, MAXIN)
             ? rows_smem_bytes(bf, MAXN, 8, 64, MAXIN)
             : rows_smem_bytes(bf, MAXN, 4, 128, MAXIN);
}

// K11 and K11d (BF: K11bf, K11dbf): the grid is G CTAs, at most the
// resident capacity, fixed for the launch. Each phase's work is a list of
// virtual CTAs that the G CTAs walk in order (v = blockIdx.x, + G, ...): the
// stage input, the prep and the step's outputs in 16-row blocks of each
// element, each layer in its row-pass plan's (row block, column group) CTAs
// -- the row pass's arithmetic (rows_body), so every stage derivative is the
// per-stage K1 (K1bf) route's bit for bit. Its plans take CTAs of 8 or 4
// rows (ops/fused_step.py STEP_BMS), one column a thread, so one
// instantiation of the row pass serves every layer; two CTAs an SM (at most
// 128 registers a thread), so the flagship's 200 row-pass CTAs a layer are
// all resident.
template <bool DIR, bool BF>
__global__ void __launch_bounds__(NT, 2) step_rows_kernel(const StepArgs<BF> A) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float dyn[];
  __shared__ RowShared sh;
  const int n = A.n, H = A.H, S = A.S, L = A.L;
  const long long nH = (long long)n * H;
  const long long mhalf = (long long)A.Btot * n * A.ldm;  // one M buffer
  const int nrb = (n + BM - 1) / BM, nv = A.nb * nrb;      // 16-row blocks
  const int G = gridDim.x;

  for (int s = 0; s < S; ++s) {
    // 1-2. Per 16-row block: the stage input (own rows), then the
    // statistics and layer 0's M rows at the stage's node.
    for (int v = blockIdx.x; v < nv; v += G) {
      const int b = A.b0 + v / nrb, r0 = (v % nrb) * BM;
      const long long own = (long long)b * nH + (long long)r0 * H;
      const int cnt = (min(r0 + BM, n) - r0) * H;
      const float* f0 = A.f0 + own;
      const float* kown = A.ks + (long long)b * S * nH + (long long)r0 * H;
      const float hb = __ldg(A.h + b);
      __syncthreads();
      for (int e = threadIdx.x; e < cnt; e += NT) {
        float acc = __fmul_rn(A.a[s][0], f0[e]);
        for (int j = 1; j <= s; ++j)
          acc = __fadd_rn(acc, __fmul_rn(A.a[s][j], kown[(j - 1) * nH + e]));
        A.Yi[own + e] = __fadd_rn(A.y[own + e], __fmul_rn(hb, acc));
      }
      __syncthreads();
      const long long base =
          (long long)b * A.P.bstride + (long long)__ldg(A.idx + b * S + s) * n * n;
      prep_rows<DIR, BF>(A.P, base, __ldg(A.tau + b * S + s), b, r0, n, A.Yi, H,
                         A.layers[0], A.Mbuf, A.ldm, A.stats);
    }
    grid.sync();
    // 3. The layer stack, each layer on its plan; rows_body stores row gi
    // of element b at F + (b n + gi) ldf, so F is shifted to land in slot s
    // of ks.
    for (int l = 0; l < L; ++l) {
      const bool last = l == L - 1;
      const int bm = A.plan.bm[l], groups = A.plan.groups[l];
      const int per = ((n + bm - 1) / bm) * groups;  // virtual CTAs an element
      for (int v = blockIdx.x; v < A.nb * per; v += G) {
        const int b = A.b0 + v / per, w = v % per;
        const long long base =
            (long long)b * A.P.bstride + (long long)__ldg(A.idx + b * S + s) * n * n;
        float* F = last ? A.ks + ((long long)b * (S - 1) + s) * nH : nullptr;
        __syncthreads();  // the previous CTA's reads of the shared memory done
        rows_body<DIR, 1, 0, BF>(sh, dyn, A.P, base, __ldg(A.tau + b * S + s), b, w / groups,
                                 w % groups, n, A.stats, A.layers[l],
                                 A.Mbuf + (l % 2) * mhalf, A.ldm, F, H, last ? 0 : 1,
                                 last ? 0 : 1, A.layers[last ? l : l + 1],
                                 A.Mbuf + ((l + 1) % 2) * mhalf, A.ldm, bm, A.ldm % 4 == 0,
                                 A.plan.cc[l]);
      }
      grid.sync();
    }
  }

  // The step's outputs, per 16-row block; k_S is slot S - 1.
  for (int v = blockIdx.x; v < nv; v += G) {
    const int b = A.b0 + v / nrb, r0 = (v % nrb) * BM;
    const long long own = (long long)b * nH + (long long)r0 * H;
    const int cnt = (min(r0 + BM, n) - r0) * H;
    const float* kown = A.ks + (long long)b * S * nH + (long long)r0 * H;
    const float hb = __ldg(A.h + b);
    for (int e = threadIdx.x; e < cnt; e += NT) {
      const float k0 = A.f0[own + e];
      float bacc = __fmul_rn(A.bw[0], k0), eacc = __fmul_rn(A.ew[0], k0);
      for (int j = 1; j <= S; ++j) {
        const float kj = kown[(j - 1) * nH + e];
        bacc = __fadd_rn(bacc, __fmul_rn(A.bw[j], kj));
        eacc = __fadd_rn(eacc, __fmul_rn(A.ew[j], kj));
      }
      A.y1[own + e] = __fadd_rn(A.y[own + e], __fmul_rn(hb, bacc));
      A.err[own + e] = __fmul_rn(hb, eacc);
      A.f1[own + e] = kown[(S - 1) * nH + e];
    }
  }
}

}  // namespace fs

using namespace fs;

// The kernels' shared-memory allowance (step_smem_most), set once per
// device, basis and precision; 0 or a CUDA error.
template <bool DIR, bool BF>
static int allow_step_smem() {
  static bool allowed[64];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < 64 && allowed[dev]) return 0;
  err = (int)cudaFuncSetAttribute(step_rows_kernel<DIR, BF>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  step_smem_most(BF));
  if (err == 0 && dev < 64) allowed[dev] = true;
  return err;
}

// How many CTAs of the step's kernel (directed basis or not, bf16 or not)
// with ``smem`` bytes of dynamic shared memory can be resident at once on
// the current device (blocks per SM times SMs); 0 on error.
template <bool DIR, bool BF>
static int capacity_of(int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (allow_step_smem<DIR, BF>() != 0) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, step_rows_kernel<DIR, BF>, NT,
                                                    smem) != cudaSuccess)
    return 0;
  return per_sm * sms;
}

// smem: the kernel's dynamic shared memory in bytes.
extern "C" int gncde_fused_step_capacity(int directed, int bf16, int smem) {
  if (smem < 0 || smem > step_smem_most(bf16 != 0)) return 0;
  if (bf16) return directed ? capacity_of<true, true>(smem) : capacity_of<false, true>(smem);
  return directed ? capacity_of<true, false>(smem) : capacity_of<false, false>(smem);
}

template <bool BF>
static int launch_step(const void* d, const void* c, const void* b, const void* a,
                       long long plane_bstride, const int* idx, const float* tau,
                       const float* h, const float* y, const float* f0, int Btot, int b0,
                       int nb, int n, int S, const float* amat, const float* bvec,
                       const float* berr, int L, const int* dims, const void* const* ptrs,
                       const int* plan, int directed, float* stats, float* Mbuf, int ldm,
                       float* Yi, float* ks, float* y1, float* err, float* f1,
                       cudaStream_t stream) {
  using T = typename Planes<BF>::T;
  StepArgs<BF> A;
  A.P = Planes<BF>{static_cast<const T*>(d), static_cast<const T*>(c),
                   static_cast<const T*>(b), static_cast<const T*>(a), plane_bstride};
  A.idx = idx;
  A.tau = tau;
  A.h = h;
  A.y = y;
  A.f0 = f0;
  for (int s = 0; s < SMAX; ++s)
    for (int j = 0; j < SMAX; ++j) A.a[s][j] = (s < S && j < S) ? amat[s * S + j] : 0.f;
  for (int j = 0; j <= SMAX; ++j) {
    A.bw[j] = j <= S ? bvec[j] : 0.f;
    A.ew[j] = j <= S ? berr[j] : 0.f;
  }
  for (int l = 0; l < L; ++l) A.layers[l] = layer_from(ptrs, dims, l);
  A.S = S;
  A.n = n;
  A.H = dims[0];
  A.L = L;
  A.ldm = ldm;
  A.b0 = b0;
  A.Btot = Btot;
  A.stats = stats;
  A.Mbuf = Mbuf;
  A.Yi = Yi;
  A.ks = ks;
  A.y1 = y1;
  A.err = err;
  A.f1 = f1;
  A.nb = nb;
  void* args[] = {&A};
  cudaError_t e;
  // The plans: CTAs of 8 or 4 rows, one column a thread (cw = 64 or 128
  // columns, one group: every layer of the step is at most MAXIN wide).
  int most = (n + BM - 1) / BM;  // virtual CTAs an element: prep and outputs
  for (int l = 0; l < L; ++l) {
    const int bm = plan[3 * l], cc = plan[3 * l + 1], groups = plan[3 * l + 2];
    if ((bm != 4 && bm != 8) || cc != 1 || groups != 1) return (int)cudaErrorInvalidValue;
    A.plan.bm[l] = bm;
    A.plan.cc[l] = cc;
    A.plan.groups[l] = groups;
    const int per = (n + bm - 1) / bm * groups;
    most = per > most ? per : most;
  }
  const int smem = step_smem_bytes(BF, dims, L, n, A.plan);
  const int cap = directed ? capacity_of<true, BF>(smem) : capacity_of<false, BF>(smem);
  if (cap < 1) return (int)cudaErrorInvalidConfiguration;
  const long long want = (long long)most * nb;
  const int G = want < cap ? (int)want : cap;
  const void* fn = directed ? (const void*)step_rows_kernel<true, BF>
                            : (const void*)step_rows_kernel<false, BF>;
  e = cudaLaunchCooperativeKernel(fn, dim3(G), dim3(NT), args, (size_t)smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One step for batch elements b0 .. b0 + nb - 1 (one cooperative launch of
// G CTAs, at most the resident capacity). Buffers are sized for the whole
// batch Btot. amat: host (S, S)
// row-major; bvec, berr: host (S + 1); dims, ptrs: host arrays as for K1;
// plan: host (bm, cc, groups) per layer, the stages' row-pass plans
// (ops/fused_step.py step_plans); directed: the layers' basis
// is the (11, 2) directed stack; planes float32, or bfloat16 when bf16
// (K11bf). Returns the first CUDA error.
extern "C" int gncde_fused_step(const void* d, const void* c, const void* b,
                                const void* a, long long plane_bstride, const int* idx,
                                const float* tau, const float* h, const float* y,
                                const float* f0, int Btot, int b0, int nb, int n, int S,
                                const float* amat, const float* bvec, const float* berr,
                                int L, const int* dims, const void* const* ptrs,
                                const int* plan, int directed, int bf16, float* stats,
                                float* Mbuf, int ldm, float* Yi, float* ks, float* y1,
                                float* err, float* f1, cudaStream_t stream) {
  if (L < 1 || L > LMAX || S < 1 || S > SMAX || nb < 1 || b0 < 0 || b0 + nb > Btot ||
      n < 1 || !dims_ok(dims, L, ldm))
    return (int)cudaErrorInvalidValue;
  const int H = dims[0];
  if (dims[2 * L - 1] != H) return (int)cudaErrorInvalidValue;  // k and y alike
  if (plan == nullptr || n > MAXN) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_step<true>(d, c, b, a, plane_bstride, idx, tau, h, y, f0, Btot, b0, nb, n,
                             S, amat, bvec, berr, L, dims, ptrs, plan, directed, stats, Mbuf,
                             ldm, Yi, ks, y1, err, f1, stream);
  return launch_step<false>(d, c, b, a, plane_bstride, idx, tau, h, y, f0, Btot, b0, nb, n,
                            S, amat, bvec, berr, L, dims, ptrs, plan, directed, stats, Mbuf,
                            ldm, Yi, ks, y1, err, f1, stream);
}
