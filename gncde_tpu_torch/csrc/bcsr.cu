// K8 and K9: the blocked-ELL (BCSR) SpMM and SDDMM.
//
// K8 replaces gncde_tpu/ops/bcsr.py _make_spmm_kernel / _spmm_call /
// _spmm_call_batched:
//   out[b, i-block, :] = sum_k blocks[b, i, k] @ M[b, idx[b, i, k]-block, :]
// K9 replaces _sddmm_kernel / _sddmm_call / _sddmm_call_batched:
//   out[b, i, k] = X[b, i-block, :] @ Y[b, idx[b, i, k]-block, :]^T
//
// Layout. idx (B, nb, kb) int32 column-block ids (padding slots hold 0 and,
// in K8, all-zero blocks); blocks (B, nb, kb, bs, bs) f32; M, X, Y (B, n, H)
// f32, unpadded: rows at or past n read as zero (bound-checked, M is never
// copied into a padded buffer); K8's out (B, n, H) writes rows < n only;
// K9's out (B, nb, kb, bs, bs). Every operand has its own batch stride in
// elements, 0 for an operand shared by the batch (the TPU kernel's batch
// flags, without a broadcast copy). Any bs in [1, 128] and any H.
//
// The TPU kernels walk a sequential grid (nb, kb) and accumulate each block
// row's output across the kb steps in VMEM. Here CTAs run in parallel, so
// the slot loop moves inside the CTA:
//  * K8 (``spmm_kernel<RT, CT>``): one CTA of 128 threads per (element,
//    strip of RB = 8 RT rows of a block row, column chunk of HC = 16 CT of
//    H: 16 for H <= 16, else 32). ops/bcsr.py ``spmm_plan`` chooses RB in
//    {8, 16, 32}: the largest whose grid still fills the card's 132 SMs (RB
//    = 8 at the flagship: 256 CTAs; 32 at n = 32768: 1,024). The CTA
//    streams its slots through a ring of three stages, two slots ahead of
//    the products: each stage holds the strip's RB x bs piece of the block
//    and the gathered bs x HC tile of M, copied by cp.async in 16-byte
//    granules (4-byte copies where a block row or an M row is not a
//    multiple of 16 bytes: bs or H not a multiple of 4), rows at or past n,
//    columns at or past H and padding zero-filled by the copy itself. Each
//    thread owns an RT x CT micro-tile (rows rg RT .., columns cg CT ..;
//    lanes 0-15 and 16-31 of a warp are two row groups of one column range),
//    reads its rows as float4 along the block's columns (a broadcast within
//    each quarter warp) and M's row as a CT-vector, and does RT CT FMAs per
//    element of M it loads. Every output is one FMA chain over the slots in
//    order and, within a slot, the block's columns in order, the chain of the
//    first version of this kernel (the padding adds exact zeros), so the
//    result is bitwise repeatable and bitwise that version's; no atomics.
//  * K9: one CTA per (element, block row, slot). It sweeps H in chunks of
//    32, staging the bs x 32 row tile of X and the gathered tile of Y, and
//    each of its 256 threads accumulates an 8 x 8 micro-tile of the bs x bs
//    output (strided by 16, so shared-memory reads do not conflict).
//
// What bounds them on the card. K8 at the flagship shape (bs 128, H 16)
// does 2 bs H flops per stored block element it reads (4 bytes): 8 flops
// per byte, under the card's f32 ratio of 20, so bytes bound it: 4.2 MB of
// blocks at the flagship, 50 MB at n = 32768 (bs 128, kb 3, H 32), each
// block element read once; M's tiles are read once per strip, mostly from
// L2. The first version read each block value by a scalar load with a
// div/mod, staged 32-deep chunks with two barriers each and nothing in
// flight across them, and made one M load and RPT block loads per RPT
// FMAs from shared memory, so shared memory and latency set its pace (2.4x
// cuSPARSE's BSR @ M at the flagship on an NVIDIA H100 80GB HBM3 at
// 700.00 W). K9 writes bs^2 outputs per slot
// from 2 bs H inputs: at H 16 to 32 it is bytes-bound on its output. K9
// uses plain f32 FMA on scalar loads (no tensor cores, no TMA).
#include <cuda_runtime.h>

#include <cstdint>

namespace bcsr {

constexpr int NT = 256;   // K9 threads
constexpr int MAXBS = 128;
constexpr int HT = 32;    // K9: H per staged chunk
constexpr int NTS = 128;  // K8 threads
constexpr int NSTAGE = 3; // K8 ring stages

// K8's ablation (tools/kernel_times_torch.py K8-ablation, gncde_bcsr_spmm_probe):
// the template parameter PROBE of spmm_kernel, 0 on every launch of the main
// path; bits that drop one part of its work each.
enum SpmmProbe { SP_NO_BLOCKS = 1, SP_NO_M = 2, SP_NO_PRODUCT = 4 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// cp.async of 16 (or 4) bytes, of which src_bytes are read and the rest of
// the copy zero-filled.
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// K8's shared memory: NSTAGE stages of the block strip As[RB][lda] and the
// M tile Ms[bsr][HC], bsr = bs rounded up to 4 (the float4 reduce step),
// lda = bsr + 4.
__host__ __device__ constexpr int spmm_stage_floats(int rb, int hc, int bs) {
  return rb * (((bs + 3) & ~3) + 4) + ((bs + 3) & ~3) * hc;
}

template <int RT, int CT, int PROBE>
__global__ void __launch_bounds__(NTS)
spmm_kernel(const int* __restrict__ idx, long long idx_bs,
            const float* __restrict__ blocks, long long blk_bs,
            const float* __restrict__ M, long long m_bs, float* __restrict__ out,
            int nb, int kb, int bs, int n, int H, int vec_a, int vec_m) {
  constexpr int RB = 8 * RT, HC = 16 * CT;
  extern __shared__ __align__(16) float smem[];
  const int bsr = (bs + 3) & ~3, lda = bsr + 4;
  const int stage = spmm_stage_floats(RB, HC, bs);

  const int nsub = (bs + RB - 1) / RB;
  const int i = blockIdx.y / nsub;
  const int row0 = (blockIdx.y - i * nsub) * RB;
  const int rows = min(RB, bs - row0);
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * HC;
  const int tid = threadIdx.x, lane = tid % 32;
  const int cg = lane % 16, rg = 2 * (tid / 32) + lane / 16;

  const int* ib = idx + b * idx_bs + (long long)i * kb;
  const float* Bb =
      blocks + b * blk_bs + (long long)i * kb * bs * bs + (long long)row0 * bs;
  const float* Mb = M + b * m_bs;

  // Slot k into stage k % NSTAGE: the strip's block rows and M's gathered
  // rows j bs .. j bs + bsr - 1, columns c0 .. c0 + HC - 1.
  auto fetch = [&](int k) {
    float* As = smem + (k % NSTAGE) * stage;
    float* Ms = As + RB * lda;
    const int j = __ldg(ib + k);
    const bool jok = j >= 0 && j < nb;
    const float* blk = Bb + (long long)k * bs * bs;
    if constexpr ((PROBE & SP_NO_BLOCKS) != 0) {
    } else if (vec_a) {  // bs % 4 == 0: bsr == bs
      const int gpr = bs / 4;
      for (int e = tid; e < RB * gpr; e += NTS) {
        const int r = e / gpr, q = 4 * (e - r * gpr);
        const bool ok = r < rows;
        cp16(As + r * lda + q, ok ? blk + (long long)r * bs + q : blocks, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < RB * bsr; e += NTS) {
        const int r = e / bsr, q = e - r * bsr;
        const bool ok = r < rows && q < bs;
        cp4(As + r * lda + q, ok ? blk + (long long)r * bs + q : blocks, ok ? 4 : 0);
      }
    }
    if constexpr ((PROBE & SP_NO_M) != 0) {
    } else if (vec_m) {  // H % 4 == 0
      constexpr int gpr = HC / 4;
      for (int e = tid; e < bsr * gpr; e += NTS) {
        const int q = e / gpr, c = 4 * (e - q * gpr);
        const long long gr = (long long)j * bs + q;
        const bool ok = jok && q < bs && gr < n && c0 + c < H;
        cp16(Ms + q * HC + c, ok ? Mb + gr * H + c0 + c : M, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < bsr * HC; e += NTS) {
        const int q = e / HC, c = e - q * HC;
        const long long gr = (long long)j * bs + q;
        const bool ok = jok && q < bs && gr < n && c0 + c < H;
        cp4(Ms + q * HC + c, ok ? Mb + gr * H + c0 + c : M, ok ? 4 : 0);
      }
    }
  };

  float acc[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = 0.f;

  fetch(0);
  cp_commit();
  if (kb > 1) fetch(1);
  cp_commit();
  for (int k = 0; k < kb; ++k) {
    cp_wait1();  // slot k's group has landed
    __syncthreads();
    // Stage (k + 2) % 3 held slot k - 1, which every thread has finished.
    if (k + 2 < kb) fetch(k + 2);
    cp_commit();
    const float* As = smem + (k % NSTAGE) * stage + rg * RT * lda;
    const float* Ms = smem + (k % NSTAGE) * stage + RB * lda + cg * CT;
    for (int q = 0; q < bsr && !(PROBE & SP_NO_PRODUCT); q += 4) {
      float4 a[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        a[r] = *reinterpret_cast<const float4*>(As + r * lda + q);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float m[CT];
        if constexpr (CT == 2) {
          const float2 v = *reinterpret_cast<const float2*>(Ms + (q + u) * HC);
          m[0] = v.x;
          m[1] = v.y;
        } else {
          m[0] = Ms[(q + u) * HC];
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float av = u == 0 ? a[r].x : u == 1 ? a[r].y : u == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[r][c] = fmaf(av, m[c], acc[r][c]);
        }
      }
    }
  }

  float* ob = out + (long long)b * n * H;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int lr = rg * RT + r;
    const long long grow = (long long)i * bs + row0 + lr;
    if (lr >= rows || grow >= n) continue;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int col = c0 + cg * CT + c;
      if (col < H) ob[grow * H + col] = acc[r][c];
    }
  }
}

__global__ void __launch_bounds__(NT)
sddmm_kernel(const int* __restrict__ idx, long long idx_bs,
             const float* __restrict__ X, long long x_bs,
             const float* __restrict__ Y, long long y_bs, float* __restrict__ out,
             int nb, int kb, int bs, int n, int H) {
  __shared__ float Xs[MAXBS][HT + 1];
  __shared__ float Ys[MAXBS][HT + 1];
  const int k = blockIdx.x, i = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int pm = (bs + 15) / 16;  // micro-tile extent in use

  const int j = idx[b * idx_bs + (long long)i * kb + k];
  const bool jok = j >= 0 && j < nb;
  const float* Xb = X + b * x_bs;
  const float* Yb = Y + b * y_bs;

  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

  for (int h0 = 0; h0 < H; h0 += HT) {
    const int hn = min(HT, H - h0);
    for (int e = tid; e < bs * HT; e += NT) {
      const int a = e / HT, h = e - (e / HT) * HT;
      const long long xr = (long long)i * bs + a;
      const long long yr = (long long)j * bs + a;
      Xs[a][h] = (h < hn && xr < n) ? __ldg(Xb + xr * H + h0 + h) : 0.f;
      Ys[a][h] = (h < hn && jok && yr < n) ? __ldg(Yb + yr * H + h0 + h) : 0.f;
    }
    __syncthreads();
    for (int h = 0; h < hn; ++h) {
      float xa[8], yb[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        xa[p] = (p < pm) ? Xs[ty + 16 * p][h] : 0.f;
        yb[p] = (p < pm) ? Ys[tx + 16 * p][h] : 0.f;
      }
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(xa[p], yb[q], acc[p][q]);
    }
    __syncthreads();
  }

  float* ob = out + (((long long)b * nb + i) * kb + k) * bs * bs;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int a = ty + 16 * p;
    if (a >= bs) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = tx + 16 * q;
      if (c < bs) ob[(long long)a * bs + c] = acc[p][q];
    }
  }
}

inline bool dims_ok(int B, int nb, int kb, int bs, int n, int H) {
  return B >= 1 && B <= 65535 && nb >= 1 && kb >= 1 && bs >= 1 && bs <= MAXBS && n >= 1 &&
         H >= 1 && (long long)nb * bs >= n;
}

}  // namespace bcsr

template <int RT, int CT, int PROBE>
static int launch_spmm(const int* idx, long long idx_bs, const float* blocks,
                       long long blk_bs, const float* M, long long m_bs, float* out, int B,
                       int nb, int kb, int bs, int n, int H, cudaStream_t stream) {
  constexpr int RB = 8 * RT, HC = 16 * CT;
  // The shared memory allowance (the largest block size's) is set once per
  // device and instantiation.
  static bool allowed[64];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= 64 || !allowed[dev]) {
    err = (int)cudaFuncSetAttribute(
        bcsr::spmm_kernel<RT, CT, PROBE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bcsr::NSTAGE * bcsr::spmm_stage_floats(RB, HC, bcsr::MAXBS) * (int)sizeof(float));
    if (err != 0) return err;
    if (dev < 64) allowed[dev] = true;
  }
  const int bytes = bcsr::NSTAGE * bcsr::spmm_stage_floats(RB, HC, bs) * (int)sizeof(float);
  const long long gy = (long long)nb * ((bs + RB - 1) / RB);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec_a = bs % 4 == 0 && aligned(blocks) && blk_bs % 4 == 0;
  const int vec_m = H % 4 == 0 && aligned(M) && m_bs % 4 == 0;
  dim3 grid((H + HC - 1) / HC, (unsigned)gy, B);
  bcsr::spmm_kernel<RT, CT, PROBE><<<grid, bcsr::NTS, bytes, stream>>>(
      idx, idx_bs, blocks, blk_bs, M, m_bs, out, nb, kb, bs, n, H, vec_a, vec_m);
  return (int)cudaGetLastError();
}

// rb: the strip height of the plan (ops/bcsr.py spmm_plan: 8, 16 or 32);
// the column chunk is 16 for H <= 16, else 32. A probe (PROBE != 0) is built
// only for the ablation's two plans: (rb, chunk) = (8, 16) and (32, 32).
template <int PROBE>
static int spmm(const int* idx, long long idx_bs, const float* blocks, long long blk_bs,
                const float* M, long long m_bs, float* out, int B, int nb, int kb, int bs,
                int n, int H, int rb, cudaStream_t stream) {
  if (!bcsr::dims_ok(B, nb, kb, bs, n, H) || idx_bs < 0 || blk_bs < 0 || m_bs < 0)
    return (int)cudaErrorInvalidValue;
#define GNCDE_SPMM(RT, CT)                                                                \
  launch_spmm<RT, CT, PROBE>(idx, idx_bs, blocks, blk_bs, M, m_bs, out, B, nb, kb, bs, n, \
                             H, stream)
  const int hc = H <= 16 ? 16 : 32;
  if constexpr (PROBE != 0) {
    if (rb == 8 && hc == 16) return GNCDE_SPMM(1, 1);
    if (rb == 32 && hc == 32) return GNCDE_SPMM(4, 2);
  } else {
    switch (rb * 100 + hc) {
      case 816: return GNCDE_SPMM(1, 1);
      case 832: return GNCDE_SPMM(1, 2);
      case 1616: return GNCDE_SPMM(2, 1);
      case 1632: return GNCDE_SPMM(2, 2);
      case 3216: return GNCDE_SPMM(4, 1);
      case 3232: return GNCDE_SPMM(4, 2);
    }
  }
#undef GNCDE_SPMM
  return (int)cudaErrorInvalidValue;
}

// rb: the launch plan's rows of a block row per CTA (ops/bcsr.py
// spmm_plan: 8, 16 or 32).
extern "C" int gncde_bcsr_spmm(const int* idx, long long idx_bs, const float* blocks,
                               long long blk_bs, const float* M, long long m_bs,
                               float* out, int B, int nb, int kb, int bs, int n, int H,
                               int rb, cudaStream_t stream) {
  return spmm<0>(idx, idx_bs, blocks, blk_bs, M, m_bs, out, B, nb, kb, bs, n, H, rb, stream);
}

// K8's ablation (tools/kernel_times_torch.py K8-ablation): gncde_bcsr_spmm
// with the SpmmProbe bits ``probe`` (1, 2, 3, 4 or 7), which drop parts of
// its work (the output is then wrong); 0 is the main path's kernel.
extern "C" int gncde_bcsr_spmm_probe(const int* idx, long long idx_bs,
                                     const float* blocks, long long blk_bs, const float* M,
                                     long long m_bs, float* out, int B, int nb, int kb, int bs,
                                     int n, int H, int rb, int probe, cudaStream_t stream) {
  switch (probe) {
#define GNCDE_SPMM_PROBE(BITS) \
  case BITS:                   \
    return spmm<BITS>(idx, idx_bs, blocks, blk_bs, M, m_bs, out, B, nb, kb, bs, n, H, rb, stream);
    GNCDE_SPMM_PROBE(0)
    GNCDE_SPMM_PROBE(1)
    GNCDE_SPMM_PROBE(2)
    GNCDE_SPMM_PROBE(3)
    GNCDE_SPMM_PROBE(4)
    GNCDE_SPMM_PROBE(7)
#undef GNCDE_SPMM_PROBE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int gncde_bcsr_sddmm(const int* idx, long long idx_bs, const float* X,
                                long long x_bs, const float* Y, long long y_bs,
                                float* out, int B, int nb, int kb, int bs, int n, int H,
                                cudaStream_t stream) {
  if (!bcsr::dims_ok(B, nb, kb, bs, n, H) || idx_bs < 0 || x_bs < 0 || y_bs < 0 ||
      nb > 65535 || kb > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(kb, nb, B);
  bcsr::sddmm_kernel<<<grid, bcsr::NT, 0, stream>>>(idx, idx_bs, X, x_bs, Y, y_bs, out, nb,
                                                    kb, bs, n, H);
  return (int)cudaGetLastError();
}
