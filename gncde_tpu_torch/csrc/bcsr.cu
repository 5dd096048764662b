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
//  * K8: one CTA per (element, 32-row strip of a block row, column chunk of
//    HC = 16 or 32 of H). It loops over the kb slots (padded ones too, as
//    the TPU kernel does) and over the block's columns in chunks of 32,
//    staging the 32 x 32 piece of the block and the gathered 32 x HC piece
//    of M in shared memory, and accumulates its 32 x HC outputs in
//    registers (2 or 4 per thread). One thread owns each output and sums in
//    slot order, so the result is bitwise repeatable; no atomics.
//  * K9: one CTA per (element, block row, slot). It sweeps H in chunks of
//    32, staging the bs x 32 row tile of X and the gathered tile of Y, and
//    each of its 256 threads accumulates an 8 x 8 micro-tile of the bs x bs
//    output (strided by 16, so shared-memory reads do not conflict).
//
// What bounds them on the card. K8 at the flagship shape (bs 128, H 16)
// does 2 bs H flops per stored block element it reads (4 bytes): 8 flops
// per byte, under the card's f32 ratio of 20, so bytes bound it; the
// blocks are read once per column chunk, M's tiles come mostly from L2. K9
// writes bs^2 outputs per slot from 2 bs H inputs: at H 16 to 32 it is
// bytes-bound on its output. Both use plain f32 FMA (no tensor cores, no
// TMA): right first, fast in a later change.
#include <cuda_runtime.h>

namespace bcsr {

constexpr int NT = 256;
constexpr int MAXBS = 128;
constexpr int RB = 32;  // K8: rows of a block row per CTA
constexpr int KT = 32;  // K8: reduce depth per staged chunk
constexpr int HT = 32;  // K9: H per staged chunk

template <int HC>
__global__ void __launch_bounds__(NT)
spmm_kernel(const int* __restrict__ idx, long long idx_bs,
            const float* __restrict__ blocks, long long blk_bs,
            const float* __restrict__ M, long long m_bs, float* __restrict__ out,
            int nb, int kb, int bs, int n, int H) {
  constexpr int RG = NT / HC;   // row groups
  constexpr int RPT = RB / RG;  // rows per thread
  __shared__ float As[RB][KT + 1];
  __shared__ float Ms[KT][HC];

  const int nsub = (bs + RB - 1) / RB;
  const int i = blockIdx.y / nsub;
  const int row0 = (blockIdx.y - i * nsub) * RB;
  const int rows = min(RB, bs - row0);
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * HC;
  const int tid = threadIdx.x;
  const int tc = tid % HC, tr = tid / HC;

  const int* ib = idx + b * idx_bs + (long long)i * kb;
  const float* Bb = blocks + b * blk_bs + (long long)i * kb * bs * bs;
  const float* Mb = M + b * m_bs;

  float acc[RPT];
#pragma unroll
  for (int p = 0; p < RPT; ++p) acc[p] = 0.f;

  for (int k = 0; k < kb; ++k) {
    const int j = ib[k];
    const bool jok = j >= 0 && j < nb;
    const float* blk = Bb + (long long)k * bs * bs;
    for (int kk0 = 0; kk0 < bs; kk0 += KT) {
      for (int e = tid; e < RB * KT; e += NT) {
        const int r = e / KT, q = e - (e / KT) * KT;
        As[r][q] = (r < rows && kk0 + q < bs)
                       ? __ldg(blk + (long long)(row0 + r) * bs + kk0 + q) : 0.f;
      }
      for (int e = tid; e < KT * HC; e += NT) {
        const int q = e / HC, c = e - (e / HC) * HC;
        const long long gr = (long long)j * bs + kk0 + q;
        Ms[q][c] = (jok && kk0 + q < bs && gr < n && c0 + c < H)
                       ? __ldg(Mb + gr * H + c0 + c) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int q = 0; q < KT; ++q) {
        const float mv = Ms[q][tc];
#pragma unroll
        for (int p = 0; p < RPT; ++p) acc[p] = fmaf(As[tr + p * RG][q], mv, acc[p]);
      }
      __syncthreads();
    }
  }

  const int col = c0 + tc;
  if (col >= H) return;
  float* ob = out + (long long)b * n * H;
#pragma unroll
  for (int p = 0; p < RPT; ++p) {
    const int r = tr + p * RG;
    const long long grow = (long long)i * bs + row0 + r;
    if (r < rows && grow < n) ob[grow * H + col] = acc[p];
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

extern "C" int gncde_bcsr_spmm(const int* idx, long long idx_bs, const float* blocks,
                               long long blk_bs, const float* M, long long m_bs,
                               float* out, int B, int nb, int kb, int bs, int n, int H,
                               cudaStream_t stream) {
  if (!bcsr::dims_ok(B, nb, kb, bs, n, H) || idx_bs < 0 || blk_bs < 0 || m_bs < 0)
    return (int)cudaErrorInvalidValue;
  const long long gy = (long long)nb * ((bs + bcsr::RB - 1) / bcsr::RB);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  if (H <= 16) {
    dim3 grid((H + 15) / 16, (unsigned)gy, B);
    bcsr::spmm_kernel<16><<<grid, bcsr::NT, 0, stream>>>(idx, idx_bs, blocks, blk_bs, M,
                                                          m_bs, out, nb, kb, bs, n, H);
  } else {
    dim3 grid((H + 31) / 32, (unsigned)gy, B);
    bcsr::spmm_kernel<32><<<grid, bcsr::NT, 0, stream>>>(idx, idx_bs, blocks, blk_bs, M,
                                                          m_bs, out, nb, kb, bs, n, H);
  }
  return (int)cudaGetLastError();
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
