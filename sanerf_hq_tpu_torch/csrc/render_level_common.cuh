// Device code shared by the render-level kernels (render_level.cu, forward;
// render_level_bwd.cu, backward) and K8 (fused_mlp.cu): the bf16 WMMA and
// mma.sync products, the sample geometry with its contraction, the block
// freq encoding and the CP line features.  Every function works on a pass
// of PP points held by one CTA of NWARPS warps; PP is a multiple of 16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace sanerf {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int OUT = 16;  // padded width of the last layer
constexpr int GEO = 15;  // geometry features composited by the final level
constexpr int SHD = 16;  // SH width (degree 4)
constexpr size_t SMEM_LIMIT = 232448;

// C[PP x n] = A[PP x k] * W^T.  A: bf16 in shared memory (row-major, lda);
// W: [n x k] bf16 row-major (ldw) in global or shared memory, i.e. B
// col-major.  With O set, writes relu(C) as bf16 into O (ldo); else C as
// fp32 into F.  A warp holds at most MAXM row tiles' sums at once.
template <int PP, int MAXM = PP / 16>
__device__ void dense_ld(const bf16* A, int lda, int k, const bf16* W,
                         int ldw, int n, bf16* O, int ldo, float* F, int ldf,
                         float* scratch) {
  constexpr int MT = PP / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = n / 16;
  int wpn = 1;  // warps sharing one column tile (power of two dividing MT)
  while (wpn * 2 * ntiles <= NWARPS && wpn * 2 <= MT) wpn *= 2;
  while (MT / wpn > MAXM) wpn *= 2;
  const int mper = MT / wpn;
  const int units = ntiles * wpn;
  for (int u = warp; u < units; u += NWARPS) {
    const int nt = u / wpn, m0 = (u % wpn) * mper;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXM];
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
      if (i < mper) wmma::fill_fragment(acc[i], 0.0f);
    const bf16* wt = W + (size_t)nt * 16 * ldw;
    for (int kt = 0; kt < k; kt += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, wt + kt, ldw);
#pragma unroll
      for (int i = 0; i < MAXM; ++i) {
        if (i < mper) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + (m0 + i) * 16 * lda + kt, lda);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXM; ++i) {
      if (i < mper) {
        wmma::store_matrix_sync(scratch, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = (m0 + i) * 16 + (e >> 4), c = nt * 16 + (e & 15);
          const float v = scratch[e];
          if (O) O[r * ldo + c] = __float2bfloat16(fmaxf(v, 0.0f));
          else F[r * ldf + c] = v;
        }
        __syncwarp();
      }
    }
  }
}

// mma.sync products on ldmatrix fragments (the proposal kernel in
// render_level.cu, K8's narrow kernel in fused_mlp.cu).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// d [16 x 8] += a [16 x 16] b [16 x 8]: bf16 products, fp32 sums; b as
// the fragment's two registers.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          const unsigned (&b)[2]) {
  mma_16816(d, a, b[0], b[1]);
}

// Midpoint, width and contracted / grid_bound position of one sample.
__device__ __forceinline__ void geometry(const float* o, const float* d,
                                         float b0, float b1, float grid_bound,
                                         float* xn, float& t, float& delta) {
  t = (b0 + b1) * 0.5f;
  delta = b1 - b0;
  float x[3], ax[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = o[i] + d[i] * t;
    ax[i] = fabsf(x[i]);
  }
  const float mag = fmaxf(fmaxf(ax[0], ax[1]), ax[2]);
  const float inv = 1.0f / fmaxf(mag, 1e-38f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float scale = ax[i] == mag ? (2.0f - inv) * inv : inv;
    xn[i] = (mag < 1.0f ? x[i] : x[i] * scale) / grid_bound;
  }
}

// Geometry of the pass's points (threads < PP), then the block freq rows
// [x | sin | cos] (3 + 6*deg columns) of each point into row q of `X`.
// Point gp of the CTA's rays is sample gp % T of ray ray0 + gp / T; points
// at or past total_pts, or of rays past n_rays, get zero geometry.
template <int PP>
__device__ void build_geometry_freq(const float* rays_o, const float* rays_d,
                                    const float* bins, int n_rays, int T,
                                    int ray0, int total_pts, int p0, int deg,
                                    float grid_bound, float* xn, float* tt,
                                    float* dl, bf16* X, int ldX) {
  const int tid = threadIdx.x;
  if (tid < PP) {
    const int gp = p0 + tid, r = gp / T, s = gp - r * T, ray = ray0 + r;
    float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f}, b0 = 0.f, b1 = 0.f;
    if (gp < total_pts && ray < n_rays) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        o[i] = rays_o[(size_t)ray * 3 + i];
        d[i] = rays_d[(size_t)ray * 3 + i];
      }
      b0 = bins[(size_t)ray * (T + 1) + s];
      b1 = bins[(size_t)ray * (T + 1) + s + 1];
    }
    geometry(o, d, b0, b1, grid_bound, xn + tid * 3, tt[tid], dl[tid]);
  }
  __syncthreads();
  const int F3 = 3 * deg, per = 3 + F3;
  for (int item = tid; item < PP * per; item += NTHREADS) {
    const int q = item / per, j = item - q * per;
    bf16* row = X + q * ldX;
    if (j < 3) {
      row[j] = __float2bfloat16(xn[q * 3 + j]);
    } else {
      const int idx = j - 3, k = idx / 3, dd = idx - 3 * k;
      float sv, cv;
      sincosf(ldexpf(xn[q * 3 + dd], k), &sv, &cv);
      row[3 + idx] = __float2bfloat16(sv);
      row[3 + F3 + idx] = __float2bfloat16(cv);
    }
  }
}

// Zero columns [c0, c1) of the pass's rows: padding must not hold NaN bits.
template <int PP>
__device__ void zero_cols(bf16* X, int ldX, int c0, int c1) {
  const int w = c1 - c0;
  for (int item = threadIdx.x; item < PP * w; item += NTHREADS) {
    const int q = item / w;
    X[q * ldX + c0 + (item - q * w)] = __float2bfloat16(0.0f);
  }
}

// Linear-interp taps of one point on the three CP axes: lower row i0 and
// weight f of the upper row (f reaches 1 at the top edge).
__device__ __forceinline__ void cp_taps(const float* xn, int res, int* i0,
                                        float* f) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pp =
        fminf(fmaxf((xn[a] + 1.0f) * 0.5f, 0.0f), 1.0f) * (float)(res - 1);
    const float fl = fminf(fmaxf(floorf(pp), 0.0f), (float)(res - 2));
    i0[a] = (int)fl;
    f[a] = pp - fl;
  }
}

// Line feature of axis basis B [res, rank] at column r.
__device__ __forceinline__ float cp_line(const float* B, int rank, int i0,
                                         float f, int r) {
  return B[(size_t)i0 * rank + r] * (1.0f - f) +
         B[(size_t)(i0 + 1) * rank + r] * f;
}

// CP line features of the pass's points, product over the axes, as bf16
// into columns [c0, c0 + rank) of X: a warp per point, lanes over the rank.
template <int PP>
__device__ void build_cp(const float* const* cp, int rank, int res,
                         const float* xn, bf16* X, int ldX, int c0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = warp; q < PP && rank > 0; q += NWARPS) {
    int i0[3];
    float f[3];
    cp_taps(xn + q * 3, res, i0, f);
    for (int r = lane; r < rank; r += 32) {
      float g = cp_line(cp[0], rank, i0[0], f[0], r);
      g = g * cp_line(cp[1], rank, i0[1], f[1], r);
      g = g * cp_line(cp[2], rank, i0[2], f[2], r);
      X[q * ldX + c0 + r] = __float2bfloat16(g);
    }
  }
}

// Number of entries of the non-decreasing c[0, n) that are <= v: the set
// {k : c_k <= v} is the prefix [0, count).  One binary search.
__device__ __forceinline__ int count_le(const float* c, int n, float v) {
  int a = 0, b = n;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (c[m] <= v) a = m + 1;
    else b = m;
  }
  return a;
}

// Streaming multiprocessors of the current device: the persistent grids
// size themselves by it.
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

inline int launch_checked(const void* kernel, int grid, size_t smem,
                          cudaStream_t stream, void* args) {
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* argv[] = {args};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(NTHREADS), argv, smem,
                         stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace sanerf
