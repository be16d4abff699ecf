// Inverse-CDF lookup for NVIDIA Hopper (sm_90a): K10.  Bound to Python
// through ctypes (sanerf_hq_tpu_torch/ops/sample_pdf.py); plain C interface,
// no PyTorch headers.
//
// Replaces (JAX reference): sanerf_hq_tpu/ops/sample_pdf_pallas.py `_kernel`
// (:22), reached through sample_pdf_lookup_pallas (:59, pallas_call :69),
// which ops/ray.py sample_pdf calls on every composable proposal level.
//
// Computes, per (ray, query u): cdf_g0 / bins_g0 the last entries with
// cdf_k <= u, cdf_g1 / bins_g1 the first with cdf_k > u (the last entry if
// none), t = (u - cdf_g0) / (cdf_g1 - cdf_g0) where the denominator is
// positive (else 0), clipped to [0, 1], and bins_g0 + t (bins_g1 - bins_g0).
// The TPU kernel sweeps all K entries per query, because a binary search
// lowers badly there; rows are non-decreasing (a clamped cumsum and sorted
// bin edges), so here {k : cdf_k <= u} is a prefix and one binary search
// (count_le, shared with K5) finds its end k*.  The four lookups are then
// cdf[k*], bins[k*], cdf[min(k*+1, K-1)], bins[min(k*+1, K-1)]; an empty
// prefix takes the masked reduction's -1e38.  The arithmetic is rounded as
// the plain version's separate PyTorch operations round it (no FMA).
//
// Design: one thread per (ray, query), 256 a block; the threads of a warp
// share one or two rows (Q = 65 or 33), which they read through L1.  What
// bounds it on this card: bytes, N (2K + 2Q) x 4 of them; the search is
// about log2(K) compares a query.
#include "render_level_common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
sample_pdf_lookup_kernel(const float* __restrict__ cdf,
                         const float* __restrict__ bins,
                         const float* __restrict__ u, float* __restrict__ out,
                         long long items, int K, int Q) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= items) return;
  const long long ray = i / Q;
  const float* c = cdf + ray * K;
  const float* b = bins + ray * K;
  const float v = u[i];
  const int j = sanerf::count_le(c, K, v) - 1;
  float c0 = -1e38f, b0 = -1e38f;
  if (j >= 0) {
    c0 = c[j];
    b0 = b[j];
  }
  const int k1 = j + 1 < K ? j + 1 : K - 1;
  const float c1 = c[k1], b1 = b[k1];
  const float denom = __fsub_rn(c1, c0);
  float t = denom > 0.0f ? __fdiv_rn(__fsub_rn(v, c0), denom) : 0.0f;
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  out[i] = __fadd_rn(b0, __fmul_rn(t, __fsub_rn(b1, b0)));
}

}  // namespace

extern "C" {

// cdf, bins [n, k] (rows non-decreasing), u [n, q], out [n, q]; all fp32
// and contiguous.  Returns 0 or a cudaError_t code.
int sanerf_sample_pdf_lookup(const float* cdf, const float* bins,
                             const float* u, float* out, int n, int k, int q,
                             void* stream) {
  const long long items = (long long)n * q;
  if (items == 0) return 0;
  const long long blocks = (items + THREADS - 1) / THREADS;
  sample_pdf_lookup_kernel<<<(unsigned)blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(cdf, bins, u, out,
                                                     items, k, q);
  return (int)cudaGetLastError();
}

const char* sanerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
