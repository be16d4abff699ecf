// Render-level kernels for NVIDIA Hopper (sm_90a): the proposal level with
// in-kernel inverse-CDF resampling (K5, K1 with its weights output, and K7
// with the weights alone) and the final level with in-kernel CP line features (K3, and K6 with its
// per-sample trunk features output).  Bound to Python
// through ctypes (sanerf_hq_tpu_torch/ops/render_level.py); plain C
// interface, no PyTorch headers.  Shared device code:
// render_level_common.cuh.
//
// Replaces (JAX reference, sanerf_hq_tpu/ops/render_level_pallas.py):
//   K5  _make_prop_sample_kernel(weights_out=False)  (:258), reached through
//       fused_prop_level_sample (:336)
//   K1  _make_prop_sample_kernel(weights_out=True)   (:258), reached through
//       prop_level_train_sample (:449) -> _prop_level_sample_train_impl
//       (:391); the same kernel as K5 with the raw weights stored
//   K7  _make_prop_kernel                            (:169), reached through
//       fused_prop_level (:201, pallas_call :220) and prop_level_train
//       (:1083); the same kernel with the raw weights stored and Q = 0: no
//       resampling epilogue and no shared memory for it
//   K3  _make_final_train_kernel                     (:695), reached through
//       fused_final_level (:64) -> _final_train_fwd_impl (:968)
//   K6  _make_final_train_kernel(geo_out=True)       (:695), reached through
//       fused_final_level_frozen (:85, pallas_call :143); the same kernel as
//       K3 with each sample's 15 trunk features stored (geo [N, T, 15])
//
// Design.  One CTA of 8 warps owns a tile of whole rays and walks their
// (ray, sample) points in passes of P = 128 points:
//   1. geometry: bin midpoint -> inf-norm contraction -> / grid_bound;
//   2. the trunk input built in shared memory as bf16: block k-major freq
//      rows [x | sin(2^k x_d) | cos(2^k x_d)], then (K3) the CP-rank line
//      features read as a direct two-tap gather from the three bases (the
//      TPU's iota one-hot matmul existed only because TPU gathers are slow);
//   3. each layer a bf16 WMMA product (mma.sync tiles, fp32 accumulation):
//      A from shared memory, B (weights) straight from global memory, where
//      they stay hot in L1/L2 across CTAs; hidden ReLU outputs rounded to
//      bf16, the last layer kept fp32;
//   4. one thread per ray for the sequential transmittance loop, carried in
//      registers across passes;
//   5. (K5, K1) per-ray cdf, prefix-max / suffix-min of the s-bins in shared
//      memory, then one thread per (ray, query) binary search.  K1 also
//      stores each raw weight (1-e)*trans; the cdf adds the 0.01 floor to
//      it with __fadd_rn, so K1's bins are K5's bit for bit.
// What bounds it on this card: K3 is tensor-core work (about 2e5 MAC a
// sample against a few hundred bytes of I/O); K5 is tensor-core work plus
// sin/cos and the serial compositing loop.  This first version keeps all
// activations of a pass on chip, so device memory traffic is inputs and
// outputs only; it does not yet use wgmma/TMA or overlap weight loads.
#include "render_level_common.cuh"

using namespace sanerf;

namespace {

constexpr int P = 128;  // points per pass

struct FinalParams {
  const float *rays_o, *rays_d, *bins, *sh;
  const bf16 *w0, *w1, *w2, *w3;
  const float* cp[3];
  float *f_image, *depth, *wsum, *weights;
  float* geo;  // [N, T, 15] per-sample trunk features (K6) or null (K3)
  int n_rays, T, deg, rank, res, hidden, kin, rays_per_cta, opaque_last;
  float grid_bound, db;
};

// K3 and K6.  Shared memory: X [P, H+KIN+8] holds [act | h_in] so the skip layer
// reads one contiguous [act(H) | h_in(KIN)] row; Y [P, H+8]; F [P, 16] fp32
// raw outputs; per-warp 16x16 fp32 scratch; per-point geometry.
__global__ void __launch_bounds__(NTHREADS)
final_level_kernel(FinalParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.hidden, KIN = p.kin, T = p.T, R = p.rays_per_cta;
  const int ldX = H + KIN + 8, ldY = H + 8;
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* Y = X + P * ldX;
  float* F = reinterpret_cast<float*>(Y + P * ldY);
  float* scratch = F + P * OUT;
  float* xn = scratch + NWARPS * 256;
  float* tt = xn + P * 3;
  float* dl = tt + P;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ray0 = blockIdx.x * R, total_pts = R * T;
  const int nf = 3 + 6 * p.deg;  // freq columns; CP columns follow
  bf16* hin = X + H;

  float trans = 1.0f, depth = 0.0f, wsum = 0.0f, fe[GEO];
#pragma unroll
  for (int c = 0; c < GEO; ++c) fe[c] = 0.0f;

  for (int p0 = 0; p0 < total_pts; p0 += P) {
    build_geometry_freq<P>(p.rays_o, p.rays_d, p.bins, p.n_rays, T, ray0,
                           total_pts, p0, p.deg, p.grid_bound, xn, tt, dl,
                           hin, ldX);
    zero_cols<P>(hin, ldX, nf + p.rank, KIN);
    build_cp<P>(p.cp, p.rank, p.res, xn, hin, ldX, nf);
    __syncthreads();
    float* ws = scratch + warp * 256;
    dense<P>(hin, ldX, KIN, p.w0, H, Y, ldY, nullptr, 0, ws);
    __syncthreads();
    dense<P>(Y, ldY, H, p.w1, H, X, ldX, nullptr, 0, ws);
    __syncthreads();
    dense<P>(X, ldX, H + KIN, p.w2, H, Y, ldY, nullptr, 0, ws);
    __syncthreads();
    dense<P>(Y, ldY, H, p.w3, OUT, nullptr, 0, F, OUT, ws);
    __syncthreads();
    if (p.geo) {
      // K6: a pass holds consecutive points of whole rays, so its points'
      // features are one contiguous run of geo; every thread stores, and
      // neighbouring threads write neighbouring addresses
      const int npts = min(P, total_pts - p0);
      const int valid = min(npts, (p.n_rays - ray0) * T - p0);
      float* g = p.geo + ((size_t)ray0 * T + p0) * GEO;
      for (int item = tid; item < valid * GEO; item += NTHREADS) {
        const int q = item / GEO;
        g[item] = F[q * OUT + 1 + (item - q * GEO)];
      }
    }
    if (tid < R && ray0 + tid < p.n_rays) {
      const int ray = ray0 + tid;
      const int lo = max(p0, tid * T), hi = min(p0 + P, (tid + 1) * T);
      for (int gp = lo; gp < hi; ++gp) {
        const int q = gp - p0, s = gp - tid * T;
        const float* raw = F + q * OUT;
        const float sigma = expf(fminf(fmaxf(raw[0] + p.db, -30.0f), 15.0f));
        const float e =
            (p.opaque_last && s == T - 1) ? 0.0f : expf(-dl[q] * sigma);
        const float w = (1.0f - e) * trans;
        trans *= e;
#pragma unroll
        for (int c = 0; c < GEO; ++c) fe[c] += w * raw[1 + c];
        depth += w * tt[q];
        wsum += w;
        p.weights[(size_t)ray * T + s] = w;
      }
    }
    __syncthreads();
  }
  if (tid < R && ray0 + tid < p.n_rays) {
    const size_t ray = ray0 + tid;
    float* fo = p.f_image + ray * (GEO + SHD);
#pragma unroll
    for (int c = 0; c < GEO; ++c) fo[c] = fe[c];
    for (int c = 0; c < SHD; ++c) fo[GEO + c] = wsum * p.sh[ray * SHD + c];
    p.depth[ray] = depth;
    p.wsum[ray] = wsum;
  }
}

struct PropParams {
  const float *rays_o, *rays_d, *bins, *s_bins, *u;
  const bf16 *w0, *w1, *w2;
  float *out, *weights;  // weights [N, T] raw (K1, K7) or null (K5)
  int n_rays, T, Q, deg, hidden, kin, rays_per_cta, opaque_last;
  float grid_bound, db;
};

// K5, K1 and K7 (Q = 0: s_bins, u and out unused).  Shared memory: X [P,
// max(KIN,H)+8], Y [P, H+8], F [P, 16] fp32, scratch, per-point geometry,
// then, with Q > 0, per ray: floored weights [T], cdf [T+1], prefix-max and
// suffix-min of the s-bins [T+1] each, total.
__global__ void __launch_bounds__(NTHREADS)
prop_level_sample_kernel(PropParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.hidden, KIN = p.kin, T = p.T, Q = p.Q, R = p.rays_per_cta;
  const int ldX = (KIN > H ? KIN : H) + 8, ldY = H + 8;
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* Y = X + P * ldX;
  float* F = reinterpret_cast<float*>(Y + P * ldY);
  float* scratch = F + P * OUT;
  float* xn = scratch + NWARPS * 256;
  float* tt = xn + P * 3;
  float* dl = tt + P;
  float* wb = dl + P;            // [R, T]
  float* cdf = wb + R * T;       // [R, T+1]
  float* pmax = cdf + R * (T + 1);
  float* smin = pmax + R * (T + 1);
  float* tot = smin + R * (T + 1);  // [R]
  const int tid = threadIdx.x, warp = tid >> 5;
  const int ray0 = blockIdx.x * R, total_pts = R * T;

  float trans = 1.0f, total = 0.0f;
  for (int p0 = 0; p0 < total_pts; p0 += P) {
    build_geometry_freq<P>(p.rays_o, p.rays_d, p.bins, p.n_rays, T, ray0,
                           total_pts, p0, p.deg, p.grid_bound, xn, tt, dl, X,
                           ldX);
    zero_cols<P>(X, ldX, 3 + 6 * p.deg, KIN);
    __syncthreads();
    float* ws = scratch + warp * 256;
    dense<P>(X, ldX, KIN, p.w0, H, Y, ldY, nullptr, 0, ws);
    __syncthreads();
    dense<P>(Y, ldY, H, p.w1, H, X, ldX, nullptr, 0, ws);
    __syncthreads();
    dense<P>(X, ldX, H, p.w2, OUT, nullptr, 0, F, OUT, ws);
    __syncthreads();
    if (tid < R && ray0 + tid < p.n_rays) {
      const int lo = max(p0, tid * T), hi = min(p0 + P, (tid + 1) * T);
      for (int gp = lo; gp < hi; ++gp) {
        const int q = gp - p0, s = gp - tid * T;
        const float sigma =
            expf(fminf(fmaxf(F[q * OUT] + p.db, -30.0f), 15.0f));
        const float e =
            (p.opaque_last && s == T - 1) ? 0.0f : expf(-dl[q] * sigma);
        const float wr = (1.0f - e) * trans;
        if (p.weights) p.weights[(size_t)(ray0 + tid) * T + s] = wr;
        const float w = __fadd_rn(wr, 0.01f);
        if (Q > 0) wb[tid * T + s] = w;
        total += w;
        trans *= e;
      }
    }
    __syncthreads();
  }
  if (Q == 0) return;  // K7: the weights are all it writes
  // per-ray cdf on the unnormalised running sum, and the s-bin prefix-max /
  // suffix-min the masked lookup reduces to
  if (tid < R && ray0 + tid < p.n_rays) {
    const float* sb = p.s_bins + (size_t)(ray0 + tid) * (T + 1);
    float* c = cdf + tid * (T + 1);
    float* pm = pmax + tid * (T + 1);
    float* sm = smin + tid * (T + 1);
    c[0] = 0.0f;
    for (int k = 0; k < T; ++k) c[k + 1] = fminf(c[k] + wb[tid * T + k], total);
    pm[0] = sb[0];
    for (int k = 1; k <= T; ++k) pm[k] = fmaxf(pm[k - 1], sb[k]);
    sm[T] = sb[T];
    for (int k = T - 1; k >= 0; --k) sm[k] = fminf(sm[k + 1], sb[k]);
    tot[tid] = total;
  }
  __syncthreads();
  for (int item = tid; item < R * Q; item += NTHREADS) {
    const int r = item / Q, ray = ray0 + r;
    if (ray >= p.n_rays) continue;
    const float* c = cdf + r * (T + 1);
    const float ut = p.u[(size_t)ray * Q + (item - r * Q)] * tot[r];
    // c is non-decreasing, so {k : c_k <= ut} is a prefix [0, j]
    const int j = count_le(c, T + 1, ut) - 1;
    float cg0 = -1e38f, sg0 = -1e38f, cg1, sg1;
    if (j >= 0) {
      cg0 = c[j];
      sg0 = pmax[r * (T + 1) + j];
    }
    if (j < T) {
      cg1 = c[j + 1];
      sg1 = smin[r * (T + 1) + j + 1];
    } else {
      cg1 = c[T];
      sg1 = smin[r * (T + 1) + T];
    }
    const float denom = cg1 - cg0;
    float t = denom > 0.0f ? (ut - cg0) / denom : 0.0f;
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    p.out[(size_t)ray * Q + (item - r * Q)] = sg0 + t * (sg1 - sg0);
  }
}

size_t final_smem(int H, int KIN) {
  return (size_t)P * (H + KIN + 8) * 2 + (size_t)P * (H + 8) * 2 +
         (size_t)(P * OUT + NWARPS * 256 + P * 5) * 4;
}

size_t prop_smem(int H, int KIN, int T, int Q, int R) {
  const int wx = KIN > H ? KIN : H;
  return (size_t)P * (wx + 8) * 2 + (size_t)P * (H + 8) * 2 +
         (size_t)(P * OUT + NWARPS * 256 + P * 5) * 4 +
         (Q > 0 ? (size_t)(R * T + 3 * R * (T + 1) + R) * 4 : 0);
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t code.  Weights are bf16 [out, in] padded:
// w0 [H, KIN], w1 [H, H], w2 [H, H+KIN] (columns [act | h_in]), w3 [16, H];
// KIN = 3 + 6*deg + rank rounded up to 16, H a multiple of 16.
// geo: [N, T, 15] per-sample trunk features (K6) or null (K3).
int sanerf_final_level(const float* rays_o, const float* rays_d,
                       const float* real_bins, const float* sh,
                       const void* w0, const void* w1, const void* w2,
                       const void* w3, const float* cp_x, const float* cp_y,
                       const float* cp_z, float* f_image, float* depth,
                       float* wsum, float* weights, float* geo, int n_rays,
                       int T,
                       int freq_degree, int cp_rank, int cp_res, int hidden,
                       int kin, float grid_bound, int opaque_last,
                       float density_bias, void* stream) {
  FinalParams p;
  p.rays_o = rays_o; p.rays_d = rays_d; p.bins = real_bins; p.sh = sh;
  p.w0 = (const bf16*)w0; p.w1 = (const bf16*)w1;
  p.w2 = (const bf16*)w2; p.w3 = (const bf16*)w3;
  p.cp[0] = cp_x; p.cp[1] = cp_y; p.cp[2] = cp_z;
  p.f_image = f_image; p.depth = depth; p.wsum = wsum; p.weights = weights;
  p.geo = geo;
  p.n_rays = n_rays; p.T = T; p.deg = freq_degree; p.rank = cp_rank;
  p.res = cp_res; p.hidden = hidden; p.kin = kin;
  p.rays_per_cta = T >= P ? 1 : P / T;
  p.opaque_last = opaque_last; p.grid_bound = grid_bound;
  p.db = density_bias;
  if (n_rays == 0) return 0;
  const int grid = (n_rays + p.rays_per_cta - 1) / p.rays_per_cta;
  return launch_checked((const void*)final_level_kernel, grid,
                        final_smem(hidden, kin), (cudaStream_t)stream, &p);
}

// Weights are bf16 [out, in] padded: w0 [H, KIN], w1 [H, H], w2 [16, H]
// (row 0 the density head); KIN = 3 + 6*deg rounded up to 16.
// weights: [N, T] raw weights (K1, K7) or null (K5).  Q = 0 is K7: no
// resampling, s_bins, u and out unused (null).
int sanerf_prop_level_sample(const float* rays_o, const float* rays_d,
                             const float* real_bins, const float* s_bins,
                             const float* u, const void* w0, const void* w1,
                             const void* w2, float* out, float* weights,
                             int n_rays, int T,
                             int Q, int freq_degree, int hidden, int kin,
                             float grid_bound, int opaque_last,
                             float density_bias, void* stream) {
  PropParams p;
  p.rays_o = rays_o; p.rays_d = rays_d; p.bins = real_bins;
  p.s_bins = s_bins; p.u = u;
  p.w0 = (const bf16*)w0; p.w1 = (const bf16*)w1; p.w2 = (const bf16*)w2;
  p.out = out; p.weights = weights;
  p.n_rays = n_rays; p.T = T; p.Q = Q; p.deg = freq_degree;
  p.hidden = hidden; p.kin = kin;
  p.rays_per_cta = T >= P ? 1 : P / T;
  p.opaque_last = opaque_last; p.grid_bound = grid_bound;
  p.db = density_bias;
  if (n_rays == 0) return 0;
  const int grid = (n_rays + p.rays_per_cta - 1) / p.rays_per_cta;
  return launch_checked((const void*)prop_level_sample_kernel, grid,
                        prop_smem(hidden, kin, T, Q, p.rays_per_cta),
                        (cudaStream_t)stream, &p);
}

const char* sanerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
