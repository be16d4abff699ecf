// Backward render-level kernels for NVIDIA Hopper (sm_90a): the weight
// gradients of the proposal level (K2) and of the final level with its CP
// line features (K4).  Bound to Python through ctypes
// (sanerf_hq_tpu_torch/ops/render_level.py); plain C interface, no PyTorch
// headers.  Shared device code: render_level_common.cuh.
//
// Replaces (JAX reference, sanerf_hq_tpu/ops/render_level_pallas.py):
//   K2  _make_prop_bwd_kernel  (:861), reached through _prop_train_bwd
//       (:1103), the VJP of prop_level_train_sample (:449)
//   K4  _make_final_bwd_kernel (:754), reached through _final_train_bwd
//       (:1024), the VJP of final_level_train (:957)
//
// What they compute.  No gradient flows to rays, bins or sh: only the MLP
// weights (and K4's CP bases) get one.  Compositing backward in closed form
// (render_level_pallas.py:29):
//   dL/d(ds_s) = G_s T_{s+1} - sum_{j>s} G_j w_j,  ds_s = delta_s sigma_s,
// with G_s = dL/dw_s (K2) or, for K4,
//   G_s = g_f[:15].h_s[1:] + g_f[15:].sh + g_depth t_s + g_wsum + g_w[s];
// the density grad is dL/d(ds_s) delta_s sigma_s inside (-30, 15) and 0
// outside it and at the opaque last sample.  Then the trunk backward with
// the reference's rounding points: dh cast to bf16; dW_l += d^T x_l and
// da = d W_l, both bf16 products with fp32 sums; da masked by the layer's
// input > 0 (the relu mask) and cast to bf16.  K4 keeps the CP rows' grad
// (w0's last rank columns and the skip re-entry into w2) in fp32 and runs
// the product rule through the three line factors.
//
// Design.  A CTA of 8 warps walks groups of whole rays (gridDim.x groups
// apart), in passes of PP points: 128 when the pass fits shared memory,
// else 64 (K4 at flagship width: its stash is [A2 | h_in], A1 and A3 in
// bf16, about 1.8 KB a point).
//   1. Forward with every layer's input kept in shared memory, then the
//      per-point raw density (and K4's g_f . h[1:]).
//   2. One thread per ray: the transmittance forward and the reverse suffix
//      sum over the ray's T samples, on per-sample scalars in shared memory.
//   3. The trunk backward on the kept activations (a ray group that spans
//      several passes recomputes each pass's forward; at the flagship shapes
//      every group fits one pass, so nothing is computed twice).  dW tiles
//      are WMMA products over the pass's points, added into this CTA's own
//      fp32 slab in device memory; a second kernel sums the slabs in CTA
//      order, so the weight grads are the same bits on every run.  K4's CP
//      basis grads go out with fp32 atomicAdd (2 taps x 3 axes x rank a
//      point into rows many points share), so they vary in their last bits.
// What bounds it on this card: tensor-core work (one forward plus the dW
// and dA products, about 5.9e5 MAC a sample for K4 and 1.7e4 for K2) on
// chip; device memory sees the inputs, the per-pass read-modify-write of
// the CTA's dW slab (L2-resident for K2, about 0.8 MB a pass for K4) and
// the atomics.  This first version uses WMMA (mma.sync), not wgmma/TMA.
#include "render_level_common.cuh"

using namespace sanerf;

namespace {

// dW [m x n] (fp32, row-major with ld ldw, in device memory) += D^T X over
// the pass's PP points.  D: [PP, m] bf16 (ldd), X: [PP, n] bf16 (ldx), both
// in shared memory.  With first set, the old contents are not read.
template <int PP>
__device__ void accum_dw(const bf16* D, int ldd, int m, const bf16* X,
                         int ldx, int n, float* dW, int ldw, bool first) {
  const int warp = threadIdx.x >> 5;
  const int mtn = m / 16, ntn = n / 16;
  for (int u = warp; u < mtn * ntn; u += NWARPS) {
    const int mt = u / ntn, nt = u - mt * ntn;
    float* c = dW + (size_t)mt * 16 * ldw + nt * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (first) wmma::fill_fragment(acc, 0.0f);
    else wmma::load_matrix_sync(acc, c, ldw, wmma::mem_row_major);
#pragma unroll
    for (int kt = 0; kt < PP; kt += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, D + kt * ldd + mt * 16, ldd);
      wmma::load_matrix_sync(b, X + kt * ldx + nt * 16, ldx);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(c, acc, ldw, wmma::mem_row_major);
  }
}

// C [PP x n] = D [PP x k] * W [k x n]: D bf16 in shared memory (ldd), W the
// layer's bf16 [out, in] weights in device memory (ldw), row-major B.  Only
// the columns the backward needs are computed: column c < nmask becomes
// bf16(M[c] > 0 ? C : 0) in O (the next d, masked by the layer's input M);
// column c in [e0, e1) is added in fp32 to E[c - e0] (the CP rows' grad).
template <int PP>
__device__ void backprop_da(const bf16* D, int ldd, int k, const bf16* W,
                            int ldw, const bf16* M, int ldm, bf16* O, int ldo,
                            int nmask, float* E, int lde, int e0, int e1,
                            float* scratch) {
  constexpr int MT = PP / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t1 = nmask / 16;
  const int t2lo = e1 > e0 ? e0 / 16 : 0, t2hi = e1 > e0 ? (e1 + 15) / 16 : 0;
  const int ntiles = t1 + (t2hi - t2lo);
  int wpn = 1;  // warps sharing one column tile (power of two dividing MT)
  while (wpn * 2 * ntiles <= NWARPS && wpn * 2 <= MT) wpn *= 2;
  const int mper = MT / wpn;
  for (int u = warp; u < ntiles * wpn; u += NWARPS) {
    const int ti = u / wpn, m0 = (u % wpn) * mper;
    const int nt = ti < t1 ? ti : t2lo + (ti - t1);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < mper) wmma::fill_fragment(acc[i], 0.0f);
    for (int kt = 0; kt < k; kt += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, W + (size_t)kt * ldw + nt * 16, ldw);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < mper) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, D + (m0 + i) * 16 * ldd + kt, ldd);
          wmma::mma_sync(acc[i], a, b, acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < mper) {
        wmma::store_matrix_sync(scratch, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = (m0 + i) * 16 + (e >> 4), c = nt * 16 + (e & 15);
          const float v = scratch[e];
          if (c < nmask) {
            const bool on = __bfloat162float(M[r * ldm + c]) > 0.0f;
            O[r * ldo + c] = __float2bfloat16(on ? v : 0.0f);
          } else if (c >= e0 && c < e1) {
            E[r * lde + c - e0] += v;
          }
        }
        __syncwarp();
      }
    }
  }
}

// One thread per ray: transmittance forward, then the reverse suffix sum
// over the ray's T samples.  raw [T] holds the raw densities and leaves
// with the density grads.  K4: G [T] holds g_f[:15] . h[1:] and gc the
// ray's (g_f[15:] . sh, g_depth, g_wsum), completed here into G_s; K2: both
// null and G_s = g_w[s].  Tn, w [T] are scratch.
__device__ void composite_bwd(const float* bins, const float* g_w, int ray,
                              int T, int opaque_last, float db,
                              const float* gc, float* raw, float* G,
                              float* Tn, float* w) {
  const float* b = bins + (size_t)ray * (T + 1);
  const float* gw = g_w + (size_t)ray * T;
  float trans = 1.0f;
  for (int s = 0; s < T; ++s) {
    const float delta = b[s + 1] - b[s];
    const float sigma = expf(fminf(fmaxf(raw[s] + db, -30.0f), 15.0f));
    const float e = (opaque_last && s == T - 1) ? 0.0f : expf(-delta * sigma);
    w[s] = (1.0f - e) * trans;
    trans = trans * e;
    Tn[s] = trans;
    if (G) {
      const float t = (b[s] + b[s + 1]) * 0.5f;
      G[s] = G[s] + gc[0] + gc[1] * t + gc[2] + gw[s];
    }
  }
  float S = 0.0f;
  for (int s = T - 1; s >= 0; --s) {
    const float Gs = G ? G[s] : gw[s];
    const float d_ds = Gs * Tn[s] - S;
    S = S + Gs * w[s];
    float dr = 0.0f;
    const float x = raw[s] + db;
    if (!(opaque_last && s == T - 1) && x > -30.0f && x < 15.0f)
      dr = d_ds * (b[s + 1] - b[s]) * expf(x);
    raw[s] = dr;
  }
}

__global__ void reduce_partials(const float* part, int n_part, int slab,
                                float* out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < slab;
       i += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int c = 0; c < n_part; ++c) s += part[(size_t)c * slab + i];
    out[i] = s;
  }
}

int launch_reduce(const float* part, int n_part, int slab, float* out,
                  cudaStream_t stream) {
  const int blocks = slab < 1024 * 256 ? (slab + 255) / 256 : 1024;
  reduce_partials<<<blocks, 256, 0, stream>>>(part, n_part, slab, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2: proposal MLP (3 bias-free layers, freq input) weight grads
// ---------------------------------------------------------------------------

struct PropBwdParams {
  const float *rays_o, *rays_d, *bins;
  const bf16 *w0, *w1, *w2;
  const float* g_w;
  float* dw_part;  // [gridDim.x, slab]: dW0 [H,KIN] | dW1 [H,H] | dW2 [16,H]
  int n_rays, T, deg, hidden, kin, rays_per_group, n_groups, opaque_last;
  float grid_bound, db;
};

struct PropSmem {
  bf16 *X0, *X1, *X2, *DA, *DB, *D2;
  float *F, *scratch, *xn, *tt, *dl, *raw, *Tn, *w;
};

template <int PP>
__device__ PropSmem prop_smem_layout(unsigned char* smem, int H, int KIN,
                                     int GP) {
  PropSmem s;
  s.X0 = reinterpret_cast<bf16*>(smem);  // [PP, KIN+8] layer-0 input
  s.X1 = s.X0 + PP * (KIN + 8);          // [PP, H+8] layer-1 input
  s.X2 = s.X1 + PP * (H + 8);            // [PP, H+8] layer-2 input
  s.DA = s.X2 + PP * (H + 8);            // [PP, H+8] upstream grads
  s.DB = s.DA + PP * (H + 8);
  s.D2 = s.DB + PP * (H + 8);            // [PP, OUT+8] last layer's grad
  s.F = reinterpret_cast<float*>(s.D2 + PP * (OUT + 8));  // [PP, OUT]
  s.scratch = s.F + PP * OUT;
  s.xn = s.scratch + NWARPS * 256;
  s.tt = s.xn + PP * 3;
  s.dl = s.tt + PP;
  s.raw = s.dl + PP;  // [GP] per-sample scalars of the ray group
  s.Tn = s.raw + GP;
  s.w = s.Tn + GP;
  return s;
}

size_t prop_bwd_smem(int PP, int H, int KIN, int GP) {
  return (size_t)PP * (KIN + 8) * 2 + (size_t)4 * PP * (H + 8) * 2 +
         (size_t)PP * (OUT + 8) * 2 +
         (size_t)(PP * OUT + NWARPS * 256 + PP * 5 + 3 * GP) * 4;
}

template <int PP>
__device__ void prop_forward(const PropBwdParams& p, const PropSmem& s,
                             int ray0, int GP, int p0) {
  const int H = p.hidden, KIN = p.kin;
  float* ws = s.scratch + (threadIdx.x >> 5) * 256;
  build_geometry_freq<PP>(p.rays_o, p.rays_d, p.bins, p.n_rays, p.T, ray0,
                          GP, p0, p.deg, p.grid_bound, s.xn, s.tt, s.dl, s.X0,
                          KIN + 8);
  zero_cols<PP>(s.X0, KIN + 8, 3 + 6 * p.deg, KIN);
  __syncthreads();
  dense<PP>(s.X0, KIN + 8, KIN, p.w0, H, s.X1, H + 8, nullptr, 0, ws);
  __syncthreads();
  dense<PP>(s.X1, H + 8, H, p.w1, H, s.X2, H + 8, nullptr, 0, ws);
  __syncthreads();
  dense<PP>(s.X2, H + 8, H, p.w2, OUT, nullptr, 0, s.F, OUT, ws);
  __syncthreads();
}

template <int PP>
__global__ void __launch_bounds__(NTHREADS)
prop_level_bwd_kernel(PropBwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.hidden, KIN = p.kin, T = p.T, R = p.rays_per_group;
  const int GP = R * T, npass = (GP + PP - 1) / PP, tid = threadIdx.x;
  const PropSmem s = prop_smem_layout<PP>(smem, H, KIN, GP);
  float* ws = s.scratch + (tid >> 5) * 256;
  float* part = p.dw_part + (size_t)blockIdx.x *
                                ((size_t)H * KIN + (size_t)H * H + OUT * H);
  float* dW0 = part;
  float* dW1 = dW0 + (size_t)H * KIN;
  float* dW2 = dW1 + (size_t)H * H;
  bool first = true;
  for (int g = blockIdx.x; g < p.n_groups; g += gridDim.x) {
    const int ray0 = g * R;
    for (int pass = 0; pass < npass; ++pass) {
      const int p0 = pass * PP;
      prop_forward<PP>(p, s, ray0, GP, p0);
      if (tid < PP && p0 + tid < GP) s.raw[p0 + tid] = s.F[tid * OUT];
      __syncthreads();
    }
    if (tid < R && ray0 + tid < p.n_rays)
      composite_bwd(p.bins, p.g_w, ray0 + tid, T, p.opaque_last, p.db,
                    nullptr, s.raw + tid * T, nullptr, s.Tn + tid * T,
                    s.w + tid * T);
    __syncthreads();
    for (int pass = 0; pass < npass; ++pass) {
      const int p0 = pass * PP;
      if (npass > 1) prop_forward<PP>(p, s, ray0, GP, p0);
      for (int item = tid; item < PP * OUT; item += NTHREADS) {
        const int q = item / OUT, c = item - q * OUT, gp = p0 + q;
        const bool ok = c == 0 && gp < GP && ray0 + gp / T < p.n_rays;
        s.D2[q * (OUT + 8) + c] = __float2bfloat16(ok ? s.raw[gp] : 0.0f);
      }
      __syncthreads();
      accum_dw<PP>(s.D2, OUT + 8, OUT, s.X2, H + 8, H, dW2, H, first);
      backprop_da<PP>(s.D2, OUT + 8, OUT, p.w2, H, s.X2, H + 8, s.DA, H + 8,
                      H, nullptr, 0, 0, 0, ws);
      __syncthreads();
      accum_dw<PP>(s.DA, H + 8, H, s.X1, H + 8, H, dW1, H, first);
      backprop_da<PP>(s.DA, H + 8, H, p.w1, H, s.X1, H + 8, s.DB, H + 8, H,
                      nullptr, 0, 0, 0, ws);
      __syncthreads();
      accum_dw<PP>(s.DB, H + 8, H, s.X0, KIN + 8, KIN, dW0, KIN, first);
      __syncthreads();
      first = false;
    }
  }
}

// ---------------------------------------------------------------------------
// K4: final trunk (4 bias-free layers, skip at layer 2, freq + CP input)
// weight grads and CP basis grads
// ---------------------------------------------------------------------------

struct FinalBwdParams {
  const float *rays_o, *rays_d, *bins, *sh;
  const bf16 *w0, *w1, *w2, *w3;
  const float* cp[3];
  const float *g_f, *g_depth, *g_wsum, *g_w;
  float* dw_part;  // [gridDim.x, slab]: dW0 | dW1 | dW2 [H,H+KIN] | dW3
  float* dcp[3];   // [res, rank] each, accumulated with atomicAdd
  int n_rays, T, deg, rank, res, hidden, kin, rays_per_group, n_groups,
      opaque_last;
  float grid_bound, db;
};

struct FinalSmem {
  bf16 *B2, *A1, *A3, *DA, *DB, *D3;
  float *F, *scratch, *xn, *tt, *dl, *E, *gfr, *gc, *raw, *G, *Tn, *w;
};

template <int PP>
__device__ FinalSmem final_smem_layout(unsigned char* smem, int H, int KIN,
                                       int rank, int R, int GP) {
  FinalSmem s;
  s.B2 = reinterpret_cast<bf16*>(smem);  // [PP, H+KIN+8]: [A2 | h_in]
  s.A1 = s.B2 + PP * (H + KIN + 8);      // [PP, H+8] layer-1 input
  s.A3 = s.A1 + PP * (H + 8);            // [PP, H+8] layer-3 input
  s.DA = s.A3 + PP * (H + 8);            // [PP, H+8] upstream grads
  s.DB = s.DA + PP * (H + 8);
  s.D3 = s.DB + PP * (H + 8);            // [PP, OUT+8] last layer's grad
  s.F = reinterpret_cast<float*>(s.D3 + PP * (OUT + 8));  // [PP, OUT]
  s.scratch = s.F + PP * OUT;
  s.xn = s.scratch + NWARPS * 256;
  s.tt = s.xn + PP * 3;
  s.dl = s.tt + PP;
  s.E = s.dl + PP;        // [PP, rank] grad of the CP features
  s.gfr = s.E + PP * rank;  // [R, 15] g_f of the geometry features
  s.gc = s.gfr + R * GEO;   // [R, 3] g_f[15:].sh, g_depth, g_wsum
  s.raw = s.gc + R * 3;     // [GP] per-sample scalars of the ray group
  s.G = s.raw + GP;
  s.Tn = s.G + GP;
  s.w = s.Tn + GP;
  return s;
}

size_t final_bwd_smem(int PP, int H, int KIN, int rank, int R, int GP) {
  return (size_t)PP * (H + KIN + 8) * 2 + (size_t)4 * PP * (H + 8) * 2 +
         (size_t)PP * (OUT + 8) * 2 +
         (size_t)(PP * OUT + NWARPS * 256 + PP * 5 + PP * rank +
                  R * (GEO + 3) + 4 * GP) * 4;
}

template <int PP>
__device__ void final_forward(const FinalBwdParams& p, const FinalSmem& s,
                              int ray0, int GP, int p0) {
  const int H = p.hidden, KIN = p.kin, ldB = H + KIN + 8;
  const int nf = 3 + 6 * p.deg;
  bf16* hin = s.B2 + H;
  float* ws = s.scratch + (threadIdx.x >> 5) * 256;
  build_geometry_freq<PP>(p.rays_o, p.rays_d, p.bins, p.n_rays, p.T, ray0,
                          GP, p0, p.deg, p.grid_bound, s.xn, s.tt, s.dl, hin,
                          ldB);
  zero_cols<PP>(hin, ldB, nf + p.rank, KIN);
  build_cp<PP>(p.cp, p.rank, p.res, s.xn, hin, ldB, nf);
  __syncthreads();
  dense<PP>(hin, ldB, KIN, p.w0, H, s.A1, H + 8, nullptr, 0, ws);
  __syncthreads();
  dense<PP>(s.A1, H + 8, H, p.w1, H, s.B2, ldB, nullptr, 0, ws);
  __syncthreads();
  dense<PP>(s.B2, ldB, H + KIN, p.w2, H, s.A3, H + 8, nullptr, 0, ws);
  __syncthreads();
  dense<PP>(s.A3, H + 8, H, p.w3, OUT, nullptr, 0, s.F, OUT, ws);
  __syncthreads();
}

template <int PP>
__global__ void __launch_bounds__(NTHREADS)
final_level_bwd_kernel(FinalBwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.hidden, KIN = p.kin, T = p.T, R = p.rays_per_group;
  const int rank = p.rank, nf = 3 + 6 * p.deg, ldB = H + KIN + 8;
  const int GP = R * T, npass = (GP + PP - 1) / PP, tid = threadIdx.x;
  const FinalSmem s = final_smem_layout<PP>(smem, H, KIN, rank, R, GP);
  float* ws = s.scratch + (tid >> 5) * 256;
  float* dW0 = p.dw_part +
               (size_t)blockIdx.x * ((size_t)H * KIN + (size_t)H * H +
                                     (size_t)H * (H + KIN) + OUT * H);
  float* dW1 = dW0 + (size_t)H * KIN;
  float* dW2 = dW1 + (size_t)H * H;
  float* dW3 = dW2 + (size_t)H * (H + KIN);
  bool first = true;
  for (int g = blockIdx.x; g < p.n_groups; g += gridDim.x) {
    const int ray0 = g * R;
    if (tid < R) {
      const int ray = ray0 + tid;
      const bool ok = ray < p.n_rays;
      const float* gf = p.g_f + (size_t)ray * (GEO + SHD);
      for (int c = 0; c < GEO; ++c) s.gfr[tid * GEO + c] = ok ? gf[c] : 0.0f;
      float gsh = 0.0f;
      for (int c = 0; c < SHD && ok; ++c)
        gsh += gf[GEO + c] * p.sh[(size_t)ray * SHD + c];
      s.gc[tid * 3] = gsh;
      s.gc[tid * 3 + 1] = ok ? p.g_depth[ray] : 0.0f;
      s.gc[tid * 3 + 2] = ok ? p.g_wsum[ray] : 0.0f;
    }
    // 1. forward: raw density and g_f[:15] . h[1:] of every sample
    for (int pass = 0; pass < npass; ++pass) {
      const int p0 = pass * PP;
      final_forward<PP>(p, s, ray0, GP, p0);
      if (tid < PP && p0 + tid < GP) {
        const int gp = p0 + tid, r = gp / T;
        float dot = 0.0f;
        for (int c = 0; c < GEO; ++c)
          dot += s.gfr[r * GEO + c] * s.F[tid * OUT + 1 + c];
        s.raw[gp] = s.F[tid * OUT];
        s.G[gp] = dot;
      }
      __syncthreads();
    }
    // 2. compositing backward, a thread per ray
    if (tid < R && ray0 + tid < p.n_rays)
      composite_bwd(p.bins, p.g_w, ray0 + tid, T, p.opaque_last, p.db,
                    s.gc + tid * 3, s.raw + tid * T, s.G + tid * T,
                    s.Tn + tid * T, s.w + tid * T);
    __syncthreads();
    // 3. trunk backward
    for (int pass = 0; pass < npass; ++pass) {
      const int p0 = pass * PP;
      if (npass > 1) final_forward<PP>(p, s, ray0, GP, p0);
      for (int item = tid; item < PP * OUT; item += NTHREADS) {
        const int q = item / OUT, c = item - q * OUT, gp = p0 + q, r = gp / T;
        float v = 0.0f;
        if (gp < GP && ray0 + r < p.n_rays)
          v = c == 0 ? s.raw[gp] : s.w[gp] * s.gfr[r * GEO + c - 1];
        s.D3[q * (OUT + 8) + c] = __float2bfloat16(v);
      }
      for (int item = tid; item < PP * rank; item += NTHREADS)
        s.E[item] = 0.0f;
      __syncthreads();
      accum_dw<PP>(s.D3, OUT + 8, OUT, s.A3, H + 8, H, dW3, H, first);
      backprop_da<PP>(s.D3, OUT + 8, OUT, p.w3, H, s.A3, H + 8, s.DA, H + 8,
                      H, nullptr, 0, 0, 0, ws);
      __syncthreads();
      accum_dw<PP>(s.DA, H + 8, H, s.B2, ldB, H + KIN, dW2, H + KIN, first);
      backprop_da<PP>(s.DA, H + 8, H, p.w2, H + KIN, s.B2, ldB, s.DB, H + 8,
                      H, s.E, rank, H + nf, H + nf + rank, ws);
      __syncthreads();
      accum_dw<PP>(s.DB, H + 8, H, s.A1, H + 8, H, dW1, H, first);
      backprop_da<PP>(s.DB, H + 8, H, p.w1, H, s.A1, H + 8, s.DA, H + 8, H,
                      nullptr, 0, 0, 0, ws);
      __syncthreads();
      accum_dw<PP>(s.DA, H + 8, H, s.B2 + H, ldB, KIN, dW0, KIN, first);
      if (rank)
        backprop_da<PP>(s.DA, H + 8, H, p.w0, KIN, nullptr, 0, nullptr, 0, 0,
                        s.E, rank, nf, nf + rank, ws);
      __syncthreads();
      // product rule through extra = L_x L_y L_z, scattered to both taps
      for (int item = tid; item < PP * rank; item += NTHREADS) {
        const int q = item / rank, r = item - q * rank, gp = p0 + q;
        if (gp >= GP || ray0 + gp / T >= p.n_rays) continue;
        int i0[3];
        float f[3], l[3];
        cp_taps(s.xn + q * 3, p.res, i0, f);
#pragma unroll
        for (int a = 0; a < 3; ++a)
          l[a] = cp_line(p.cp[a], rank, i0[a], f[a], r);
        const float de = s.E[item];
        const float dla[3] = {de * l[1] * l[2], de * l[0] * l[2],
                              de * l[0] * l[1]};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float* row = p.dcp[a] + (size_t)i0[a] * rank + r;
          atomicAdd(row, dla[a] * (1.0f - f[a]));
          atomicAdd(row + rank, dla[a] * f[a]);
        }
      }
      __syncthreads();
      first = false;
    }
  }
}

// Pass size: 128 points when the kernel's shared memory fits, else 64.
template <typename SmemFn>
int pick_pass(int T, SmemFn smem_of, int& R, size_t& smem) {
  for (int pp = 128; pp >= 64; pp -= 64) {
    R = T >= pp ? 1 : pp / T;
    smem = smem_of(pp, R, R * T);
    if (smem <= SMEM_LIMIT) return pp;
  }
  return 0;
}

}  // namespace

extern "C" {

// K2.  Returns 0 or a cudaError_t code.  Weights bf16 [out, in] padded as
// K5 takes them: w0 [H, KIN], w1 [H, H], w2 [16, H] (row 0 the density
// head).  g_w [N, T] is dL/dweights.  dw_part holds max_ctas slabs of
// H*KIN + H*H + 16*H floats; dw_out receives their sum (dW0 | dW1 | dW2).
int sanerf_prop_level_bwd(const float* rays_o, const float* rays_d,
                          const float* real_bins, const void* w0,
                          const void* w1, const void* w2, const float* g_w,
                          float* dw_part, float* dw_out, int max_ctas,
                          int n_rays, int T, int freq_degree, int hidden,
                          int kin, float grid_bound, int opaque_last,
                          float density_bias, void* stream) {
  PropBwdParams p;
  p.rays_o = rays_o; p.rays_d = rays_d; p.bins = real_bins;
  p.w0 = (const bf16*)w0; p.w1 = (const bf16*)w1; p.w2 = (const bf16*)w2;
  p.g_w = g_w; p.dw_part = dw_part;
  p.n_rays = n_rays; p.T = T; p.deg = freq_degree; p.hidden = hidden;
  p.kin = kin; p.opaque_last = opaque_last; p.grid_bound = grid_bound;
  p.db = density_bias;
  if (n_rays <= 0 || T < 1 || max_ctas < 1) return (int)cudaErrorInvalidValue;
  size_t smem;
  const int pp = pick_pass(
      T,
      [&](int PP, int, int GP) { return prop_bwd_smem(PP, hidden, kin, GP); },
      p.rays_per_group, smem);
  if (!pp) return (int)cudaErrorInvalidValue;
  p.n_groups = (n_rays + p.rays_per_group - 1) / p.rays_per_group;
  const int grid = max_ctas < p.n_groups ? max_ctas : p.n_groups;
  const void* kernel = pp == 128 ? (const void*)prop_level_bwd_kernel<128>
                                 : (const void*)prop_level_bwd_kernel<64>;
  int rc = launch_checked(kernel, grid, smem, (cudaStream_t)stream, &p);
  if (rc) return rc;
  const int slab = hidden * kin + hidden * hidden + OUT * hidden;
  return launch_reduce(dw_part, grid, slab, dw_out, (cudaStream_t)stream);
}

// K4.  Returns 0 or a cudaError_t code.  Weights bf16 [out, in] padded as
// K3 takes them: w0 [H, KIN], w1 [H, H], w2 [H, H+KIN], w3 [16, H].
// g_f [N, 31], g_depth, g_wsum [N], g_w [N, T] are the grads of K3's
// outputs.  dw_part holds max_ctas slabs of H*KIN + H*H + H*(H+KIN) + 16*H
// floats; dw_out receives their sum.  dcp_* [res, rank] must be zeroed by
// the caller (null when rank is 0).
int sanerf_final_level_bwd(const float* rays_o, const float* rays_d,
                           const float* real_bins, const float* sh,
                           const void* w0, const void* w1, const void* w2,
                           const void* w3, const float* cp_x,
                           const float* cp_y, const float* cp_z,
                           const float* g_f, const float* g_depth,
                           const float* g_wsum, const float* g_w,
                           float* dw_part, float* dw_out, float* dcp_x,
                           float* dcp_y, float* dcp_z, int max_ctas,
                           int n_rays, int T, int freq_degree, int cp_rank,
                           int cp_res, int hidden, int kin, float grid_bound,
                           int opaque_last, float density_bias,
                           void* stream) {
  FinalBwdParams p;
  p.rays_o = rays_o; p.rays_d = rays_d; p.bins = real_bins; p.sh = sh;
  p.w0 = (const bf16*)w0; p.w1 = (const bf16*)w1;
  p.w2 = (const bf16*)w2; p.w3 = (const bf16*)w3;
  p.cp[0] = cp_x; p.cp[1] = cp_y; p.cp[2] = cp_z;
  p.g_f = g_f; p.g_depth = g_depth; p.g_wsum = g_wsum; p.g_w = g_w;
  p.dw_part = dw_part;
  p.dcp[0] = dcp_x; p.dcp[1] = dcp_y; p.dcp[2] = dcp_z;
  p.n_rays = n_rays; p.T = T; p.deg = freq_degree; p.rank = cp_rank;
  p.res = cp_res; p.hidden = hidden; p.kin = kin;
  p.opaque_last = opaque_last; p.grid_bound = grid_bound;
  p.db = density_bias;
  if (n_rays <= 0 || T < 1 || max_ctas < 1) return (int)cudaErrorInvalidValue;
  size_t smem;
  const int pp = pick_pass(
      T,
      [&](int PP, int R, int GP) {
        return final_bwd_smem(PP, hidden, kin, cp_rank, R, GP);
      },
      p.rays_per_group, smem);
  if (!pp) return (int)cudaErrorInvalidValue;
  p.n_groups = (n_rays + p.rays_per_group - 1) / p.rays_per_group;
  const int grid = max_ctas < p.n_groups ? max_ctas : p.n_groups;
  const void* kernel = pp == 128 ? (const void*)final_level_bwd_kernel<128>
                                 : (const void*)final_level_bwd_kernel<64>;
  int rc = launch_checked(kernel, grid, smem, (cudaStream_t)stream, &p);
  if (rc) return rc;
  const int slab =
      hidden * kin + hidden * hidden + hidden * (hidden + kin) + OUT * hidden;
  return launch_reduce(dw_part, grid, slab, dw_out, (cudaStream_t)stream);
}

const char* sanerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
