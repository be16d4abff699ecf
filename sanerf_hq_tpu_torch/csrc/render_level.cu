// Render-level kernels for NVIDIA Hopper (sm_90a): the proposal level with
// in-kernel inverse-CDF resampling (K5, K1 with its weights output, and K7
// with the weights alone) and the final level with CP line features (K3,
// and K6 with its per-sample trunk features output).  Bound to Python
// through ctypes (sanerf_hq_tpu_torch/ops/render_level.py); plain C
// interface, no PyTorch headers.  Shared device code:
// render_level_common.cuh, render_level_gemm.cuh.
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
//       fused_final_level_frozen (:85, pallas_call :143); the same launches
//       as K3 with each sample's 15 trunk features stored (geo [N, T, 15])
//
// K3 and K6: a sequence of launches over all N*T points, as K4's stash
// part runs its forward (render_level_gemm.cuh): final_input_kernel
// (geometry, block freq rows and the CP line features as a two-tap gather,
// bf16, into the h_in columns of a [P, H+KIN] scratch xb), four wgmma
// layer products (128 x 128 tiles, two CTAs an SM: A1, A2 into xb's first
// H columns so that the skip layer reads one [A2 | h_in] row, A3, and the
// fp32 last layer F [P, 16]), then final_forward_composite, a warp a ray:
// the round's 32 rows of F staged through 2 KB of shared memory a warp,
// transmittance as a shuffle product scan in rounds of 32 samples carried
// in order (any T), and warp sums for f_image[:15], depth and the weights'
// sum.  The scratch, about 1.9 KB a point at flagship width, is the
// design's cost (the first port's fused kernel kept every activation on
// chip but ran WMMA with B fragments from L1/L2, a CTA barrier between
// steps and a thread a ray compositing, 19x its bound).  What bounds K3:
// the products (2e5 MAC a sample) and the scratch's traffic.
//
// K5, K1 and K7: one kernel, a CTA of 8 warps walking groups of whole rays
// (8 rays, or 128 points' worth when T is small) in 128-point passes, the
// grid as many CTAs as the SMs hold at once.  At widths whose weights let
// two CTAs share an SM (the flagship's 64-wide proposal MLPs: 18 KB) the
// weights sit in shared memory for the CTA's life and every product takes
// A and B from shared memory (mma.sync on ldmatrix fragments, bf16
// products, fp32 sums, the epilogue straight from the registers); wider
// layers read their weights through L1/L2 (WMMA), one CTA an SM.  Each
// pass: geometry and freq rows (sincosf(ldexpf(x, k))), three products,
// the raw densities kept for the group.  Then a warp a ray: transmittance
// as a shuffle
// product scan, each raw weight (1-e)*trans stored coalesced (K1, K7); the
// floored weight __fadd_rn(w, 0.01f) (not contracted, so that K1's bins
// are K5's bit for bit) summed by a shuffle scan into the unnormalised
// cdf, clipped at the total; the s-bins' prefix-max and suffix-min as
// shuffle scans; then a thread a (ray, query) binary search over shared
// memory.  What bounds it: the latency of each pass's chain of small steps
// (8e3 MAC a sample is little tensor work).
#include "render_level_gemm.cuh"

using namespace sanerf;

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// K3 / K6: forward compositing, a warp a ray
// ---------------------------------------------------------------------------

struct CompositeParams {
  const float *f, *bins, *sh;  // f [N*T, 16]: raw density | 15 features
  float *f_image, *depth, *wsum, *weights;
  float* geo;  // [N, T, 15] per-sample trunk features (K6) or null (K3)
  int n_rays, T, opaque_last;
  float db;
};

constexpr int FLD = OUT + 1;  // row stride of the staged rows: no conflicts

__global__ void __launch_bounds__(NTHREADS)
final_forward_composite(CompositeParams p) {
  __shared__ float rows[NWARPS][32 * FLD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, T = p.T;
  const int ray = blockIdx.x * NWARPS + warp;
  if (ray >= p.n_rays) return;  // the whole warp; no CTA barrier follows
  float* st = rows[warp];
  const float* b = p.bins + (size_t)ray * (T + 1);
  const float* F = p.f + (size_t)ray * T * OUT;
  float carry = 1.0f, fe[GEO], depth = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int c = 0; c < GEO; ++c) fe[c] = 0.0f;
  for (int s0 = 0; s0 < T; s0 += 32) {
    const int n = min(32, T - s0);
    // the round's rows of F: 16-byte loads, neighbouring lanes on
    // neighbouring addresses
    const float4* src = reinterpret_cast<const float4*>(F + (size_t)s0 * OUT);
    for (int i = lane; i < n * (OUT / 4); i += 32) {
      const float4 v = src[i];
      float* d = st + (i >> 2) * FLD + (i & 3) * 4;
      d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
    }
    __syncwarp();
    const int s = s0 + lane;
    float e = 1.0f, t = 0.0f;
    if (lane < n) {
      const float b0 = b[s], b1 = b[s + 1];
      t = (b0 + b1) * 0.5f;
      const float sigma =
          expf(fminf(fmaxf(st[lane * FLD] + p.db, -30.0f), 15.0f));
      e = (p.opaque_last && s == T - 1) ? 0.0f : expf(-(b1 - b0) * sigma);
    }
    float inc = e;  // product over the round's lanes up to this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc *= v;
    }
    const float prev = __shfl_up_sync(FULL, inc, 1);
    const float w = (1.0f - e) * (carry * (lane == 0 ? 1.0f : prev));
    carry *= __shfl_sync(FULL, inc, 31);
    if (lane < n) {
      p.weights[(size_t)ray * T + s] = w;
#pragma unroll
      for (int c = 0; c < GEO; ++c) fe[c] += w * st[lane * FLD + 1 + c];
      depth += w * t;
      wsum += w;
    }
    if (p.geo) {  // K6: the round's features, one contiguous run of geo
      float* g = p.geo + ((size_t)ray * T + s0) * GEO;
      for (int i = lane; i < n * GEO; i += 32) {
        const int q = i / GEO;
        g[i] = st[q * FLD + 1 + (i - q * GEO)];
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < GEO; ++c) fe[c] += __shfl_xor_sync(FULL, fe[c], o);
    depth += __shfl_xor_sync(FULL, depth, o);
    wsum += __shfl_xor_sync(FULL, wsum, o);
  }
  float* fo = p.f_image + (size_t)ray * (GEO + SHD);
  float v = 0.0f;
#pragma unroll
  for (int c = 0; c < GEO; ++c)
    if (lane == c) v = fe[c];
  if (lane < GEO) fo[lane] = v;
  else if (lane < GEO + SHD)
    fo[lane] = wsum * p.sh[(size_t)ray * SHD + lane - GEO];
  if (lane == 31) {
    p.depth[ray] = depth;
    p.wsum[ray] = wsum;
  }
}

int launch_composite(CompositeParams c, cudaStream_t stream) {
  return launch_checked((const void*)final_forward_composite,
                        (c.n_rays + NWARPS - 1) / NWARPS, 0, stream, &c);
}

// ---------------------------------------------------------------------------
// K5, K1, K7: the proposal level
// ---------------------------------------------------------------------------

constexpr int PP = 128;  // points a pass

struct PropParams {
  const float *rays_o, *rays_d, *bins, *s_bins, *u;
  const bf16 *w0, *w1, *w2;
  float *out, *weights;  // weights [N, T] raw (K1, K7) or null (K5)
  int n_rays, T, Q, deg, hidden, kin, rays_per_group, n_groups, opaque_last;
  float grid_bound, db;
};

struct PropSmem {
  bf16 *X, *Y, *W0, *W1, *W2;
  float *F, *scratch, *xn, *tt, *dl, *raw, *cdf, *pmax, *smin, *tot;
};

__host__ __device__ inline int prop_ldx(int H, int KIN) {
  return (KIN > H ? KIN : H) + 8;
}

// bf16 elements of Y, which also holds the last layer's fp32 F [PP, 16].
__host__ __device__ inline int prop_y_elems(int H) {
  return PP * (H + 8) > PP * OUT * 2 ? PP * (H + 8) : PP * OUT * 2;
}

__host__ __device__ inline int prop_w_elems(int H, int KIN) {
  return H * (KIN + 8) + H * (H + 8) + OUT * (H + 8);
}

// X [PP, max(KIN,H)+8] the layer-0 input, then layer 1's output; Y [PP,
// H+8] layer 0's output, then F; the weights (wsm); per-warp WMMA scratch;
// the pass's geometry; the group's raw densities [R*T]; with Q > 0 per ray
// the cdf, prefix-max and suffix-min of the s-bins [T+1] each, and the
// total.
__host__ __device__ inline size_t prop_smem(int H, int KIN, int T, int Q,
                                            int R, bool wsm) {
  const size_t b16 = (size_t)PP * prop_ldx(H, KIN) + prop_y_elems(H) +
                     (wsm ? prop_w_elems(H, KIN) : 0);
  const size_t f32 = (wsm ? 0 : (size_t)NWARPS * 256) + PP * 5 +
                     (size_t)R * T +
                     (Q > 0 ? (size_t)3 * R * (T + 1) + R : 0);
  return b16 * 2 + f32 * 4;
}

__device__ PropSmem prop_layout(unsigned char* smem, int H, int KIN, int T,
                                int Q, int R, bool wsm) {
  PropSmem s;
  s.X = reinterpret_cast<bf16*>(smem);
  s.Y = s.X + PP * prop_ldx(H, KIN);
  s.W0 = s.Y + prop_y_elems(H);                // [H, KIN+8]
  s.W1 = s.W0 + (wsm ? H * (KIN + 8) : 0);     // [H, H+8]
  s.W2 = s.W1 + (wsm ? H * (H + 8) : 0);       // [16, H+8]
  s.F = reinterpret_cast<float*>(s.Y);
  float* f = reinterpret_cast<float*>(s.W2 + (wsm ? OUT * (H + 8) : 0));
  s.scratch = f;  // WMMA scratch: dense_ld's, without wsm
  s.xn = s.scratch + (wsm ? 0 : NWARPS * 256);
  s.tt = s.xn + PP * 3;
  s.dl = s.tt + PP;
  s.raw = s.dl + PP;
  s.cdf = s.raw + R * T;
  s.pmax = s.cdf + (Q > 0 ? R * (T + 1) : 0);
  s.smin = s.pmax + (Q > 0 ? R * (T + 1) : 0);
  s.tot = s.smin + (Q > 0 ? R * (T + 1) : 0);
  return s;
}

// One warp, one ray: transmittance and raw weights from the ray's raw
// densities (shared), sample s in lane s % 32 of round s / 32, the rounds
// carried in order; bins read once, coalesced; each raw weight stored
// (weights non-null).  With Q > 0: the cdf [T+1] on the floored weights'
// running sum clipped at their total, the s-bins' prefix-max and
// suffix-min [T+1], and the total.  Every lane of the warp calls it.
__device__ void prop_composite_warp(const PropParams& p, int ray,
                                    const float* raw, float* cdf, float* pmax,
                                    float* smin, float* tot) {
  const int lane = threadIdx.x & 31, T = p.T;
  const float* b = p.bins + (size_t)ray * (T + 1);
  float carry = 1.0f, csum = 0.0f;
  for (int s0 = 0; s0 < T; s0 += 32) {
    const int s = s0 + lane;
    float e = 1.0f;
    if (s < T) {
      const float sigma = expf(fminf(fmaxf(raw[s] + p.db, -30.0f), 15.0f));
      e = (p.opaque_last && s == T - 1) ? 0.0f
                                        : expf(-(b[s + 1] - b[s]) * sigma);
    }
    float inc = e;  // product over the round's lanes up to this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc *= v;
    }
    const float prev = __shfl_up_sync(FULL, inc, 1);
    const float wr = (1.0f - e) * (carry * (lane == 0 ? 1.0f : prev));
    carry *= __shfl_sync(FULL, inc, 31);
    if (s < T && p.weights) p.weights[(size_t)ray * T + s] = wr;
    if (p.Q == 0) continue;
    float w = s < T ? __fadd_rn(wr, 0.01f) : 0.0f;  // running sum in the round
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += v;
    }
    if (s < T) cdf[s + 1] = csum + w;
    csum += __shfl_sync(FULL, w, 31);
  }
  if (p.Q == 0) return;
  __syncwarp();
  for (int k = lane; k <= T; k += 32)
    cdf[k] = k == 0 ? 0.0f : fminf(cdf[k], csum);
  const float* sb = p.s_bins + (size_t)ray * (T + 1);
  float cm = -3.0e38f;
  for (int k0 = 0; k0 <= T; k0 += 32) {
    const int k = k0 + lane;
    float v = k <= T ? sb[k] : -3.0e38f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float x = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v = fmaxf(v, x);
    }
    if (k <= T) pmax[k] = fmaxf(cm, v);
    cm = fmaxf(cm, __shfl_sync(FULL, v, 31));
  }
  cm = 3.0e38f;
  for (int k0 = T / 32 * 32; k0 >= 0; k0 -= 32) {
    const int k = k0 + lane;
    float v = k <= T ? sb[k] : 3.0e38f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float x = __shfl_down_sync(FULL, v, o);
      if (lane + o < 32) v = fminf(v, x);
    }
    if (k <= T) smin[k] = fminf(cm, v);
    cm = fminf(cm, __shfl_sync(FULL, v, 0));
  }
  if (lane == 0) *tot = csum;
}

// C [PP x n] = A [PP x k] W^T with A (row-major, lda) and W ([n, k]
// row-major, ldw) both in shared memory: warp w takes rows 16 w .. 16 w +
// 15 in column blocks of 64, fragments by ldmatrix (the +8 row padding
// keeps its eight rows on distinct banks), mma.sync m16n8k16, and the
// sums leave the registers straight: relu(C) as bf16 pairs into O (ldo),
// or C as fp32 pairs into F (ldf).  k a multiple of 16, n of 8.
__device__ void dense_mma(const bf16* A, int lda, int k, const bf16* W,
                          int ldw, int n, bf16* O, int ldo, float* F,
                          int ldf) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const bf16* ap = A + (r0 + (lane & 15)) * lda + ((lane >> 4) << 3);
  for (int n0 = 0; n0 < n; n0 += 64) {
    const int nt = min(8, (n - n0) / 8);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const bf16* bp = W + (n0 + (lane & 7)) * ldw + (((lane >> 3) & 1) << 3);
    for (int kk = 0; kk < k; kk += 16) {
      unsigned a[4];
      ldmatrix_x4(a, ap + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          unsigned b[2];
          ldmatrix_x2(b, bp + j * 8 * ldw + kk);
          mma_16816(acc[j], a, b);
        }
      }
    }
    const int row = r0 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= nt) continue;
      const int col = n0 + j * 8 + ((lane & 3) << 1);
      if (O) {
        *reinterpret_cast<__nv_bfloat162*>(O + row * ldo + col) =
            __floats2bfloat162_rn(fmaxf(acc[j][0], 0.0f),
                                  fmaxf(acc[j][1], 0.0f));
        *reinterpret_cast<__nv_bfloat162*>(O + (row + 8) * ldo + col) =
            __floats2bfloat162_rn(fmaxf(acc[j][2], 0.0f),
                                  fmaxf(acc[j][3], 0.0f));
      } else {
        *reinterpret_cast<float2*>(F + row * ldf + col) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(F + (row + 8) * ldf + col) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// One layer of the proposal MLP over the pass: dense_mma with the weights
// in shared memory (WSM), else dense_ld with them from L1/L2.
template <bool WSM>
__device__ __forceinline__ void prop_layer(const bf16* A, int lda, int k,
                                           const bf16* W, int ldw, int n,
                                           bf16* O, int ldo, float* F,
                                           int ldf, float* ws) {
  if constexpr (WSM) dense_mma(A, lda, k, W, ldw, n, O, ldo, F, ldf);
  else dense_ld<PP>(A, lda, k, W, ldw, n, O, ldo, F, ldf, ws);
}

// WSM: the weights in shared memory for the CTA's life, two CTAs an SM.
template <bool WSM>
__global__ void __launch_bounds__(NTHREADS, WSM ? 2 : 1)
prop_level_sample_kernel(PropParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.hidden, KIN = p.kin, T = p.T, Q = p.Q;
  const int R = p.rays_per_group, GP = R * T, LDX = prop_ldx(H, KIN);
  const int tid = threadIdx.x, warp = tid >> 5;
  const PropSmem s = prop_layout(smem, H, KIN, T, Q, R, WSM);
  float* ws = s.scratch + warp * 256;
  const bf16* W[3] = {p.w0, p.w1, p.w2};
  int ldw[3] = {KIN, H, H};
  if (WSM) {  // read before the first product, past two barriers
    copy_rows(p.w0, KIN, s.W0, KIN + 8, H, KIN);
    copy_rows(p.w1, H, s.W1, H + 8, H, H);
    copy_rows(p.w2, H, s.W2, H + 8, OUT, H);
    W[0] = s.W0, W[1] = s.W1, W[2] = s.W2;
    ldw[0] = KIN + 8, ldw[1] = H + 8, ldw[2] = H + 8;
  }
  for (int g = blockIdx.x; g < p.n_groups; g += gridDim.x) {
    const int ray0 = g * R;
    for (int p0 = 0; p0 < GP; p0 += PP) {
      build_geometry_freq<PP>(p.rays_o, p.rays_d, p.bins, p.n_rays, T, ray0,
                              GP, p0, p.deg, p.grid_bound, s.xn, s.tt, s.dl,
                              s.X, LDX);
      zero_cols<PP>(s.X, LDX, 3 + 6 * p.deg, KIN);
      __syncthreads();
      prop_layer<WSM>(s.X, LDX, KIN, W[0], ldw[0], H, s.Y, H + 8, nullptr, 0,
                      ws);
      __syncthreads();
      prop_layer<WSM>(s.Y, H + 8, H, W[1], ldw[1], H, s.X, LDX, nullptr, 0,
                      ws);
      __syncthreads();
      prop_layer<WSM>(s.X, LDX, H, W[2], ldw[2], OUT, nullptr, 0, s.F, OUT,
                      ws);
      __syncthreads();
      if (tid < PP && p0 + tid < GP) s.raw[p0 + tid] = s.F[tid * OUT];
      // the next pass writes F again only past two barriers
    }
    __syncthreads();
    for (int r = warp; r < R; r += NWARPS)
      if (ray0 + r < p.n_rays)
        prop_composite_warp(p, ray0 + r, s.raw + r * T, s.cdf + r * (T + 1),
                            s.pmax + r * (T + 1), s.smin + r * (T + 1),
                            s.tot + r);
    if (Q == 0) continue;  // K7: the weights are all it writes
    __syncthreads();
    for (int item = tid; item < R * Q; item += NTHREADS) {
      const int r = item / Q, ray = ray0 + r;
      if (ray >= p.n_rays) continue;
      const float* c = s.cdf + r * (T + 1);
      const float ut = p.u[(size_t)ray * Q + (item - r * Q)] * s.tot[r];
      // c is non-decreasing, so {k : c_k <= ut} is a prefix [0, j]
      const int j = count_le(c, T + 1, ut) - 1;
      float cg0 = -1e38f, sg0 = -1e38f, cg1, sg1;
      if (j >= 0) {
        cg0 = c[j];
        sg0 = s.pmax[r * (T + 1) + j];
      }
      if (j < T) {
        cg1 = c[j + 1];
        sg1 = s.smin[r * (T + 1) + j + 1];
      } else {
        cg1 = c[T];
        sg1 = s.smin[r * (T + 1) + T];
      }
      const float denom = cg1 - cg0;
      float t = denom > 0.0f ? (ut - cg0) / denom : 0.0f;
      t = fminf(fmaxf(t, 0.0f), 1.0f);
      p.out[(size_t)ray * Q + (item - r * Q)] = sg0 + t * (sg1 - sg0);
    }
    // the next group writes the cdf and the totals only past its passes'
    // barriers
  }
}

// The proposal kernel's launch at this shape: the kernel (weights in
// shared memory when two CTAs an SM then fit), its shared memory, the ray
// groups in p and the grid (as many CTAs as the SMs hold at once, at most
// one a group).  Returns 0 or a cudaError_t code.
int prop_launch_shape(PropParams& p, const void*& kernel, size_t& smem,
                      int& grid) {
  if (p.n_rays <= 0 || p.T < 1 || p.Q < 0) return (int)cudaErrorInvalidValue;
  const int H = p.hidden, KIN = p.kin, T = p.T, Q = p.Q;
  int R = T >= PP / NWARPS ? NWARPS : PP / T;
  while (R > 1 && prop_smem(H, KIN, T, Q, R, false) > SMEM_LIMIT) R /= 2;
  p.rays_per_group = R;
  p.n_groups = (p.n_rays + R - 1) / R;
  int per_sm = 0;
  for (int wsm = 1; wsm >= 0; --wsm) {
    kernel = wsm ? (const void*)prop_level_sample_kernel<true>
                 : (const void*)prop_level_sample_kernel<false>;
    smem = prop_smem(H, KIN, T, Q, R, wsm);
    if (smem > SMEM_LIMIT) continue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        NTHREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm >= 2 || !wsm) break;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  grid = per_sm * sm_count();
  grid = grid < p.n_groups ? grid : p.n_groups;
  return 0;
}

}  // namespace

extern "C" {

// K3 (geo null) and K6.  Returns 0 or a cudaError_t code.  Weights are
// bf16 [out, in] padded: w0 [H, KIN], w1 [H, H], w2 [H, H+KIN] (columns
// [act | h_in]), w3 [16, H]; KIN = 3 + 6*deg + rank rounded up to 16, H a
// multiple of 16.  Scratch, P = N*T rows each: xb [P, H+KIN], a1, a3
// [P, H] bf16; f [P, 16], xn [P, 3] fp32.  geo: [N, T, 15] per-sample
// trunk features (K6) or null (K3).  Launches, in order: the inputs, four
// products and the compositing.
int sanerf_final_level(const float* rays_o, const float* rays_d,
                       const float* real_bins, const float* sh,
                       const void* w0, const void* w1, const void* w2,
                       const void* w3, const float* cp_x, const float* cp_y,
                       const float* cp_z, void* xb, void* a1, void* a3,
                       float* f, float* xn, float* f_image, float* depth,
                       float* wsum, float* weights, float* geo, int n_rays,
                       int T, int freq_degree, int cp_rank, int cp_res,
                       int hidden, int kin, float grid_bound, int opaque_last,
                       float density_bias, void* stream) {
  if (n_rays == 0) return 0;
  if (n_rays < 0 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  FinalInput in = {rays_o, rays_d, real_bins, {cp_x, cp_y, cp_z}, (bf16*)xb,
                   xn, n_rays, T, freq_degree, cp_rank, cp_res, hidden, kin,
                   grid_bound};
  int rc = launch_final_input(in, st);
  if (rc) return rc;
  rc = launch_trunk_forward((long long)n_rays * T, hidden, kin,
                            (const bf16*)w0, (const bf16*)w1, (const bf16*)w2,
                            (const bf16*)w3, (bf16*)xb, (bf16*)a1, (bf16*)a3,
                            f, st);
  if (rc) return rc;
  CompositeParams c = {f, real_bins, sh, f_image, depth, wsum, weights, geo,
                       n_rays, T, opaque_last, density_bias};
  return launch_composite(c, st);
}

// K3's first part alone: h_in into xb's columns [H, H+KIN) and xn, as
// sanerf_final_level takes them.
int sanerf_final_inputs(const float* rays_o, const float* rays_d,
                        const float* real_bins, const float* cp_x,
                        const float* cp_y, const float* cp_z, void* xb,
                        float* xn, int n_rays, int T, int freq_degree,
                        int cp_rank, int cp_res, int hidden, int kin,
                        float grid_bound, void* stream) {
  if (n_rays == 0) return 0;
  if (n_rays < 0 || T < 1) return (int)cudaErrorInvalidValue;
  FinalInput in = {rays_o, rays_d, real_bins, {cp_x, cp_y, cp_z}, (bf16*)xb,
                   xn, n_rays, T, freq_degree, cp_rank, cp_res, hidden, kin,
                   grid_bound};
  return launch_final_input(in, (cudaStream_t)stream);
}

// One layer product alone (layer_gemm): y = bf16(relu(x w^T)) (relu) or
// f = x w^T in fp32.  x [points, k] bf16 with row stride ldx, w [n, k]
// bf16 (ldw), y or f [points, n] with row stride ldy; k a multiple of 16,
// n and the strides multiples of 8, every row 16-byte aligned.
int sanerf_layer_product(const void* x, const void* w, void* y, float* f,
                         long long points, long long ldx, int ldw,
                         long long ldy, int k, int n, int relu,
                         void* stream) {
  if (points == 0) return 0;
  if (points < 0 || k < 16 || k % 16 || n < 8 || n % 8 || ldx % 8 ||
      ldw % 8 || ldy % 8)
    return (int)cudaErrorInvalidValue;
  LayerGemm g = {};
  g.points = points;
  g.x = (const bf16*)x; g.ldx = ldx; g.k = k; g.w = (const bf16*)w;
  g.ldw = ldw; g.n = n;
  if (relu) {
    g.y = (bf16*)y; g.ldy = ldy;
    return launch_layer<EPI_RELU>(g, (cudaStream_t)stream);
  }
  g.f = f; g.ldf = (int)ldy;
  return launch_layer<EPI_F32>(g, (cudaStream_t)stream);
}

// K3's compositing alone: f [N*T, 16] (raw density | 15 features) fp32 ->
// f_image [N, 31], depth, wsum [N], weights [N, T], geo [N, T, 15] or
// null.
int sanerf_final_composite(const float* f, const float* real_bins,
                           const float* sh, float* f_image, float* depth,
                           float* wsum, float* weights, float* geo,
                           int n_rays, int T, int opaque_last,
                           float density_bias, void* stream) {
  if (n_rays == 0) return 0;
  if (n_rays < 0 || T < 1) return (int)cudaErrorInvalidValue;
  CompositeParams c = {f, real_bins, sh, f_image, depth, wsum, weights, geo,
                       n_rays, T, opaque_last, density_bias};
  return launch_composite(c, (cudaStream_t)stream);
}

// The proposal kernel's grid and ray groups at this shape, into *grid and
// *groups: a CTA walks more than one group when groups > grid.  Returns 0
// or a cudaError_t code.
int sanerf_prop_level_sample_shape(int n_rays, int T, int Q, int hidden,
                                   int kin, int* grid, int* groups) {
  PropParams p = {};
  p.n_rays = n_rays; p.T = T; p.Q = Q; p.hidden = hidden; p.kin = kin;
  const void* kernel;
  size_t smem;
  const int rc = prop_launch_shape(p, kernel, smem, *grid);
  *groups = p.n_groups;
  return rc;
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
  if (n_rays == 0) return 0;
  PropParams p;
  p.rays_o = rays_o; p.rays_d = rays_d; p.bins = real_bins;
  p.s_bins = s_bins; p.u = u;
  p.w0 = (const bf16*)w0; p.w1 = (const bf16*)w1; p.w2 = (const bf16*)w2;
  p.out = out; p.weights = weights;
  p.n_rays = n_rays; p.T = T; p.Q = Q; p.deg = freq_degree;
  p.hidden = hidden; p.kin = kin;
  p.opaque_last = opaque_last; p.grid_bound = grid_bound;
  p.db = density_bias;
  const void* kernel;
  size_t smem;
  int grid;
  const int rc = prop_launch_shape(p, kernel, smem, grid);
  if (rc) return rc;
  return launch_checked(kernel, grid, smem, (cudaStream_t)stream, &p);
}

const char* sanerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
