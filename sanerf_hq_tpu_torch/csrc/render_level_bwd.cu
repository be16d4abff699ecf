// Backward render-level kernels for NVIDIA Hopper (sm_90a): the weight
// gradients of the proposal level (K2) and of the final level with its CP
// line features (K4).  Bound to Python through ctypes
// (sanerf_hq_tpu_torch/ops/render_level.py); plain C interface, no PyTorch
// headers.  Shared device code: render_level_common.cuh, and
// render_level_gemm.cuh (the input kernel, the wgmma layer products and the
// trunk's forward, which K3 in render_level.cu launches too).
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
// Design.  The TPU kernels sum dW in VMEM over a sequential grid; Hopper
// runs its CTAs in parallel, and the first port gave each CTA an fp32 dW
// slab in device memory that every 64- or 128-point pass read and wrote
// back.  At the flagship shapes on an NVIDIA H100 80GB HBM3 at 700 W
// (phase split by ablation, PERF.md) that slab cost K4 5.5 of its
// 10.7 ms, its forward and dA products (B fragments from L1/L2, one 8-warp
// CTA an SM) 4.7 ms, and K2's compositing, a thread a ray, 1.2 of its
// 3.1 ms at T = 128.
//   K4 takes dW off the per-pass path.  (a) final_level_bwd_stash: kernels
//   over all N*T points at once that write the bf16 operands of the four
//   weight products (each layer's input, h_in once, and each masked grad
//   d) to a stash in device memory, 3.4 KB a point at flagship width:
//   final_input_kernel (geometry, freq and CP features), four forward
//   products and four dA products in layer_gemm (128 x 128 tiles, a
//   three-stage cp.async ring of 64-wide k steps into 128-byte-swizzled
//   tiles, wgmma, two CTAs an SM; epilogues relu, fp32, or relu mask with
//   the CP columns' sums), final_composite_kernel (a warp a ray, shuffle
//   scans), and the CP basis grads (final_cp_partial_kernel: a slab of
//   shared memory a chunk of points and an axis, a thread a rank column,
//   the points added in order; final_cp_reduce_kernel: the chunks summed
//   in chunk order; the same bits on every run).  Not one kernel fused
//   over ray groups: its activations and streamed weights take 200 KB of
//   shared memory, one 8-warp CTA an SM that cannot hide its loads, and
//   measured it was slower than these GEMMs.  (b) weight_grad_gemm:
//   dW_l = d_l^T x_l over all points, 128 x 128 output tiles in registers
//   across a split-K range of points, the operands read as they lie in the
//   stash (M- and N-major wgmma operands) through a three-stage ring of
//   64-point steps; a fixed number of splits (one wave) and a reduction in
//   split order keep the weight grads the same bits on every run.  What
//   bounds K4: the stash's traffic and the products (3.7e5 MAC a sample in
//   (a), 2.0e5 in (b)); PERF.md has each part's time beside its bound.
//   K2 keeps dW on chip: at widths whose dW fits 4 accumulator tiles a warp
//   (H = 64, KIN = 48: 32 tiles of 16 x 16), each warp sums its tiles in
//   registers over all its CTA's passes and the CTA writes its slab once;
//   the weights sit in shared memory for the CTA's life, the compositing
//   runs a warp per ray, and about 105 KB of shared memory lets two CTAs
//   share an SM.  Wider layers keep the slab in device memory, read and
//   written every pass, with weights from L1/L2 (one CTA an SM).  A second
//   kernel sums the slabs in CTA order.  What bounds K2: the latency of
//   each 128-point group's chain of small steps (1.7e4 MAC a sample is
//   little tensor work).
#include "render_level_gemm.cuh"

using namespace sanerf;

namespace {

// dW [m x n] (fp32, row-major with ld ldw, in device memory) += D^T X over
// the pass's PP points.  D: [PP, m] bf16 (ldd), X: [PP, n] bf16 (ldx), both
// in shared memory.  With first set, the old contents are not read.  (K2
// at widths whose dW does not fit on chip.)
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

// O [PP x n] = bf16(M > 0 ? D W : 0): D [PP x k] bf16 in shared memory
// (ldd), W the layer's bf16 [out, in] weights [k x n] in device or shared
// memory (ldw, row-major B), masked by the layer's input M (ldm): the next
// layer's grad d.  A warp holds at most MAXM row tiles' sums at once.  (K2.)
template <int PP, int MAXM = PP / 16>
__device__ void backprop_da(const bf16* D, int ldd, int k, const bf16* W,
                            int ldw, const bf16* M, int ldm, bf16* O, int ldo,
                            int n, float* scratch) {
  constexpr int MT = PP / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = n / 16;
  int wpn = 1;  // warps sharing one column tile (power of two dividing MT)
  while (wpn * 2 * ntiles <= NWARPS && wpn * 2 <= MT) wpn *= 2;
  while (MT / wpn > MAXM) wpn *= 2;
  const int mper = MT / wpn;
  for (int u = warp; u < ntiles * wpn; u += NWARPS) {
    const int nt = u / wpn, m0 = (u % wpn) * mper;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXM];
#pragma unroll
    for (int i = 0; i < MAXM; ++i)
      if (i < mper) wmma::fill_fragment(acc[i], 0.0f);
    for (int kt = 0; kt < k; kt += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, W + (size_t)kt * ldw + nt * 16, ldw);
#pragma unroll
      for (int i = 0; i < MAXM; ++i) {
        if (i < mper) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, D + (m0 + i) * 16 * ldd + kt, ldd);
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
          const bool on = __bfloat162float(M[r * ldm + c]) > 0.0f;
          O[r * ldo + c] = __float2bfloat16(on ? scratch[e] : 0.0f);
        }
        __syncwarp();
      }
    }
  }
}

// One warp per ray: the transmittance forward (a product scan) and the
// reverse suffix sum (a sum scan) over the ray's T samples, sample s in
// lane s % 32 of round s / 32, the rounds carried in order.  bins and g_w
// are read once, coalesced.  raw [T] (shared) holds the raw densities and
// leaves with the density grads; G [T] leaves with G_s: with gc (K4) it
// comes in holding g_f[:15] . h[1:] and is completed with the ray's
// (g_f[15:] . sh, g_depth, g_wsum) and g_w; without (K2) G_s = g_w[s].
// Tn, w, dt [T] are shared scratch.  Every lane of the warp calls it.
__device__ void composite_bwd_warp(const float* bins, const float* g_w,
                                   int ray, int T, int opaque_last, float db,
                                   const float* gc, float* raw, float* G,
                                   float* Tn, float* w, float* dt) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const float* b = bins + (size_t)ray * (T + 1);
  const float* gw = g_w + (size_t)ray * T;
  float carry = 1.0f;  // transmittance before the round
  for (int s0 = 0; s0 < T; s0 += 32) {
    const int s = s0 + lane;
    float e = 1.0f;
    if (s < T) {
      const float b0 = b[s], b1 = b[s + 1];
      const float sigma = expf(fminf(fmaxf(raw[s] + db, -30.0f), 15.0f));
      e = (opaque_last && s == T - 1) ? 0.0f : expf(-(b1 - b0) * sigma);
      dt[s] = b1 - b0;
      G[s] = gc ? G[s] + gc[0] + gc[1] * ((b0 + b1) * 0.5f) + gc[2] + gw[s]
                : gw[s];
    }
    float inc = e;  // product over the round's lanes up to this one
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(full, inc, o);
      if (lane >= o) inc *= v;
    }
    const float prev = __shfl_up_sync(full, inc, 1);
    const float before = carry * (lane == 0 ? 1.0f : prev);
    if (s < T) {
      w[s] = (1.0f - e) * before;
      Tn[s] = before * e;
    }
    carry = carry * __shfl_sync(full, inc, 31);
  }
  __syncwarp();
  float S = 0.0f;  // sum of G_j w_j over the later rounds
  for (int s0 = (T - 1) / 32 * 32; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    const float gs = s < T ? G[s] : 0.0f;
    const float v = s < T ? gs * w[s] : 0.0f;
    float inc = v;  // sum over this lane and the later ones of the round
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(full, inc, o);
      if (lane + o < 32) inc += u;
    }
    const float next = __shfl_down_sync(full, inc, 1);
    const float after = S + (lane == 31 ? 0.0f : next);
    if (s < T) {
      const float d_ds = gs * Tn[s] - after;
      const float x = raw[s] + db;
      float dr = 0.0f;
      if (!(opaque_last && s == T - 1) && x > -30.0f && x < 15.0f)
        dr = d_ds * dt[s] * expf(x);
      raw[s] = dr;
    }
    S = S + __shfl_sync(full, inc, 0);
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

// dW tiles a warp keeps in registers when K2's dW is on chip.
constexpr int PROP_TILES_W = 4;

// 16 x 16 tiles of K2's dW, the on-chip test.
__host__ __device__ inline int prop_dw_tiles(int H, int KIN) {
  return (H / 16) * (KIN / 16) + (H / 16) * (H / 16) + H / 16;
}

struct PropSmem {
  bf16 *X0, *X1, *X2, *DA, *D2, *W0, *W1, *W2;
  float *F, *scratch, *xn, *tt, *dl, *raw, *G, *Tn, *w, *dt;
};

// X2 also holds the layer-0 grad once layer 2's products are done; F
// spans DA and D2 (the forward's output is read before either is
// written).  W0..W2 hold the weights for the CTA's life when wsm.
__device__ PropSmem prop_smem_layout(unsigned char* smem, int PP, int H,
                                     int KIN, int GP, bool wsm) {
  PropSmem s;
  s.X0 = reinterpret_cast<bf16*>(smem);  // [PP, KIN+8] layer-0 input
  s.X1 = s.X0 + PP * (KIN + 8);          // [PP, H+8] layer-1 input
  s.X2 = s.X1 + PP * (H + 8);            // [PP, H+8] layer-2 input
  s.DA = s.X2 + PP * (H + 8);            // [PP, H+8] layer-1 grad
  s.D2 = s.DA + PP * (H + 8);            // [PP, OUT+8] last layer's grad
  s.W0 = s.D2 + PP * (OUT + 8);          // [H, KIN+8]
  s.W1 = s.W0 + (wsm ? H * (KIN + 8) : 0);   // [H, H+8]
  s.W2 = s.W1 + (wsm ? H * (H + 8) : 0);     // [16, H+8]
  s.F = reinterpret_cast<float*>(s.DA);      // [PP, OUT]
  float* f = reinterpret_cast<float*>(s.W2 + (wsm ? OUT * (H + 8) : 0));
  s.scratch = f;
  s.xn = s.scratch + NWARPS * 256;
  s.tt = s.xn + PP * 3;
  s.dl = s.tt + PP;
  s.raw = s.dl + PP;  // [GP] per-sample scalars of the ray group
  s.G = s.raw + GP;
  s.Tn = s.G + GP;
  s.w = s.Tn + GP;
  s.dt = s.w + GP;
  return s;
}

size_t prop_bwd_smem(int PP, int H, int KIN, int GP, bool wsm) {
  size_t b = (size_t)PP * (KIN + 8 + 3 * (H + 8) + OUT + 8) * 2;
  if (wsm) b += (size_t)(H * (KIN + 8) + H * (H + 8) + OUT * (H + 8)) * 2;
  return b + (size_t)(NWARPS * 256 + PP * 5 + 5 * GP) * 4;
}

template <int PP, int MAXM>
__device__ void prop_forward(const PropBwdParams& p, const PropSmem& s,
                             const bf16* const* W, const int* ldw, int ray0,
                             int GP, int p0) {
  const int H = p.hidden, KIN = p.kin;
  float* ws = s.scratch + (threadIdx.x >> 5) * 256;
  build_geometry_freq<PP>(p.rays_o, p.rays_d, p.bins, p.n_rays, p.T, ray0,
                          GP, p0, p.deg, p.grid_bound, s.xn, s.tt, s.dl, s.X0,
                          KIN + 8);
  zero_cols<PP>(s.X0, KIN + 8, 3 + 6 * p.deg, KIN);
  __syncthreads();
  dense_ld<PP, MAXM>(s.X0, KIN + 8, KIN, W[0], ldw[0], H, s.X1, H + 8,
                     nullptr, 0, ws);
  __syncthreads();
  dense_ld<PP, MAXM>(s.X1, H + 8, H, W[1], ldw[1], H, s.X2, H + 8, nullptr,
                     0, ws);
  __syncthreads();
  dense_ld<PP, MAXM>(s.X2, H + 8, H, W[2], ldw[2], OUT, nullptr, 0, s.F, OUT,
                     ws);
  __syncthreads();
}

// Layer, row tile and column tile of dW tile u (slab order, 16 x 16
// tiles); false past the last.
__device__ __forceinline__ bool prop_tile(int u, int H, int KIN, int& layer,
                                          int& mt, int& nt) {
  const int h = H / 16, k = KIN / 16;
  if (u < h * k) {
    layer = 0, mt = u / k, nt = u - mt * k;
  } else if (u < h * k + h * h) {
    u -= h * k;
    layer = 1, mt = u / h, nt = u - mt * h;
  } else if (u < h * k + h * h + h) {
    layer = 2, mt = 0, nt = u - h * k - h * h;
  } else {
    return false;
  }
  return true;
}

// This warp's on-chip dW tiles of layer L += D^T X over the pass (tile
// u = warp + NWARPS * j holds slab tile u).
template <int PP>
__device__ void accum_tiles(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, int L,
    const bf16* D, int ldd, const bf16* X, int ldx, int H, int KIN) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < PROP_TILES_W; ++j) {
    int layer, mt, nt;
    if (!prop_tile(warp + NWARPS * j, H, KIN, layer, mt, nt) || layer != L)
      continue;
#pragma unroll
    for (int kt = 0; kt < PP; kt += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, D + kt * ldd + mt * 16, ldd);
      wmma::load_matrix_sync(b, X + kt * ldx + nt * 16, ldx);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
}

// ONCHIP: dW in registers over the CTA's passes, weights in shared memory,
// two CTAs an SM.  Else: the slab read and written every pass.
template <int PP, bool ONCHIP>
__global__ void __launch_bounds__(NTHREADS, ONCHIP ? 2 : 1)
prop_level_bwd_kernel(PropBwdParams p) {
  constexpr int MAXM = ONCHIP ? 4 : PP / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.hidden, KIN = p.kin, T = p.T, R = p.rays_per_group;
  const int GP = R * T, npass = (GP + PP - 1) / PP, tid = threadIdx.x;
  const int warp = tid >> 5;
  const PropSmem s = prop_smem_layout(smem, PP, H, KIN, GP, ONCHIP);
  float* ws = s.scratch + warp * 256;
  float* dW0 = p.dw_part + (size_t)blockIdx.x * ((size_t)H * KIN +
                                                 (size_t)H * H + OUT * H);
  float* dW1 = dW0 + (size_t)H * KIN;
  float* dW2 = dW1 + (size_t)H * H;
  const bf16* W[3] = {p.w0, p.w1, p.w2};
  int ldw[3] = {KIN, H, H};
  if (ONCHIP) {
    copy_rows(p.w0, KIN, s.W0, KIN + 8, H, KIN);
    copy_rows(p.w1, H, s.W1, H + 8, H, H);
    copy_rows(p.w2, H, s.W2, H + 8, OUT, H);
    W[0] = s.W0, W[1] = s.W1, W[2] = s.W2;
    ldw[0] = KIN + 8, ldw[1] = H + 8, ldw[2] = H + 8;
    __syncthreads();
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PROP_TILES_W];
#pragma unroll
  for (int j = 0; j < PROP_TILES_W; ++j) wmma::fill_fragment(acc[j], 0.0f);
  bool first = true;
  for (int g = blockIdx.x; g < p.n_groups; g += gridDim.x) {
    const int ray0 = g * R;
    for (int pass = 0; pass < npass; ++pass) {
      const int p0 = pass * PP;
      prop_forward<PP, MAXM>(p, s, W, ldw, ray0, GP, p0);
      if (tid < PP && p0 + tid < GP) s.raw[p0 + tid] = s.F[tid * OUT];
      __syncthreads();
    }
    for (int r = warp; r < R; r += NWARPS)
      if (ray0 + r < p.n_rays)
        composite_bwd_warp(p.bins, p.g_w, ray0 + r, T, p.opaque_last, p.db,
                           nullptr, s.raw + r * T, s.G + r * T, s.Tn + r * T,
                           s.w + r * T, s.dt + r * T);
    __syncthreads();
    for (int pass = 0; pass < npass; ++pass) {
      const int p0 = pass * PP;
      if (npass > 1) prop_forward<PP, MAXM>(p, s, W, ldw, ray0, GP, p0);
      for (int item = tid; item < PP * OUT; item += NTHREADS) {
        const int q = item / OUT, c = item - q * OUT, gp = p0 + q;
        const bool ok = c == 0 && gp < GP && ray0 + gp / T < p.n_rays;
        s.D2[q * (OUT + 8) + c] = __float2bfloat16(ok ? s.raw[gp] : 0.0f);
      }
      __syncthreads();
      if (ONCHIP) accum_tiles<PP>(acc, 2, s.D2, OUT + 8, s.X2, H + 8, H, KIN);
      else accum_dw<PP>(s.D2, OUT + 8, OUT, s.X2, H + 8, H, dW2, H, first);
      backprop_da<PP, MAXM>(s.D2, OUT + 8, OUT, W[2], ldw[2], s.X2, H + 8,
                            s.DA, H + 8, H, ws);
      __syncthreads();
      if (ONCHIP) accum_tiles<PP>(acc, 1, s.DA, H + 8, s.X1, H + 8, H, KIN);
      else accum_dw<PP>(s.DA, H + 8, H, s.X1, H + 8, H, dW1, H, first);
      backprop_da<PP, MAXM>(s.DA, H + 8, H, W[1], ldw[1], s.X1, H + 8, s.X2,
                            H + 8, H, ws);
      __syncthreads();
      if (ONCHIP) accum_tiles<PP>(acc, 0, s.X2, H + 8, s.X0, KIN + 8, H, KIN);
      else accum_dw<PP>(s.X2, H + 8, H, s.X0, KIN + 8, KIN, dW0, KIN, first);
      __syncthreads();
      first = false;
    }
  }
  if (ONCHIP) {
#pragma unroll
    for (int j = 0; j < PROP_TILES_W; ++j) {
      int layer, mt, nt;
      if (!prop_tile(warp + NWARPS * j, H, KIN, layer, mt, nt)) continue;
      float* base = layer == 0 ? dW0 : layer == 1 ? dW1 : dW2;
      const int ld = layer == 0 ? KIN : H;
      wmma::store_matrix_sync(base + (size_t)mt * 16 * ld + nt * 16, acc[j],
                              ld, wmma::mem_row_major);
    }
  }
}

// ---------------------------------------------------------------------------
// K4 (a): final trunk (4 bias-free layers, skip at layer 2, freq + CP input)
// forward recompute, compositing backward, dA chain and CP basis grads,
// over all points at once; every product's bf16 operands land in the stash
// ---------------------------------------------------------------------------

struct FinalBwdParams {
  const float *rays_o, *rays_d, *bins, *sh;
  const bf16 *w0, *w1, *w2, *w3;
  const bf16 *w0t, *w1t, *w2t, *w3t;  // their transposes, for the dA chain
  const float* cp[3];
  const float *g_f, *g_depth, *g_wsum, *g_w;
  // the stash, one row a point: [A2 | h_in] (H+KIN), A1, A3 (H), d3 (16),
  // d2, d1, d0 (H)
  bf16 *xb, *a1, *a3, *d3, *d2, *d1, *d0;
  // scratch: the last layer's output F [P, 16], the contracted positions
  // xn [P, 3] and the CP features' grad E [P, rank], fp32
  float *f, *xn, *e;
  float* dcp[3];  // [res, rank] each, written by final_cp_reduce_kernel
  float* cp_part;  // [chunks, 3, res, rank]: the chunks' CP grads
  int n_rays, T, deg, rank, res, hidden, kin, opaque_last, cp_chunks;
  float grid_bound, db;
};

// A warp per ray: raw density and g_f[:15] . h[1:] of every sample from F,
// the compositing backward, and the ray's rows of d3 = bf16([density grad |
// w g_f[:15]]).  Shared memory: 5 T floats a warp.
__global__ void __launch_bounds__(NTHREADS)
final_composite_kernel(FinalBwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = p.T, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * NWARPS + warp;
  if (ray >= p.n_rays) return;  // the whole warp; no CTA barrier follows
  float* raw = reinterpret_cast<float*>(smem) + (size_t)warp * 5 * T;
  float *G = raw + T, *Tn = G + T, *w = Tn + T, *dt = w + T;
  const float* gf = p.g_f + (size_t)ray * (GEO + SHD);
  float gc[3] = {0.0f, p.g_depth[ray], p.g_wsum[ray]};
  for (int c = 0; c < SHD; ++c)
    gc[0] += gf[GEO + c] * p.sh[(size_t)ray * SHD + c];
  for (int s = lane; s < T; s += 32) {
    const float* F = p.f + ((size_t)ray * T + s) * OUT;
    float dot = 0.0f;
    for (int c = 0; c < GEO; ++c) dot += gf[c] * F[1 + c];
    raw[s] = F[0];
    G[s] = dot;
  }
  __syncwarp();
  composite_bwd_warp(p.bins, p.g_w, ray, T, p.opaque_last, p.db, gc, raw, G,
                     Tn, w, dt);
  __syncwarp();
  bf16* d3 = p.d3 + (size_t)ray * T * OUT;
  for (int item = lane; item < T * OUT; item += 32) {
    const int s = item / OUT, c = item - s * OUT;
    d3[item] = __float2bfloat16(c == 0 ? raw[s] : w[s] * gf[c - 1]);
  }
}

// CP basis grads: the product rule through extra = L_x L_y L_z, each
// point's grad split between the two taps of each axis, summed in a fixed
// order.  CTA (c, a, g) takes axis a, ranks [CP_COLS g, CP_COLS g +
// CP_COLS) and the CP_CHUNK consecutive points of chunk c: thread t owns
// column t of a [res, CP_COLS] slab in shared memory and adds the points
// into it in point order (CP_RUN at a time, their inputs loaded first),
// then writes the slab to cp_part[c][a].  final_cp_reduce_kernel sums the
// chunks' slabs in chunk order.  No atomics, so the CP grads are the same
// bits on every run.
constexpr int CP_RUN = 8, CP_CHUNK = 1024, CP_COLS = 64;

// One axis of cp_taps (render_level_common.cuh), the same arithmetic.
__device__ __forceinline__ void cp_tap(const float* xn, int res, int a,
                                       int& i0, float& f) {
  const float pp =
      fminf(fmaxf((xn[a] + 1.0f) * 0.5f, 0.0f), 1.0f) * (float)(res - 1);
  const float fl = fminf(fmaxf(floorf(pp), 0.0f), (float)(res - 2));
  i0 = (int)fl;
  f = pp - fl;
}

__global__ void __launch_bounds__(CP_COLS)
final_cp_partial_kernel(FinalBwdParams p) {
  extern __shared__ __align__(16) float slab[];  // [res][CP_COLS]
  const int a = blockIdx.y, t = threadIdx.x, rank = p.rank, res = p.res;
  const int r = blockIdx.z * CP_COLS + t;
  const int b = a == 0 ? 1 : 0, c = a == 2 ? 1 : 2;
  const long long P = (long long)p.n_rays * p.T;
  const long long q0 = (long long)blockIdx.x * CP_CHUNK;
  const long long q1 = q0 + CP_CHUNK < P ? q0 + CP_CHUNK : P;
  float* col = slab + t;
  for (int j = 0; j < res; ++j) col[j * CP_COLS] = 0.0f;
  if (r >= rank) return;  // this thread's column is never read
  for (long long q = q0; q < q1; q += CP_RUN) {
    const int n = (int)(q1 - q < CP_RUN ? q1 - q : CP_RUN);
    int ia[CP_RUN];
    float fa[CP_RUN], dl[CP_RUN];
#pragma unroll
    for (int k = 0; k < CP_RUN; ++k) {
      ia[k] = 0;
      fa[k] = dl[k] = 0.0f;
      if (k < n) {
        const float* xn = p.xn + (q + k) * 3;
        int ib, ic;
        float fb, fc;
        cp_tap(xn, res, a, ia[k], fa[k]);
        cp_tap(xn, res, b, ib, fb);
        cp_tap(xn, res, c, ic, fc);
        dl[k] = p.e[(q + k) * rank + r] * cp_line(p.cp[b], rank, ib, fb, r) *
                cp_line(p.cp[c], rank, ic, fc, r);
      }
    }
#pragma unroll
    for (int k = 0; k < CP_RUN; ++k) {
      if (k < n) {
        col[ia[k] * CP_COLS] += dl[k] * (1.0f - fa[k]);
        col[(ia[k] + 1) * CP_COLS] += dl[k] * fa[k];
      }
    }
  }
  float* out = p.cp_part + ((long long)blockIdx.x * 3 + a) * res * rank;
  for (int j = 0; j < res; ++j) out[(size_t)j * rank + r] = col[j * CP_COLS];
}

// dcp[a][j][r] = the sum over the chunks, in chunk order, of cp_part.
__global__ void __launch_bounds__(NTHREADS)
final_cp_reduce_kernel(FinalBwdParams p) {
  const long long per_axis = (long long)p.res * p.rank;
  const long long i = blockIdx.x * (long long)NTHREADS + threadIdx.x;
  if (i >= 3 * per_axis) return;
  const int a = (int)(i / per_axis);
  const long long j = i - a * per_axis;
  const float* src = p.cp_part + a * per_axis + j;
  float s = 0.0f;
  for (int c = 0; c < p.cp_chunks; ++c) s += src[(long long)c * 3 * per_axis];
  p.dcp[a][j] = s;
}

// ---------------------------------------------------------------------------
// K4 (b): the weight-grad GEMM, dW_l = d_l^T x_l over the stash's points
// ---------------------------------------------------------------------------

constexpr int GM = 128, GN = 128, GK = 64, GSTAGES = 3;
constexpr int GTILE = GK * GM;  // elements of one operand's stage (GM == GN)
constexpr int GEMM_MAX_PRODUCTS = 4;

struct GemmProduct {
  const bf16 *d, *x;  // [points, m] (ldd), [points, n] (ldx)
  long long ldd, ldx, out;  // out: offset of dW [m, n] in the slab
  int m, n, tiles_n, tile0;
};

struct GemmParams {
  GemmProduct prod[GEMM_MAX_PRODUCTS];
  int n_prod, n_tiles;
  long long points, chunk, slab;
  float* part;  // [splits, slab]
};

size_t gemm_smem() { return (size_t)GSTAGES * 2 * GTILE * 2 + 1024; }

// CTA b computes output tile b % n_tiles over split b / n_tiles of the
// points: d^T x, both operands as they lie in the stash (M- and N-major),
// each stage two 64-column blocks of GK points; warpgroup w takes rows
// 64 w .. 64 w + 63 of the 128 x 128 tile.
__global__ void __launch_bounds__(NTHREADS, 2)
weight_grad_gemm(const GemmParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(align1024(smem_raw));  // d, [GSTAGES]
  bf16* Bs = As + GSTAGES * GTILE;                           // x, [GSTAGES]
  const int tile = blockIdx.x % p.n_tiles, split = blockIdx.x / p.n_tiles;
  int pi = 0;
  while (pi + 1 < p.n_prod && tile >= p.prod[pi + 1].tile0) ++pi;
  const GemmProduct g = p.prod[pi];
  const int t = tile - g.tile0;
  const int m0 = (t / g.tiles_n) * GM, n0 = (t % g.tiles_n) * GN;
  const long long k0 = (long long)split * p.chunk;
  const long long k1 = min(p.points, k0 + p.chunk);
  const int nk = k1 > k0 ? (int)((k1 - k0 + GK - 1) / GK) : 0;
  const int tid = threadIdx.x, wg = tid >> 7;
  // this thread's 16-byte pieces of a stage: piece pc (of 16 across the
  // 128 columns) of points tid / 16 + 16 i of the d and x tiles
  constexpr int PIECES = GK * (GM / 8) / NTHREADS;
  static_assert(GM == GN && GM == 128 && PIECES * NTHREADS == GK * 16,
                "loader layout");
  const int pc = tid & 15, prow = tid >> 4;
  const bool dok = m0 + pc * 8 < g.m, xok = n0 + pc * 8 < g.n;
  const bf16* dsrc = g.d + (dok ? m0 + pc * 8 : 0);
  const bf16* xsrc = g.x + (xok ? n0 + pc * 8 : 0);
  const int block = (pc >> 3) * (GK * 64);  // the piece's 64-column block
  auto load = [&](int kt) {
    const int st = kt % GSTAGES;
    const long long kb = k0 + (long long)kt * GK;
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int row = prow + i * (NTHREADS / 16);
      const long long pt = kb + row;
      const bool ok = pt < k1;
      const int off = st * GTILE + block + sw128(row, pc & 7);
      cp_async16(As + off, dsrc + (ok && dok ? pt * g.ldd : 0), ok && dok);
      cp_async16(Bs + off, xsrc + (ok && xok ? pt * g.ldx : 0), ok && xok);
    }
  };
  const bool on = m0 + wg * 64 < g.m;  // this warpgroup's 64 rows
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int st = 0; st < GSTAGES - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GSTAGES - 2>();
    fence_async_shared();
    __syncthreads();  // stage kt arrived; every product of stage kt - 1 done
    if (kt + GSTAGES - 1 < nk) load(kt + GSTAGES - 1);
    cp_async_commit();
    if (on) {
      const bf16* a = As + (kt % GSTAGES) * GTILE + wg * GK * 64;
      const bf16* b = Bs + (kt % GSTAGES) * GTILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GK / 16; ++kk)  // 16 points: two 8-row atoms
        wgmma_m64n128k16<1, 1>(acc,
                               sw128_desc(a + kk * 16 * 64, GK * 128, 1024),
                               sw128_desc(b + kk * 16 * 64, GK * 128, 1024));
      wgmma_commit();
      wgmma_wait_all(acc);
    }
  }
  cp_async_wait<0>();
  if (!on) return;
  float* out = p.part + split * p.slab + g.out;
  const int r = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + j * 8 + (tid & 3) * 2;
    if (c >= g.n) continue;
    if (r < g.m)
      *reinterpret_cast<float2*>(out + (size_t)r * g.n + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < g.m)
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * g.n + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Pass size of K2: 128 points when the kernel's shared memory fits, else
// 64.
int prop_pick_pass(int T, int H, int KIN, bool wsm, int& R, size_t& smem) {
  for (int pp = 128; pp >= 64; pp -= 64) {
    R = T >= pp ? 1 : pp / T;
    smem = prop_bwd_smem(pp, H, KIN, R * T, wsm);
    if (smem <= SMEM_LIMIT) return pp;
  }
  return 0;
}

// K2's launch: the kernel, its shared memory and grid (a slab a CTA: as
// many CTAs as the SMs hold at once, at most one a ray group), and the
// ray groups in p.  Returns 0 or a cudaError_t code.
int prop_launch_shape(PropBwdParams& p, const void*& kernel, size_t& smem,
                      int& grid) {
  if (p.n_rays <= 0 || p.T < 1) return (int)cudaErrorInvalidValue;
  const bool onchip = prop_dw_tiles(p.hidden, p.kin) <= NWARPS * PROP_TILES_W;
  const int pp = prop_pick_pass(p.T, p.hidden, p.kin, onchip,
                                p.rays_per_group, smem);
  if (!pp) return (int)cudaErrorInvalidValue;
  p.n_groups = (p.n_rays + p.rays_per_group - 1) / p.rays_per_group;
  kernel =
      onchip ? (pp == 128 ? (const void*)prop_level_bwd_kernel<128, true>
                          : (const void*)prop_level_bwd_kernel<64, true>)
             : (pp == 128 ? (const void*)prop_level_bwd_kernel<128, false>
                          : (const void*)prop_level_bwd_kernel<64, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      NTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  grid = (per_sm < 1 ? 1 : per_sm) * sm_count();
  grid = grid < p.n_groups ? grid : p.n_groups;
  return 0;
}

}  // namespace

extern "C" {

// K2: the number of slabs (CTAs) sanerf_prop_level_bwd writes at this
// shape, into *n_part.  Returns 0 or a cudaError_t code.
int sanerf_prop_level_bwd_slabs(int n_rays, int T, int hidden, int kin,
                                int* n_part) {
  PropBwdParams p = {};
  p.n_rays = n_rays; p.T = T; p.hidden = hidden; p.kin = kin;
  const void* kernel;
  size_t smem;
  return prop_launch_shape(p, kernel, smem, *n_part);
}

// K2, its first kernel.  Returns 0 or a cudaError_t code.  Weights bf16
// [out, in] padded as K5 takes them: w0 [H, KIN], w1 [H, H], w2 [16, H]
// (row 0 the density head).  g_w [N, T] is dL/dweights.  dw_part holds
// n_part slabs of H*KIN + H*H + 16*H floats (dW0 | dW1 | dW2), n_part as
// sanerf_prop_level_bwd_slabs gives it: one a CTA, whose sum in CTA order
// (sanerf_reduce_partials) is the weights' grads.
int sanerf_prop_level_bwd(const float* rays_o, const float* rays_d,
                          const float* real_bins, const void* w0,
                          const void* w1, const void* w2, const float* g_w,
                          float* dw_part, int n_part, int n_rays, int T,
                          int freq_degree, int hidden, int kin,
                          float grid_bound, int opaque_last,
                          float density_bias, void* stream) {
  PropBwdParams p;
  p.rays_o = rays_o; p.rays_d = rays_d; p.bins = real_bins;
  p.w0 = (const bf16*)w0; p.w1 = (const bf16*)w1; p.w2 = (const bf16*)w2;
  p.g_w = g_w; p.dw_part = dw_part;
  p.n_rays = n_rays; p.T = T; p.deg = freq_degree; p.hidden = hidden;
  p.kin = kin; p.opaque_last = opaque_last; p.grid_bound = grid_bound;
  p.db = density_bias;
  const void* kernel;
  size_t smem;
  int grid;
  const int rc = prop_launch_shape(p, kernel, smem, grid);
  if (rc) return rc;
  if (grid != n_part) return (int)cudaErrorInvalidValue;
  return launch_checked(kernel, grid, smem, (cudaStream_t)stream, &p);
}

// out [slab] = the sum of part [n_part, slab] over its rows, in row order.
int sanerf_reduce_partials(const float* part, float* out, int n_part,
                           int slab, void* stream) {
  if (n_part < 1 || slab < 1) return (int)cudaErrorInvalidValue;
  return launch_reduce(part, n_part, slab, out, (cudaStream_t)stream);
}

// K4 (a).  Returns 0 or a cudaError_t code.  Weights bf16 [out, in] padded
// as K3 takes them: w0 [H, KIN], w1 [H, H], w2 [H, H+KIN], w3 [16, H],
// and their transposes w0t [KIN, H], w1t, w2t [H+KIN, H], w3t [H, 16].
// g_f [N, 31], g_depth, g_wsum [N], g_w [N, T] are the grads of K3's
// outputs.  The stash, P = N*T rows each, bf16: xb [A2 | h_in] (H+KIN),
// a1, a3 (H), d3 (16), d2, d1, d0 (H); the weight grads are dW0 = d0^T
// xb[:, H:], dW1 = d1^T a1, dW2 = d2^T xb, dW3 = d3^T a3.  Scratch, fp32:
// f [P, 16], xn [P, 3], e [P, rank] and cp_part [ceil(P / CP_CHUNK), 3,
// cp_res, rank] (null when rank is 0).  dcp_* [res, rank] (null when rank
// is 0) are written whole.  Launches, in order: the inputs, four forward
// products, the compositing, three or four dA products, and the CP grads'
// partial and reduce kernels.
int sanerf_final_level_bwd(const float* rays_o, const float* rays_d,
                           const float* real_bins, const float* sh,
                           const void* w0, const void* w1, const void* w2,
                           const void* w3, const void* w0t, const void* w1t,
                           const void* w2t, const void* w3t,
                           const float* cp_x, const float* cp_y,
                           const float* cp_z, const float* g_f,
                           const float* g_depth, const float* g_wsum,
                           const float* g_w, void* xb, void* a1, void* a3,
                           void* d3, void* d2, void* d1, void* d0, float* f,
                           float* xn, float* e,
                           float* dcp_x, float* dcp_y, float* dcp_z,
                           float* cp_part, int n_rays, int T, int freq_degree, int cp_rank,
                           int cp_res, int hidden, int kin, float grid_bound,
                           int opaque_last, float density_bias,
                           void* stream) {
  FinalBwdParams p;
  p.rays_o = rays_o; p.rays_d = rays_d; p.bins = real_bins; p.sh = sh;
  p.w0 = (const bf16*)w0; p.w1 = (const bf16*)w1;
  p.w2 = (const bf16*)w2; p.w3 = (const bf16*)w3;
  p.w0t = (const bf16*)w0t; p.w1t = (const bf16*)w1t;
  p.w2t = (const bf16*)w2t; p.w3t = (const bf16*)w3t;
  p.cp[0] = cp_x; p.cp[1] = cp_y; p.cp[2] = cp_z;
  p.g_f = g_f; p.g_depth = g_depth; p.g_wsum = g_wsum; p.g_w = g_w;
  p.xb = (bf16*)xb; p.a1 = (bf16*)a1; p.a3 = (bf16*)a3; p.d3 = (bf16*)d3;
  p.d2 = (bf16*)d2; p.d1 = (bf16*)d1; p.d0 = (bf16*)d0;
  p.f = f; p.xn = xn; p.e = e;
  p.dcp[0] = dcp_x; p.dcp[1] = dcp_y; p.dcp[2] = dcp_z;
  p.n_rays = n_rays; p.T = T; p.deg = freq_degree; p.rank = cp_rank;
  p.res = cp_res; p.hidden = hidden; p.kin = kin;
  p.opaque_last = opaque_last; p.grid_bound = grid_bound;
  p.db = density_bias;
  const size_t comp_smem = (size_t)NWARPS * 5 * T * 4;
  if (n_rays <= 0 || T < 1 || comp_smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int H = hidden, KIN = kin, nf = 3 + 6 * freq_degree;
  const long long P = (long long)n_rays * T;
  cudaStream_t st = (cudaStream_t)stream;
  FinalInput in = {rays_o, rays_d, real_bins, {cp_x, cp_y, cp_z}, p.xb, xn,
                   n_rays, T, freq_degree, cp_rank, cp_res, H, KIN,
                   grid_bound};
  int rc = launch_final_input(in, st);
  if (rc) return rc;
  rc = launch_trunk_forward(P, H, KIN, p.w0, p.w1, p.w2, p.w3, p.xb, p.a1,
                            p.a3, p.f, st);
  if (rc) return rc;
  rc = launch_checked((const void*)final_composite_kernel,
                      (n_rays + NWARPS - 1) / NWARPS, comp_smem, st, &p);
  if (rc) return rc;
  // dA chain: d2 = mask(A3) (d3 W3); d1 = mask(A2) (d2 W2)[:, :H] with the
  // CP columns into E; d0 = mask(A1) (d1 W1); E += (d0 W0)[:, CP columns]
  LayerGemm b = {};
  b.points = P;
  b.x = p.d3; b.ldx = OUT; b.k = OUT; b.w = p.w3t; b.ldw = OUT; b.n = H;
  b.nmask = H; b.m = p.a3; b.ldm = H; b.y = p.d2; b.ldy = H;
  if ((rc = launch_layer<EPI_MASK>(b, st))) return rc;
  b.x = p.d2; b.ldx = H; b.k = H; b.w = p.w2t; b.ldw = H;
  b.m = p.xb; b.ldm = H + KIN; b.y = p.d1; b.ldy = H;
  if (cp_rank) {
    b.e0 = H + nf; b.e1 = H + nf + cp_rank; b.n = (b.e1 + 15) / 16 * 16;
    b.f = p.e; b.ldf = cp_rank; b.eadd = 0;
  }
  if ((rc = launch_layer<EPI_MASK>(b, st))) return rc;
  b = LayerGemm{};
  b.points = P;
  b.x = p.d1; b.ldx = H; b.k = H; b.w = p.w1t; b.ldw = H; b.n = H;
  b.nmask = H; b.m = p.a1; b.ldm = H; b.y = p.d0; b.ldy = H;
  if ((rc = launch_layer<EPI_MASK>(b, st))) return rc;
  if (!cp_rank) return 0;
  b = LayerGemm{};
  b.points = P;
  b.x = p.d0; b.ldx = H; b.k = H; b.w = p.w0t; b.ldw = H;
  b.e0 = nf; b.e1 = nf + cp_rank; b.n = (b.e1 + 15) / 16 * 16;
  b.f = p.e; b.ldf = cp_rank; b.eadd = 1;
  if ((rc = launch_layer<EPI_MASK>(b, st))) return rc;
  const long long chunks = (P + CP_CHUNK - 1) / CP_CHUNK;
  const size_t slab = (size_t)cp_res * CP_COLS * sizeof(float);
  if (slab > SMEM_LIMIT || chunks > (1LL << 30) || !cp_part)
    return (int)cudaErrorInvalidValue;
  p.cp_part = cp_part;
  p.cp_chunks = (int)chunks;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)final_cp_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)slab);
  if (err != cudaSuccess) return (int)err;
  void* argv[] = {&p};
  err = cudaLaunchKernel((const void*)final_cp_partial_kernel,
                         dim3((unsigned)chunks, 3,
                              (cp_rank + CP_COLS - 1) / CP_COLS),
                         dim3(CP_COLS), argv, slab, st);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long outs = 3LL * cp_res * cp_rank;
  return launch_checked((const void*)final_cp_reduce_kernel,
                        (int)((outs + NTHREADS - 1) / NTHREADS), 0, st, &p);
}

// K4 (b).  Returns 0 or a cudaError_t code.  desc holds n_prod products of
// six int64s each: d, x (device pointers to bf16 [points, m] and
// [points, n], 16-byte aligned), ldd, ldx (multiples of 8), m, n
// (multiples of 16).  part [splits, slab] and out [slab] (fp32, slab the
// sum of m*n) receive dW_l = d_l^T x_l [m, n], one after the other:
// splits ranges of the points summed in split order.
int sanerf_weight_grads(const long long* desc, int n_prod, long long points,
                        int splits, float* part, float* out, void* stream) {
  if (n_prod < 1 || n_prod > GEMM_MAX_PRODUCTS || splits < 1 || points < 0)
    return (int)cudaErrorInvalidValue;
  GemmParams p;
  long long slab = 0;
  int tiles = 0;
  for (int i = 0; i < n_prod; ++i) {
    const long long* e = desc + 6 * i;
    GemmProduct& g = p.prod[i];
    g.d = (const bf16*)e[0]; g.x = (const bf16*)e[1];
    g.ldd = e[2]; g.ldx = e[3]; g.m = (int)e[4]; g.n = (int)e[5];
    if (g.m < 16 || g.n < 16 || g.m % 16 || g.n % 16 || g.ldd % 8 ||
        g.ldx % 8 || (e[0] & 15) || (e[1] & 15))
      return (int)cudaErrorInvalidValue;
    g.tiles_n = (g.n + GN - 1) / GN;
    g.tile0 = tiles;
    g.out = slab;
    tiles += ((g.m + GM - 1) / GM) * g.tiles_n;
    slab += (long long)g.m * g.n;
  }
  p.n_prod = n_prod; p.n_tiles = tiles; p.points = points; p.slab = slab;
  p.part = part;
  const long long per = (points + splits - 1) / splits;
  p.chunk = (per + GK - 1) / GK * GK;
  int rc = launch_checked((const void*)weight_grad_gemm, tiles * splits,
                          gemm_smem(), (cudaStream_t)stream, &p);
  if (rc) return rc;
  return launch_reduce(part, splits, (int)slab, out, (cudaStream_t)stream);
}

const char* sanerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
