// Frequency encoding + bias-free MLP forward for NVIDIA Hopper (sm_90a):
// K8 (and K9).  Bound to Python through ctypes
// (sanerf_hq_tpu_torch/ops/fused_mlp.py); plain C interface, no PyTorch
// headers.  Shared device code: render_level_common.cuh.
//
// Replaces (JAX reference, sanerf_hq_tpu/ops/fused_mlp.py):
//   K8  _make_kernel_t (:213), reached through _pallas_forward_t (:238,
//       pallas_call :251) from fused_freq_mlp (:186) -> _fused (:163): the
//       composable route's proposal MLPs and, without CP features, its
//       trunk (models/mlp_field.py FreqMLP);
//   K9  _make_kernel (:103), reached through _pallas_forward (:134,
//       pallas_call :145): the same function with points on rows.  The two
//       layouts are TPU VMEM choices (points on lanes so that a [T, 3]
//       block does not pad to 128 lanes); here one kernel computes both.
//
// Computes, per point: the block freq encoding [x | sin(2^k x_d) |
// cos(2^k x_d)] (k-major, D + 2 D deg columns) rounded to bf16 once, then
// one bf16 product with fp32 sums per layer; hidden ReLU outputs rounded
// to bf16, the last layer kept fp32.  Layer `skip` reads [activation |
// layer-0 input], the rounded layer-0 input kept in shared memory.  Any
// layer count up to MAXL, hidden layers of one width H (a multiple of 16).
//
// Design.  One CTA of 8 warps owns P = 128 points (the last CTA masks its
// tail): it loads their coordinates, builds the freq rows in shared memory
// (precise sincosf on ldexpf(x, k): 2^9 x reaches +-512), and runs each
// layer as WMMA bf16 tiles (mma.sync, fp32 accumulation) with A from
// shared memory and B (the weights) from global memory, where they stay
// hot in L1/L2 across CTAs.  Activations ping-pong between two shared
// buffers and never reach device memory: the kernel reads x and writes
// the output only.  What bounds it on this card: tensor-core work (6,656
// MAC a point for the proposal MLP, 167,424 for the trunk, against 16 and
// 76 bytes of I/O).  This first version does not use wgmma/TMA or stage
// the weights in shared memory.
#include "render_level_common.cuh"

using namespace sanerf;

namespace {

constexpr int P = 128;   // points per CTA
constexpr int MAXL = 8;  // layers

struct MlpParams {
  const float* x;
  float* out;
  const bf16* w[MAXL];
  int n_layers, B, D, deg, hidden, kin, out_dim, outp, skip;
};

// C[PP x n] = [A1 (k1 columns) | A2 (k2 columns)] * W^T, as dense<PP> in
// render_level_common.cuh with the input in two segments: W [n x (k1+k2)]
// bf16 row-major in global memory.  With O set, writes relu(C) as bf16
// into O (ldo); else C as fp32 into F (ldf).
template <int PP>
__device__ void dense2(const bf16* A1, int lda1, int k1, const bf16* A2,
                       int lda2, int k2, const bf16* W, int n, bf16* O,
                       int ldo, float* F, int ldf, float* scratch) {
  constexpr int MT = PP / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ntiles = n / 16, ldw = k1 + k2;
  int wpn = 1;  // warps sharing one column tile (power of two dividing MT)
  while (wpn * 2 * ntiles <= NWARPS && wpn * 2 <= MT) wpn *= 2;
  const int mper = MT / wpn;
  const int units = ntiles * wpn;
  for (int u = warp; u < units; u += NWARPS) {
    const int nt = u / wpn, m0 = (u % wpn) * mper;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < mper) wmma::fill_fragment(acc[i], 0.0f);
    const bf16* wt = W + (size_t)nt * 16 * ldw;
    for (int seg = 0; seg < 2; ++seg) {
      const bf16* A = seg ? A2 : A1;
      const int lda = seg ? lda2 : lda1, k = seg ? k2 : k1;
      const bf16* ws = wt + (seg ? k1 : 0);
      for (int kt = 0; kt < k; kt += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, ws + kt, ldw);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < mper) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                           wmma::row_major> a;
            wmma::load_matrix_sync(a, A + (m0 + i) * 16 * lda + kt, lda);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
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
          if (O) O[r * ldo + c] = __float2bfloat16(fmaxf(v, 0.0f));
          else F[r * ldf + c] = v;
        }
        __syncwarp();
      }
    }
  }
}

// Shared memory: the layer-0 input HIN [P, KIN+8] (kept for the skip
// layer), two activation buffers [P, H+8], the fp32 output F [P, OUTP],
// per-warp 16x16 fp32 scratch, the points' coordinates [P, D].
__global__ void __launch_bounds__(NTHREADS)
fused_freq_mlp_kernel(MlpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.hidden, KIN = p.kin, D = p.D;
  const int ldh = KIN + 8, ld = H + 8;
  bf16* hin = reinterpret_cast<bf16*>(smem);
  bf16* buf[2] = {hin + P * ldh, hin + P * ldh + P * ld};
  float* F = reinterpret_cast<float*>(buf[1] + P * ld);
  float* scratch = F + P * p.outp;
  float* xs = scratch + NWARPS * 256;
  const int tid = threadIdx.x, warp = tid >> 5;
  const long long p0 = (long long)blockIdx.x * P;
  const int npts = (int)min((long long)P, (long long)p.B - p0);

  // the CTA's points are one contiguous run of x; points past B read 0
  for (int i = tid; i < P * D; i += NTHREADS)
    xs[i] = i < npts * D ? p.x[p0 * D + i] : 0.0f;
  __syncthreads();
  const int F3 = D * p.deg, per = D + F3;
  for (int item = tid; item < P * per; item += NTHREADS) {
    const int q = item / per, j = item - q * per;
    bf16* row = hin + q * ldh;
    if (j < D) {
      row[j] = __float2bfloat16(xs[q * D + j]);
    } else {
      const int idx = j - D, k = idx / D, d = idx - k * D;
      float sv, cv;
      sincosf(ldexpf(xs[q * D + d], k), &sv, &cv);
      row[D + idx] = __float2bfloat16(sv);
      row[D + F3 + idx] = __float2bfloat16(cv);
    }
  }
  zero_cols<P>(hin, ldh, D + 2 * F3, KIN);
  __syncthreads();

  float* ws = scratch + warp * 256;
  const bf16* cur = hin;
  int ldc = ldh, kc = KIN, nb = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const bool last = l == p.n_layers - 1, skip = l == p.skip;
    dense2<P>(cur, ldc, kc, skip ? hin : nullptr, ldh, skip ? KIN : 0,
              p.w[l], last ? p.outp : H, last ? nullptr : buf[nb], ld,
              last ? F : nullptr, p.outp, ws);
    __syncthreads();
    cur = buf[nb];
    ldc = ld;
    kc = H;
    nb ^= 1;
  }
  for (int i = tid; i < npts * p.out_dim; i += NTHREADS) {
    const int q = i / p.out_dim;
    p.out[p0 * p.out_dim + i] = F[q * p.outp + (i - q * p.out_dim)];
  }
}

size_t mlp_smem(int H, int KIN, int OUTP, int D) {
  return (size_t)P * (KIN + 8) * 2 + (size_t)2 * P * (H + 8) * 2 +
         (size_t)(P * OUTP + NWARPS * 256 + P * D) * 4;
}

}  // namespace

extern "C" {

// x [B, D] fp32, out [B, out_dim] fp32, both contiguous.  ws: n_layers
// bf16 [rows, cols] row-major weights, padded: layer l has rows H (the
// last: out_dim rounded up to 16) and cols k1 + k2, k1 = kin at layer 0
// (kin = D (1 + 2 deg) rounded up to 16) and hidden after it, k2 = kin at
// the skip layer and 0 elsewhere; padding is zero.  skip_layer -1: none;
// 0 is refused (layer 0 has no activation to put before its input).
// Returns 0 or a cudaError_t code.
int sanerf_fused_freq_mlp(const float* x, float* out, const void* const* ws,
                          int n_layers, int B, int D, int freq_degree,
                          int hidden, int kin, int out_dim, int skip_layer,
                          void* stream) {
  if (n_layers < 1 || n_layers > MAXL || hidden % 16 || kin % 16 ||
      out_dim < 1 || D < 1 || skip_layer == 0)
    return (int)cudaErrorInvalidValue;
  MlpParams p;
  p.x = x;
  p.out = out;
  for (int l = 0; l < MAXL; ++l)
    p.w[l] = l < n_layers ? (const bf16*)ws[l] : nullptr;
  p.n_layers = n_layers; p.B = B; p.D = D; p.deg = freq_degree;
  p.hidden = hidden; p.kin = kin; p.out_dim = out_dim;
  p.outp = (out_dim + 15) / 16 * 16;
  p.skip = skip_layer;
  if (B == 0) return 0;
  const int grid = (B + P - 1) / P;
  return launch_checked((const void*)fused_freq_mlp_kernel, grid,
                        mlp_smem(hidden, kin, p.outp, D),
                        (cudaStream_t)stream, &p);
}

const char* sanerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
