// Frequency encoding + bias-free MLP forward for NVIDIA Hopper (sm_90a):
// K8 (and K9).  Bound to Python through ctypes
// (sanerf_hq_tpu_torch/ops/fused_mlp.py); plain C interface, no PyTorch
// headers.  Shared device code: render_level_common.cuh (mma.sync helpers),
// render_level_gemm.cuh (layer_gemm, copy_rows).
//
// Replaces (JAX reference, sanerf_hq_tpu/ops/fused_mlp.py):
//   K8  _make_kernel_t (:213), reached through _pallas_forward_t (:238,
//       pallas_call :251) from fused_freq_mlp (:186) -> _fused (:163): the
//       composable route's proposal MLPs and, without CP features, its
//       trunk (models/mlp_field.py FreqMLP);
//   K9  _make_kernel (:103), reached through _pallas_forward (:134,
//       pallas_call :145): the same function with points on rows.  The two
//       layouts are TPU VMEM choices (points on lanes so that a [T, 3]
//       block does not pad to 128 lanes); here one entry point computes both.
//
// Computes, per point: the block freq encoding [x | sin(2^k x_d) |
// cos(2^k x_d)] (k-major, nin = D (1 + 2 deg) columns, zero-padded to KIN,
// a multiple of 16) rounded to bf16 once, then one bf16 product with fp32
// sums per layer; hidden ReLU outputs rounded to bf16, the last layer kept
// fp32.  Layer `skip` reads [activation | layer-0 input].  Weights are the
// fp32 [out, in] parameters; layer l as bf16 is [rows, cols] zero-padded:
// rows H (the last layer: the output width), cols KIN at layer 0, H + KIN
// at the skip layer, H elsewhere (layer_shape).
//
// Two designs; the wrapper picks one (fused_mlp.py mlp_design, the same
// rule as narrow_smem here).
//
// Narrow (hidden width <= 64, and the bf16 weights with the warps' input
// rows in shared memory leave room for two CTAs an SM: the 64 x 3
// proposal MLPs, 6656 MAC a point).  One kernel, fused_freq_mlp_narrow,
// reads the fp32 weights itself: each CTA rounds them to bf16 and stages
// them zero-padded into shared memory once, so the wrapper launches
// nothing else.  The grid is persistent (as many CTAs as the SMs hold at
// once) and each warp walks its own 32-point tiles with no CTA barrier: a
// lane builds its point's freq row into the warp's rows in shared memory
// (sincosf(ldexpf(x, k)), a loop over d and k with no division), then every
// layer runs as mma.sync m16n8k16 with B (and the layer-0 / skip input) by
// ldmatrix from shared memory.  The sums of two adjacent n8 tiles have the
// layout of the A fragment of one k16 tile of the next layer, so the
// hidden activations stay in registers (ReLU, round to bf16, pack) and
// never pass through shared memory; a B fragment serves both m tiles of
// the warp.  What bounds it: the mma.sync chains and the sin/cos (18 a
// point for the proposal MLP), not its 16 bytes of I/O a point; 128
// registers a thread allow 16 warps an SM, which do not hide their
// latency (about twice the counted issue time, PERF.md).
//
// Wide (the 256 x 4 trunk at --cp_rank 0, 167,424 MAC a point, and every
// other shape).  K3's design over all points: fused_freq_mlp_pack makes
// the padded bf16 weights of all layers in one launch,
// fused_freq_mlp_input writes the freq rows into the h_in columns of a
// [P, H + KIN] scratch xb (a thread a point into shared memory, then
// 16-byte stores), and one layer_gemm launch a layer (wgmma, 128 x 128
// tiles, two CTAs an SM; EPI_RELU hidden, EPI_F32 last).  The layer before
// the skip layer writes xb's first H columns, so that the skip layer reads
// one [activation | h_in] row; the others ping-pong between scratch a and
// b.  The scratch is this design's cost.  What bounds it: the products'
// scratch traffic and the tensor cores.
#include "render_level_gemm.cuh"

using namespace sanerf;

namespace {

constexpr int MAXL = 8;          // layers
constexpr int NARROW_HT = 4;     // hidden k16 tiles a warp holds: H <= 64
constexpr int NARROW_MT = 2;     // m16 tiles a warp
constexpr int NARROW_PTS = NARROW_MT * 16;  // points a warp tile
// two CTAs an SM: 2 (bytes + 1 KB reserved) <= 228 KB
constexpr size_t NARROW_SMEM_MAX = 115712;
constexpr int FPTS = NTHREADS;   // points a CTA of the wide input kernel

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// Layer l's weights: rows, the fp32 columns cols_in and the padded bf16
// columns cols (the padding is at the end of the row).
__host__ __device__ inline void layer_shape(int l, int L, int H, int nin,
                                            int kin, int out_dim, int skip,
                                            int& rows, int& cols_in,
                                            int& cols) {
  rows = l == L - 1 ? out_dim : H;
  const int act = l == 0 ? 0 : H;
  const bool in = l == 0 || l == skip;
  cols_in = act + (in ? nin : 0);
  cols = act + (in ? kin : 0);
}

struct MlpParams {
  const float* x;
  float* out;
  const float* w[MAXL];  // fp32 [rows, cols_in]
  int n_layers, B, D, deg, hidden, nin, kin, out_dim, skip;
};

// Shared memory of the narrow kernel: each layer [round16(rows), cols + 8]
// bf16, then each warp's input rows [32, KIN + 8].
__host__ __device__ inline size_t narrow_smem(int L, int H, int nin, int kin,
                                              int out_dim, int skip) {
  size_t el = (size_t)NWARPS * NARROW_PTS * (kin + 8);
  for (int l = 0; l < L; ++l) {
    int rows, cin, cols;
    layer_shape(l, L, H, nin, kin, out_dim, skip, rows, cin, cols);
    el += (size_t)round16(rows) * (cols + 8);
  }
  return el * 2;
}

// The block freq row of point pt (a point at or past B reads 0) as bf16
// into row[0, nin): x, then sin and cos of 2^k x_d at column D + k D + d
// and D + D deg + k D + d.
__device__ __forceinline__ void freq_row(const float* x, long long pt, int B,
                                         int D, int deg, bf16* row) {
  const bool ok = pt < B;
  const float* xp = x + (ok ? pt : 0) * D;
  const int F3 = D * deg;
  for (int d = 0; d < D; ++d) {
    const float v = ok ? xp[d] : 0.0f;
    row[d] = __float2bfloat16(v);
    bf16* s = row + D + d;
    for (int k = 0; k < deg; ++k, s += D) {
      float sv, cv;
      sincosf(ldexpf(v, k), &sv, &cv);
      s[0] = __float2bfloat16(sv);
      s[F3] = __float2bfloat16(cv);
    }
  }
}

typedef unsigned Frag[NARROW_MT][NARROW_HT][4];

__device__ __forceinline__ unsigned relu_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(fmaxf(a, 0.0f), fmaxf(b, 0.0f));
  return *reinterpret_cast<unsigned*>(&h);
}

// The sums of output columns [16 c, 16 c + 16) of one layer over the
// warp's 32 points: the activation's kt_act k tiles from the registers
// (act), then kt_in k tiles of the layer-0 input from the warp's rows in
// shared memory (hin, ldh); W [rows, ldw] in shared memory, the
// activation's columns first.  acc[m][j]: m tile m, n8 tile j.
__device__ __forceinline__ void chunk_sums(float (&acc)[NARROW_MT][2][4],
                                           int c, const Frag& act,
                                           int kt_act, const bf16* hin,
                                           int ldh, int kt_in, const bf16* W,
                                           int ldw) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < NARROW_MT; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.0f;
  // ldmatrix x4 of B: rows 16 c + (lane & 7) (+8 for lanes 16-31), columns
  // k (+8 for lanes 8-15 and 24-31): registers 0, 1 the first n8 tile's
  // fragment, 2, 3 the second's
  const bf16* bp = W + (c * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldw +
                   (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kt = 0; kt < NARROW_HT; ++kt) {
    if (kt < kt_act) {
      unsigned b[4];
      ldmatrix_x4(b, bp + kt * 16);
#pragma unroll
      for (int m = 0; m < NARROW_MT; ++m) {
        mma_16816(acc[m][0], act[m][kt], b[0], b[1]);
        mma_16816(acc[m][1], act[m][kt], b[2], b[3]);
      }
    }
  }
  const bf16* ap = hin + (lane & 15) * ldh + ((lane >> 4) << 3);
  for (int kt = 0; kt < kt_in; ++kt) {
    unsigned b[4];
    ldmatrix_x4(b, bp + (kt_act + kt) * 16);
#pragma unroll
    for (int m = 0; m < NARROW_MT; ++m) {
      unsigned a[4];
      ldmatrix_x4(a, ap + m * 16 * ldh + kt * 16);
      mma_16816(acc[m][0], a, b[0], b[1]);
      mma_16816(acc[m][1], a, b[2], b[3]);
    }
  }
}

// A hidden layer: relu(sums) rounded to bf16 into next, the A fragments of
// the next layer (k tile c from output columns [16 c, 16 c + 16)).
__device__ __forceinline__ void hidden_layer(const Frag& act, int kt_act,
                                             const bf16* hin, int ldh,
                                             int kt_in, const bf16* W,
                                             int ldw, int n16, Frag& next) {
#pragma unroll
  for (int c = 0; c < NARROW_HT; ++c) {
    if (c >= n16) break;
    float acc[NARROW_MT][2][4];
    chunk_sums(acc, c, act, kt_act, hin, ldh, kt_in, W, ldw);
#pragma unroll
    for (int m = 0; m < NARROW_MT; ++m) {
      next[m][c][0] = relu_bf16x2(acc[m][0][0], acc[m][0][1]);
      next[m][c][1] = relu_bf16x2(acc[m][0][2], acc[m][0][3]);
      next[m][c][2] = relu_bf16x2(acc[m][1][0], acc[m][1][1]);
      next[m][c][3] = relu_bf16x2(acc[m][1][2], acc[m][1][3]);
    }
  }
}

// The last layer: the fp32 sums straight from the registers into out
// [B, out_dim] (rows p0 .. p0 + 31, columns < out_dim).
__device__ __forceinline__ void last_layer(const Frag& act, int kt_act,
                                           const bf16* hin, int ldh,
                                           int kt_in, const bf16* W, int ldw,
                                           int n16, float* out, long long p0,
                                           int B, int out_dim) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int c = 0; c < n16; ++c) {
    float acc[NARROW_MT][2][4];
    chunk_sums(acc, c, act, kt_act, hin, ldh, kt_in, W, ldw);
#pragma unroll
    for (int m = 0; m < NARROW_MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = p0 + m * 16 + g + 8 * h;
          const int col = c * 16 + j * 8 + 2 * q;
          if (row >= B) continue;
          float* o = out + row * out_dim;
          if (col < out_dim) o[col] = acc[m][j][2 * h];
          if (col + 1 < out_dim) o[col + 1] = acc[m][j][2 * h + 1];
        }
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
fused_freq_mlp_narrow(MlpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int L = p.n_layers, H = p.hidden;
  // the weights, rounded to bf16 and zero-padded, once for the CTA's life
  const bf16* W[MAXL];
  int ldw[MAXL], n16[MAXL];
  bf16* dst = reinterpret_cast<bf16*>(smem);
  for (int l = 0; l < L; ++l) {
    int rows, cin, cols;
    layer_shape(l, L, H, p.nin, p.kin, p.out_dim, p.skip, rows, cin, cols);
    const int rp = round16(rows), ld = cols + 8;
    const float* src = p.w[l];
    for (int i = tid; i < rp * ld; i += NTHREADS) {
      const int r = i / ld, c = i - r * ld;
      dst[i] = __float2bfloat16(r < rows && c < cin ? src[r * cin + c]
                                                    : 0.0f);
    }
    W[l] = dst;
    ldw[l] = ld;
    n16[l] = rp / 16;
    dst += rp * ld;
  }
  // the warp's input rows; their padding columns [nin, kin) stay zero
  const int ldh = p.kin + 8;
  bf16* hin = dst + warp * NARROW_PTS * ldh;
  for (int i = lane; i < NARROW_PTS * ldh; i += 32)
    hin[i] = __float2bfloat16(0.0f);
  __syncthreads();  // the last CTA-wide barrier

  const int kt_in = p.kin / 16, ht = H / 16;
  const long long n_tiles = ((long long)p.B + NARROW_PTS - 1) / NARROW_PTS;
  const long long stride = (long long)gridDim.x * NWARPS;
  Frag a, b;
  for (long long t = (long long)blockIdx.x * NWARPS + warp; t < n_tiles;
       t += stride) {
    const long long p0 = t * NARROW_PTS;
    freq_row(p.x, p0 + lane, p.B, p.D, p.deg, hin + lane * ldh);
    __syncwarp();
    if (L == 1) {
      last_layer(a, 0, hin, ldh, kt_in, W[0], ldw[0], n16[0], p.out, p0,
                 p.B, p.out_dim);
    } else {
      hidden_layer(b, 0, hin, ldh, kt_in, W[0], ldw[0], n16[0], a);
      for (int l = 1; l < L - 1; ++l) {
        const bool sk = l == p.skip;
        hidden_layer(a, ht, hin, ldh, sk ? kt_in : 0, W[l], ldw[l], n16[l],
                     b);
#pragma unroll
        for (int m = 0; m < NARROW_MT; ++m)
#pragma unroll
          for (int k = 0; k < NARROW_HT; ++k)
#pragma unroll
            for (int i = 0; i < 4; ++i) a[m][k][i] = b[m][k][i];
      }
      const bool sk = L - 1 == p.skip;
      last_layer(a, ht, hin, ldh, sk ? kt_in : 0, W[L - 1], ldw[L - 1],
                 n16[L - 1], p.out, p0, p.B, p.out_dim);
    }
    __syncwarp();  // every lane's fragments loaded before the rows change
  }
}

// ---------------------------------------------------------------------------
// Wide design
// ---------------------------------------------------------------------------

struct PackParams {
  const float* w[MAXL];
  bf16* dst;
  long long off[MAXL + 1];  // element offset of each layer in dst
  int cols_in[MAXL], cols[MAXL], n_layers;
};

// Every layer's bf16 [rows, cols] weights, zero-padded, into one buffer.
__global__ void __launch_bounds__(NTHREADS)
fused_freq_mlp_pack(PackParams p) {
  const long long total = p.off[p.n_layers];
  for (long long i = (long long)blockIdx.x * NTHREADS + threadIdx.x;
       i < total; i += (long long)gridDim.x * NTHREADS) {
    int l = 0;
    while (i >= p.off[l + 1]) ++l;
    const long long e = i - p.off[l];
    const int cols = p.cols[l], cin = p.cols_in[l];
    const long long r = e / cols;
    const int c = (int)(e - r * cols);
    p.dst[i] = __float2bfloat16(c < cin ? p.w[l][r * cin + c] : 0.0f);
  }
}

struct FreqInput {
  const float* x;
  bf16* dst;  // row i at dst + i ld, KIN columns
  long long ld;
  int B, D, deg, nin, kin;
};

// The freq rows of FPTS points, a thread a point, into shared memory
// [FPTS, KIN + 8] (padding columns zero), then to dst in 16-byte pieces.
__global__ void __launch_bounds__(NTHREADS)
fused_freq_mlp_input(FreqInput p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* rows = reinterpret_cast<bf16*>(smem);
  const int ldr = p.kin + 8;
  const long long p0 = (long long)blockIdx.x * FPTS;
  bf16* row = rows + threadIdx.x * ldr;
  freq_row(p.x, p0 + threadIdx.x, p.B, p.D, p.deg, row);
  for (int c = p.nin; c < p.kin; ++c) row[c] = __float2bfloat16(0.0f);
  __syncthreads();
  const int nv = (int)min((long long)FPTS, (long long)p.B - p0);
  copy_rows(rows, ldr, p.dst + p0 * p.ld, p.ld, nv, p.kin);
}

int launch_pack(const float* const* ws, bf16* dst, int L, int H, int nin,
                int kin, int out_dim, int skip, cudaStream_t st) {
  PackParams p = {};
  p.dst = dst;
  p.n_layers = L;
  for (int l = 0; l < L; ++l) {
    int rows, cin, cols;
    layer_shape(l, L, H, nin, kin, out_dim, skip, rows, cin, cols);
    p.w[l] = ws[l];
    p.cols_in[l] = cin;
    p.cols[l] = cols;
    p.off[l + 1] = p.off[l] + (long long)rows * cols;
  }
  const long long blocks = (p.off[L] + NTHREADS - 1) / NTHREADS;
  const int cap = 4 * sm_count();
  return launch_checked((const void*)fused_freq_mlp_pack,
                        (int)(blocks < cap ? blocks : cap), 0, st, &p);
}

int launch_input(const float* x, bf16* dst, long long ld, int B, int D,
                 int deg, int kin, cudaStream_t st) {
  FreqInput p = {x, dst, ld, B, D, deg, D * (1 + 2 * deg), kin};
  return launch_checked((const void*)fused_freq_mlp_input,
                        (int)(((long long)B + FPTS - 1) / FPTS),
                        (size_t)FPTS * (kin + 8) * 2, st, &p);
}

bool valid_shape(int L, int B, int D, int deg, int H, int kin, int out_dim,
                 int skip) {
  return L >= 1 && L <= MAXL && B >= 0 && D >= 1 && deg >= 0 &&
         H % 16 == 0 && H >= 16 && H <= 256 && kin % 16 == 0 &&
         kin >= D * (1 + 2 * deg) && kin <= 256 && out_dim >= 1 &&
         out_dim <= 256 && skip != 0 && skip < L;
}

}  // namespace

extern "C" {

// Shared memory of the narrow kernel at this shape (bytes): the wrapper's
// design rule reads the same sum.
long long sanerf_fused_freq_mlp_narrow_smem(int n_layers, int D,
                                            int freq_degree, int hidden,
                                            int kin, int out_dim,
                                            int skip_layer) {
  return (long long)narrow_smem(n_layers, hidden, D * (1 + 2 * freq_degree),
                                kin, out_dim, skip_layer);
}

// The narrow design, one launch.  x [B, D] fp32, out [B, out_dim] fp32,
// ws: n_layers fp32 [rows, cols_in] weights (layer_shape), all contiguous.
// hidden H (16 to 64, a multiple of 16; any value when n_layers is 1), kin
// = D (1 + 2 deg) rounded up to 16, skip_layer -1 (none) or 1 to
// n_layers - 1.  Returns 0 or a cudaError_t code.
int sanerf_fused_freq_mlp_narrow(const float* x, float* out,
                                 const float* const* ws, int n_layers, int B,
                                 int D, int freq_degree, int hidden, int kin,
                                 int out_dim, int skip_layer, void* stream) {
  if (!valid_shape(n_layers, B, D, freq_degree, hidden, kin, out_dim,
                   skip_layer) ||
      (n_layers > 1 && hidden > NARROW_HT * 16))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  MlpParams p;
  p.x = x;
  p.out = out;
  for (int l = 0; l < MAXL; ++l) p.w[l] = l < n_layers ? ws[l] : nullptr;
  p.n_layers = n_layers; p.B = B; p.D = D; p.deg = freq_degree;
  p.hidden = hidden; p.nin = D * (1 + 2 * freq_degree); p.kin = kin;
  p.out_dim = out_dim; p.skip = skip_layer;
  const size_t smem = narrow_smem(n_layers, hidden, p.nin, kin, out_dim,
                                  skip_layer);
  if (smem > NARROW_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)fused_freq_mlp_narrow;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      NTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)B + NARROW_PTS - 1) / NARROW_PTS;
  const long long need = (tiles + NWARPS - 1) / NWARPS;
  const long long grid = (long long)per_sm * sm_count();
  return launch_checked(kernel, (int)(grid < need ? grid : need), smem,
                        (cudaStream_t)stream, &p);
}

// The wide design: the weight pack, the input kernel and one layer_gemm
// launch a layer, in order on the stream.  x, out, ws as the narrow entry;
// wpack: bf16 scratch of sum rows * cols elements (layer_shape); xb: bf16
// [B, c0 + kin] with c0 = hidden when a skip layer exists, else 0 (h_in in
// columns [c0, c0 + kin)); a, b: bf16 [B, hidden] or null where the layer
// plan (fused_mlp.py wide_plan) does not use them.  Returns 0 or a
// cudaError_t code.
int sanerf_fused_freq_mlp_wide(const float* x, float* out,
                               const float* const* ws, void* wpack, void* xb,
                               void* a, void* b, int n_layers, int B, int D,
                               int freq_degree, int hidden, int kin,
                               int out_dim, int skip_layer, void* stream) {
  if (!valid_shape(n_layers, B, D, freq_degree, hidden, kin, out_dim,
                   skip_layer))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int L = n_layers, H = hidden, nin = D * (1 + 2 * freq_degree);
  const int c0 = skip_layer > 0 ? H : 0;
  const long long ldxb = c0 + kin;
  bf16* wp = (bf16*)wpack;
  bf16* x0 = (bf16*)xb;
  int rc = launch_pack(ws, wp, L, H, nin, kin, out_dim, skip_layer, st);
  if (rc) return rc;
  if ((rc = launch_input(x, x0 + c0, ldxb, B, D, freq_degree, kin, st)))
    return rc;
  LayerGemm g = {};
  g.points = B;
  const bf16* cur = nullptr;  // the last hidden output (a, b or xb)
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    int rows, cin, cols;
    layer_shape(l, L, H, nin, kin, out_dim, skip_layer, rows, cin, cols);
    g.w = wp + off;
    g.ldw = cols;
    g.n = rows;
    g.k = cols;
    off += (long long)rows * cols;
    if (l == 0) {
      g.x = x0 + c0; g.ldx = ldxb;
    } else if (l == skip_layer) {
      g.x = x0; g.ldx = ldxb;  // [activation | h_in]
    } else {
      g.x = cur; g.ldx = H;
    }
    if (l == L - 1) {
      g.f = out;
      g.ldf = out_dim;
      return launch_layer<EPI_F32>(g, st);
    }
    bf16* y;
    if (l + 1 == skip_layer) {
      y = x0; g.ldy = ldxb;
    } else {
      y = (bf16*)(cur == a ? b : a); g.ldy = H;
    }
    if (!y) return (int)cudaErrorInvalidValue;
    g.y = y;
    if ((rc = launch_layer<EPI_RELU>(g, st))) return rc;
    cur = y;
  }
  return 0;
}

// The wide design's first launch alone: the padded bf16 weights of every
// layer into wpack.
int sanerf_fused_freq_mlp_pack(const float* const* ws, void* wpack,
                               int n_layers, int D, int freq_degree,
                               int hidden, int kin, int out_dim,
                               int skip_layer, void* stream) {
  if (!valid_shape(n_layers, 0, D, freq_degree, hidden, kin, out_dim,
                   skip_layer))
    return (int)cudaErrorInvalidValue;
  return launch_pack(ws, (bf16*)wpack, n_layers, hidden,
                     D * (1 + 2 * freq_degree), kin, out_dim, skip_layer,
                     (cudaStream_t)stream);
}

// The wide design's second launch alone: the freq rows of x [B, D] as
// bf16 into dst (row i at dst + i ld, kin columns, padding zero).
int sanerf_fused_freq_mlp_input(const float* x, void* dst, long long ld,
                                int B, int D, int freq_degree, int kin,
                                void* stream) {
  if (B < 0 || D < 1 || freq_degree < 0 || kin % 16 ||
      kin < D * (1 + 2 * freq_degree) || kin > 256 || ld < kin || ld % 8)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return launch_input(x, (bf16*)dst, ld, B, D, freq_degree, kin,
                      (cudaStream_t)stream);
}

const char* sanerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
