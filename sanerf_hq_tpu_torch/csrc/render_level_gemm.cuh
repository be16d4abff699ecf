// Device code shared by the final level's forward (K3, K6 in
// render_level.cu) and K4's stash part (render_level_bwd.cu): cp.async and
// wgmma helpers on 128-byte-swizzled tiles, the trunk-input kernel over
// all points (geometry, freq and CP features), and the per-layer product
// over all points (layer_gemm) with its launch and the trunk's four forward
// products.  One copy, so that K3, K4 and K8's wide design (fused_mlp.cu)
// run the same code.
#pragma once

#include "render_level_common.cuh"

namespace sanerf {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// Warpgroup products (wgmma) on tiles in shared memory, 128-byte swizzle:
// an atom is 8 rows of 128 bytes, 16-byte piece c of row r stored in slot
// c ^ (r % 8); atoms start 1024-byte aligned.  A K-major operand (K
// contiguous) holds 64 k a row; descriptor SBO 1024 (the next 8 rows), and
// a k step of 16 moves the start 32 bytes along the row.  An M- or N-major
// operand holds 64 m (or n) a row, one row a k; descriptor LBO is the
// stride between 64-column blocks, SBO 1024 (the next 8 k).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo,
                                               unsigned sbo) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return (uint64_t)((a >> 4) & 0x3FFF) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// Element offset of 16-byte piece c (0..7) of 128-byte row r.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 64 + ((c ^ (r & 7)) << 3);
}

// Dynamic shared memory rounded up to the swizzle's 1024-byte period (the
// kernels ask for 1024 bytes more than they use).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

// Makes this thread's completed cp.async writes visible to wgmma.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits for this warpgroup's products; the compiler may not move reads of
// the accumulators above it.
__device__ __forceinline__ void wgmma_wait_all(float (&d)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SANERF_D8(i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d [64 x 128] += A [64 x 16] B [16 x 128] for one warpgroup: bf16
// products, fp32 sums.  TA (TB) is 0 for a K-major A (B), 1 for an M-major
// A (N-major B).  Thread t of the warpgroup holds d[i] at row 16 (t / 32) +
// (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4) + i % 2.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : SANERF_D8(0), SANERF_D8(8), SANERF_D8(16), SANERF_D8(24),
        SANERF_D8(32), SANERF_D8(40), SANERF_D8(48), SANERF_D8(56)
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

#undef SANERF_D8

// Copies rows x cols bf16 (cols a multiple of 8) from src (lds) to dst
// (ldd), 16 bytes a thread: device memory to shared or shared to device.
__device__ inline void copy_rows(const bf16* src, size_t lds, bf16* dst,
                                 size_t ldd, int rows, int cols) {
  const int cw = cols / 8;
  for (int it = threadIdx.x; it < rows * cw; it += NTHREADS) {
    const int r = it / cw, c = (it - r * cw) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// ---------------------------------------------------------------------------
// The trunk's input over all P = N*T points
// ---------------------------------------------------------------------------

struct FinalInput {
  const float *rays_o, *rays_d, *bins;
  const float* cp[3];
  bf16* xb;   // [P, H+KIN]: h_in goes into columns [H, H+KIN)
  float* xn;  // [P, 3] contracted / grid_bound positions
  int n_rays, T, deg, rank, res, hidden, kin;
  float grid_bound;
};

constexpr int IPP = 64;  // points a CTA of the input kernel

// h_in = [freq(xn) | CP features | 0] of 64 points into xb's columns
// [H, H+KIN), and xn.
__global__ void __launch_bounds__(NTHREADS)
final_input_kernel(FinalInput p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float xn[IPP * 3], tt[IPP], dl[IPP];
  const int H = p.hidden, KIN = p.kin, P = p.n_rays * p.T;
  const int nf = 3 + 6 * p.deg, p0 = blockIdx.x * IPP;
  bf16* hin = reinterpret_cast<bf16*>(smem);  // [IPP, KIN+8]
  build_geometry_freq<IPP>(p.rays_o, p.rays_d, p.bins, p.n_rays, p.T, 0, P,
                           p0, p.deg, p.grid_bound, xn, tt, dl, hin, KIN + 8);
  zero_cols<IPP>(hin, KIN + 8, nf + p.rank, KIN);
  build_cp<IPP>(p.cp, p.rank, p.res, xn, hin, KIN + 8, nf);
  __syncthreads();
  const int nv = min(IPP, P - p0);
  copy_rows(hin, KIN + 8, p.xb + (size_t)p0 * (H + KIN) + H, H + KIN, nv,
            KIN);
  if (threadIdx.x < nv * 3) p.xn[(size_t)p0 * 3 + threadIdx.x] = xn[threadIdx.x];
}

inline int launch_final_input(FinalInput p, cudaStream_t stream) {
  const long long P = (long long)p.n_rays * p.T;
  return launch_checked((const void*)final_input_kernel,
                        (int)((P + IPP - 1) / IPP),
                        (size_t)IPP * (p.kin + 8) * 2, stream, &p);
}

// ---------------------------------------------------------------------------
// One layer's product over all points, Y = epi(X W^T): X [points, k] bf16
// (ldx), W [n, k] bf16 (ldw); the dA products take the transposed weights.
// 128 x 128 output tiles, two warpgroups of 64 rows each, the k loop in
// 64-wide steps through a three-stage cp.async ring into swizzled K-major
// tiles, wgmma products, two CTAs an SM.  The sums pass through shared
// memory to the epilogues: EPI_RELU y = bf16(relu); EPI_F32 f = sum (any
// n and ldf: 16-byte stores where a group of 8 columns fits);
// EPI_MASK column c < nmask y = bf16(m > 0 ? sum : 0), column c in
// [e0, e1) into f[:, c - e0] (added when eadd); a thread writes 8
// consecutive columns of a row.
// ---------------------------------------------------------------------------
constexpr int LM = 128, LN = 128, LK = 64, LSTAGES = 3;
constexpr int LTILE = LM * LK;  // elements of one operand's stage (LM == LN)
constexpr int LSCR = LN + 8;    // row stride of the epilogue's fp32 tile
enum { EPI_RELU = 0, EPI_F32 = 1, EPI_MASK = 2 };

struct LayerGemm {
  const bf16 *x, *w, *m;
  bf16* y;
  float* f;
  long long points, ldx, ldm, ldy;
  int k, ldw, n, ldf, nmask, e0, e1, eadd, n_tiles;
};

inline size_t layer_gemm_smem() {
  return (size_t)LSTAGES * 2 * LTILE * 2 + 1024;
}

template <int EPI>
__global__ void __launch_bounds__(NTHREADS, 2)
layer_gemm(const LayerGemm p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  bf16* As = reinterpret_cast<bf16*>(smem);  // [LSTAGES][LM rows][LK]
  bf16* Bs = As + LSTAGES * LTILE;           // [LSTAGES][LN rows][LK]
  const long long m0 = (long long)(blockIdx.x / p.n_tiles) * LM;
  const int n0 = (blockIdx.x % p.n_tiles) * LN;
  const int nk = (p.k + LK - 1) / LK;
  const int tid = threadIdx.x, wg = tid >> 7;
  // this thread's 16-byte pieces of a stage: piece pc of rows tid / 8 +
  // 32 i of the X and W tiles
  constexpr int PIECES = LM * (LK / 8) / NTHREADS;
  static_assert(LM == LN && LK == 64 && PIECES * NTHREADS == LM * 8,
                "loader layout");
  const int pc = tid & 7, prow = tid >> 3;
  const bf16 *xs[PIECES], *wsrc[PIECES];
  bool xok[PIECES], wok[PIECES];
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int row = prow + i * (NTHREADS / 8);
    xok[i] = m0 + row < p.points;
    wok[i] = n0 + row < p.n;
    xs[i] = p.x + (xok[i] ? (m0 + row) * p.ldx : 0) + pc * 8;
    wsrc[i] = p.w + (wok[i] ? (size_t)(n0 + row) * p.ldw : 0) + pc * 8;
  }
  auto load = [&](int kt) {
    const int st = kt % LSTAGES, k0 = kt * LK;
    const bool kok = k0 + pc * 8 < p.k;
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int off = st * LTILE + sw128(prow + i * (NTHREADS / 8), pc);
      cp_async16(As + off, xs[i] + k0, xok[i] && kok);
      cp_async16(Bs + off, wsrc[i] + k0, wok[i] && kok);
    }
  };
  const bool on = m0 + wg * 64 < p.points;  // this warpgroup's 64 rows
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int st = 0; st < LSTAGES - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<LSTAGES - 2>();
    fence_async_shared();
    __syncthreads();  // stage kt arrived; every product of stage kt - 1 done
    if (kt + LSTAGES - 1 < nk) load(kt + LSTAGES - 1);
    cp_async_commit();
    if (on) {
      const bf16* a = As + (kt % LSTAGES) * LTILE + wg * 64 * LK;
      const bf16* b = Bs + (kt % LSTAGES) * LTILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < LK / 16; ++kk)
        if (kt * LK + kk * 16 < p.k)
          wgmma_m64n128k16<0, 0>(acc, sw128_desc(a + kk * 16, 16, 1024),
                                 sw128_desc(b + kk * 16, 16, 1024));
      wgmma_commit();
      wgmma_wait_all(acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring becomes the epilogue's fp32 tile [LM][LSCR]
  float* tile = reinterpret_cast<float*>(smem);
  if (on) {
    const int r0 = wg * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
    const int c0 = (tid & 3) * 2;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = r0 + ((i >> 1) & 1) * 8, c = c0 + (i >> 2) * 8;
      *reinterpret_cast<float2*>(tile + r * LSCR + c) =
          make_float2(acc[i], acc[i + 1]);
    }
  }
  __syncthreads();
  // a thread takes 8 consecutive columns of a row: one 16-byte mask load
  // and one 16-byte store
  for (int item = tid; item < LM * (LN / 8); item += NTHREADS) {
    const int row = item / (LN / 8), c8 = (item % (LN / 8)) * 8;
    const long long r = m0 + row;
    const int c = n0 + c8;
    if (r >= p.points || c >= p.n) continue;
    float v[8];
    *reinterpret_cast<float4*>(v) =
        *reinterpret_cast<const float4*>(tile + row * LSCR + c8);
    *reinterpret_cast<float4*>(v + 4) =
        *reinterpret_cast<const float4*>(tile + row * LSCR + c8 + 4);
    if (EPI == EPI_F32 && c + 8 <= p.n && p.ldf % 4 == 0) {
      float4* f = reinterpret_cast<float4*>(p.f + r * p.ldf + c);
      f[0] = make_float4(v[0], v[1], v[2], v[3]);
      f[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else if (EPI == EPI_F32) {  // a ragged last group or row stride
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (c + t < p.n) p.f[r * p.ldf + c + t] = v[t];
    } else if (EPI == EPI_RELU || c < p.nmask) {
      uint4 mk = make_uint4(0, 0, 0, 0);
      if (EPI == EPI_MASK)
        mk = *reinterpret_cast<const uint4*>(p.m + r * p.ldm + c);
      const bf16* mb = reinterpret_cast<const bf16*>(&mk);
      uint4 out;
      bf16* ob = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        ob[t] = __float2bfloat16(
            EPI == EPI_RELU ? fmaxf(v[t], 0.0f)
                            : (__bfloat162float(mb[t]) > 0.0f ? v[t] : 0.0f));
      *reinterpret_cast<uint4*>(p.y + r * p.ldy + c) = out;
    } else {  // the CP columns' sums
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (c + t < p.e0 || c + t >= p.e1) continue;
        float* e = p.f + r * p.ldf + c + t - p.e0;
        *e = p.eadd ? *e + v[t] : v[t];
      }
    }
  }
}

template <int EPI>
int launch_layer(LayerGemm g, cudaStream_t stream) {
  g.n_tiles = (g.n + LN - 1) / LN;
  const long long m_tiles = (g.points + LM - 1) / LM;
  return launch_checked((const void*)layer_gemm<EPI>,
                        (int)(m_tiles * g.n_tiles), layer_gemm_smem(), stream,
                        &g);
}

// The trunk's forward over P points (4 bias-free layers, skip at layer 2):
// A1 = relu(h_in W0^T) into a1 [P, H]; A2 = relu(A1 W1^T) into xb's first
// H columns, beside h_in, so that layer 2 reads one [A2 | h_in] row; A3 =
// relu([A2 | h_in] W2^T) into a3 [P, H]; F = A3 W3^T into f [P, 16] fp32.
// Weights bf16 [out, in] padded: w0 [H, KIN], w1 [H, H], w2 [H, H+KIN],
// w3 [16, H].  Returns 0 or a cudaError_t code.
inline int launch_trunk_forward(long long P, int H, int KIN, const bf16* w0,
                                const bf16* w1, const bf16* w2,
                                const bf16* w3, bf16* xb, bf16* a1, bf16* a3,
                                float* f, cudaStream_t st) {
  int rc;
  LayerGemm g = {};
  g.points = P;
  g.x = xb + H; g.ldx = H + KIN; g.k = KIN; g.w = w0; g.ldw = KIN;
  g.n = H; g.y = a1; g.ldy = H;
  if ((rc = launch_layer<EPI_RELU>(g, st))) return rc;
  g.x = a1; g.ldx = H; g.k = H; g.w = w1; g.ldw = H;
  g.y = xb; g.ldy = H + KIN;
  if ((rc = launch_layer<EPI_RELU>(g, st))) return rc;
  g.x = xb; g.ldx = H + KIN; g.k = H + KIN; g.w = w2; g.ldw = H + KIN;
  g.y = a3; g.ldy = H;
  if ((rc = launch_layer<EPI_RELU>(g, st))) return rc;
  g.x = a3; g.ldx = H; g.k = H; g.w = w3; g.ldw = H; g.n = OUT;
  g.f = f; g.ldf = OUT;
  return launch_layer<EPI_F32>(g, st);
}

}  // namespace sanerf
