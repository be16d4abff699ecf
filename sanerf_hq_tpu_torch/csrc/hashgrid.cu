// Multiresolution hash-grid encoder for NVIDIA Hopper (sm_90a): K11, one
// gather kernel forward and one scatter kernel backward.  Bound to Python
// through ctypes (sanerf_hq_tpu_torch/ops/hashgrid.py `hash_encode_cuda`,
// a torch.autograd.Function); plain C interface, no PyTorch headers.
//
// Replaces no TPU kernel: the JAX package's encoder
// (sanerf_hq_tpu/ops/hashgrid.py hash_encode_unit) is XLA, a gather and a
// scatter-add that XLA fuses with the hash arithmetic.  The port's plain
// PyTorch version of it (`hash_encode_unit`, its twin, kept for CPU
// tensors) runs that arithmetic as int64 tensors of [levels, 8 corners, B]
// through a chain of aten kernels, and its backward is `index_add_`: it
// filled most of a hash-grid training step.
//
// Computes what the twin computes, per point b and level l below the
// active count: u = (x + bound) * (1 / (2 bound)) (aten's division by a
// scalar on the card), zero output and zero gradient where u leaves
// [0, 1] on some axis, else on u clamped to [0, 1]:
//   pos = min(max(u R - 0.5, 0), R - 1), lower corner floor(pos)
//   (align_corners: pos = u (R - 1), lower corner min(floor(pos), R - 2));
//   frac = pos - corner, smoothstep frac^2 (3 - 2 frac) where asked;
//   the 8 corners (bit d of a corner's number picks the upper neighbour
//   min(lo + 1, R - 1) along axis d), each a table row: the spatial hash
//   c0 ^ c1 * 2654435761 ^ c2 * 805459861 or the dense strides, in uint32,
//   mod the level's size plus its offset (packed: the lower corner's row
//   holds all 8 corners, corner k at columns k C ... k C + C - 1);
//   weight w_k = w_x * w_y * w_z in axis order (f or 1 - f);
//   out = sum over k = 0..7 in order of w_k * row_k, each product and sum
//   rounded on its own (no FMA: the __f*_rn intrinsics throughout), so
//   positions and rows equal the twin's bit for bit.
// Levels at or above max_level write zeros and take no gradient.
//
// Design: one thread per (point, level), the level on the grid's y axis,
// so a warp's 32 points share one level's table region and neighbouring
// samples of a ray fall in neighbouring cells.  The level constants come
// by value in a struct of at most 16 levels (no copy to the device).  A
// corner row is one vector load (float2 at C = 2, two float4 at C = 8) and
// the output one vector store.  The backward recomputes the corners from
// x and scatters w_k * dL/dout into a dense fp32 gradient of the table's
// shape (what index_add_ writes) with vector fp32 atomics (float2 and
// float4 atomicAdd exist on sm_90).  A level whose rows fit in
// SHARED_BYTES (level 0 at R = 16 and C = 2: 4096 rows, 32 KB) is hit by
// every point over few rows: its CTAs take SPAN x 256 points each, sum
// their grads with shared-memory atomics and add each non-zero sum to
// device memory once.  Hashed and large levels scatter straight to device
// memory.  What bounds it on this card: bytes.  Forward, the points
// (12 B), the output (4 C B a level) and the rows the points touch;
// backward, the points, dL/dout, and the touched rows read and written
// by the atomics (the gradient's memset is its own aten launch).
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_LEVELS = 16;

// Must match `HashLevels` in ops/hashgrid.py field for field.  Outside the
// unnamed namespace: the C launch functions take it, and a type with
// internal linkage would give them internal linkage too.
struct HashLevels {
  int res[MAX_LEVELS];
  unsigned offset[MAX_LEVELS];
  unsigned size[MAX_LEVELS];
  unsigned stride[MAX_LEVELS][3];  // dense strides, 0 past the early stop
  int use_hash[MAX_LEVELS];
  int shared[MAX_LEVELS];  // backward sums this level in shared memory
};

namespace {

constexpr int THREADS = 256;
constexpr size_t SHARED_BYTES = 32768;  // ops/hashgrid.py SHARED_BYTES
constexpr int SPAN = 8;  // blocks of a shared-memory level: SPAN x THREADS points
constexpr unsigned PRIME1 = 2654435761u, PRIME2 = 805459861u;

struct HashArgs {
  long long points;
  int levels;  // output levels L
  int active;  // levels below max_level
  float bound;
  float inv_extent;  // fp32 1 / (2 bound)
  int align_corners;
  int smoothstep;
};

struct Cell {
  unsigned lo[3], hi[3];
  float f[3];
};

// Unit coordinates of point x, clamped; true where x leaves the cube.
__device__ __forceinline__ bool unit_coords(const float* __restrict__ x,
                                            const HashArgs& a, float u[3]) {
  bool oob = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float v = __fmul_rn(__fadd_rn(x[d], a.bound), a.inv_extent);
    oob |= (v < 0.0f) | (v > 1.0f);
    u[d] = fminf(fmaxf(v, 0.0f), 1.0f);
  }
  return oob;
}

__device__ __forceinline__ void level_cell(const float u[3], int res,
                                           const HashArgs& a, Cell& c) {
  const float rf = (float)res;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float pos, g;
    if (a.align_corners) {
      pos = __fmul_rn(u[d], __fsub_rn(rf, 1.0f));
      g = fminf(floorf(pos), __fsub_rn(rf, 2.0f));
    } else {
      pos = fminf(fmaxf(__fsub_rn(__fmul_rn(u[d], rf), 0.5f), 0.0f),
                  __fsub_rn(rf, 1.0f));
      g = floorf(pos);
    }
    float f = __fsub_rn(pos, g);
    if (a.smoothstep)
      f = __fmul_rn(__fmul_rn(f, f), __fsub_rn(3.0f, __fmul_rn(2.0f, f)));
    const int lo = (int)g;
    c.lo[d] = (unsigned)lo;
    c.hi[d] = (unsigned)min(lo + 1, res - 1);
    c.f[d] = f;
  }
}

__device__ __forceinline__ unsigned grid_row(unsigned c0, unsigned c1,
                                             unsigned c2,
                                             const HashLevels& lv, int l) {
  const unsigned idx =
      lv.use_hash[l] ? (c0 ^ (c1 * PRIME1) ^ (c2 * PRIME2))
                     : c0 * lv.stride[l][0] + c1 * lv.stride[l][1] +
                           c2 * lv.stride[l][2];
  return idx % lv.size[l] + lv.offset[l];
}

__device__ __forceinline__ float corner_weight(const Cell& c, int k) {
  float w = (k & 1) ? c.f[0] : __fsub_rn(1.0f, c.f[0]);
  w = __fmul_rn(w, (k & 2) ? c.f[1] : __fsub_rn(1.0f, c.f[1]));
  return __fmul_rn(w, (k & 4) ? c.f[2] : __fsub_rn(1.0f, c.f[2]));
}

// Row of corner k: non-packed, the corner's own row; packed, the lower
// corner's row (the caller adds k C).
template <bool PACKED>
__device__ __forceinline__ unsigned corner_row(const Cell& c, int k,
                                               const HashLevels& lv, int l) {
  if (PACKED) return grid_row(c.lo[0], c.lo[1], c.lo[2], lv, l);
  return grid_row((k & 1) ? c.hi[0] : c.lo[0], (k & 2) ? c.hi[1] : c.lo[1],
                  (k & 4) ? c.hi[2] : c.lo[2], lv, l);
}

template <int C>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float v[C]) {
  if constexpr (C == 1) {
    v[0] = __ldg(p);
  } else if constexpr (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  }
}

template <int C>
__device__ __forceinline__ void store_vec(float* p, const float v[C]) {
  if constexpr (C == 1) {
    p[0] = v[0];
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

template <int C>
__device__ __forceinline__ void atomic_add_vec(float* p, const float v[C]) {
#if !defined(__CUDA_ARCH__) || __CUDA_ARCH__ < 900
#pragma unroll
  for (int c = 0; c < C; ++c) atomicAdd(p + c, v[c]);  // not built: sm_90a only
#else
  if constexpr (C == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < C; i += 4)
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  }
#endif
}

// rows_out [active, R, points] (R = 8, packed 1) and frac_out [active,
// points, 3], where not null: the corners' rows and the fractions, for the
// card test to hold against the twin's.
template <int C, bool PACKED>
__global__ void __launch_bounds__(THREADS)
hash_encode_fwd(const float* __restrict__ x, const float* __restrict__ table,
                float* __restrict__ out, int* __restrict__ rows_out,
                float* __restrict__ frac_out, HashArgs a, HashLevels lv) {
  constexpr int ROW = PACKED ? 8 * C : C;
  const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int l = blockIdx.y;
  if (b >= a.points) return;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  if (l < a.active) {
    float u[3];
    const bool oob = unit_coords(x + 3 * b, a, u);
    Cell cell;
    level_cell(u, lv.res[l], a, cell);
    if (frac_out != nullptr) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        frac_out[((long long)l * a.points + b) * 3 + d] = cell.f[d];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned row = corner_row<PACKED>(cell, k, lv, l);
      if (rows_out != nullptr && (!PACKED || k == 0))
        rows_out[((long long)l * (PACKED ? 1 : 8) + k) * a.points + b] =
            (int)row;
      const float w = corner_weight(cell, k);
      float v[C];
      load_vec<C>(table + (size_t)row * ROW + (PACKED ? k * C : 0), v);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, v[c]));
    }
    if (oob) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    }
  }
  store_vec<C>(out + b * ((long long)a.levels * C) + l * C, acc);
}

// Adds point b's grads at level l: into `dst` indexed by global row
// (device memory, vector atomics) or, with SHARED, into the level's slab
// in shared memory (row minus the level's offset, scalar atomics).
template <int C, bool PACKED, bool SHARED>
__device__ __forceinline__ void scatter_point(
    long long b, int l, const float* __restrict__ x,
    const float* __restrict__ grad_out, float* dst, const HashArgs& a,
    const HashLevels& lv) {
  constexpr int ROW = PACKED ? 8 * C : C;
  float u[3];
  if (unit_coords(x + 3 * b, a, u)) return;  // zero gradient outside
  float g[C];
  load_vec<C>(grad_out + b * ((long long)a.levels * C) + l * C, g);
  Cell cell;
  level_cell(u, lv.res[l], a, cell);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned row = corner_row<PACKED>(cell, k, lv, l);
    const float w = corner_weight(cell, k);
    float p[C];
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = __fmul_rn(w, g[c]);
    const size_t at = (size_t)(SHARED ? row - lv.offset[l] : row) * ROW +
                      (PACKED ? k * C : 0);
    if (SHARED) {
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(dst + at + c, p[c]);
    } else {
      atomic_add_vec<C>(dst + at, p);
    }
  }
}

template <int C, bool PACKED>
__global__ void __launch_bounds__(THREADS)
hash_encode_bwd(const float* __restrict__ x,
                const float* __restrict__ grad_out, float* grad_table,
                HashArgs a, HashLevels lv) {
  constexpr int ROW = PACKED ? 8 * C : C;
  extern __shared__ float slab[];
  const int l = blockIdx.y;
  if (lv.shared[l]) {
    const long long first = (long long)blockIdx.x * (THREADS * SPAN);
    if (first >= a.points) return;  // uniform over the CTA
    const long long last = min(first + THREADS * SPAN, a.points);
    const int n = (int)lv.size[l] * ROW;
    for (int i = threadIdx.x; i < n; i += THREADS) slab[i] = 0.0f;
    __syncthreads();
    for (long long b = first + threadIdx.x; b < last; b += THREADS)
      scatter_point<C, PACKED, true>(b, l, x, grad_out, slab, a, lv);
    __syncthreads();
    float* g = grad_table + (size_t)lv.offset[l] * ROW;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const float v = slab[i];
      if (v != 0.0f) atomicAdd(g + i, v);
    }
    return;
  }
  const long long b = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (b >= a.points) return;
  scatter_point<C, PACKED, false>(b, l, x, grad_out, grad_table, a, lv);
}

HashArgs make_args(long long points, int levels, int active, float bound,
                   float inv_extent, int align_corners, int smoothstep) {
  HashArgs a;
  a.points = points;
  a.levels = levels;
  a.active = active;
  a.bound = bound;
  a.inv_extent = inv_extent;
  a.align_corners = align_corners;
  a.smoothstep = smoothstep;
  return a;
}

template <int C, bool PACKED>
int launch_fwd(const float* x, const float* table, float* out, int* rows_out,
               float* frac_out, const HashArgs& a, const HashLevels& lv,
               cudaStream_t stream) {
  const dim3 grid((unsigned)((a.points + THREADS - 1) / THREADS), a.levels);
  hash_encode_fwd<C, PACKED>
      <<<grid, THREADS, 0, stream>>>(x, table, out, rows_out, frac_out, a, lv);
  return (int)cudaGetLastError();
}

template <int C, bool PACKED>
int launch_bwd(const float* x, const float* grad_out, float* grad_table,
               const HashArgs& a, const HashLevels& lv, cudaStream_t stream) {
  constexpr int ROW = PACKED ? 8 * C : C;
  size_t smem = 0;
  for (int l = 0; l < a.active; ++l)
    if (lv.shared[l]) {
      const size_t bytes = (size_t)lv.size[l] * ROW * sizeof(float);
      smem = bytes > smem ? bytes : smem;
    }
  if (smem > SHARED_BYTES) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a.points + THREADS - 1) / THREADS), a.active);
  hash_encode_bwd<C, PACKED>
      <<<grid, THREADS, smem, stream>>>(x, grad_out, grad_table, a, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [points, 3] world coordinates, table [rows, row_dim], out [points,
// levels * level_dim]; all fp32, contiguous, 16-byte aligned.  rows_out and
// frac_out may be null.  Returns 0 or a cudaError_t code.
int sanerf_hash_encode_fwd(const float* x, const float* table, float* out,
                           int* rows_out, float* frac_out, long long points,
                           int levels, int active, int level_dim, int packed,
                           float bound, float inv_extent, int align_corners,
                           int smoothstep, const HashLevels* lv,
                           void* stream) {
  if (points == 0) return 0;
  if (levels < 1 || levels > MAX_LEVELS || active < 0 || active > levels)
    return (int)cudaErrorInvalidValue;
  const HashArgs a = make_args(points, levels, active, bound, inv_extent,
                               align_corners, smoothstep);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (level_dim * 2 + (packed ? 1 : 0)) {
    case 2: return launch_fwd<1, false>(x, table, out, rows_out, frac_out, a, *lv, s);
    case 3: return launch_fwd<1, true>(x, table, out, rows_out, frac_out, a, *lv, s);
    case 4: return launch_fwd<2, false>(x, table, out, rows_out, frac_out, a, *lv, s);
    case 5: return launch_fwd<2, true>(x, table, out, rows_out, frac_out, a, *lv, s);
    case 8: return launch_fwd<4, false>(x, table, out, rows_out, frac_out, a, *lv, s);
    case 9: return launch_fwd<4, true>(x, table, out, rows_out, frac_out, a, *lv, s);
    case 16: return launch_fwd<8, false>(x, table, out, rows_out, frac_out, a, *lv, s);
    case 17: return launch_fwd<8, true>(x, table, out, rows_out, frac_out, a, *lv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// grad_out [points, levels * level_dim]; grad_table [rows, row_dim],
// zeroed by the caller.  The same constants as the forward.
int sanerf_hash_encode_bwd(const float* x, const float* grad_out,
                           float* grad_table, long long points, int levels,
                           int active, int level_dim, int packed, float bound,
                           float inv_extent, int align_corners, int smoothstep,
                           const HashLevels* lv, void* stream) {
  if (points == 0 || active == 0) return 0;
  if (levels < 1 || levels > MAX_LEVELS || active < 0 || active > levels)
    return (int)cudaErrorInvalidValue;
  const HashArgs a = make_args(points, levels, active, bound, inv_extent,
                               align_corners, smoothstep);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (level_dim * 2 + (packed ? 1 : 0)) {
    case 2: return launch_bwd<1, false>(x, grad_out, grad_table, a, *lv, s);
    case 3: return launch_bwd<1, true>(x, grad_out, grad_table, a, *lv, s);
    case 4: return launch_bwd<2, false>(x, grad_out, grad_table, a, *lv, s);
    case 5: return launch_bwd<2, true>(x, grad_out, grad_table, a, *lv, s);
    case 8: return launch_bwd<4, false>(x, grad_out, grad_table, a, *lv, s);
    case 9: return launch_bwd<4, true>(x, grad_out, grad_table, a, *lv, s);
    case 16: return launch_bwd<8, false>(x, grad_out, grad_table, a, *lv, s);
    case 17: return launch_bwd<8, true>(x, grad_out, grad_table, a, *lv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sanerf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
