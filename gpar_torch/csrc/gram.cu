// Fused composite-kernel Gram matrix for Hopper (sm_90a): the forward kernel
// and, further down, its backward (the vector-Jacobian product), built into
// one library by gpar_torch/ops/_build.py.
//
// The forward replaces the Pallas TPU kernel of the JAX package:
// gpar_tpu/ops/pallas_gram.py, _gram_kernel_body (launched by
// _gram_pallas_call).  Same function, per output element:
//
//   K[i, j] = sum_t w_t * g_t(d2_t(i, j)) + sum_lin w_t * <u_t(i), v_t(j)> + const
//
// with g = exp(-d2/2) for "rbf" terms and exp(-alpha * log1p(d2 / (2 alpha)))
// for "rq" terms.  u_t / v_t are the per-term feature maps (stretch,
// periodic embedding, select and gate already folded in on the host side,
// gpar_torch/ops/gram_kernel.py), concatenated column-wise into xf (n, D)
// and yf (m, D) at their true widths, D padded with zeros to a multiple of 4.
//
// Squared distances are computed directly as sum_k (u_k - v_k)^2, not by the
// norm identity |u|^2 + |v|^2 - 2 u.v the TPU kernel uses to feed its matrix
// unit.  Every term is at most 128 wide (on the main path 1 to 15), so the
// identity saves nothing on CUDA cores, and the direct form has no
// cancellation: in float32 the identity loses ~eps * |u|^2 absolute in d2,
// ~3e-4 at the main path's input scale (|u| ~ 50), while the direct form is
// accurate to a few ulps of d2 and needs no clamp at zero.  No tensor cores:
// TF32 would break the float32 accuracy the fit relies on.
//
// What bounds it on an H100: the output write, n * m * sizeof(T) bytes at
// 3.35 TB/s; the function's n * m * (2 * sum d_t + 4 T + 1) operations at
// 67 TFLOP/s are below that at every main-path width (sum d <= 31).  The
// direct form issues 2 instructions per feature and output (a subtraction
// and a fused multiply-add, where the norm identity needs one) plus an
// accurate exp per rbf term, so at the widest layer its own arithmetic,
// not the write, sets its floor.  The design keeps the memory system busy:
// - one block of 256 threads owns a 32 x (32 * VEC) output tile (32 x 128 in
//   float, 32 x 64 in double); each warp writes whole rows of it with 16-byte
//   stores, 512 contiguous bytes per instruction, 4 rows per thread; the
//   small tile keeps registers low enough for three blocks on an SM, so one
//   block's staging overlaps another's arithmetic, and gives 632 blocks at
//   256 x 10 000 (4.8 per SM), which balances the SMs;
// - all terms' features of the tile (D <= KC features; wider trees are
//   staged in chunks of KC) are staged in one pass behind one barrier: rows
//   are read as 16-byte vectors (hence D padded to a multiple of 4) and
//   stored feature-major, so that the compute loop reads a warp's 128
//   columns as one conflict-free 512-byte shared load and its 4 rows as
//   one broadcast.  A 16-byte cp.async cannot transpose, and the row-major
//   layout it would give costs 4-way bank conflicts in the inner loop;
// - staging indices are compile-time shifts (row fastest), no divides;
// - the inner feature loop is unrolled by 4; a term that ends inside a
//   chunk applies its tail there, one that crosses a chunk keeps its partial
//   distances in registers.
// exp / log1p are the accurate versions (no fast-math).  Ragged edges load
// zeros and are masked on the write.
//
// A leading batch axis (the JAX package vmaps the Gram over Monte-Carlo
// samples, which gives its pallas_call a batch grid axis): one launch
// computes `batch` Grams, blockIdx.z running over them, each element's
// operands sx / sy elements apart and a stride of 0 for an operand all
// elements share (the inducing inputs, the training rows).  The tiles and
// their arithmetic are the 2-D kernel's; the grid only grows by the batch.
// The parameter vector has a stride of its own, sp: 0 shares one vector
// (the sample axis of the serving tails), 2T + 1 gives every element its
// own (the JAX package vmaps the fit's objective over restarts and layers,
// which batches its pallas_call's params block too).

#include <cuda_runtime.h>
#include <stdint.h>

// A launch takes a tree of at most GPAR_GRAM_MAX_TERMS terms.  Term t reads
// the feature columns [off[t], off[t] + dim[t]) of xf (n, D) and yf (m, D);
// the wrapper pads D to a multiple of 4 with zero columns that belong to no
// term.  par = [w_0 .. w_{T-1}, alpha_0 .. alpha_{T-1}, const].

#define GPAR_GRAM_MAX_TERMS 32
#define GPAR_THREADS 256

enum { KIND_RBF = 0, KIND_RQ = 1, KIND_LIN = 2 };

struct TermSpec {
  int n_terms;
  int kind[GPAR_GRAM_MAX_TERMS];
  int off[GPAR_GRAM_MAX_TERMS];
  int dim[GPAR_GRAM_MAX_TERMS];
};

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_log1p(float v) { return log1pf(v); }
__device__ __forceinline__ double dev_log1p(double v) { return log1p(v); }

// Four consecutive elements of a 16-byte-aligned address (a float4, or two
// double2), through the read-only path.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
// The same from shared memory (no read-only path there).
__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void lds4(const double* p, double* v) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

static inline bool fill_spec(TermSpec& spec, int n_terms, const int* kinds,
                             const int* offs, const int* dims, int D) {
  if (n_terms < 1 || n_terms > GPAR_GRAM_MAX_TERMS) return false;
  spec.n_terms = n_terms;
  for (int t = 0; t < n_terms; ++t) {
    if (kinds[t] < KIND_RBF || kinds[t] > KIND_LIN || dims[t] < 1 || offs[t] < 0 ||
        offs[t] + dims[t] > D)
      return false;
    spec.kind[t] = kinds[t];
    spec.off[t] = offs[t];
    spec.dim[t] = dims[t];
  }
  return true;
}

template <typename T>
struct FwdCfg {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte access
  static constexpr int BC = 32 * VEC;         // columns per block: a warp-wide row
  static constexpr int BR = 32;               // rows per block
  static constexpr int RT = BR / (GPAR_THREADS / 32);  // rows per thread
  static constexpr int KC = sizeof(T) == 4 ? 64 : 32;  // features staged at once
  static constexpr size_t smem(int kw) { return (size_t)kw * (BR + BC) * sizeof(T); }
};

__device__ __forceinline__ void ldsv(const float* p, float* v) { lds4(p, v); }
__device__ __forceinline__ void ldsv(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void ldgv(const float* p, float* v) { load4(p, v); }
__device__ __forceinline__ void ldgv(const double* p, double* v) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void stgv(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void stgv(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

template <typename T>
__global__ void __launch_bounds__(GPAR_THREADS, 3)
gram_tile_kernel(const T* __restrict__ xf, const T* __restrict__ yf,
                 const T* __restrict__ par, T* __restrict__ out, int n, int m,
                 int D, int Dt, long long sx, long long sy, long long sp, TermSpec spec) {
  using C = FwdCfg<T>;
  constexpr int VEC = C::VEC, BC = C::BC, BR = C::BR, RT = C::RT, KC = C::KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // blockIdx.z is the batch element: its operands sit sx / sy elements
  // apart and its parameters sp (0 for what every element shares), its
  // Gram n * m apart.
  xf += blockIdx.z * sx;
  yf += blockIdx.z * sy;
  par += blockIdx.z * sp;
  out += (size_t)blockIdx.z * n * m;
  T* xT = reinterpret_cast<T*>(smem_raw);  // [kw][BR], feature-major
  T* yT = xT + min(D, KC) * BR;            // [kw][BC]

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = blockIdx.y * BR;
  const int col0 = blockIdx.x * BC;

  T acc[RT][VEC], s[RT][VEC];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[a][c] = s[a][c] = T(0);

  int t = 0;
  for (int kc = 0; kc < Dt; kc += KC) {
    const int kw = min(KC, D - kc);  // a multiple of 4, hence of VEC
    if (kc > 0) __syncthreads();     // the previous chunk's readers are done
    const int qn = kw / VEC;
    for (int e = tid; e < qn * BR; e += GPAR_THREADS) {
      const int r = e % BR, q = e / BR;
      T v[VEC];
      if (row0 + r < n) {
        ldgv(xf + (size_t)(row0 + r) * D + kc + q * VEC, v);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) v[c] = T(0);
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) xT[(q * VEC + c) * BR + r] = v[c];
    }
    for (int e = tid; e < qn * BC; e += GPAR_THREADS) {
      const int r = e % BC, q = e / BC;
      T v[VEC];
      if (col0 + r < m) {
        ldgv(yf + (size_t)(col0 + r) * D + kc + q * VEC, v);
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c) v[c] = T(0);
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c) yT[(q * VEC + c) * BC + r] = v[c];
    }
    __syncthreads();

    // The terms that overlap features [kc, kc + kw).
    while (t < spec.n_terms && spec.off[t] < kc + kw) {
      const int t_end = spec.off[t] + spec.dim[t];
      const int ka = max(spec.off[t], kc) - kc;
      const int kb = min(t_end, kc + kw) - kc;
      if (spec.kind[t] == KIND_LIN) {
#pragma unroll 4
        for (int k = ka; k < kb; ++k) {
          T a[RT], b[VEC];
#pragma unroll
          for (int h = 0; h < RT; h += VEC) ldsv(xT + k * BR + RT * ty + h, a + h);
          ldsv(yT + k * BC + VEC * tx, b);
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < VEC; ++j) s[i][j] += a[i] * b[j];
        }
      } else {
#pragma unroll 4
        for (int k = ka; k < kb; ++k) {
          T a[RT], b[VEC];
#pragma unroll
          for (int h = 0; h < RT; h += VEC) ldsv(xT + k * BR + RT * ty + h, a + h);
          ldsv(yT + k * BC + VEC * tx, b);
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              const T diff = a[i] - b[j];
              s[i][j] += diff * diff;
            }
        }
      }
      if (t_end > kc + kw) break;  // the term goes on in the next chunk

      const T w = par[t];
      const int kind = spec.kind[t];
      if (kind == KIND_LIN) {
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[i][j] += w * s[i][j];
      } else if (kind == KIND_RBF) {
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[i][j] += w * dev_exp(T(-0.5) * s[i][j]);
      } else {
        const T alpha = par[spec.n_terms + t];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[i][j] += w * dev_exp(-alpha * dev_log1p(s[i][j] / (T(2) * alpha)));
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[i][j] = T(0);
      ++t;
    }
  }

  const T cst = par[2 * spec.n_terms];
  const int c = col0 + VEC * tx;
  const bool vec_ok = (m % VEC == 0) && c + VEC <= m;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + RT * ty + i;
    if (r >= n) break;
    T v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = acc[i][j] + cst;
    T* dst = out + (size_t)r * m + c;
    if (vec_ok) {
      stgv(dst, v);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (c + j < m) dst[j] = v[j];
    }
  }
}

template <typename T>
static int launch(const void* xf, const void* yf, const void* par, void* out,
                  int batch, int n, int m, int D, long long sx, long long sy, long long sp,
                  int n_terms, const int* kinds, const int* offs, const int* dims,
                  void* stream) {
  using C = FwdCfg<T>;
  TermSpec spec;
  if (batch < 1 || n < 1 || m < 1 || D % 4 != 0 || sx < 0 || sy < 0 ||
      (sp != 0 && sp != 2 * n_terms + 1) ||
      !fill_spec(spec, n_terms, kinds, offs, dims, D))
    return (int)cudaErrorInvalidValue;
  // Rows load as 16-byte vectors, so every element's operands must stay
  // 16-byte aligned: the strides are whole rows of D (a multiple of 4).
  if (sx % D != 0 || sy % D != 0) return (int)cudaErrorInvalidValue;
  // The chunk walk needs the terms in order and back to back from column 0.
  for (int t = 0; t < n_terms; ++t)
    if (offs[t] != (t == 0 ? 0 : offs[t - 1] + dims[t - 1])) return (int)cudaErrorInvalidValue;
  const int Dt = offs[n_terms - 1] + dims[n_terms - 1];
  dim3 grid((m + C::BC - 1) / C::BC, (n + C::BR - 1) / C::BR, batch);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = C::smem(D < C::KC ? D : C::KC);  // at most 48 KB
  gram_tile_kernel<T><<<grid, GPAR_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)xf, (const T*)yf, (const T*)par, (T*)out, n, m, D, Dt, sx, sy, sp, spec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward.
//
// The JAX package has no kernel for this: its custom VJP
// (gpar_tpu/ops/pallas_gram.py, _fwd/_bwd of gram_fused) takes jax.vjp of
// the plain recursion gram_eval and leaves it to XLA.  Given the upstream
// gradient G (n, m) of the forward above, this computes the
// vector-Jacobian product with respect to the prepared features and
// parameters.  Per term t with features u (n, d), v (m, d), weight w and
// s_ij = sum_k (u_ik - v_jk)^2:
//
//   rbf: e = exp(-s/2),  P = -(w/2) G e,  dw = sum G e
//   rq:  r = 1 + s/(2a), P = -(w/2) G r^(-a-1),  dw = sum G r^(-a),
//        da = sum G w r^(-a) (s/(2a r) - log r)
//   rbf and rq: du_ik = 2 sum_j P_ij (u_ik - v_jk), dv_jk = -2 sum_i P_ij (u_ik - v_jk)
//   lin: du = w G v, dv = w G^T u, dw = sum G (u v^T)
//   and dc = sum G for the constant.
// The differences are formed directly, as in the forward.  The norm
// identity du_ik = 2 (u_ik sum_j P_ij - sum_j P_ij v_jk) would save the
// subtraction, but at the main path's input scale (|u| ~ 50, distances of
// a few length scales) its two sums cancel to 1 part in ~50 and, summed over
// 10 000 columns in float32, would lose the 1e-4 the fit's gradient is
// held to; the direct form loses nothing.
//
// Design.  Terms are independent in the backward, so the grid is
// (column tiles, row splits, terms): a block owns BC columns of one term
// (128 in float, 64 in double) and walks the rows of its split in steps of
// BR rows.  A thread owns a register tile of R rows by VEC columns of the
// step: its warp covers R rows by all BC columns, the 8 warps the step's BR
// rows.  There are two tiles: the big one (R = 8, BR = 64 in float; R = 4,
// BR = 32 in double) and a small one (R = 2, BR = 16) for grids where the
// big one, at one step per split, would leave more than half the SMs idle
// (at 256 x 256: 24 blocks, the small one 96): there a block's latency, not
// the work, sets the time.
// Per step
// it stages the step's u rows, loads its G tile with 16-byte loads (a warp
// reads whole 512-byte row segments), and then
//   - forms s over the term's features from u and v in shared memory: per
//     feature one 16-byte load of v (conflict-free across the warp) and
//     R / 4 broadcast loads of u serve 2 R VEC floating-point operations;
//   - forms P in place of G, in registers;
//   - takes du and dv together, per feature with the same loads, one
//     difference and two fused multiply-adds per tile entry, one into the
//     row sums (du), one into the column sums (dv).
// dv: a lane owns its columns for the whole walk, so its column sums go
// into its own entries of its warp's accumulators in shared memory, with no
// barrier; the 8 warps' accumulators are summed, in warp order, once per
// block and written as the row split's partial.  du: the 32 lanes of a
// warp share its rows, so the row sums of a group of KG features (R KG = 16
// values per lane) are combined across the warp by a transpose-reduce in
// registers, about one shuffle per value, and written as the column tile's
// partial.  Neither map depends on the term's width: a lane owns columns,
// never features, and groups of KG, 4, 2 and 1 cover any width, so no lane
// idles at d = 17.  A wide term is taken in chunks of KC = 24 features, each
// walking the rows again (s and P are recomputed), so that the
// accumulators fit: a term of 128 features needs 197 KiB of shared memory
// in float (202 KiB in double), past the default 48 KB; the opt-in to that
// much is made once, when the library is loaded (gpar_gram_init), not at a
// launch: a launch may be captured into a CUDA graph, and a capture should
// hold stream work only.
// The wrapper's plan (gram_kernel._bwd_plan) picks the tile and splits rows
// in whole steps until the SMs hold at least 3 blocks each and the busiest
// holds at most 1.2 times the mean (at 256 x 11 840 with three terms: the
// big tile, 2 splits, 558 blocks, 4.23 per SM, 5 on the busiest), else one
// step per split: an SM holds two big-tile blocks at a time,
// a third overlaps their loads and barriers, and every block pays for
// staging v and writing its dv partial, so more splits cost more than the
// balance they buy.  The scalar sums are reduced inside the block in a fixed
// tree.  A second kernel sums the partials in a fixed order, one lane per
// 8 partials (at most 8 lanes) per entry, combined in lane order.  There
// are no atomics: the result is the same bit for bit from call to call.
//
// A batch (the JAX package vmaps the VJP with the forward, over restarts
// and layers): g is (B, n, m), and xf, yf and par each either carry the
// batch (strides sx = n D, sy = m D, sp = 2T + 1) or are shared by every
// element (stride 0).  The grid's z runs over b T + t, so a batch fills the
// card without row splits; the partials get a batch axis, du_part (B, ct,
// n, D), dv_part (B, r, m, D) and sc_part (3, T, B, ct, r).  The reduction
// sums a batched operand's partials per element and a shared operand's
// over every element's, in the same fixed order (element, then tile or
// split): the gradient of a shared operand is the sum over the batch, with
// no atomics.  At B = 1 the launch, the plan and the bits are the 2-D ones.
//
// What bounds it on an H100: the function reads G, xf and yf once and
// writes dxf, dyf (bytes: (n m + 2 (n + m) D) sizeof(T)).  Its operations,
// per output element: 6 per feature of an rbf or rq term (s, P v and P^T u,
// each a product and a sum per feature under the norm identity) and 4 per
// feature of a lin term (G v and G^T u; dw = sum_ik u_ik (G v)_ik reuses G v),
// a tail of 4 per rbf term (exp, G e, its sum, P), 10 per rq term (h, log1p,
// exp, G r^(-a), its sum, the da summand and its sum, P) and 1 per lin term
// (P = w G), and 1 for the constant's sum.  At the widest main-path layer
// that is bound by operations at 67 TFLOP/s in float32; the one-feature
// first layer is bound by bytes.  This kernel spends 5 floating-point
// instructions per feature and tile entry of an rbf or rq term (2 in the s
// loop, 3 in the du/dv loop; 4 for a lin term) and about one shuffle, two
// selects and an add per du value: instruction throughput, not shared memory,
// is its limit.  It reads G once per term (the second and third reads
// mostly from L2).  exp / log1p are the accurate versions; no tensor cores
// (TF32 is off).

// The row tiles, in rows per thread and step: BIG_ROWS (a 64-row step in
// float, 32 in double), and SMALL_ROWS (a 16-row step) for the grids that
// the big one would leave latency-bound.
template <typename T>
struct BwdTiles {
  static constexpr int BIG_ROWS = sizeof(T) == 4 ? 8 : 4;
  static constexpr int SMALL_ROWS = 2;
};

template <typename T, int ROWS>
struct BwdCfg {
  using type = T;
  static constexpr int VEC = 16 / sizeof(T);  // columns per thread: one 16-byte vector
  static constexpr int BC = 32 * VEC;         // columns a block owns (128 float, 64 double)
  static constexpr int WARPS = GPAR_THREADS / 32;
  static constexpr int R = ROWS;              // rows per thread and step
  static constexpr int BR = WARPS * R;        // rows per step
  static constexpr int KG = 16 / R;           // features per du group, at most (R KG = 16 sums)
  static constexpr int KC = 24;               // features per chunk of the dv accumulators
  static constexpr int SV = BC + 4;           // padded stride of vT and dvw, keeps 16-byte rows
  static constexpr size_t smem(int dmax) {
    return sizeof(T) * ((size_t)dmax * (SV + BR) + (size_t)WARPS * (dmax < KC ? dmax : KC) * SV);
  }
};

__device__ __forceinline__ void stsv(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void stsv(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void lds2(const float* p, float* v) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void lds2(const double* p, double* v) { ldsv(p, v); }

// The thread's R rows of feature k of the step's u (uT is [d][BR]).
template <typename C, typename T = typename C::type>
__device__ __forceinline__ void lds_rows(const T* __restrict__ uT, int k, int wp, T (&a)[C::R]) {
  const T* p = uT + k * C::BR + C::R * wp;
  if constexpr (C::R % 4 == 0) {
#pragma unroll
    for (int h = 0; h < C::R; h += 4) lds4(p + h, a + h);
  } else {
    static_assert(C::R == 2, "rows per thread: a multiple of 4, or 2");
    lds2(p, a);
  }
}

// One stage of a transpose-reduce across the warp, then the rest: at
// shuffle distance O a lane keeps the half of its values [0, 2H) that its
// bit O selects and adds its partner's copy of that half; once one value
// is left, the remaining distances add whole sums.  The stages are
// templates so that every index into val is a compile-time constant (a
// loop over two induction variables is not unrolled, and a runtime index
// puts the array behind predicated moves).
template <int H, int O, typename T, int V>
__device__ __forceinline__ void transpose_reduce(T (&val)[V], int lane) {
  if constexpr (O >= 1) {
    if constexpr (H >= 1) {
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const T mine = upper ? val[i + H] : val[i];
        const T theirs = upper ? val[i] : val[i + H];
        val[i] = mine + __shfl_xor_sync(0xffffffffu, theirs, O);
      }
    } else {
      val[0] += __shfl_xor_sync(0xffffffffu, val[0], O);
    }
    transpose_reduce<H / 2, O / 2>(val, lane);
  }
}

// du and dv of the G features [k, k + G) of a term, from P in registers.
// Per feature a thread forms P (u - v) over its R x VEC tile (a lin term:
// P v for du, P u for dv) and sums it over its columns for du and over its
// rows for dv.  The dv sums are added to the thread's own entries of its
// warp's accumulators (dvw, at chunk-relative feature kk): no other thread
// touches them until the chunk ends.  The 32 lanes of the warp share the
// rows: the R x G du sums are combined by a transpose-reduce, where at
// shuffle distance 16, 8, ... a lane keeps half of its values and adds its
// partner's copy of that half (V - 1 + log2(32 / V) shuffles for V = R G
// values, in a fixed order).  Lane l ends with value l / (32 / V), row
// value / G and feature value % G, which the first lane of each run of
// 32 / V writes if the row is live.
template <typename C, int G, bool LIN, typename T = typename C::type>
__device__ __forceinline__ void du_dv_group(const T (&P)[C::R][C::VEC],
                                            const T* __restrict__ uT, const T* __restrict__ vT,
                                            T* __restrict__ dvw, int k, int kk,
                                            T* __restrict__ du_rows, int D, int live_rows) {
  constexpr int R = C::R, VEC = C::VEC, V = R * G, SPAN = 32 / V;
  static_assert(V <= 32, "a group's du sums must fit the lanes of a warp");
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  T val[V];
#pragma unroll
  for (int i = 0; i < V; ++i) val[i] = T(0);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    T a[R], b[VEC], dv[VEC];
    lds_rows<C>(uT, k + g, wp, a);
    ldsv(vT + (k + g) * C::SV + VEC * lane, b);
    T* const acc = dvw + (kk + g) * C::SV + VEC * lane;
    ldsv(acc, dv);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        if (LIN) {
          val[i * G + g] += P[i][q] * b[q];
          dv[q] += P[i][q] * a[i];
        } else {
          const T diff = a[i] - b[q];
          val[i * G + g] += P[i][q] * diff;
          dv[q] += P[i][q] * diff;
        }
      }
    stsv(acc, dv);
  }
  transpose_reduce<V / 2, 16>(val, lane);
  const int idx = lane / SPAN;
  if (lane % SPAN == 0 && idx / G < live_rows)
    du_rows[(idx / G) * D + k + idx % G] = (LIN ? T(1) : T(2)) * val[0];
}

// du and dv of the features [k0, k0 + kn) of the term for one step: groups
// of KG, then one each of 4, 2 and 1 as the width needs.  No barrier: a
// warp reads only the staged u and v and writes only its own accumulators.
template <typename C, bool LIN, typename T = typename C::type>
__device__ __forceinline__ void du_dv_step(const T (&P)[C::R][C::VEC],
                                           const T* __restrict__ uT, const T* __restrict__ vT,
                                           T* __restrict__ dvw, int k0, int kn,
                                           T* __restrict__ du_rows, int D, int live_rows) {
  static_assert(C::KG == 2 || C::KG == 4 || C::KG == 8, "the tail below takes groups of 4, 2 and 1");
  int kk = 0;
  for (; kk + C::KG <= kn; kk += C::KG)
    du_dv_group<C, C::KG, LIN>(P, uT, vT, dvw, k0 + kk, kk, du_rows, D, live_rows);
  if constexpr (C::KG >= 8) {
    if (kn - kk >= 4) {
      du_dv_group<C, 4, LIN>(P, uT, vT, dvw, k0 + kk, kk, du_rows, D, live_rows);
      kk += 4;
    }
  }
  if constexpr (C::KG >= 4) {
    if (kn - kk >= 2) {
      du_dv_group<C, 2, LIN>(P, uT, vT, dvw, k0 + kk, kk, du_rows, D, live_rows);
      kk += 2;
    }
  }
  if (kn - kk >= 1) du_dv_group<C, 1, LIN>(P, uT, vT, dvw, k0 + kk, kk, du_rows, D, live_rows);
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(GPAR_THREADS, 2)
gram_bwd_kernel(const T* __restrict__ xf, const T* __restrict__ yf,
                const T* __restrict__ par, const T* __restrict__ g,
                T* __restrict__ du_part, T* __restrict__ dv_part,
                T* __restrict__ sc_part, int n, int m, int D, int rows_per_split,
                int dmax, long long sx, long long sy, long long sp, TermSpec spec) {
  using C = BwdCfg<T, ROWS>;
  constexpr int BC = C::BC, BR = C::BR, R = C::R, VEC = C::VEC, SV = C::SV, KC = C::KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vT = reinterpret_cast<T*>(smem_raw);  // [dmax][SV]  v, feature-major
  T* uT = vT + (size_t)dmax * SV;          // [dmax][BR]  u of the step
  T* dvw = uT + (size_t)dmax * BR;         // [WARPS][min(dmax, KC)][SV]  dv of a chunk by warp
  __shared__ T red[C::WARPS][3];

  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  // blockIdx.z = b T + t: batch element b, term t.
  const int t = blockIdx.z % spec.n_terms, b = blockIdx.z / spec.n_terms;
  const int nb = gridDim.z / spec.n_terms, ct = blockIdx.x, rs = blockIdx.y;
  xf += b * sx;
  yf += b * sy;
  par += b * sp;
  g += (size_t)b * n * m;
  du_part += (size_t)b * gridDim.x * n * D;
  dv_part += (size_t)b * gridDim.y * m * D;
  const int kind = spec.kind[t], off = spec.off[t], d = spec.dim[t];
  const int c0 = ct * BC;
  const int rbeg = rs * rows_per_split;
  const int rend = min(n, rbeg + rows_per_split);

  // v, feature fastest: a warp reads runs of d consecutive features of a
  // row of yf.
  for (int e = tid; e < d * BC; e += GPAR_THREADS) {
    const int j = e / d, k = e - j * d;
    vT[k * SV + j] = c0 + j < m ? yf[(size_t)(c0 + j) * D + off + k] : T(0);
  }
  const T w = par[t];
  const T alpha = kind == KIND_RQ ? par[spec.n_terms + t] : T(1);
  const bool lin = kind == KIND_LIN;
  const bool vec_ok = (m % VEC == 0) && ((uintptr_t)g % 16 == 0);
  const int cl = VEC * lane;  // the thread's first column in the tile
  const int kw = min(dmax, KC);
  T* const dvw_w = dvw + (size_t)wp * kw * SV;  // this warp's accumulators
  T* const du_tile = du_part + (size_t)ct * n * D + off;
  T sdw = T(0), sda = T(0), sdc = T(0);

  // The term's features in chunks of KC (one chunk up to 24 features, so
  // on the main path): each chunk walks the rows of the split, recomputing
  // s and P, and takes du and dv of its own features.
  for (int k0 = 0; k0 < d; k0 += KC) {
    const int kn = min(KC, d - k0);
    for (int kk = 0; kk < kn; ++kk) {
      T z[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) z[q] = T(0);
      stsv(dvw_w + kk * SV + cl, z);
    }
    for (int r0 = rbeg; r0 < rend; r0 += BR) {
      __syncthreads();  // staged v / the previous step's readers of uT are done
      for (int e = tid; e < d * BR; e += GPAR_THREADS) {
        const int i = e % BR, k = e / BR;
        uT[k * BR + i] = r0 + i < rend ? xf[(size_t)(r0 + i) * D + off + k] : T(0);
      }
      // G of the thread's tile, which P replaces below; rows past the split
      // and columns past m read 0, so they add nothing anywhere.
      const int rt = r0 + R * wp;
      T P[R][VEC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int c = c0 + cl;
        if (rt + i < rend && vec_ok && c + VEC <= m) {
          ldgv(g + (size_t)(rt + i) * m + c, P[i]);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            P[i][q] = rt + i < rend && c + q < m ? g[(size_t)(rt + i) * m + c + q] : T(0);
        }
      }
      __syncthreads();

      T s[R][VEC];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int q = 0; q < VEC; ++q) s[i][q] = T(0);
      if (lin) {
#pragma unroll 2
        for (int k = 0; k < d; ++k) {
          T a[R], b[VEC];
          lds_rows<C>(uT, k, wp, a);
          ldsv(vT + k * SV + cl, b);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int q = 0; q < VEC; ++q) s[i][q] += a[i] * b[q];
        }
      } else {
#pragma unroll 2
        for (int k = 0; k < d; ++k) {
          T a[R], b[VEC];
          lds_rows<C>(uT, k, wp, a);
          ldsv(vT + k * SV + cl, b);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
              const T diff = a[i] - b[q];
              s[i][q] += diff * diff;
            }
        }
      }

      // P in place of G; the scalar sums once, in the first chunk.
      const bool first = k0 == 0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const T G = P[i][q], S = s[i][q];
          if (first) sdc += G;
          if (kind == KIND_RBF) {
            const T ge = G * dev_exp(T(-0.5) * S);
            if (first) sdw += ge;
            P[i][q] = T(-0.5) * w * ge;
          } else if (kind == KIND_RQ) {
            const T hh = S / (T(2) * alpha);
            const T lr = dev_log1p(hh);
            const T gr = G * dev_exp(-alpha * lr);
            if (first) {
              sdw += gr;
              sda += w * gr * (hh / (T(1) + hh) - lr);
            }
            P[i][q] = T(-0.5) * w * gr / (T(1) + hh);
          } else {
            if (first) sdw += G * S;
            P[i][q] = w * G;
          }
        }
      }

      T* const du_rows = du_tile + (size_t)rt * D;
      if (lin)
        du_dv_step<C, true>(P, uT, vT, dvw_w, k0, kn, du_rows, D, rend - rt);
      else
        du_dv_step<C, false>(P, uT, vT, dvw_w, k0, kn, du_rows, D, rend - rt);
    }

    __syncthreads();  // every warp's dv sums of the chunk are in dvw
    // The warps' sums in warp order, feature fastest: a warp writes runs of
    // kn consecutive entries of a row of the dv partials.
    const T scale = lin ? T(1) : T(-2);
    for (int e = tid; e < kn * BC; e += GPAR_THREADS) {
      const int j = e / kn, kk = e - j * kn;
      T sum = T(0);
#pragma unroll
      for (int wi = 0; wi < C::WARPS; ++wi) sum += dvw[((size_t)wi * kw + kk) * SV + j];
      if (c0 + j < m) dv_part[((size_t)rs * m + c0 + j) * D + off + k0 + kk] = scale * sum;
    }
    __syncthreads();  // the next chunk clears dvw
  }

  sdw = warp_sum(sdw);
  sda = warp_sum(sda);
  sdc = warp_sum(sdc);
  if (lane == 0) {
    red[wp][0] = sdw;
    red[wp][1] = sda;
    red[wp][2] = sdc;
  }
  __syncthreads();
  if (tid < 3) {
    T acc = T(0);
    for (int wi = 0; wi < C::WARPS; ++wi) acc += red[wi][tid];
    sc_part[((((size_t)tid * spec.n_terms + t) * nb + b) * gridDim.x + ct) * gridDim.y + rs] = acc;
  }
}

// Sums the partials in a fixed order: dxf over column tiles, dyf over row
// splits, each dpar entry over all blocks of its term; pad columns get
// zeros.  A batched operand (xb, yb, pb) sums each element's own partials;
// a shared one sums every element's, element by element.  Blocks [0, bx)
// take 256 / lx consecutive entries of dxf each, with lx lanes splitting
// its partials; blocks [bx, bx + by) do the same for dyf with ly lanes; the
// rest take one scalar each, 2T + 1 per element of a batched par (2T + 1
// for a shared one).  The lanes' sums are combined in lane order: the
// result does not depend on scheduling.
template <typename T>
__global__ void __launch_bounds__(GPAR_THREADS)
gram_bwd_reduce(const T* __restrict__ du_part, const T* __restrict__ dv_part,
                const T* __restrict__ sc_part, T* __restrict__ dxf,
                T* __restrict__ dyf, T* __restrict__ dpar, int n, int m, int D,
                int Dt, int CT, int R, int B, int xb, int yb, int pb, int bx, int lx,
                int by, int ly, TermSpec spec) {
  __shared__ T buf[GPAR_THREADS];
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  if (blk < bx + by) {
    const bool is_x = blk < bx;
    const bool own = is_x ? xb : yb;
    const int lanes = is_x ? lx : ly;
    const int P = (is_x ? CT : R) * (own ? 1 : B);  // partials per entry
    const int per = GPAR_THREADS / lanes;
    const int lane = tid / per, el = tid % per;
    const size_t E = (size_t)(is_x ? n : m) * D;  // one element's entries
    const size_t EA = own ? (size_t)B * E : E;     // the output's entries
    const size_t e = (size_t)(is_x ? blk : blk - bx) * per + el;
    const T* part = is_x ? du_part : dv_part;
    T acc = T(0);
    if (e < EA) {
      const size_t be = e / E, w = e - be * E;
      if ((int)(w % D) < Dt) {
        const T* src = part + be * P * E + w;
#pragma unroll 4
        for (int p = lane; p < P; p += lanes) acc += src[p * E];
      }
    }
    buf[tid] = acc;
    __syncthreads();
    if (lane == 0 && e < EA) {
      T sum = T(0);
      for (int l = 0; l < lanes; ++l) sum += buf[l * per + el];
      (is_x ? dxf : dyf)[e] = sum;
    }
    return;
  }
  // One scalar of element be: dw_t (slot 0), dalpha_t (slot 1, rq terms
  // only) or the constant's dc (slot 2, kept by term 0's blocks).
  const int T_ = spec.n_terms, NS = 2 * T_ + 1, sidx = blk - bx - by;
  const int be = sidx / NS, s = sidx - be * NS;
  int t = 0, slot = 2;
  if (s < T_) {
    t = s, slot = 0;
  } else if (s < 2 * T_) {
    t = s - T_, slot = spec.kind[t] == KIND_RQ ? 1 : -1;
  }
  T acc = T(0);
  if (slot >= 0) {
    const size_t cnt = (size_t)CT * R * (pb ? 1 : B);
    const T* src = sc_part + (((size_t)slot * T_ + t) * B + be) * CT * R;
    for (size_t q = tid; q < cnt; q += GPAR_THREADS) acc += src[q];
  }
  acc = warp_sum(acc);
  if ((tid & 31) == 0) buf[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    T sum = T(0);
    for (int wi = 0; wi < GPAR_THREADS / 32; ++wi) sum += buf[wi];
    dpar[sidx] = sum;
  }
}

// Lanes per entry of the reduction: one per 8 partials, at most 8, so that a
// sum of a few row splits' partials takes one lane and 256 entries a block.
static int lanes_for(int parts) {
  int l = 1;
  while (l < 8 && 8 * l < parts) l *= 2;
  return l;
}

template <typename T, int ROWS>
static void launch_bwd_tile(const void* xf, const void* yf, const void* par, const void* g,
                            void* du_part, void* dv_part, void* sc_part, int n, int m, int D,
                            int batch, int n_terms, int ct, int r, int rps, int dmax,
                            long long sx, long long sy, long long sp, const TermSpec& spec,
                            cudaStream_t st) {
  const size_t smem = BwdCfg<T, ROWS>::smem(dmax);
  gram_bwd_kernel<T, ROWS><<<dim3(ct, r, batch * n_terms), GPAR_THREADS, smem, st>>>(
      (const T*)xf, (const T*)yf, (const T*)par, (const T*)g, (T*)du_part, (T*)dv_part,
      (T*)sc_part, n, m, D, rps, dmax, sx, sy, sp, spec);
}

template <typename T>
static int launch_bwd(const void* xf, const void* yf, const void* par, const void* g,
                      void* dxf, void* dyf, void* dpar, void* du_part, void* dv_part,
                      void* sc_part, int batch, int n, int m, int D, long long sx,
                      long long sy, long long sp, int n_terms, const int* kinds,
                      const int* offs, const int* dims, int ct, int r, int rps, int step,
                      void* stream) {
  constexpr int BIG = BwdTiles<T>::BIG_ROWS, SMALL = BwdTiles<T>::SMALL_ROWS;
  constexpr int BC = BwdCfg<T, BIG>::BC;
  TermSpec spec;
  if (batch < 1 || n < 1 || m < 1 || !fill_spec(spec, n_terms, kinds, offs, dims, D))
    return (int)cudaErrorInvalidValue;
  // Each operand carries the batch (a whole element's stride) or is shared.
  if ((sx != 0 && sx != (long long)n * D) || (sy != 0 && sy != (long long)m * D) ||
      (sp != 0 && sp != 2 * n_terms + 1))
    return (int)cudaErrorInvalidValue;
  // The wrapper's plan (gram_kernel._bwd_plan) chose the tile's step (rows
  // per step, one of the two tiles') and sized the partial buffers: ct
  // column tiles, r row splits of rps rows, a whole number of steps each.
  if ((step != BwdCfg<T, BIG>::BR && step != BwdCfg<T, SMALL>::BR) || ct != (m + BC - 1) / BC ||
      rps < step || rps % step != 0 || r != (n + rps - 1) / rps)
    return (int)cudaErrorInvalidValue;
  if (r > 65535 || (long long)batch * n_terms > 65535) return (int)cudaErrorInvalidConfiguration;
  int dmax = 0, Dt = 0;
  for (int t = 0; t < n_terms; ++t) {
    dmax = dims[t] > dmax ? dims[t] : dmax;
    Dt = offs[t] + dims[t] > Dt ? offs[t] + dims[t] : Dt;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (step == BwdCfg<T, BIG>::BR)
    launch_bwd_tile<T, BIG>(xf, yf, par, g, du_part, dv_part, sc_part, n, m, D, batch, n_terms,
                            ct, r, rps, dmax, sx, sy, sp, spec, st);
  else
    launch_bwd_tile<T, SMALL>(xf, yf, par, g, du_part, dv_part, sc_part, n, m, D, batch,
                              n_terms, ct, r, rps, dmax, sx, sy, sp, spec, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int xb = sx != 0, yb = sy != 0, pb = sp != 0;
  const int lx = lanes_for(ct * (xb ? 1 : batch)), ly = lanes_for(r * (yb ? 1 : batch));
  const size_t ex = (size_t)n * D * (xb ? batch : 1), ey = (size_t)m * D * (yb ? batch : 1);
  const size_t bx = (ex + GPAR_THREADS / lx - 1) / (GPAR_THREADS / lx);
  const size_t by = (ey + GPAR_THREADS / ly - 1) / (GPAR_THREADS / ly);
  const size_t blocks = bx + by + (size_t)(2 * n_terms + 1) * (pb ? batch : 1);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  gram_bwd_reduce<T><<<(unsigned)blocks, GPAR_THREADS, 0, st>>>(
      (const T*)du_part, (const T*)dv_part, (const T*)sc_part, (T*)dxf, (T*)dyf,
      (T*)dpar, n, m, D, Dt, ct, r, batch, xb, yb, pb, (int)bx, lx, (int)by, ly, spec);
  return (int)cudaGetLastError();
}

template <typename T, int ROWS>
static int opt_in_smem() {
  // The most shared memory any launch asks for: a term of 128 features.
  const size_t smem = BwdCfg<T, ROWS>::smem(128);
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(gram_bwd_kernel<T, ROWS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

extern "C" {

int gpar_gram_max_terms() { return GPAR_GRAM_MAX_TERMS; }

// Once per process, on the current device, before any launch.
int gpar_gram_init() {
  int e = opt_in_smem<float, BwdTiles<float>::BIG_ROWS>();
  if (e == 0) e = opt_in_smem<float, BwdTiles<float>::SMALL_ROWS>();
  if (e == 0) e = opt_in_smem<double, BwdTiles<double>::BIG_ROWS>();
  return e != 0 ? e : opt_in_smem<double, BwdTiles<double>::SMALL_ROWS>();
}

// sx, sy, sp: each operand's stride between batch elements, 0 when it is
// shared by every element.
int gpar_gram_f32(const void* xf, const void* yf, const void* par, void* out,
                  int batch, int n, int m, int D, long long sx, long long sy, long long sp,
                  int n_terms, const int* kinds, const int* offs, const int* dims,
                  void* stream) {
  return launch<float>(xf, yf, par, out, batch, n, m, D, sx, sy, sp, n_terms, kinds, offs,
                       dims, stream);
}

int gpar_gram_f64(const void* xf, const void* yf, const void* par, void* out,
                  int batch, int n, int m, int D, long long sx, long long sy, long long sp,
                  int n_terms, const int* kinds, const int* offs, const int* dims,
                  void* stream) {
  return launch<double>(xf, yf, par, out, batch, n, m, D, sx, sy, sp, n_terms, kinds, offs,
                        dims, stream);
}

// g is (batch, n, m); du_part is (batch, ct, n, D), dv_part (batch, r, m, D),
// sc_part (3, T, batch, ct, r); step is the row tile's rows per step.
int gpar_gram_bwd_f32(const void* xf, const void* yf, const void* par, const void* g,
                      void* dxf, void* dyf, void* dpar, void* du_part, void* dv_part,
                      void* sc_part, int batch, int n, int m, int D, long long sx,
                      long long sy, long long sp, int n_terms, const int* kinds,
                      const int* offs, const int* dims, int ct, int r, int rps, int step,
                      void* stream) {
  return launch_bwd<float>(xf, yf, par, g, dxf, dyf, dpar, du_part, dv_part, sc_part,
                           batch, n, m, D, sx, sy, sp, n_terms, kinds, offs, dims, ct, r,
                           rps, step, stream);
}

int gpar_gram_bwd_f64(const void* xf, const void* yf, const void* par, const void* g,
                      void* dxf, void* dyf, void* dpar, void* du_part, void* dv_part,
                      void* sc_part, int batch, int n, int m, int D, long long sx,
                      long long sy, long long sp, int n_terms, const int* kinds,
                      const int* offs, const int* dims, int ct, int r, int rps, int step,
                      void* stream) {
  return launch_bwd<double>(xf, yf, par, g, dxf, dyf, dpar, du_part, dv_part, sc_part,
                            batch, n, m, D, sx, sy, sp, n_terms, kinds, offs, dims, ct, r,
                            rps, step, stream);
}

const char* gpar_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
