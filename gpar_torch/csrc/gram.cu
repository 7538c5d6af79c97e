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
                 int D, int Dt, TermSpec spec) {
  using C = FwdCfg<T>;
  constexpr int VEC = C::VEC, BC = C::BC, BR = C::BR, RT = C::RT, KC = C::KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
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
                  int n, int m, int D, int n_terms, const int* kinds,
                  const int* offs, const int* dims, void* stream) {
  using C = FwdCfg<T>;
  TermSpec spec;
  if (n < 1 || m < 1 || D % 4 != 0 || !fill_spec(spec, n_terms, kinds, offs, dims, D))
    return (int)cudaErrorInvalidValue;
  // The chunk walk needs the terms in order and back to back from column 0.
  for (int t = 0; t < n_terms; ++t)
    if (offs[t] != (t == 0 ? 0 : offs[t - 1] + dims[t - 1])) return (int)cudaErrorInvalidValue;
  const int Dt = offs[n_terms - 1] + dims[n_terms - 1];
  dim3 grid((m + C::BC - 1) / C::BC, (n + C::BR - 1) / C::BR);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = C::smem(D < C::KC ? D : C::KC);  // at most 48 KB
  gram_tile_kernel<T><<<grid, GPAR_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)xf, (const T*)yf, (const T*)par, (T*)out, n, m, D, Dt, spec);
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
// The differences are formed directly, as in the forward: no cancellation.
//
// Design.  Terms are independent in the backward, so the grid is
// (column tiles, row splits, terms): a block owns BC columns of one term
// (128 in float, 64 in double) and walks the rows of its split in steps of
// BR = 16.  Per step it stages the step's u rows, reads its G tile once with
// 16-byte loads (a warp reads whole 512-byte row segments in float),
// recomputes s from features in shared memory, forms P in shared memory,
// and then
//   - sums du over its BC columns for the step's rows (four chains per
//     thread, 16-byte shared loads) and writes that partial, one per column
//     tile, straight out;
//   - adds dv for its columns into shared memory over the whole row walk
//     (four columns and two features per thread, so each P load serves
//     eight products), written once at the end, one partial per row split.
// Row splits are only as many as it takes to give every SM two blocks (the
// wrapper's plan, which also sizes the partial buffers).  Shared memory grows
// with the widest term; past 36 features in float (34 in double) it exceeds
// the default 48 KB (at most ~157 KB, at 128).  The opt-in to that much is
// made once, when the library is loaded (gpar_gram_init), not at a launch:
// a launch may be captured into a CUDA graph, and a capture should hold
// stream work only.
// The scalar sums are reduced inside the block in a fixed tree.  A second
// kernel sums the partials in a fixed order, with up to 8 lanes per entry
// combined in lane order.  There are no atomics: the result is the same bit
// for bit from call to call.  On the main path (256 x 10 000, three terms,
// 31 features) the short side is the 256 inducing points, so the du
// partials are small (79 column tiles x 256 x 32).
//
// What bounds it on an H100: the function reads G, xf and yf once and
// writes dxf, dyf (bytes: (n m + 2 (n + m) D) sizeof(T)).  Its operations,
// per output element: 6 per feature of an rbf or rq term (s, P v and P^T u,
// each a product and a sum per feature under the norm identity) and 4 per
// feature of a lin term (G v and G^T u; dw = sum_ik u_ik (G v)_ik reuses G v),
// a tail of 4 per rbf term (exp, G e, its sum, P), 10 per rq term (h, log1p,
// exp, G r^(-a), its sum, the da summand and its sum, P) and 1 per lin term
// (P = w G), and 1 for the constant's sum.  At the widest main-path layer
// (rbf of 1 feature, lin and rbf of 15) that is 166 per output, so it is
// bound by operations at 67 TFLOP/s in float32; the one-feature first layer
// is bound by bytes.  This kernel's direct form spends 6 floating-point instructions per
// feature and output element for every kind (3 subtractions, 3 fused
// multiply-adds; a lin term runs the same loops with u = 0) and, above all,
// shared-memory traffic: the du sum reloads P and v for every feature, which
// makes the shared-memory pipe, not the arithmetic, its limit.  It reads G
// once per term (the second and third reads mostly from L2).
// exp / log1p are the accurate versions; no tensor cores (TF32 is off).

template <typename T>
struct BwdCfg {
  static constexpr int BC = sizeof(T) == 4 ? 128 : 64;  // columns a block owns
  static constexpr int BR = 16;                         // rows per step
  static constexpr int TPR = BC / 4;                    // threads per G-tile row
  static constexpr int RPP = GPAR_THREADS / TPR;        // G-tile rows per pass
  static constexpr int PASSES = BR / RPP;
  static constexpr int SV = BC + 4;  // padded stride of vT and Ps, keeps 16-byte rows
  static constexpr int DU_LANES = GPAR_THREADS / BR;    // threads per row in the du sum
  static constexpr int DV_LANES = GPAR_THREADS / (BC / 4);  // threads per column quad in dv
  static size_t smem(int dmax) {
    return sizeof(T) * ((size_t)dmax * (SV + BC + BR) + (size_t)BR * SV);
  }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(GPAR_THREADS)
gram_bwd_kernel(const T* __restrict__ xf, const T* __restrict__ yf,
                const T* __restrict__ par, const T* __restrict__ g,
                T* __restrict__ du_part, T* __restrict__ dv_part,
                T* __restrict__ sc_part, int n, int m, int D, int rows_per_split,
                int dmax, TermSpec spec) {
  using C = BwdCfg<T>;
  constexpr int BC = C::BC, BR = C::BR, TPR = C::TPR, RPP = C::RPP, SV = C::SV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vT = reinterpret_cast<T*>(smem_raw);  // [dmax][SV]  v, feature-major
  T* Ps = vT + (size_t)dmax * SV;          // [BR][SV]    P of the step
  T* uT = Ps + BR * SV;                    // [dmax][BR]  u of the step
  T* dvacc = uT + (size_t)dmax * BR;       // [dmax][BC]  dv over the row walk
  __shared__ T red[GPAR_THREADS / 32][3];

  const int tid = threadIdx.x;
  const int t = blockIdx.z, ct = blockIdx.x, rs = blockIdx.y;
  const int kind = spec.kind[t], off = spec.off[t], d = spec.dim[t];
  const int c0 = ct * BC;
  const int rbeg = rs * rows_per_split;
  const int rend = min(n, rbeg + rows_per_split);

  for (int e = tid; e < d * BC; e += GPAR_THREADS) {
    const int j = e % BC, k = e / BC;
    vT[k * SV + j] = c0 + j < m ? yf[(size_t)(c0 + j) * D + off + k] : T(0);
    dvacc[k * BC + j] = T(0);
  }
  const T w = par[t];
  const T alpha = kind == KIND_RQ ? par[spec.n_terms + t] : T(1);
  const bool vec_ok = (m % 4 == 0) && ((uintptr_t)g % 16 == 0);
  const int px = tid % TPR, py = tid / TPR;
  const int du_i = tid / C::DU_LANES, du_k = tid % C::DU_LANES;
  const int dv_c = 4 * (tid % (BC / 4)), dv_k = tid / (BC / 4);
  T sdw = T(0), sda = T(0), sdc = T(0);

  for (int r0 = rbeg; r0 < rend; r0 += BR) {
    __syncthreads();  // staged v / the previous step's readers of uT and Ps are done
    for (int e = tid; e < d * BR; e += GPAR_THREADS) {
      const int i = e % BR, k = e / BR;
      uT[k * BR + i] = r0 + i < rend ? xf[(size_t)(r0 + i) * D + off + k] : T(0);
    }
    T gv[C::PASSES][4];
#pragma unroll
    for (int p = 0; p < C::PASSES; ++p) {
      const int r = r0 + py + RPP * p, c = c0 + 4 * px;
      if (r < rend && vec_ok && c + 4 <= m) {
        load4(g + (size_t)r * m + c, gv[p]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gv[p][q] = (r < rend && c + q < m) ? g[(size_t)r * m + c + q] : T(0);
      }
    }
    __syncthreads();

    T s[C::PASSES][4];
#pragma unroll
    for (int p = 0; p < C::PASSES; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[p][q] = T(0);
    if (kind == KIND_LIN) {
#pragma unroll 4
      for (int k = 0; k < d; ++k) {
        T b[4];
        lds4(vT + k * SV + 4 * px, b);
#pragma unroll
        for (int p = 0; p < C::PASSES; ++p) {
          const T a = uT[k * BR + py + RPP * p];
#pragma unroll
          for (int q = 0; q < 4; ++q) s[p][q] += a * b[q];
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < d; ++k) {
        T b[4];
        lds4(vT + k * SV + 4 * px, b);
#pragma unroll
        for (int p = 0; p < C::PASSES; ++p) {
          const T a = uT[k * BR + py + RPP * p];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const T diff = a - b[q];
            s[p][q] += diff * diff;
          }
        }
      }
    }

#pragma unroll
    for (int p = 0; p < C::PASSES; ++p) {
      T P[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T G = gv[p][q], S = s[p][q];
        sdc += G;
        if (kind == KIND_RBF) {
          const T ge = G * dev_exp(T(-0.5) * S);
          sdw += ge;
          P[q] = T(-0.5) * w * ge;
        } else if (kind == KIND_RQ) {
          const T h = S / (T(2) * alpha);
          const T lr = dev_log1p(h);
          const T gr = G * dev_exp(-alpha * lr);
          sdw += gr;
          sda += w * gr * (h / (T(1) + h) - lr);
          P[q] = T(-0.5) * w * gr / (T(1) + h);
        } else {
          sdw += G * S;
          P[q] = w * G;
        }
      }
      T* dst = Ps + (py + RPP * p) * SV + 4 * px;
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[q] = P[q];
    }

    __syncthreads();  // Ps is complete

    // du over this block's columns, for the step's rows: four chains per
    // thread over the columns, 16-byte shared loads.
    {
      const int r = r0 + du_i;
      const T* prow = Ps + du_i * SV;
      for (int k = du_k; k < d; k += C::DU_LANES) {
        const T* vrow = vT + k * SV;
        // With ui = 0 a lin term's sum is -(G v)_ik w.
        const T ui = kind == KIND_LIN ? T(0) : uT[k * BR + du_i];
        T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll 4
        for (int j = 0; j < BC; j += 4) {
          T pj[4], vj[4];
          lds4(prow + j, pj);
          lds4(vrow + j, vj);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += pj[q] * (ui - vj[q]);
        }
        const T sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        if (r < rend) du_part[((size_t)ct * n + r) * D + off + k] = (kind == KIND_LIN ? T(-1) : T(2)) * sum;
      }
    }

    // dv for this block's columns, four columns and two features per
    // thread (each P load serves both), added over the row walk.
    for (int k0 = dv_k; k0 < d; k0 += 2 * C::DV_LANES) {
      const int k1 = k0 + C::DV_LANES;
      const bool has1 = k1 < d;
      T v0[4], v1[4] = {T(0), T(0), T(0), T(0)};
      T a0[4] = {T(0), T(0), T(0), T(0)}, a1[4] = {T(0), T(0), T(0), T(0)};
      lds4(vT + k0 * SV + dv_c, v0);
      if (has1) lds4(vT + k1 * SV + dv_c, v1);
      if (kind == KIND_LIN) v0[0] = v0[1] = v0[2] = v0[3] = v1[0] = v1[1] = v1[2] = v1[3] = T(0);
#pragma unroll
      for (int i = 0; i < BR; i += 4) {
        T u0[4], u1[4] = {T(0), T(0), T(0), T(0)};
        lds4(uT + k0 * BR + i, u0);
        if (has1) lds4(uT + k1 * BR + i, u1);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          T pi[4];
          lds4(Ps + (i + h) * SV + dv_c, pi);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            a0[q] += pi[q] * (u0[h] - v0[q]);
            a1[q] += pi[q] * (u1[h] - v1[q]);
          }
        }
      }
      const T scale = kind == KIND_LIN ? T(1) : T(-2);
#pragma unroll
      for (int q = 0; q < 4; ++q) dvacc[k0 * BC + dv_c + q] += scale * a0[q];
      if (has1)
#pragma unroll
        for (int q = 0; q < 4; ++q) dvacc[k1 * BC + dv_c + q] += scale * a1[q];
    }
  }

  __syncthreads();  // dvacc was zeroed under another mapping
  for (int k = dv_k; k < d; k += C::DV_LANES)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c0 + dv_c + q < m)
        dv_part[((size_t)rs * m + c0 + dv_c + q) * D + off + k] = dvacc[k * BC + dv_c + q];

  sdw = warp_sum(sdw);
  sda = warp_sum(sda);
  sdc = warp_sum(sdc);
  if ((tid & 31) == 0) {
    red[tid >> 5][0] = sdw;
    red[tid >> 5][1] = sda;
    red[tid >> 5][2] = sdc;
  }
  __syncthreads();
  if (tid < 3) {
    T acc = T(0);
    for (int wi = 0; wi < GPAR_THREADS / 32; ++wi) acc += red[wi][tid];
    sc_part[(((size_t)tid * spec.n_terms + t) * gridDim.x + ct) * gridDim.y + rs] = acc;
  }
}

// Sums the partials in a fixed order: dxf over column tiles, dyf over row
// splits, each dpar entry over all blocks of its term; pad columns get
// zeros.  Blocks [0, bx) take 256 / lx consecutive entries of dxf each,
// with lx lanes splitting the column tiles; blocks [bx, bx + by) do the
// same for dyf with ly lanes; the last 2T + 1 blocks take one scalar each.
// The lanes' sums are combined in lane order: the result does not depend
// on scheduling.
template <typename T>
__global__ void __launch_bounds__(GPAR_THREADS)
gram_bwd_reduce(const T* __restrict__ du_part, const T* __restrict__ dv_part,
                const T* __restrict__ sc_part, T* __restrict__ dxf,
                T* __restrict__ dyf, T* __restrict__ dpar, int n, int m, int D,
                int Dt, int CT, int R, int bx, int lx, int by, int ly, TermSpec spec) {
  __shared__ T buf[GPAR_THREADS];
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  if (blk < bx + by) {
    const bool is_x = blk < bx;
    const int lanes = is_x ? lx : ly, P = is_x ? CT : R;
    const int per = GPAR_THREADS / lanes;
    const int lane = tid / per, el = tid % per;
    const size_t E = (size_t)(is_x ? n : m) * D;
    const size_t e = (size_t)(is_x ? blk : blk - bx) * per + el;
    const T* part = is_x ? du_part : dv_part;
    T acc = T(0);
    if (e < E && (int)(e % D) < Dt) {
#pragma unroll 4
      for (int p = lane; p < P; p += lanes) acc += part[p * E + e];
    }
    buf[tid] = acc;
    __syncthreads();
    if (lane == 0 && e < E) {
      T sum = T(0);
      for (int l = 0; l < lanes; ++l) sum += buf[l * per + el];
      (is_x ? dxf : dyf)[e] = sum;
    }
    return;
  }
  // One scalar: dw_t (slot 0), dalpha_t (slot 1, rq terms only) or the
  // constant's dc (slot 2, kept by term 0's blocks).
  const int T_ = spec.n_terms, sidx = blk - bx - by;
  int t = 0, slot = 2;
  if (sidx < T_) {
    t = sidx, slot = 0;
  } else if (sidx < 2 * T_) {
    t = sidx - T_, slot = spec.kind[t] == KIND_RQ ? 1 : -1;
  }
  T acc = T(0);
  if (slot >= 0) {
    const T* src = sc_part + ((size_t)slot * T_ + t) * CT * R;
    for (int b = tid; b < CT * R; b += GPAR_THREADS) acc += src[b];
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

static int lanes_for(int parts) {
  int l = 1;
  while (l < 8 && l < parts) l *= 2;
  return l;
}

template <typename T>
static int launch_bwd(const void* xf, const void* yf, const void* par, const void* g,
                      void* dxf, void* dyf, void* dpar, void* du_part, void* dv_part,
                      void* sc_part, int n, int m, int D, int n_terms, const int* kinds,
                      const int* offs, const int* dims, int ct, int r, int rps,
                      void* stream) {
  using C = BwdCfg<T>;
  TermSpec spec;
  if (n < 1 || m < 1 || !fill_spec(spec, n_terms, kinds, offs, dims, D))
    return (int)cudaErrorInvalidValue;
  // The wrapper's plan (gram_kernel._bwd_plan) sized the partial buffers:
  // ct column tiles, r row splits of rps rows, a whole number of steps each.
  if (ct != (m + C::BC - 1) / C::BC || rps < C::BR || rps % C::BR != 0 ||
      r != (n + rps - 1) / rps)
    return (int)cudaErrorInvalidValue;
  if (r > 65535) return (int)cudaErrorInvalidConfiguration;
  int dmax = 0, Dt = 0;
  for (int t = 0; t < n_terms; ++t) {
    dmax = dims[t] > dmax ? dims[t] : dmax;
    Dt = offs[t] + dims[t] > Dt ? offs[t] + dims[t] : Dt;
  }
  const size_t smem = C::smem(dmax);
  cudaStream_t st = (cudaStream_t)stream;
  gram_bwd_kernel<T><<<dim3(ct, r, n_terms), GPAR_THREADS, smem, st>>>(
      (const T*)xf, (const T*)yf, (const T*)par, (const T*)g, (T*)du_part, (T*)dv_part,
      (T*)sc_part, n, m, D, rps, dmax, spec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int lx = lanes_for(ct), ly = lanes_for(r);
  const size_t bx = ((size_t)n * D + GPAR_THREADS / lx - 1) / (GPAR_THREADS / lx);
  const size_t by = ((size_t)m * D + GPAR_THREADS / ly - 1) / (GPAR_THREADS / ly);
  const size_t blocks = bx + by + 2 * n_terms + 1;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  gram_bwd_reduce<T><<<(unsigned)blocks, GPAR_THREADS, 0, st>>>(
      (const T*)du_part, (const T*)dv_part, (const T*)sc_part, (T*)dxf, (T*)dyf,
      (T*)dpar, n, m, D, Dt, ct, r, (int)bx, lx, (int)by, ly, spec);
  return (int)cudaGetLastError();
}

template <typename T>
static int opt_in_smem() {
  // The most shared memory any launch asks for: a term of 128 features.
  const size_t smem = BwdCfg<T>::smem(128);
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(gram_bwd_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

extern "C" {

int gpar_gram_max_terms() { return GPAR_GRAM_MAX_TERMS; }

// Once per process, on the current device, before any launch.
int gpar_gram_init() {
  const int e = opt_in_smem<float>();
  return e != 0 ? e : opt_in_smem<double>();
}

int gpar_gram_f32(const void* xf, const void* yf, const void* par, void* out,
                  int n, int m, int D, int n_terms, const int* kinds,
                  const int* offs, const int* dims, void* stream) {
  return launch<float>(xf, yf, par, out, n, m, D, n_terms, kinds, offs, dims,
                       stream);
}

int gpar_gram_f64(const void* xf, const void* yf, const void* par, void* out,
                  int n, int m, int D, int n_terms, const int* kinds,
                  const int* offs, const int* dims, void* stream) {
  return launch<double>(xf, yf, par, out, n, m, D, n_terms, kinds, offs, dims,
                        stream);
}

// du_part is (ct, n, D), dv_part (r, m, D), sc_part (3, T, ct, r).
int gpar_gram_bwd_f32(const void* xf, const void* yf, const void* par, const void* g,
                      void* dxf, void* dyf, void* dpar, void* du_part, void* dv_part,
                      void* sc_part, int n, int m, int D, int n_terms, const int* kinds,
                      const int* offs, const int* dims, int ct, int r, int rps,
                      void* stream) {
  return launch_bwd<float>(xf, yf, par, g, dxf, dyf, dpar, du_part, dv_part, sc_part,
                           n, m, D, n_terms, kinds, offs, dims, ct, r, rps, stream);
}

int gpar_gram_bwd_f64(const void* xf, const void* yf, const void* par, const void* g,
                      void* dxf, void* dyf, void* dpar, void* du_part, void* dv_part,
                      void* sc_part, int n, int m, int D, int n_terms, const int* kinds,
                      const int* offs, const int* dims, int ct, int r, int rps,
                      void* stream) {
  return launch_bwd<double>(xf, yf, par, g, dxf, dyf, dpar, du_part, dv_part, sc_part,
                            n, m, D, n_terms, kinds, offs, dims, ct, r, rps, stream);
}

const char* gpar_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
