// Fused composite-kernel Gram matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
// gpar_tpu/ops/pallas_gram.py, _gram_kernel_body (launched by
// _gram_pallas_call).  Same function, per output element:
//
//   K[i, j] = sum_t w_t * g_t(d2_t(i, j)) + sum_lin w_t * <u_t(i), v_t(j)> + const
//
// with g = exp(-d2/2) for "rbf" terms and exp(-alpha * log1p(d2 / (2 alpha)))
// for "rq" terms.  u_t / v_t are the per-term feature maps (stretch,
// periodic embedding, select and gate already folded in on the host side,
// gpar_torch/ops/gram_kernel.py), concatenated column-wise into xf (n, D)
// and yf (m, D); each term reads its own true width (no lane padding).
//
// Squared distances are computed directly as sum_k (u_k - v_k)^2, not by the
// norm identity |u|^2 + |v|^2 - 2 u.v the TPU kernel uses to feed its matrix
// unit.  Here every term is at most 128 wide (in the main path 1 to 15), so
// the identity saves nothing on CUDA cores, and the direct form has no
// cancellation: in float32 the identity loses ~eps * |u|^2 absolute in d2,
// ~3e-4 at the main path's input scale (|u| ~ 50), while the direct form is
// accurate to a few ulps of d2 and needs no clamp at zero.
//
// What bounds it on an H100: the output write, n * m * sizeof(T) bytes at
// 3.35 TB/s, against the function's n * m * (2 * sum d_t + ~20) FLOPs at the
// 67 TFLOP/s float32 rate outside the tensor cores (the direct form above
// spends 3 rather than 2 per rbf/rq feature, the price of its accuracy).
// With the main path's widths (sum d <= 31) the two are within a few times
// of each other, and at (256, 10000) both are microseconds, so launch
// latency dominates.  The simple design: one block of 16 x 16 threads per 64 x 64
// output tile, 4 x 4 outputs per thread held in registers across all terms;
// the tile's x rows and y rows of each term are staged through shared
// memory in chunks of 32 features; exp / log1p stay in registers; each
// output element is written once, half-warps on consecutive columns.
// Ragged edges load zeros and are masked on the write.

#include <cuda_runtime.h>

#define GPAR_GRAM_MAX_TERMS 32
#define GPAR_TILE 64
#define GPAR_KCH 32
#define GPAR_TX 16
#define GPAR_TY 16

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

template <typename T>
__global__ void __launch_bounds__(GPAR_TX * GPAR_TY)
gram_tile_kernel(const T* __restrict__ xf, const T* __restrict__ yf,
                 const T* __restrict__ par, T* __restrict__ out, int n, int m,
                 int D, TermSpec spec) {
  // Feature-major staging; the +1 pad keeps the row-major global loads'
  // shared-memory stores off a single bank.
  __shared__ T xs[GPAR_KCH][GPAR_TILE + 1];
  __shared__ T ys[GPAR_KCH][GPAR_TILE + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * GPAR_TX + tx;
  const int row0 = blockIdx.y * GPAR_TILE;
  const int col0 = blockIdx.x * GPAR_TILE;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int t = 0; t < spec.n_terms; ++t) {
    const int kind = spec.kind[t];
    const int off = spec.off[t];
    const int d = spec.dim[t];
    T s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = T(0);

    for (int kc = 0; kc < d; kc += GPAR_KCH) {
      const int kd = min(GPAR_KCH, d - kc);
      __syncthreads();  // the previous chunk's readers are done
      for (int idx = tid; idx < GPAR_TILE * kd; idx += GPAR_TX * GPAR_TY) {
        const int r = idx / kd;
        const int k = idx - r * kd;
        const int gr = row0 + r;
        const int gc = col0 + r;
        xs[k][r] = gr < n ? xf[(size_t)gr * D + off + kc + k] : T(0);
        ys[k][r] = gc < m ? yf[(size_t)gc * D + off + kc + k] : T(0);
      }
      __syncthreads();
      if (kind == KIND_LIN) {
        for (int k = 0; k < kd; ++k) {
          T a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + GPAR_TY * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = ys[k][tx + GPAR_TX * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
        }
      } else {
        for (int k = 0; k < kd; ++k) {
          T a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + GPAR_TY * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = ys[k][tx + GPAR_TX * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const T diff = a[i] - b[j];
              s[i][j] += diff * diff;
            }
        }
      }
    }

    const T w = par[t];
    if (kind == KIND_LIN) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += w * s[i][j];
    } else if (kind == KIND_RBF) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += w * dev_exp(T(-0.5) * s[i][j]);
    } else {
      const T alpha = par[spec.n_terms + t];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += w * dev_exp(-alpha * dev_log1p(s[i][j] / (T(2) * alpha)));
    }
  }

  const T cst = par[2 * spec.n_terms];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + GPAR_TY * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + GPAR_TX * j;
      if (c < m) out[(size_t)r * m + c] = acc[i][j] + cst;
    }
  }
}

template <typename T>
static int launch(const void* xf, const void* yf, const void* par, void* out,
                  int n, int m, int D, int n_terms, const int* kinds,
                  const int* offs, const int* dims, void* stream) {
  if (n_terms < 1 || n_terms > GPAR_GRAM_MAX_TERMS || n < 1 || m < 1)
    return (int)cudaErrorInvalidValue;
  TermSpec spec;
  spec.n_terms = n_terms;
  for (int t = 0; t < n_terms; ++t) {
    spec.kind[t] = kinds[t];
    spec.off[t] = offs[t];
    spec.dim[t] = dims[t];
  }
  dim3 block(GPAR_TX, GPAR_TY);
  dim3 grid((m + GPAR_TILE - 1) / GPAR_TILE, (n + GPAR_TILE - 1) / GPAR_TILE);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  gram_tile_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)xf, (const T*)yf, (const T*)par, (T*)out, n, m, D, spec);
  return (int)cudaGetLastError();
}

extern "C" {

int gpar_gram_max_terms() { return GPAR_GRAM_MAX_TERMS; }

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

const char* gpar_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
