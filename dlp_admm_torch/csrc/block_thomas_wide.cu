// Batched symmetric block-tridiagonal solve (block Thomas), block width
// 32 < B <= the shared-memory limit: one thread block per system.
//
// Replaces the Pallas kernel dlp_admm_tpu/solvers/thomas_pallas.py
// (block_thomas_solve_pallas, body _thomas_kernel); block_thomas_warp.cu is
// the same function for B <= 32 and says what it computes: block Thomas with
// a row-swapping Gauss-Jordan on each stage's [C_k | U_k | g_k] (the first
// largest |entry| of the pivot column, pivots floored at +-1e-30, one
// reciprocal per pivot, multipliers a_ij / pivot), back substitution, and,
// in the equilibrated variant, what dlp_admm_tpu/solvers/linalg.py
// equil_solve does around each stage solve: d = 1/sqrt(max(rowmax|C_k|,
// 1e-30)), eliminate (D C D) Y = D [U_k | g_k], refine once on the scaled
// system by eliminating [D C D | residual] again, X = D Y.
//
// Layout: diag [S, T, B, B], upper [S, Tu, B, B] (Tu = T-1 or T; entry T-1
// is ignored), rhs [S, T, B], out [S, T, B], row-major and contiguous.
// xs [S, T, B, B] and ys [S, T, B] are scratch the caller allocates.
//
// What bounds it on this card: a serial chain of T*B dependent pivot steps
// per system, each a rank-1 update of a [B, 2B+1] tile that no longer fits
// one warp's registers. The time is the chain's length times the cost of a
// pivot step: two block barriers and a round trip through shared memory.
//
// What the design does about it: blockIdx.x = s, so S systems run on S SMs;
// the whole recursion, both passes, is one launch; the augmented tile and
// X_{k-1}, y_{k-1} live in shared memory; each warp takes rows of the tile
// and its lanes stride over the columns right of the pivot, so no index is
// divided in an inner loop; every thread finds the pivot row itself from
// the same shared values, and the row swap is folded into the update, so a
// pivot costs two barriers. It is the block-per-system design the port began
// with, kept for the widths the warp kernel cannot hold (the 8-vehicle
// local width 61); a width past the shared-memory limit (the 8-vehicle edge
// width 264) needs a tile in global memory and is refused by the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T floor_pivot(T p) {
  const T tiny = T(1e-30);
  if (fabs(p) > tiny) return p;
  return p >= T(0) ? tiny : -tiny;
}

// Gauss-Jordan with partial pivoting on aug [b, w] in shared memory: on
// return columns b.. hold C^-1 [those columns]. Ends with a barrier.
template <typename T>
__device__ void gauss_jordan(T* aug, T* prow, T* jrow, T* fcol, int b, int w) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int j = 0; j < b; ++j) {
    // pivot row p: the first largest |aug[i, j]|, i >= j (a NaN wins, as
    // in argmax); every thread finds the same p from the same shared
    // values, so no barrier
    int p = j;
    T best = fabs(aug[j * w + j]);
    for (int i = j + 1; i < b; ++i) {
      const T v = fabs(aug[i * w + j]);
      if (v > best || (v != v && best == best)) {
        best = v;
        p = i;
      }
    }
    const T inv = T(1) / floor_pivot(aug[p * w + j]);
    for (int c = j + 1 + tid; c < w; c += kThreads) {
      prow[c] = aug[p * w + c];
      jrow[c] = aug[j * w + c];
    }
    // row i's multiplier a_ij / pivot, as in the warp kernel
    for (int i = tid; i < b; i += kThreads) fcol[i] = aug[i * w + j] * inv;
    __syncthreads();
    // rows j and p swap: row j becomes the scaled pivot row, row p the
    // eliminated old row j
    for (int i = warp; i < b; i += kWarps) {
      T* row = aug + i * w;
      if (i == j) {
        for (int c = j + 1 + lane; c < w; c += 32) row[c] = prow[c] * inv;
      } else if (i == p) {
        const T f = fcol[j];
        for (int c = j + 1 + lane; c < w; c += 32)
          row[c] = fma(-f, prow[c], jrow[c]);
      } else {
        const T f = fcol[i];
        for (int c = j + 1 + lane; c < w; c += 32)
          row[c] = fma(-f, prow[c], row[c]);
      }
    }
    __syncthreads();
  }
}

template <typename T, bool EQ>
__global__ void __launch_bounds__(kThreads)
thomas_wide_kernel(const T* __restrict__ diag, const T* __restrict__ upper,
                   const T* __restrict__ rhs, T* __restrict__ out,
                   T* __restrict__ xs, T* __restrict__ ys, int t_len, int b,
                   int upper_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int w = 2 * b + 1;            // augmented width [C | U | g]
  T* aug = smem;                      // [b, w]
  T* x_prev = aug + b * w;            // [b, b]  X_{k-1}
  T* y_prev = x_prev + b * b;         // [b]     y_{k-1}, then z_{k+1}
  T* prow = y_prev + b;               // [w]     pivot row
  T* jrow = prow + w;                 // [w]     row j before a row swap
  T* fcol = jrow + w;                 // [b]     pivot column (factors)
  T* orig = fcol + b;                 // [b, w]  EQ: the scaled stage system
  T* dsc = orig + b * w;              // [b]     EQ: the row scales d

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* d_s = diag + (size_t)s * t_len * b * b;
  const T* u_s = upper + (size_t)s * upper_len * b * b;
  const T* r_s = rhs + (size_t)s * t_len * b;
  T* x_s = xs + (size_t)s * t_len * b * b;
  T* y_s = ys + (size_t)s * t_len * b;
  T* o_s = out + (size_t)s * t_len * b;

  for (int k = 0; k < t_len; ++k) {
    const T* d_k = d_s + (size_t)k * b * b;
    const T* u_km1 = k > 0 ? u_s + (size_t)(k - 1) * b * b : nullptr;
    const T* u_k = k < t_len - 1 ? u_s + (size_t)k * b * b : nullptr;
    // aug = [D_k - U_{k-1}^T X_{k-1} | U_k | r_k - U_{k-1}^T y_{k-1}]
    for (int i = warp; i < b; i += kWarps) {
      for (int c = lane; c < w; c += 32) {
        T v;
        if (c < b) {
          v = d_k[i * b + c];
          if (u_km1) {
            T acc = T(0);
            for (int q = 0; q < b; ++q)
              acc = fma(u_km1[q * b + i], x_prev[q * b + c], acc);
            v -= acc;
          }
        } else if (c < 2 * b) {
          v = u_k ? u_k[i * b + (c - b)] : T(0);
        } else {
          v = r_s[k * b + i];
          if (u_km1) {
            T acc = T(0);
            for (int q = 0; q < b; ++q)
              acc = fma(u_km1[q * b + i], y_prev[q], acc);
            v -= acc;
          }
        }
        aug[i * w + c] = v;
      }
    }
    __syncthreads();

    if (EQ) {
      for (int i = warp; i < b; i += kWarps) {
        T r = T(0);
        for (int c = lane; c < b; c += 32) r = fmax(r, fabs(aug[i * w + c]));
        for (int m = 16; m > 0; m >>= 1)
          r = fmax(r, __shfl_xor_sync(0xffffffffu, r, m));
        if (lane == 0) dsc[i] = T(1) / sqrt(fmax(r, T(1e-30)));
      }
      __syncthreads();
      for (int i = warp; i < b; i += kWarps) {
        const T di = dsc[i];
        for (int c = lane; c < w; c += 32) {
          T v = aug[i * w + c] * di;
          if (c < b) v *= dsc[c];
          aug[i * w + c] = v;
          orig[i * w + c] = v;
        }
      }
      __syncthreads();
    }

    gauss_jordan(aug, prow, jrow, fcol, b, w);

    if (EQ) {
      // park Y in x_prev | y_prev, put [D C D | residual] into aug
      for (int i = warp; i < b; i += kWarps) {
        for (int c = lane; c < b; c += 32)
          x_prev[i * b + c] = aug[i * w + b + c];
        if (lane == 0) y_prev[i] = aug[i * w + 2 * b];
      }
      __syncthreads();
      for (int i = warp; i < b; i += kWarps) {
        const T* orow = orig + i * w;
        for (int c = lane; c < w; c += 32) {
          T v = orow[c];
          if (c >= b) {
            const int cc = c - b;
            for (int q = 0; q < b; ++q)
              v = fma(-orow[q], cc < b ? x_prev[q * b + cc] : y_prev[q], v);
          }
          aug[i * w + c] = v;
        }
      }
      __syncthreads();
      gauss_jordan(aug, prow, jrow, fcol, b, w);
    }

    // X_k = aug[:, b:2b], y_k = aug[:, 2b]  (EQ: D (Y + dY))
    T* x_k = x_s + (size_t)k * b * b;
    for (int i = warp; i < b; i += kWarps) {
      const T di = EQ ? dsc[i] : T(1);
      for (int c = lane; c <= b; c += 32) {
        T v = aug[i * w + b + c];
        if (c < b) {
          if (EQ) v = (x_prev[i * b + c] + v) * di;
          x_prev[i * b + c] = v;
          x_k[i * b + c] = v;
        } else {
          if (EQ) v = (y_prev[i] + v) * di;
          y_prev[i] = v;
          y_s[k * b + i] = v;
        }
      }
    }
    __syncthreads();
  }

  // back substitution: z_k = y_k - X_k z_{k+1}; y_prev holds z_{k+1}
  for (int i = tid; i < b; i += kThreads) y_prev[i] = T(0);
  __syncthreads();
  for (int k = t_len - 1; k >= 0; --k) {
    const T* x_k = x_s + (size_t)k * b * b;
    for (int i = tid; i < b; i += kThreads) {
      T acc = T(0);
      for (int q = 0; q < b; ++q) acc = fma(x_k[i * b + q], y_prev[q], acc);
      fcol[i] = y_s[k * b + i] - acc;
    }
    __syncthreads();
    for (int i = tid; i < b; i += kThreads) {
      y_prev[i] = fcol[i];
      o_s[k * b + i] = fcol[i];
    }
    __syncthreads();
  }
}

size_t wide_elems(int b, bool eq) {
  const size_t w = 2 * (size_t)b + 1;
  size_t n = b * w + (size_t)b * b + b + 2 * w + b;
  if (eq) n += b * w + b;
  return n;
}

template <typename T, bool EQ>
int launch(const void* diag, const void* upper, const void* rhs, void* out,
           void* xs, void* ys, int s, int t_len, int b, int upper_len,
           size_t smem_bytes, void* stream) {
  static size_t allowed = 48 * 1024;
  const size_t need = sizeof(T) * wide_elems(b, EQ);
  if (need != smem_bytes) return -2;   // the wrapper's layout is not this one
  if (need > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        thomas_wide_kernel<T, EQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)need);
    if (err != cudaSuccess) return (int)err;
    allowed = need;
  }
  thomas_wide_kernel<T, EQ><<<s, kThreads, need, (cudaStream_t)stream>>>(
      (const T*)diag, (const T*)upper, (const T*)rhs, (T*)out, (T*)xs, (T*)ys,
      t_len, b, upper_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One thread block per system. elem_bytes 8 (double) or 4 (float);
// smem_bytes is the block's dynamic shared memory as the caller computed it.
// Returns 0, a cudaError, -1 for an argument no kernel was built for, or -2
// when smem_bytes is not what this layout needs.
int block_thomas_wide(const void* diag, const void* upper, const void* rhs,
                      void* out, void* xs, void* ys, int s, int t_len, int b,
                      int upper_len, int elem_bytes, int equilibrate,
                      size_t smem_bytes, void* stream) {
  if (b < 1 || s < 1 || t_len < 1) return -1;
#define ARGS \
  diag, upper, rhs, out, xs, ys, s, t_len, b, upper_len, smem_bytes, stream
  if (elem_bytes == 8)
    return equilibrate ? launch<double, true>(ARGS)
                       : launch<double, false>(ARGS);
  if (elem_bytes == 4)
    return equilibrate ? launch<float, true>(ARGS) : launch<float, false>(ARGS);
#undef ARGS
  return -1;
}

}  // extern "C"
