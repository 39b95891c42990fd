// Batched symmetric block-tridiagonal solve (block Thomas).
//
// Replaces the Pallas kernel dlp_admm_tpu/solvers/thomas_pallas.py
// (block_thomas_solve_pallas, body _thomas_kernel). It computes the same
// function: for each system s,
//   forward:  C_k = D_k - U_{k-1}^T X_{k-1},  g_k = r_k - U_{k-1}^T y_{k-1},
//             Gauss-Jordan on [C_k | U_k | g_k], each pivot floored at
//             +-1e-30 (sign kept), giving X_k = C_k^-1 U_k and
//             y_k = C_k^-1 g_k (U_{T-1} = 0);
//   backward: z_k = y_k - X_k z_{k+1},  z_T = 0.
// The subdiagonal blocks are U^T (the system is symmetric). No equilibration
// inside the kernel: the caller refines.
//
// One deliberate difference: the elimination swaps rows (partial pivoting,
// the first largest |entry| of the pivot column), where the Pallas kernel
// does not, as the JAX package's float64 stage solve (LU with partial
// pivoting) does. The flagship's stage blocks are saddle-point KKT matrices;
// an unpivoted elimination cannot factor one whose leading entries vanish,
// and on the H100 the unpivoted kernel's 42-step float64 flagship ended with
// NLP health 0.845 and a consensus gap of 211, against 0.929 and 0.373
// pivoted. On a system that needs no swap (e.g. diagonally dominant) both
// give the same numbers.
//
// Layout: diag [S, T, B, B], upper [S, Tu, B, B] (Tu = T-1 or T; entry T-1 is
// ignored), rhs [S, T, B], out [S, T, B], all row-major and contiguous.
// xs [S, T, B, B] and ys [S, T, B] are scratch the caller allocates.
//
// What bounds it on this card: each system is a serial chain of T*B
// dependent pivot steps (T*B = 140 for the flagship's T=7, B=20), each a
// rank-1 update of a [B, 2B+1] tile; the flops are tiny (~2 T B^2 (2B+1) per
// system). At the flagship's S <= 2 systems only 1-2 of the H100's 132 SMs
// have work, so the kernel is latency-bound: its time is the chain's length
// times the cost of one pivot step (shared-memory round trip + barrier).
//
// What the design does about it: the TPU kernel put 128 systems on the vector
// lanes and padded S with identity systems; on Hopper each system gets its own
// thread block (blockIdx.x = s), so there is no padding and S systems run on S
// SMs in parallel. The whole recursion, both passes, stays inside one launch:
// the augmented tile [B, 2B+1] and the previous stage's X_{k-1}, y_{k-1} live
// in shared memory, the threads of the block stride over the tile for each
// pivot's rank-1 update, and only the columns right of the pivot are touched
// (the columns left of it never reach the output). The pivot search is a
// scan of at most B shared values that every thread makes alone, and the row
// swap is folded into the update, so a pivot still costs two barriers.
// Packing several systems per block and warp-level elimination are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T floor_pivot(T p) {
  const T tiny = T(1e-30);
  if (fabs(p) > tiny) return p;
  return p >= T(0) ? tiny : -tiny;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_thomas_kernel(const T* __restrict__ diag, const T* __restrict__ upper,
                    const T* __restrict__ rhs, T* __restrict__ out,
                    T* __restrict__ xs, T* __restrict__ ys, int t_len, int b,
                    int upper_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int w = 2 * b + 1;            // augmented width [C | U | g]
  T* aug = smem;                      // [b, w]
  T* x_prev = aug + b * w;            // [b, b]  X_{k-1}
  T* y_prev = x_prev + b * b;         // [b]     y_{k-1}, then z_{k+1}
  T* prow = y_prev + b;               // [w]     scaled pivot row
  T* jrow = prow + w;                 // [w]     row j before a row swap
  T* fcol = jrow + w;                 // [b]     pivot column (factors)

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
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
    for (int e = tid; e < b * w; e += nth) {
      const int i = e / w;
      const int c = e - i * w;
      T v;
      if (c < b) {
        v = d_k[i * b + c];
        if (u_km1) {
          T acc = T(0);
          for (int a = 0; a < b; ++a) acc += u_km1[a * b + i] * x_prev[a * b + c];
          v -= acc;
        }
      } else if (c < 2 * b) {
        v = u_k ? u_k[i * b + (c - b)] : T(0);
      } else {
        v = r_s[k * b + i];
        if (u_km1) {
          T acc = T(0);
          for (int a = 0; a < b; ++a) acc += u_km1[a * b + i] * y_prev[a];
          v -= acc;
        }
      }
      aug[e] = v;
    }
    __syncthreads();

    // Gauss-Jordan with partial pivoting (floored pivots)
    for (int j = 0; j < b; ++j) {
      // pivot row p: the first largest |aug[i, j]|, i >= j; every thread
      // finds the same p from the same shared values, so no barrier
      int p = j;
      T best = fabs(aug[j * w + j]);
      for (int i = j + 1; i < b; ++i) {
        const T v = fabs(aug[i * w + j]);
        if (v > best) {
          best = v;
          p = i;
        }
      }
      const T pjj = floor_pivot(aug[p * w + j]);
      const int ncol = w - j - 1;     // columns right of the pivot
      for (int e = tid; e < 2 * ncol + b; e += nth) {
        if (e < ncol) {
          const int c = j + 1 + e;
          prow[c] = aug[p * w + c] / pjj;
        } else if (e < 2 * ncol) {
          const int c = j + 1 + (e - ncol);
          jrow[c] = aug[j * w + c];
        } else {
          const int i = e - 2 * ncol;
          fcol[i] = aug[i * w + j];
        }
      }
      __syncthreads();
      // rows j and p swap: row j becomes the scaled pivot row, row p the
      // eliminated old row j
      for (int e = tid; e < b * ncol; e += nth) {
        const int i = e / ncol;
        const int c = j + 1 + (e - i * ncol);
        T v;
        if (i == j) {
          v = prow[c];
        } else if (i == p) {
          v = jrow[c] - fcol[j] * prow[c];
        } else {
          v = aug[i * w + c] - fcol[i] * prow[c];
        }
        aug[i * w + c] = v;
      }
      __syncthreads();
    }

    // X_k = aug[:, b:2b], y_k = aug[:, 2b]
    T* x_k = x_s + (size_t)k * b * b;
    for (int e = tid; e < b * b; e += nth) {
      const int i = e / b;
      const int c = e - i * b;
      const T v = aug[i * w + b + c];
      x_prev[e] = v;
      x_k[e] = v;
    }
    for (int i = tid; i < b; i += nth) {
      const T v = aug[i * w + 2 * b];
      y_prev[i] = v;
      y_s[k * b + i] = v;
    }
    __syncthreads();
  }

  // back substitution: z_k = y_k - X_k z_{k+1}; y_prev holds z_{k+1}
  for (int i = tid; i < b; i += nth) y_prev[i] = T(0);
  __syncthreads();
  for (int k = t_len - 1; k >= 0; --k) {
    const T* x_k = x_s + (size_t)k * b * b;
    for (int i = tid; i < b; i += nth) {
      T acc = T(0);
      for (int a = 0; a < b; ++a) acc += x_k[i * b + a] * y_prev[a];
      fcol[i] = y_s[k * b + i] - acc;
    }
    __syncthreads();
    for (int i = tid; i < b; i += nth) {
      y_prev[i] = fcol[i];
      o_s[k * b + i] = fcol[i];
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int b) {
  const int w = 2 * b + 1;
  return sizeof(T) * ((size_t)b * w + (size_t)b * b + b + 2 * w + b);
}

template <typename T>
int launch(const T* diag, const T* upper, const T* rhs, T* out, T* xs, T* ys,
           int s, int t_len, int b, int upper_len, void* stream) {
  const size_t smem = smem_bytes<T>(b);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_thomas_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  block_thomas_kernel<T><<<s, kThreads, smem, (cudaStream_t)stream>>>(
      diag, upper, rhs, out, xs, ys, t_len, b, upper_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs at width b, elem_bytes 8 (double) or
// 4 (float); the wrapper checks it against the device's per-block limit.
size_t block_thomas_smem_bytes(int b, int elem_bytes) {
  return elem_bytes == 8 ? smem_bytes<double>(b) : smem_bytes<float>(b);
}

int block_thomas_f64(const double* diag, const double* upper,
                     const double* rhs, double* out, double* xs, double* ys,
                     int s, int t_len, int b, int upper_len, void* stream) {
  return launch<double>(diag, upper, rhs, out, xs, ys, s, t_len, b, upper_len,
                        stream);
}

int block_thomas_f32(const float* diag, const float* upper, const float* rhs,
                     float* out, float* xs, float* ys, int s, int t_len,
                     int b, int upper_len, void* stream) {
  return launch<float>(diag, upper, rhs, out, xs, ys, s, t_len, b, upper_len,
                       stream);
}

}  // extern "C"
