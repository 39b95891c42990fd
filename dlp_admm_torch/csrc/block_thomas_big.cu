// Batched symmetric block-tridiagonal solve (block Thomas) for the block
// widths past the wide kernel's classes (float64 B > 97, float32 B > 138;
// equilibrated: B > 80 and B > 106): one thread block per system, the
// stage's augmented tile in shared memory where it fits, else in a device
// workspace.
//
// Replaces the Pallas kernel dlp_admm_tpu/solvers/thomas_pallas.py
// (block_thomas_solve_pallas, body _thomas_kernel) at these widths;
// block_thomas_warp.cu (B <= 32) and block_thomas_wide.cu (up to the wide
// classes) compute the same function: block Thomas with a row-swapping
// Gauss-Jordan on each stage's [C_k | U_k | g_k] (row j swaps with the
// first row i >= j of largest |aug[i, j]|, a NaN above everything; the
// pivot floored at +-1e-30; row i subtracts (aug[i, j] / pivot) times the
// pivot row, the pivot row is scaled by 1 / pivot), back substitution, and,
// in the equilibrated variant, what dlp_admm_tpu/solvers/linalg.py
// equil_solve does around each stage solve: d = 1/sqrt(max(rowmax|C_k|,
// 1e-30)), eliminate (D C D) Y = D [U_k | g_k], refine once on the scaled
// system, X = D Y. solvers/thomas.py (block_thomas_plain) is the same
// function in plain PyTorch.
//
// Layout: diag [S, T, B, B], upper [S, Tu, B, B] (Tu = T-1 or T; entry T-1
// is ignored), rhs [S, T, B], out [S, T, B], row-major and contiguous.
// Scratch the caller allocates: xs [S, T, B, B] and ys [S, T, B] (every
// stage's X_k, y_k, for the back substitution); work [S, B (2B+1)] (the
// tile, where it does not fit shared memory; else null); equilibrated,
// orig [S, B (2B+1) + B B] (the scaled stage system, for the refinement's
// residual, then every pivot step's multipliers). Every element the kernel
// reads there it has written first.
//
// What bounds it on this card: a serial chain of T*B dependent pivot steps
// per system, each a block-wide argmax, a row swap and a rank-one update of
// the tile's B x (2B+1-j) live entries. The bytes (one read of the inputs)
// and the operations (about 3 B^3 a stage) are far below what one SM moves
// and computes in that time.
//
// What the design does about it (a simple design; a later one makes it
// fast). The tile [B][2B+1] stays on chip where it fits (float64 up to
// B = 118, float32 up to 168 on an H100; 187 KB at B = 108 in float64,
// past the 48 KB default, so the launch opts in to more), else in an
// L2-resident device workspace (1.1 MB a system at B = 264 in float64).
// Rows move as the plain version moves them. A pivot step has two block
// barriers: after the first, every thread reads the warps' candidates
// (largest key, then smallest row) and copies the pivot row and row j;
// after the second, warp w updates rows w, w + NW, ... (lane l the columns
// j+1+l, j+33+l, ...; the columns left of the pivot are dead), reading the
// two copied rows, so no row is read while another thread writes it; lane 0,
// which holds column j+1 of each of its rows, offers the warp's candidate
// for the next pivot step. The stage product D_k - U_{k-1}^T X_{k-1} reads
// X_{k-1} | y_{k-1} from the tile (where the last stage left it) and
// U_{k-1} from device memory, four rows a thread. The equilibrated variant
// keeps the scaled system and every step's multipliers in device scratch
// and replays the steps on the residual columns only.
//
// The file is compiled once per element type (-DBLOCK_THOMAS_REAL=double
// or float); the width is a run-time argument. solvers/thomas.py mirrors the
// shared-memory layout (big_bytes), and the launch refuses a call whose
// numbers differ.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#ifndef BLOCK_THOMAS_REAL
#error "compile with -DBLOCK_THOMAS_REAL=double or -DBLOCK_THOMAS_REAL=float"
#endif

namespace {

using real = BLOCK_THOMAS_REAL;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRows = 4;            // rows a thread holds in the products

template <typename T>
__device__ __forceinline__ T floor_pivot(T p) {
  const T tiny = T(1e-30);
  if (fabs(p) > tiny) return p;
  return p >= T(0) ? tiny : -tiny;
}

// |v| as an unsigned key that orders like |v| (a NaN above everything); a
// candidate is key + 1, and 0 offers nothing
template <typename T>
__device__ __forceinline__ unsigned long long abs_key(T v) {
  if constexpr (sizeof(T) == 8)
    return (unsigned long long)__double_as_longlong(fabs(v));
  else
    return __float_as_uint(fabsf(v));
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of one block, in bytes: in elements the pivot row and row
// j [2][2B+1], the new g column [B], the row scales [B], the reciprocal
// pivots [B] and, where it lives there, the tile [B][2B+1]; then the
// warps' candidates (u64 keys, int rows [kMaxWarps] each) and the pivot
// rows of the elimination (int[B]).
__host__ __device__ inline size_t big_bytes(int b, int elem,
                                            int tile_in_smem) {
  const size_t w = 2 * (size_t)b + 1;
  const size_t tile = tile_in_smem ? (size_t)b * w : 0;
  return round16((size_t)elem * (2 * w + 3 * (size_t)b + tile)) +
         8 * kMaxWarps + 4 * kMaxWarps + round16(4 * (size_t)b);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// out[i][c] = base(i, c) - sum_q a(i, q) x[q][c] for rows i < b and columns
// c < ncol, kRows rows a thread; x is row-major with stride ldx. The result
// goes through put(i, c, value).
template <typename T, typename A, typename Base, typename Put>
__device__ __forceinline__ void product(int b, int ncol, const T* x, int ldx,
                                        A a, Base base, Put put) {
  const int nrb = (b + kRows - 1) / kRows;
  for (int item = threadIdx.x; item < nrb * ncol; item += blockDim.x) {
    const int c = item % ncol;
    const int i0 = (item / ncol) * kRows;
    T acc[kRows] = {};
    for (int q = 0; q < b; ++q) {
      const T xv = x[(size_t)q * ldx + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (i0 + r < b) acc[r] = fma(a(i0 + r, q), xv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (i0 + r < b) put(i0 + r, c, base(i0 + r, c) - acc[r]);
  }
}

// One system a block. EQ: the equilibrated variant.
template <typename T, bool EQ>
__device__ void thomas_big(const T* __restrict__ diag,
                           const T* __restrict__ upper,
                           const T* __restrict__ rhs, T* __restrict__ out,
                           T* xs, T* ys, T* work, T* orig, int t_len, int b,
                           int upper_len, int tile_in_smem,
                           unsigned char* smem) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = nthr >> 5;
  const int w_cols = 2 * b + 1;     // [C | U | g]
  const size_t ld = w_cols;
  T* prow = reinterpret_cast<T*>(smem);   // the pivot row
  T* jrow = prow + w_cols;                 // row j before the step
  T* gnew = jrow + w_cols;                 // the stage's g, or the residual's
  T* dsc = gnew + b;                       // row scales
  T* invs = dsc + b;                       // each step's 1 / pivot
  T* tile_smem = invs + b;
  unsigned char* tail =
      smem + round16(sizeof(T) * (2 * (size_t)w_cols + 3 * (size_t)b +
                                  (tile_in_smem ? (size_t)b * w_cols : 0)));
  unsigned long long* ckey = reinterpret_cast<unsigned long long*>(tail);
  int* cpos = reinterpret_cast<int*>(ckey + kMaxWarps);
  int* piv = cpos + kMaxWarps;

  const int s = blockIdx.x;
  const size_t bb = (size_t)b * b;
  const T* d_s = diag + (size_t)s * t_len * bb;
  const T* u_s = upper + (size_t)s * upper_len * bb;
  const T* r_s = rhs + (size_t)s * t_len * b;
  T* x_s = xs + (size_t)s * t_len * bb;
  T* y_s = ys + (size_t)s * t_len * b;
  T* o_s = out + (size_t)s * t_len * b;
  T* tile = tile_in_smem ? tile_smem : work + (size_t)s * b * ld;
  // equilibrated: the scaled stage system [B][2B+1], then every step's
  // multipliers [B][B] (step j, row i)
  T* g_s = EQ ? orig + (size_t)s * (b * ld + bb) : nullptr;
  T* gm_s = EQ ? g_s + (size_t)b * ld : nullptr;

  // lane 0 of each warp: the warp's candidate for pivot column j among its
  // rows i >= j (rows w, w + NW, ...), from the values it passes in
  auto offer = [&](unsigned long long& key, int& pos, int i, T v) {
    const unsigned long long k = abs_key(v) + 1ull;
    if (k > key || (k == key && i < pos)) {
      key = k;
      pos = i;
    }
  };
  auto publish = [&](unsigned long long key, int pos) {
    if (lane == 0) {
      ckey[warp] = key;
      cpos[warp] = pos;
    }
  };
  // the first largest of the warps' candidates (every thread)
  auto winner = [&]() {
    unsigned long long key = 0;
    int pos = INT_MAX;
    for (int w = 0; w < nw; ++w) {
      const unsigned long long k = ckey[w];
      const int p = cpos[w];
      if (k > key || (k == key && p < pos)) {
        key = k;
        pos = p;
      }
    }
    return pos;
  };

  for (int k = 0; k < t_len; ++k) {
    const T* d_k = d_s + (size_t)k * bb;
    const T* r_k = r_s + (size_t)k * b;
    const T* u_k = k < t_len - 1 ? u_s + (size_t)k * bb : nullptr;
    // C = D_k - U_{k-1}^T X_{k-1}, g = r_k - U_{k-1}^T y_{k-1}, with
    // X_{k-1} | y_{k-1} in the tile's columns B .. 2B, where the last stage
    // left them; C goes to the dead columns 0 .. B-1, g to gnew
    if (k == 0) {
      for (int e = tid; e < b * b; e += nthr)
        tile[(size_t)(e / b) * ld + e % b] = d_k[e];
      for (int i = tid; i < b; i += nthr) gnew[i] = r_k[i];
    } else {
      const T* u_p = u_s + (size_t)(k - 1) * bb;
      product<T>(
          b, b + 1, tile + b, (int)ld,
          [&](int i, int q) { return u_p[(size_t)q * b + i]; },
          [&](int i, int c) {
            return c < b ? d_k[(size_t)i * b + c] : r_k[i];
          },
          [&](int i, int c, T v) {
            if (c < b)
              tile[(size_t)i * ld + c] = v;
            else
              gnew[i] = v;
          });
    }
    __syncthreads();    // every read of X_{k-1} | y_{k-1} is done
    for (int e = tid; e < b * (b + 1); e += nthr) {
      const int i = e / (b + 1), c = e % (b + 1);
      tile[(size_t)i * ld + b + c] =
          c < b ? (u_k ? u_k[(size_t)i * b + c] : T(0)) : gnew[i];
    }
    __syncthreads();

    if (EQ) {
      for (int i = warp; i < b; i += nw) {
        T mx = T(0);
        for (int c = lane; c < b; c += 32)
          mx = fmax(mx, fabs(tile[(size_t)i * ld + c]));
        mx = warp_max(mx);
        if (lane == 0) dsc[i] = T(1) / sqrt(fmax(mx, T(1e-30)));
      }
      __syncthreads();
      for (int e = tid; e < b * w_cols; e += nthr) {
        const int i = e / w_cols, c = e % w_cols;
        T v = tile[(size_t)i * ld + c] * dsc[i];
        if (c < b) v *= dsc[c];
        tile[(size_t)i * ld + c] = v;
        g_s[(size_t)i * ld + c] = v;
      }
      __syncthreads();
    }

    // Gauss-Jordan, two barriers a pivot step
    {
      unsigned long long key = 0;
      int pos = INT_MAX;
      if (lane == 0)
        for (int i = warp; i < b; i += nw)
          offer(key, pos, i, tile[(size_t)i * ld]);
      publish(key, pos);
    }
    for (int j = 0; j < b; ++j) {
      __syncthreads();    // the candidates are in, the last update is done
      const int p = winner();
      for (int c = j + tid; c < w_cols; c += nthr) {
        prow[c] = tile[(size_t)p * ld + c];
        jrow[c] = tile[(size_t)j * ld + c];
      }
      if (EQ && tid == 0) piv[j] = p;
      __syncthreads();
      const T inv = T(1) / floor_pivot(prow[j]);
      if (EQ && tid == 0) invs[j] = inv;
      unsigned long long key = 0;
      int pos = INT_MAX;
      for (int i = warp; i < b; i += nw) {
        T* row = tile + (size_t)i * ld;
        if (i == j) {
          for (int c = j + 1 + lane; c < w_cols; c += 32)
            row[c] = prow[c] * inv;
          continue;
        }
        // row p now holds what row j held
        const T* src = i == p ? jrow : row;
        const T m = src[j] * inv;
        if (EQ && lane == 0) gm_s[(size_t)j * b + i] = m;
        for (int c = j + 1 + lane; c < w_cols; c += 32) {
          const T v = fma(-m, prow[c], src[c]);
          row[c] = v;
          if (c == j + 1 && i > j) offer(key, pos, i, v);
        }
      }
      publish(key, pos);
    }
    __syncthreads();

    if (EQ) {
      // the residual D [U_k | g_k] - (D C D) Y of the solution Y in the
      // columns B .. 2B: its first B columns into the dead columns
      // 0 .. B-1, its last into gnew
      product<T>(
          b, b + 1, tile + b, (int)ld,
          [&](int i, int q) { return g_s[(size_t)i * ld + q]; },
          [&](int i, int c) { return g_s[(size_t)i * ld + b + c]; },
          [&](int i, int c, T v) {
            if (c < b)
              tile[(size_t)i * ld + c] = v;
            else
              gnew[i] = v;
          });
      __syncthreads();
      // residual entry (i, c), c <= B
      auto res = [&](int i, int c) -> T& {
        return c < b ? tile[(size_t)i * ld + c] : gnew[i];
      };
      // the elimination's steps again, on the residual
      for (int j = 0; j < b; ++j) {
        const int p = piv[j];
        for (int c = tid; c <= b; c += nthr) {
          prow[c] = res(p, c);
          jrow[c] = res(j, c);
        }
        __syncthreads();
        const T inv = invs[j];
        for (int i = warp; i < b; i += nw) {
          if (i == j) {
            for (int c = lane; c <= b; c += 32) res(j, c) = prow[c] * inv;
            continue;
          }
          const T m = gm_s[(size_t)j * b + i];
          for (int c = lane; c <= b; c += 32)
            res(i, c) = fma(-m, prow[c], i == p ? jrow[c] : res(i, c));
        }
        __syncthreads();
      }
      // X = D (Y + dY): solution row i is scaled by d[i]
      for (int e = tid; e < b * (b + 1); e += nthr) {
        const int i = e / (b + 1), c = e % (b + 1);
        T& y = tile[(size_t)i * ld + b + c];
        y = (y + res(i, c)) * dsc[i];
      }
      __syncthreads();
    }

    // X_k | y_k into the scratch the back substitution reads
    for (int e = tid; e < b * (b + 1); e += nthr) {
      const int i = e / (b + 1), c = e % (b + 1);
      const T v = tile[(size_t)i * ld + b + c];
      if (c < b)
        x_s[(size_t)k * bb + (size_t)i * b + c] = v;
      else
        y_s[(size_t)k * b + i] = v;
    }
  }

  // back substitution: z_k = y_k - X_k z_{k+1}, z in the two halves of prow
  __syncthreads();
  T* z_buf = prow;
  for (int i = tid; i < 2 * b; i += nthr) z_buf[i] = T(0);
  __syncthreads();
  for (int k = t_len - 1; k >= 0; --k) {
    const T* z_next = z_buf + ((k + 1) & 1) * b;
    T* z_k = z_buf + (k & 1) * b;
    const T* x_k = x_s + (size_t)k * bb;
    for (int i = warp; i < b; i += nw) {
      T acc = T(0);
      for (int q = lane; q < b; q += 32)
        acc = fma(x_k[(size_t)i * b + q], z_next[q], acc);
      acc = warp_sum(acc);
      if (lane == 0) {
        const T z = y_s[(size_t)k * b + i] - acc;
        z_k[i] = z;
        o_s[(size_t)k * b + i] = z;
      }
    }
    __syncthreads();
  }
}

template <bool EQ>
__global__ void __launch_bounds__(kMaxThreads, 1)
thomas_big_kernel(const real* __restrict__ diag,
                  const real* __restrict__ upper,
                  const real* __restrict__ rhs, real* __restrict__ out,
                  real* xs, real* ys, real* work, real* orig, int t_len, int b,
                  int upper_len, int tile_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_big<real, EQ>(diag, upper, rhs, out, xs, ys, work, orig, t_len, b,
                       upper_len, tile_in_smem, smem_raw);
}

template <bool EQ>
int launch(const void* diag, const void* upper, const void* rhs, void* out,
           void* xs, void* ys, void* work, void* orig, int s, int t_len, int b,
           int upper_len, int threads, int tile_in_smem, size_t smem_bytes,
           void* stream) {
  static size_t allowed = 48 * 1024;
  const size_t need = big_bytes(b, (int)sizeof(real), tile_in_smem);
  if (need != smem_bytes) return -2;   // the wrapper's layout is not this one
  auto kernel = thomas_big_kernel<EQ>;
  if (need > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err != cudaSuccess) return (int)err;
    allowed = need;
  }
  const real* d = (const real*)diag;
  const real* u = (const real*)upper;
  const real* r = (const real*)rhs;
  real* o = (real*)out;
  real* x = (real*)xs;
  real* y = (real*)ys;
  real* wk = (real*)work;
  real* g = (real*)orig;
  void* args[] = {&d, &u, &r, &o, &x, &y, &wk, &g,
                  &t_len, &b, &upper_len, &tile_in_smem};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(s),
                                     dim3(threads), args, need,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the element type this library was compiled for (8 or 4).
int block_thomas_big_elem_bytes() { return (int)sizeof(real); }

// One thread block of `threads` threads (a multiple of 32, at most 512) per
// system. work is the tile's scratch when tile_in_smem is 0 (else null);
// xs, ys and, equilibrated, orig are scratch; smem_bytes is the block's
// dynamic shared memory as the caller computed it. Returns 0, a cudaError,
// -1 for an argument the kernel does not take, or -2 when smem_bytes is not
// what this layout needs.
int block_thomas_big(const void* diag, const void* upper, const void* rhs,
                     void* out, void* xs, void* ys, void* work, void* orig,
                     int s, int t_len, int b, int upper_len, int equilibrate,
                     int threads, int tile_in_smem, size_t smem_bytes,
                     void* stream) {
  if (b < 1 || s < 1 || t_len < 1 || threads < 32 || threads % 32 ||
      threads > kMaxThreads || (equilibrate && !orig) ||
      (!tile_in_smem && !work))
    return -1;
  return equilibrate
             ? launch<true>(diag, upper, rhs, out, xs, ys, work, orig, s,
                            t_len, b, upper_len, threads, tile_in_smem,
                            smem_bytes, stream)
             : launch<false>(diag, upper, rhs, out, xs, ys, work, orig, s,
                             t_len, b, upper_len, threads, tile_in_smem,
                             smem_bytes, stream);
}

}  // extern "C"
