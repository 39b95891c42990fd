// Batched symmetric block-tridiagonal solve (block Thomas), block width
// B <= 32: one warp per system.
//
// Replaces the Pallas kernel dlp_admm_tpu/solvers/thomas_pallas.py
// (block_thomas_solve_pallas, body _thomas_kernel). For each system s,
//   forward:  C_k = D_k - U_{k-1}^T X_{k-1},  g_k = r_k - U_{k-1}^T y_{k-1},
//             Gauss-Jordan with partial pivoting on [C_k | U_k | g_k] (the
//             first largest |entry| of the pivot column, each pivot floored
//             at +-1e-30 with its sign kept, one reciprocal per pivot: row i
//             takes the multiplier a_ij / pivot, the pivot row is scaled),
//             giving X_k = C_k^-1 U_k and y_k = C_k^-1 g_k (U_{T-1} = 0);
//   backward: z_k = y_k - X_k z_{k+1},  z_T = 0.
// The subdiagonal blocks are U^T (the system is symmetric). The Pallas kernel
// does not swap rows; this one does, as the JAX package's stage solve (LU
// with partial pivoting) does, because the flagship's stage blocks are
// saddle-point KKT matrices that an unpivoted elimination may not factor.
//
// Equilibrated variant (EQ, what dlp_admm_tpu/solvers/linalg.py equil_solve
// does around each stage solve in float32): d = 1/sqrt(max(rowmax|C_k|,
// 1e-30)), eliminate (D C D) Y = D [U_k | g_k], one refinement pass on the
// scaled system, Y += (D C D)^-1 (D [U_k | g_k] - (D C D) Y), then X = D Y.
// The refinement re-applies the multipliers of the first elimination, which
// Gauss-Jordan leaves behind in the columns left of the pivot; the numbers
// are those of eliminating [D C D | residual] again.
//
// Layout: diag [S, T, B, B], upper [S, Tu, B, B] (Tu = T-1 or T; entry T-1
// is ignored), rhs [S, T, B], out [S, T, B], row-major and contiguous.
//
// What bounds it on this card: the bytes and operations are tiny (79 KB and
// 0.5 MFLOP at the flagship's S=2, T=7, B=19 in float64), and each system is
// a serial chain of T*B dependent pivot steps, so the time is the chain's
// length times the latency of one pivot step. The block-per-system kernel
// (block_thomas_wide.cu) pays two block barriers over 8 warps and a round
// trip through shared memory for every pivot.
//
// What the design does about it: a warp owns a system and lane i owns
// equation i of the augmented tile [B, 2B+1] in registers. The register
// array is indexed by compile-time constants only: the width bound BP is a
// template parameter and every loop over columns is unrolled. Those loops
// run over all BP columns without a test on the run-time B: the columns
// (and lanes) past B hold zeros, which the elimination leaves zero, and a
// test per column would put every column into a basic block of its own and
// serialize the shuffle -> multiply-add chains that otherwise overlap (with
// such tests a pivot step took 2,800 clocks on an H100 whatever the number
// of columns). A pivot step is a warp arg-max over the pivot column (two
// or three redux.sync on the bit pattern of |a|, then one on the row
// positions for the first-largest tie rule), a broadcast of the pivot row
// from lane p (__shfl_sync) and one fused multiply-add per lane and column
// right of the pivot: no block barrier and no shared-memory round trip.
// The next step's search and reciprocal need the next column alone, so a
// step updates that column first and spreads them over the rest of its
// update (85 -> 54 us per float64 solve at the flagship's shape on an H100;
// the block-per-system kernel takes 183 us). What is left on the chain of a
// step, about 530 clocks in float64, is update -> search -> broadcast ->
// reciprocal -> multiplier, each a dependent warp-wide operation.
// Rows are never exchanged: each lane tracks the position its row would
// have after the swaps (pos), which tells where its solution row goes.
// D_{k+1}, U_{k+1}, r_{k+1} are copied into shared memory with cp.async
// while stage k eliminates; X_k and y_k of every stage stay in shared
// memory for the backward pass when they fit (else in global scratch the
// caller allocates). Several warps share a block, so many systems spread
// over the SMs as warps.
//
// The file is compiled once per element type (-DBLOCK_THOMAS_REAL=double or
// float), so the two builds run side by side.
//
// Shared memory per warp, in elements: see warp_elems(); the Python wrapper
// computes the same number (solvers/thomas.py warp_elems) and launch() refuses
// a call whose number differs.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>

#ifndef BLOCK_THOMAS_REAL
#error "compile with -DBLOCK_THOMAS_REAL=double or -DBLOCK_THOMAS_REAL=float"
#endif

namespace {

using real = BLOCK_THOMAS_REAL;

constexpr unsigned kFull = 0xffffffffu;
// clock64() phases written by the profiling variant: load, equilibrate,
// eliminate, refine, store and product, back substitution
constexpr int kPhases = 6;

template <typename T>
__device__ __forceinline__ T floor_pivot(T p) {
  const T tiny = T(1e-30);
  if (fabs(p) > tiny) return p;
  return p >= T(0) ? tiny : -tiny;
}

// 1/x. In double the division is some thirty dependent instructions on the
// pivot chain; the 20-bit approximation and two Newton steps give the
// reciprocal to an ulp or two in a third of that.
__device__ __forceinline__ float reciprocal(float x) { return 1.0f / x; }

__device__ __forceinline__ double reciprocal(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  r = fma(fma(-x, r, 1.0), r, r);
  return fma(fma(-x, r, 1.0), r, r);
}

// The search for the lane holding the first largest |v| among the lanes not
// yet used as a pivot, in three steps the caller places between groups of
// column updates, so that each redux.sync's latency is covered by the
// updates that follow it. finish() returns (pos << 5) | lane of that lane,
// the same in every lane. |v| is compared by its bit pattern, which orders
// non-negative floats as unsigned integers (a NaN above everything, as in
// argmax); a used lane offers 0 and an unused one its pattern + 1, so a
// used lane never wins; among equal values the smallest position wins.
template <typename T>
struct Search;

template <>
struct Search<float> {
  unsigned cand, best;
  __device__ __forceinline__ void start(float v, bool used) {
    cand = used ? 0u : __float_as_uint(fabsf(v)) + 1u;
  }
  __device__ __forceinline__ void step1() {
    best = __reduce_max_sync(kFull, cand);
  }
  __device__ __forceinline__ void step2() {}
  __device__ __forceinline__ unsigned finish(int pos, int lane) {
    const unsigned key = cand == best ? (unsigned)((pos << 5) | lane) : ~0u;
    return __reduce_min_sync(kFull, key);
  }
};

template <>
struct Search<double> {
  unsigned hi, lo, best_hi, best_lo;
  __device__ __forceinline__ void start(double v, bool used) {
    const unsigned long long bits =
        (unsigned long long)__double_as_longlong(fabs(v));
    hi = used ? 0u : (unsigned)(bits >> 32) + 1u;
    lo = (unsigned)bits;
  }
  __device__ __forceinline__ void step1() {
    best_hi = __reduce_max_sync(kFull, hi);
  }
  __device__ __forceinline__ void step2() {
    best_lo = __reduce_max_sync(kFull, hi == best_hi ? lo : 0u);
  }
  __device__ __forceinline__ unsigned finish(int pos, int lane) {
    const bool match = hi == best_hi && lo == best_lo;
    const unsigned key = match ? (unsigned)((pos << 5) | lane) : ~0u;
    return __reduce_min_sync(kFull, key);
  }
};

template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* src, int n,
                                            int lane) {
  for (int e = lane; e < n; e += 32)
    __pipeline_memcpy_async(dst + e, src + e, sizeof(T));
}

__host__ __device__ inline size_t warp_elems(int b, int bp, int t_len,
                                             bool eq, bool hist_in_smem) {
  const size_t ldx = bp + 1, w0 = 2 * bp + 1;
  size_t n = (size_t)b * b + b       // D_k, r_k
             + 2 * (size_t)b * b     // U_k, double-buffered
             + (size_t)b * ldx;      // X_k | y_k of the current stage
  if (eq) n += (size_t)b * w0;       // the scaled stage system
  if (hist_in_smem) n += (size_t)t_len * b * ldx;  // X_k | y_k of every stage
  return n;
}

template <typename T, int BP, bool EQ, bool PROF>
__global__ void __launch_bounds__(128)
thomas_warp_kernel(const T* __restrict__ diag, const T* __restrict__ upper,
                   const T* __restrict__ rhs, T* __restrict__ out,
                   T* __restrict__ hist_g, long long* __restrict__ prof,
                   int n_sys, int t_len, int b, int upper_len,
                   int hist_in_smem) {
  constexpr int W = 2 * BP + 1;   // registers a lane holds: [C | U | g]
  constexpr int G = 2 * BP;       // index of the g column
  constexpr int LDX = BP + 1;     // row stride of X_k | y_k (y at column BP)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= n_sys) return;         // whole warps leave; no block barrier below
  const int bb = b * b;
  const size_t per_warp = warp_elems(b, BP, t_len, EQ, hist_in_smem != 0);
  T* dbuf = reinterpret_cast<T*>(smem_raw) + (size_t)warp * per_warp;
  T* rbuf = dbuf + bb;
  T* ubuf = rbuf + b;
  T* xk = ubuf + 2 * bb;
  T* orig = xk + b * LDX;
  T* hist = hist_in_smem ? orig + (EQ ? b * W : 0)
                         : hist_g + (size_t)s * t_len * b * LDX;
  const T* d_s = diag + (size_t)s * t_len * bb;
  const T* u_s = upper + (size_t)s * upper_len * bb;
  const T* r_s = rhs + (size_t)s * t_len * b;
  T* o_s = out + (size_t)s * t_len * b;
  const bool active = lane < b;
  // an inactive lane reads row 0 and drops what it read, so no load below
  // needs a branch
  const int row_l = active ? lane : 0;

  long long clk[kPhases];
  long long t0 = 0;
  if (PROF) {
#pragma unroll
    for (int i = 0; i < kPhases; ++i) clk[i] = 0;
    t0 = clock64();
  }
#define PHASE(i)                     \
  if (PROF) {                        \
    const long long t1 = clock64();  \
    clk[i] += t1 - t0;               \
    t0 = t1;                         \
  }

  stage_async(dbuf, d_s, bb, lane);
  stage_async(rbuf, r_s, b, lane);
  if (t_len > 1) stage_async(ubuf, u_s, bb, lane);
  __pipeline_commit();

  // a[0:BP) holds -U_{k-1}^T X_{k-1} (row `lane`) and a[G] holds
  // -U_{k-1}^T y_{k-1} when a stage begins; zero before stage 0. Columns
  // b..BP-1 of both halves and the rows of lanes >= b are zero throughout.
  T a[W];
#pragma unroll
  for (int c = 0; c < W; ++c) a[c] = T(0);

  for (int k = 0; k < t_len; ++k) {
    const T* uk = ubuf + (k & 1) * bb;
    const bool has_u = k < t_len - 1;   // U_{T-1} = 0: loaded as zeros
    __pipeline_wait_prior(0);
    __syncwarp();
    // [C_k | U_k | g_k], equation `lane`
    {
      const T* drow = dbuf + row_l * b;
      const T* urow = uk + row_l * b;
#pragma unroll
      for (int c = 0; c < BP; ++c) {
        const int cc = c < b ? c : 0;
        const bool in = active && c < b;
        const T dv = drow[cc];
        const T uv = has_u ? urow[cc] : T(0);
        a[c] += in ? dv : T(0);
        a[BP + c] = in ? uv : T(0);
      }
      const T rv = rbuf[row_l];
      a[G] += active ? rv : T(0);
    }
    __syncwarp();
    if (k + 1 < t_len) {
      stage_async(dbuf, d_s + (size_t)(k + 1) * bb, bb, lane);
      stage_async(rbuf, r_s + (size_t)(k + 1) * b, b, lane);
      if (k + 2 < t_len)
        stage_async(ubuf + ((k + 1) & 1) * bb, u_s + (size_t)(k + 1) * bb, bb,
                    lane);
      __pipeline_commit();
    }
    PHASE(0)

    T dscale = T(1);
    if (EQ) {
      T r = T(0);
#pragma unroll
      for (int c = 0; c < BP; ++c) r = fmax(r, fabs(a[c]));
      dscale = T(1) / sqrt(fmax(r, T(1e-30)));
#pragma unroll
      for (int c = 0; c < BP; ++c) {
        const T dc = __shfl_sync(kFull, dscale, c);
        a[c] = a[c] * dscale * dc;
        a[BP + c] *= dscale;
      }
      a[G] *= dscale;
      {
        T* row = orig + row_l * W;
        if (active) {
#pragma unroll
          for (int c = 0; c < W; ++c) row[c] = a[c];
        }
      }
      PHASE(1)
    }

    // Gauss-Jordan; pos = the position this lane's row would have after the
    // row swaps so far (the pivot of step j ends at position j). The search
    // and the reciprocal of step j+1 need column j+1 alone, so step j
    // updates that column first and spreads them over the rest of its
    // update, one basic block per step: the U columns are updated at the
    // last stage too, where they are zero.
    int pos = lane;
    bool used = !active;
    int piv[BP];                    // EQ: the pivot lane of each step
    unsigned key;
    T inv;
    {
      Search<T> sr;
      sr.start(a[0], used);
      sr.step1();
      sr.step2();
      key = sr.finish(pos, lane);
      inv = reciprocal(floor_pivot(__shfl_sync(kFull, a[0], key & 31)));
    }
#pragma unroll
    for (int j = 0; j < BP; ++j) {
      if (j < b) {
        constexpr int Q = BP / 4;
        const int p = key & 31;
        const bool is_p = lane == p;
        // the pivot lane scales its row by 1/pivot; lane i subtracts
        // (a_ij / pivot) times the pivot row
        const T m = is_p ? inv : a[j] * inv;
        auto update = [&](T& x) {
          const T pr = __shfl_sync(kFull, x, p);
          x = is_p ? x * m : fma(-m, pr, x);
        };
        // column j is dead from here on: it keeps this step's multiplier
        // (the reciprocal pivot in the pivot lane) for the refinement
        if (EQ) {
          a[j] = m;
          piv[j] = p;
        }
        if (is_p) {
          pos = j;
          used = true;
        } else if (pos == j) {
          pos = key >> 5;
        }
        Search<T> sr;
        T next = T(0);
        if (j + 1 < BP) {
          update(a[j + 1]);
          sr.start(a[j + 1], used);
        }
#pragma unroll
        for (int c = j + 2; c < BP; ++c) update(a[c]);
        if (j + 1 < BP) sr.step1();
#pragma unroll
        for (int c = BP; c < BP + Q; ++c) update(a[c]);
        if (j + 1 < BP) sr.step2();
#pragma unroll
        for (int c = BP + Q; c < BP + 2 * Q; ++c) update(a[c]);
        if (j + 1 < BP) key = sr.finish(pos, lane);
#pragma unroll
        for (int c = BP + 2 * Q; c < BP + 3 * Q; ++c) update(a[c]);
        if (j + 1 < BP) next = __shfl_sync(kFull, a[j + 1], key & 31);
#pragma unroll
        for (int c = BP + 3 * Q; c < G; ++c) update(a[c]);
        if (j + 1 < BP) inv = reciprocal(floor_pivot(next));
        update(a[G]);
      }
    }
    PHASE(2)

    if (EQ) {
      // park Y, form the residual of the scaled system in its place
      if (active) {
        T* row = xk + pos * LDX;
#pragma unroll
        for (int c = 0; c < BP; ++c) row[c] = a[BP + c];
        row[BP] = a[G];
      }
      __syncwarp();
      {
        const T* row = orig + row_l * W;
#pragma unroll
        for (int c = BP; c < W; ++c) {
          const T v = row[c];
          a[c] = active ? v : T(0);
        }
#pragma unroll 4
        for (int q = 0; q < b; ++q) {
          const T rq = row[q];
          const T aq = active ? rq : T(0);
          const T* yq = xk + q * LDX;
#pragma unroll
          for (int c = 0; c <= BP; ++c)
            a[BP + c] = fma(-aq, yq[c], a[BP + c]);
        }
      }
      // the first elimination's steps again, on the residual columns
#pragma unroll
      for (int j = 0; j < BP; ++j) {
        if (j < b) {
          const int p = piv[j];
          const bool is_p = lane == p;
          const T m = a[j];
#pragma unroll
          for (int c = BP; c < W; ++c) {
            const T pr = __shfl_sync(kFull, a[c], p);
            a[c] = is_p ? a[c] * m : fma(-m, pr, a[c]);
          }
        }
      }
      // X = D (Y + dY); solution row pos is scaled by d[pos]
      const T dx = __shfl_sync(kFull, dscale, pos);
      {
        const T* row = xk + (active ? pos : 0) * LDX;
#pragma unroll
        for (int c = 0; c < BP; ++c) {
          const T y0 = row[c];
          a[BP + c] = active ? (y0 + a[BP + c]) * dx : T(0);
        }
        const T y0 = row[BP];
        a[G] = active ? (y0 + a[G]) * dx : T(0);
      }
      __syncwarp();
      PHASE(3)
    }

    // X_k | y_k: row pos of the stage's solution (columns b..BP-1 are zero)
    if (active) {
      T* xr = xk + pos * LDX;
      T* hr = hist + ((size_t)k * b + pos) * LDX;
#pragma unroll
      for (int c = 0; c <= BP; ++c) {
        xr[c] = a[BP + c];
        hr[c] = a[BP + c];
      }
    }
    __syncwarp();
    // -U_k^T [X_k | y_k], row `lane`, for the next stage
    if (has_u) {
#pragma unroll
      for (int c = 0; c < BP; ++c) a[c] = T(0);
      a[G] = T(0);
#pragma unroll 4
      for (int q = 0; q < b; ++q) {
        const T uv = uk[q * b + row_l];
        const T uq = active ? uv : T(0);
        const T* xq = xk + q * LDX;
#pragma unroll
        for (int c = 0; c < BP; ++c) a[c] = fma(-uq, xq[c], a[c]);
        a[G] = fma(-uq, xq[BP], a[G]);
      }
    }
    PHASE(4)
  }

  // back substitution: z_k = y_k - X_k z_{k+1}; lane i holds z[i] (0 for
  // lanes >= b)
  T z = T(0);
  for (int k = t_len - 1; k >= 0; --k) {
    const T* hr = hist + ((size_t)k * b + row_l) * LDX;
    T acc = hr[BP];
    if (k < t_len - 1) {
#pragma unroll
      for (int c = 0; c < BP; ++c) {
        const T zc = __shfl_sync(kFull, z, c);
        acc = fma(-hr[c], zc, acc);
      }
    }
    z = active ? acc : T(0);
    if (active) o_s[k * b + lane] = z;
  }
  PHASE(5)
  if (PROF && lane == 0) {
#pragma unroll
    for (int i = 0; i < kPhases; ++i) prof[(size_t)s * kPhases + i] = clk[i];
  }
#undef PHASE
}

template <typename T, int BP, bool EQ, bool PROF>
int launch(const void* diag, const void* upper, const void* rhs, void* out,
           void* hist, long long* prof, int s, int t_len, int b,
           int upper_len, int warps, int hist_in_smem, size_t smem_bytes,
           void* stream) {
  static size_t allowed = 48 * 1024;
  auto kernel = thomas_warp_kernel<T, BP, EQ, PROF>;
  const size_t need =
      warps * sizeof(T) * warp_elems(b, BP, t_len, EQ, hist_in_smem != 0);
  if (need != smem_bytes) return -2;   // the wrapper's layout is not this one
  if (need > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err != cudaSuccess) return (int)err;
    allowed = need;
  }
  const int blocks = (s + warps - 1) / warps;
  kernel<<<blocks, 32 * warps, need, (cudaStream_t)stream>>>(
      (const T*)diag, (const T*)upper, (const T*)rhs, (T*)out, (T*)hist, prof,
      s, t_len, b, upper_len, hist_in_smem);
  return (int)cudaGetLastError();
}

template <int BP>
int launch_eq(int equilibrate, const void* diag, const void* upper,
              const void* rhs, void* out, void* hist, int s, int t_len, int b,
              int upper_len, int warps, int hist_in_smem, size_t smem_bytes,
              void* stream) {
  return equilibrate
             ? launch<real, BP, true, false>(diag, upper, rhs, out, hist,
                                             nullptr, s, t_len, b, upper_len,
                                             warps, hist_in_smem, smem_bytes,
                                             stream)
             : launch<real, BP, false, false>(diag, upper, rhs, out, hist,
                                              nullptr, s, t_len, b, upper_len,
                                              warps, hist_in_smem, smem_bytes,
                                              stream);
}

}  // namespace

extern "C" {

// Bytes of the element type this library was compiled for (8 or 4).
int block_thomas_warp_elem_bytes() { return (int)sizeof(real); }

// One warp per system. bp, the compile-time width bound, 20 or 32 with
// b <= bp; warps per block 1..4; hist [S, T, B, bp + 1] is scratch, used
// only when hist_in_smem is 0; smem_bytes is the block's dynamic shared
// memory as the caller computed it. Returns 0, a cudaError, -1 for an
// argument no kernel was built for, or -2 when smem_bytes is not what this
// layout needs.
int block_thomas_warp(const void* diag, const void* upper, const void* rhs,
                      void* out, void* hist, int s, int t_len, int b,
                      int upper_len, int equilibrate, int bp, int warps,
                      int hist_in_smem, size_t smem_bytes, void* stream) {
  if (b < 1 || b > bp || warps < 1 || warps > 4 || s < 1 || t_len < 1)
    return -1;
#define ARGS                                                              \
  equilibrate, diag, upper, rhs, out, hist, s, t_len, b, upper_len, warps, \
      hist_in_smem, smem_bytes, stream
  if (bp == 20) return launch_eq<20>(ARGS);
  if (bp == 32) return launch_eq<32>(ARGS);
#undef ARGS
  return -1;
}

// The same kernel at bp = 20 with clock64() counters: prof [S, 6] receives
// the clocks lane 0 of each system spent in (load, equilibrate,
// elimination, refinement, storing X_k | y_k and the product for the next
// stage, back substitution). The float64 build runs unequilibrated, the
// float32 build equilibrated, as the staged solver calls them.
int block_thomas_warp_profile(const void* diag, const void* upper,
                              const void* rhs, void* out, void* hist,
                              long long* prof, int s, int t_len, int b,
                              int upper_len, int warps, int hist_in_smem,
                              size_t smem_bytes, void* stream) {
  if (b < 1 || b > 20 || warps < 1 || warps > 4 || s < 1 || t_len < 1)
    return -1;
  return launch<real, 20, sizeof(real) == 4, true>(
      diag, upper, rhs, out, hist, prof, s, t_len, b, upper_len, warps,
      hist_in_smem, smem_bytes, stream);
}

}  // extern "C"
