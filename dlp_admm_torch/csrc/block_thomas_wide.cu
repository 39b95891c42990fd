// Batched symmetric block-tridiagonal solve (block Thomas), block width
// 32 < B <= 97 in float64 and <= 138 in float32 (equilibrated: 80 and
// 106): one thread block per system, the stage's augmented tile in
// registers.
//
// Replaces the Pallas kernel dlp_admm_tpu/solvers/thomas_pallas.py
// (block_thomas_solve_pallas, body _thomas_kernel); block_thomas_warp.cu is
// the same function for B <= 32 and says what it computes: block Thomas with
// a row-swapping Gauss-Jordan on each stage's [C_k | U_k | g_k] (the first
// largest |entry| of the pivot column, a NaN above everything, pivots
// floored at +-1e-30, one reciprocal per pivot, multipliers a_ij / pivot),
// back substitution, and, in the equilibrated variant, what
// dlp_admm_tpu/solvers/linalg.py equil_solve does around each stage solve:
// d = 1/sqrt(max(rowmax|C_k|, 1e-30)), eliminate (D C D) Y = D [U_k | g_k],
// refine once on the scaled system, X = D Y.
//
// Layout: diag [S, T, B, B], upper [S, Tu, B, B] (Tu = T-1 or T; entry T-1
// is ignored), rhs [S, T, B], out [S, T, B], row-major and contiguous.
// xs [S, T, B, B] and ys [S, T, B] (every stage's X_k, y_k, for the back
// substitution) and, equilibrated, orig [S, B (2B+1) + B NW RPW] (the
// scaled stage system, for the refinement's residual, and every pivot
// step's multipliers) are scratch the caller allocates; every element the
// kernel reads there it has written first.
//
// What bounds it on this card: a serial chain of T*B dependent pivot steps
// per system; the bytes (one read of the inputs) and operations (B^3 a
// stage) are far below what one SM moves and computes in that time. The
// block-per-system kernel this one replaces kept the tile [B, 2B+1] in
// shared memory and paid, every pivot step, a serial scan of the pivot
// column by every thread, two block barriers and a read and write of the
// whole tile through shared memory (5.1 us a pivot at B = 80 in float64).
//
// What the design does about it. Warp w owns rows w*RPW .. w*RPW+RPW-1 of
// the tile and lane l the columns l, l+32, ..., l+32(NCL-1) of each: the
// tile lives in registers (RPW*NCL values a thread, indexed by
// compile-time constants only; in the widest classes the last NT column
// slots live in shared memory instead), NW = ceil(B / RPW) warps. Rows
// never move: each row tracks the position it would have after the row
// swaps so far (pos). A pivot step has one block barrier. Before it, every
// warp offers the candidate for the coming pivot column: the lane that
// holds that column picks the warp's first largest unused row, and the
// warp writes that row, its key (|value|, position) and all its rows'
// entries in that column into a double-buffered slot of shared memory.
// After it, every warp combines the NW keys (redux.sync), reads the
// winner's row as the pivot row and its own rows' column entries as the
// multipliers' numerators, and updates its rows with one fused
// multiply-add a value; the warp that holds the pivot row then overwrites
// it with the pivot row scaled by 1/pivot, under a warp-uniform branch.
// The search, the row swap and the broadcast of the pivot row so cost one
// barrier and one round trip through shared memory of one row a warp, and
// the hot loop holds no select. The stage product D_k - U_{k-1}^T X_{k-1}
// reads X_{k-1} | y_{k-1} from shared memory (consecutive lanes,
// consecutive columns) and U_{k-1} from device memory (one address a warp
// and row: a broadcast), on the vector units (no f64 wgmma). The
// equilibrated variant writes each step's multipliers to device scratch
// and re-applies them to the residual columns only: the numbers of
// eliminating [D C D | residual] again, with one barrier a step and no
// search. The next stage's D_k, U_k, r_k are read into registers
// from device memory (L2) once a stage, not staged through shared memory:
// at B = 97 the candidate rows, X_k | y_k and the tile's last slots fill
// it (the clock64() split of the profiling build shows what loading and
// the stage product cost).
//
// The file is compiled once per element type (-DBLOCK_THOMAS_REAL=double
// or float). Width classes BP: NCL, then RPW and NT unequilibrated /
// equilibrated: double 48: 4, 4 0 / 4 0; 64: 5, 4 0 / 8 0; 80: 6, 5 0 /
// 10 2; 97: 7, 4 2 / -; float 48: 4, 4 0 / 4 0; 64: 5, 4 0 / 4 0; 80: 6,
// 5 0 / 5 0; 97 and 106: 7, 4 2 / 14 4; 138: 9, 5 4 / -. The equilibrated
// variant needs far more registers than the tile (at 16 or more warps it
// spilled at the register cap, 65,536 over the threads), so its wider
// classes run at most 8 warps with more rows a warp; at float64 97 and
// float32 138 it is not built: its range is 80 in double and 106 in
// float. solvers/thomas.py
// (WIDE_CLASSES) mirrors the table and the shared-memory layout
// (wide_bytes), and launch() refuses a call whose numbers differ.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#ifndef BLOCK_THOMAS_REAL
#error "compile with -DBLOCK_THOMAS_REAL=double or -DBLOCK_THOMAS_REAL=float"
#endif

namespace {

using real = BLOCK_THOMAS_REAL;

constexpr unsigned kFull = 0xffffffffu;
// clock64() phases of the profiling build: load and stage product,
// equilibrate, eliminate, refine, store X_k | y_k, back substitution
constexpr int kPhases = 6;

template <typename T>
__device__ __forceinline__ T floor_pivot(T p) {
  const T tiny = T(1e-30);
  if (fabs(p) > tiny) return p;
  return p >= T(0) ? tiny : -tiny;
}

__device__ __forceinline__ float reciprocal(float x) { return 1.0f / x; }

__device__ __forceinline__ double reciprocal(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  r = fma(fma(-x, r, 1.0), r, r);
  return fma(fma(-x, r, 1.0), r, r);
}

// |v| as an unsigned key that orders like |v| (a NaN above everything);
// an offer is key + 1, and 0 offers nothing
__device__ __forceinline__ unsigned long long abs_key(double v) {
  return (unsigned long long)__double_as_longlong(fabs(v));
}
__device__ __forceinline__ unsigned long long abs_key(float v) {
  return __float_as_uint(fabsf(v));
}

// The lane whose (key, pos) comes first: the largest key, then the
// smallest position. Every lane gets the same answer.
template <typename T>
__device__ __forceinline__ int pick_lane(unsigned long long key, int pos) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  bool match;
  if (sizeof(T) == 8) {
    const unsigned best_hi = __reduce_max_sync(kFull, hi);
    const unsigned best_lo =
        __reduce_max_sync(kFull, hi == best_hi ? lo : 0u);
    match = hi == best_hi && lo == best_lo;
  } else {
    match = lo == __reduce_max_sync(kFull, lo);
  }
  const unsigned best_pos =
      __reduce_min_sync(kFull, match ? (unsigned)pos : ~0u);
  return __ffs(__ballot_sync(kFull, match && (unsigned)pos == best_pos)) - 1;
}

// f(I) for the compile-time I equal to the run-time, warp-uniform i < N:
// a chain of branches, so that a warp runs one body (a register array can
// be indexed by compile-time constants only)
template <int I>
struct Index {
  __host__ __device__ constexpr operator int() const { return I; }
};

template <int N, int I = 0, typename F>
__device__ __forceinline__ void with_index(int i, F&& f) {
  if constexpr (I < N) {
    if (i == I)
      f(Index<I>());
    else
      with_index<N, I + 1>(i, f);
  }
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// Shared memory of one block, in bytes: candidate keys, positions and rows
// (u64[2][32], int[2][32], int[2][32]), the pivot rows of the elimination
// (int[B]), then in elements the candidate rows [2][NW][32 NCL], every
// row's entry in the coming pivot column [2][NW RPW], X_k | y_k [B][B+1],
// the row scales [B], the reciprocal pivots [B] and the tile's last NT
// column slots [NT][NW RPW][32].
__host__ __device__ inline size_t wide_bytes(int b, int elem, int nw, int ncl,
                                             int rpw, int nt) {
  return 8 * 64 + 4 * 128 + round16(4 * (size_t)b) +
         (size_t)elem * (2 * (size_t)nw * (32 * ncl + rpw) +
                         (size_t)b * (b + 1) + 2 * (size_t)b +
                         (size_t)nt * nw * rpw * 32);
}

template <typename T, int NCL, int RPW, int NT, int MAXW, bool EQ, bool PROF>
__global__ void __launch_bounds__(32 * MAXW, 1)
thomas_wide_kernel(const T* __restrict__ diag, const T* __restrict__ upper,
                   const T* __restrict__ rhs, T* __restrict__ out, T* xs,
                   T* ys, T* orig, long long* __restrict__ prof, int t_len,
                   int b, int upper_len) {
  constexpr int LDW = 32 * NCL;     // candidate row stride
  // the q loop of the stage product keeps this many iterations' loads in
  // flight where registers allow (not beside the equilibrated variant's)
  constexpr int kUnroll = EQ || RPW * (NCL - NT) > 20 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w_cols = 2 * b + 1;     // [C | U | g]
  const int ldx = b + 1;            // X_k | y_k row stride
  unsigned long long* ckey = reinterpret_cast<unsigned long long*>(smem_raw);
  int* cpos = reinterpret_cast<int*>(ckey + 64);
  int* crow = cpos + 64;
  int* piv = crow + 64;
  T* cand = reinterpret_cast<T*>(smem_raw + 8 * 64 + 4 * 128 +
                                 round16(4 * (size_t)b));
  T* colv = cand + 2 * (size_t)nw * LDW;
  T* xk = colv + 2 * (size_t)nw * RPW;
  T* dsc = xk + (size_t)b * ldx;
  T* invs = dsc + b;                // equilibrated: each step's 1/pivot
  T* tail = invs + b;                // the last NT column slots [NT][NW RPW][32]

  const int s = blockIdx.x;
  const size_t bb = (size_t)b * b;
  const T* d_s = diag + (size_t)s * t_len * bb;
  const T* u_s = upper + (size_t)s * upper_len * bb;
  const T* r_s = rhs + (size_t)s * t_len * b;
  T* x_s = xs + (size_t)s * t_len * bb;
  T* y_s = ys + (size_t)s * t_len * b;
  T* o_s = out + (size_t)s * t_len * b;
  // equilibrated: the scaled stage system [B][2B+1], then every step's
  // multipliers [B][NW RPW] (for the refinement)
  T* g_s = EQ ? orig + (size_t)s * b * (w_cols + nw * RPW) : nullptr;
  T* gm_s = EQ ? g_s + (size_t)b * w_cols : nullptr;

  // the profiling build's clocks, kept by thread 0 in shared memory (a
  // register array would take registers from the tile in every thread)
  __shared__ long long clk[kPhases];
  long long t0 = 0;
  if (PROF && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kPhases; ++i) clk[i] = 0;
    t0 = clock64();
  }
#define PHASE(i)                              \
  if (PROF && threadIdx.x == 0) {             \
    const long long t1 = clock64();           \
    clk[i] += t1 - t0;                        \
    t0 = t1;                                  \
  }

  const int row0 = warp * RPW;      // rows row0 .. row0 + RPW - 1
  auto active = [&](int r) { return row0 + r < b; };
  auto row = [&](int r) { return active(r) ? row0 + r : 0; };
  T a[RPW][NCL];                    // slots NCL-NT .. NCL-1 are not used
  // entry (row row0 + r, column lane + 32 m): a register, or for the last
  // NT slots shared memory (m is a compile-time constant wherever this is
  // called, so the choice is made by the compiler)
  auto at = [&](int r, int m) -> T& {
    return m >= NCL - NT
               ? tail[(((size_t)m - (NCL - NT)) * nw * RPW + row0 + r) * 32 +
                      lane]
               : a[r][m];
  };
  int pos[RPW];
  unsigned used;                    // bit r: row r was a pivot (or is past B)

  // The candidate for pivot column j: the lane holding column j picks the
  // warp's first largest unused row; the warp writes that row, its key and
  // every own row's entry in column j (the multipliers' numerators) into
  // buffer j & 1.
  auto offer = [&](int j) {
    const int lj = j & 31;
    T v[RPW] = {};
    with_index<NCL>(j >> 5, [&](auto m) {
#pragma unroll
      for (int r = 0; r < RPW; ++r) v[r] = at(r, m);
    });
    unsigned long long best = 0;
    int best_pos = INT_MAX, best_r = 0;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const unsigned long long key =
          (used >> r) & 1u ? 0ull : abs_key(v[r]) + 1ull;
      if (key > best || (key == best && pos[r] < best_pos)) {
        best = key;
        best_pos = pos[r];
        best_r = r;
      }
    }
    best_r = __shfl_sync(kFull, best_r, lj);
    T* dst = cand + ((size_t)(j & 1) * nw + warp) * LDW;
    with_index<RPW>(best_r, [&](auto r) {
#pragma unroll
      for (int m = 0; m < NCL; ++m) dst[lane + 32 * m] = at(r, m);
    });
    if (lane == lj) {
      ckey[(j & 1) * 32 + warp] = best;
      cpos[(j & 1) * 32 + warp] = best_pos;
      crow[(j & 1) * 32 + warp] = best_r;
      T* cv = colv + (size_t)(j & 1) * nw * RPW + row0;
#pragma unroll
      for (int r = 0; r < RPW; ++r) cv[r] = v[r];
    }
  };

  for (int k = 0; k < t_len; ++k) {
    const T* d_k = d_s + (size_t)k * bb;
    const T* u_k = k < t_len - 1 ? u_s + (size_t)k * bb : nullptr;
    // [D_k | U_k | r_k], then minus U_{k-1}^T [X_{k-1} | y_{k-1}]
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
      for (int m = 0; m < NCL; ++m) {
        const int c = lane + 32 * m;
        T v = T(0);
        if (c < b) {
          v = d_k[row(r) * b + c];
        } else if (c < 2 * b) {
          if (u_k) v = u_k[row(r) * b + c - b];
        } else if (c == 2 * b) {
          v = r_s[(size_t)k * b + row(r)];
        }
        at(r, m) = active(r) ? v : T(0);
      }
    }
    if (k > 0) {
      const T* u_p = u_s + (size_t)(k - 1) * bb;
      const int m_g = (2 * b) >> 5;     // the slot that holds column 2B
#pragma unroll kUnroll
      for (int q = 0; q < b; ++q) {
        T uq[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const T v = u_p[(size_t)q * b + row(r)];
          uq[r] = active(r) ? v : T(0);
        }
        const T* xq = xk + (size_t)q * ldx;
#pragma unroll
        for (int m = 0; m < NCL; ++m) {
          if (32 * m < b || m == m_g) {
            // column c of C takes X's column c, column 2B (g) takes y
            const int c = lane + 32 * m;
            const int xc = c < b ? c : (c == 2 * b ? b : -1);
            const T xv = xq[xc >= 0 ? xc : 0];
            const T x = xc >= 0 ? xv : T(0);
#pragma unroll
            for (int r = 0; r < RPW; ++r) at(r, m) = fma(-uq[r], x, at(r, m));
          }
        }
      }
    }
    __syncthreads();    // every read of X_{k-1} | y_{k-1} is done
    PHASE(0)

    if (EQ) {
      // row scales into shared memory, then the tile scaled row by row
      // (the equilibrated variant keeps as few values beside the tile as
      // it can: they would take registers from it)
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        T mx = T(0);
#pragma unroll
        for (int m = 0; m < NCL; ++m)
          if (lane + 32 * m < b) mx = fmax(mx, fabs(at(r, m)));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmax(mx, __shfl_xor_sync(kFull, mx, o));
        if (lane == 0 && active(r))
          dsc[row(r)] = T(1) / sqrt(fmax(mx, T(1e-30)));
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const T dr = dsc[row(r)];
#pragma unroll
        for (int m = 0; m < NCL; ++m) {
          const int c = lane + 32 * m;
          const T dc = dsc[c < b ? c : 0];
          T v = at(r, m) * dr;
          if (c < b) v *= dc;
          at(r, m) = v;
          if (active(r) && c < w_cols)
            g_s[(size_t)row(r) * w_cols + c] = v;
        }
      }
      PHASE(1)
    }

    // Gauss-Jordan, one barrier a pivot step
    used = 0;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      pos[r] = row0 + r;
      if (!active(r)) used |= 1u << r;
    }
    offer(0);
    for (int j = 0; j < b; ++j) {
      __syncthreads();
      const int slot = (j & 1) * 32;
      const unsigned long long key = lane < nw ? ckey[slot + lane] : 0ull;
      const int kp = lane < nw ? cpos[slot + lane] : INT_MAX;
      const int wp = pick_lane<T>(key, kp);
      const int rp = crow[slot + wp];
      const int p_pos = cpos[slot + wp];
      const T* prow = cand + ((size_t)(j & 1) * nw + wp) * LDW;
      const T inv = reciprocal(floor_pivot(prow[j]));
      if (EQ && threadIdx.x == 0) {
        piv[j] = wp * RPW + rp;
        invs[j] = inv;
      }
      const T* cv = colv + (size_t)(j & 1) * nw * RPW + row0;
      T mult[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        mult[r] = cv[r] * inv;
        if (EQ && lane == 0)
          gm_s[(size_t)j * nw * RPW + row0 + r] = mult[r];
      }
      // every row subtracts its multiplier times the pivot row (the columns
      // left of the pivot are dead and take what comes)
#pragma unroll
      for (int m = 0; m < NCL; ++m) {
        const T pr = prow[lane + 32 * m];
#pragma unroll
        for (int r = 0; r < RPW; ++r) at(r, m) = fma(-mult[r], pr, at(r, m));
      }
      // the pivot row instead becomes the pivot row scaled by 1/pivot
      if (warp == wp) {
        with_index<RPW>(rp, [&](auto r) {
#pragma unroll
          for (int m = 0; m < NCL; ++m) at(r, m) = prow[lane + 32 * m] * inv;
          pos[r] = j;
          used |= 1u << r;
        });
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        if (!(warp == wp && r == rp) && pos[r] == j) pos[r] = p_pos;
      if (j + 1 < b) offer(j + 1);
    }
    PHASE(2)

    if (EQ) {
      // park Y (row pos) in X_k | y_k, put the residual
      // D [U_k | g_k] - (D C D) Y into the U | g columns
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
#pragma unroll
        for (int m = 0; m < NCL; ++m) {
          const int c = lane + 32 * m;
          if (active(r) && c >= b && c <= 2 * b)
            xk[(size_t)pos[r] * ldx + c - b] = at(r, m);
        }
      }
      __syncthreads();
      // (the C columns are dead: every slot that holds a U | g column is
      // worked on whole, whatever its other lanes hold)
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const T* orow = g_s + (size_t)row(r) * w_cols;
#pragma unroll
        for (int m = 0; m < NCL; ++m) {
          if (32 * m + 31 >= b && 32 * m <= 2 * b) {
            const int c = lane + 32 * m;
            const T v = orow[c < w_cols ? c : 0];
            at(r, m) = active(r) ? v : T(0);
          }
        }
      }
#pragma unroll 1
      for (int q = 0; q < b; ++q) {
        T cq[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const T v = g_s[(size_t)row(r) * w_cols + q];
          cq[r] = active(r) ? v : T(0);
        }
        const T* yq = xk + (size_t)q * ldx;
#pragma unroll
        for (int m = 0; m < NCL; ++m) {
          if (32 * m + 31 >= b && 32 * m <= 2 * b) {
            const int c = lane + 32 * m;
            const T yv = yq[c >= b && c <= 2 * b ? c - b : 0];
#pragma unroll
            for (int r = 0; r < RPW; ++r)
              at(r, m) = fma(-cq[r], yv, at(r, m));
          }
        }
      }
      // the elimination's steps again, on the residual columns
      for (int j = 0; j < b; ++j) {
        const int wp = piv[j] / RPW, rp = piv[j] % RPW;
        T* buf = cand + (size_t)(j & 1) * nw * LDW;
        if (warp == wp) {
          with_index<RPW>(rp, [&](auto r) {
#pragma unroll
            for (int m = 0; m < NCL; ++m)
              if (32 * m + 31 >= b && 32 * m <= 2 * b)
                buf[lane + 32 * m] = at(r, m);
          });
        }
        T mult[RPW];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
          mult[r] = gm_s[(size_t)j * nw * RPW + row0 + r];
        __syncthreads();
#pragma unroll
        for (int m = 0; m < NCL; ++m) {
          if (32 * m + 31 >= b && 32 * m <= 2 * b) {
            const T pr = buf[lane + 32 * m];
#pragma unroll
            for (int r = 0; r < RPW; ++r)
              at(r, m) = fma(-mult[r], pr, at(r, m));
          }
        }
        if (warp == wp) {
          const T inv = invs[j];
          with_index<RPW>(rp, [&](auto r) {
#pragma unroll
            for (int m = 0; m < NCL; ++m)
              if (32 * m + 31 >= b && 32 * m <= 2 * b)
                at(r, m) = buf[lane + 32 * m] * inv;
          });
        }
      }
      // X = D (Y + dY): solution row pos is scaled by d[pos]
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const T dp = dsc[active(r) ? pos[r] : 0];
#pragma unroll
        for (int m = 0; m < NCL; ++m) {
          const int c = lane + 32 * m;
          if (active(r) && c >= b && c <= 2 * b) {
            const T y0 = xk[(size_t)pos[r] * ldx + c - b];
            at(r, m) = (y0 + at(r, m)) * dp;
          }
        }
      }
      PHASE(3)
    }

    // X_k | y_k: row pos of the stage's solution
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
#pragma unroll
      for (int m = 0; m < NCL; ++m) {
        const int c = lane + 32 * m;
        if (active(r) && c >= b && c <= 2 * b) {
          const int p = pos[r];
          xk[(size_t)p * ldx + c - b] = at(r, m);
          if (c < 2 * b)
            x_s[(size_t)k * bb + (size_t)p * b + c - b] = at(r, m);
          else
            y_s[(size_t)k * b + p] = at(r, m);
        }
      }
    }
    __syncthreads();
    PHASE(4)
  }

  // back substitution: z_k = y_k - X_k z_{k+1}, z in two halves of xk
  T* z_buf = xk;
  for (int i = threadIdx.x; i < 2 * b; i += blockDim.x) z_buf[i] = T(0);
  __syncthreads();
  for (int k = t_len - 1; k >= 0; --k) {
    const T* z_next = z_buf + ((k + 1) & 1) * b;
    T* z_k = z_buf + (k & 1) * b;
    const T* x_k = x_s + (size_t)k * bb;
    for (int i = warp; i < b; i += nw) {
      T acc = T(0);
      for (int q = lane; q < b; q += 32)
        acc = fma(x_k[(size_t)i * b + q], z_next[q], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(kFull, acc, o);
      if (lane == 0) {
        const T z = y_s[(size_t)k * b + i] - acc;
        z_k[i] = z;
        o_s[(size_t)k * b + i] = z;
      }
    }
    __syncthreads();
  }
  PHASE(5)
  if (PROF && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kPhases; ++i) prof[(size_t)s * kPhases + i] = clk[i];
  }
#undef PHASE
}

template <int BP, int NCL, int RPW, int NT, bool EQ, bool PROF>
int launch(const void* diag, const void* upper, const void* rhs, void* out,
           void* xs, void* ys, void* orig, long long* prof, int s, int t_len,
           int b, int upper_len, size_t smem_bytes, void* stream) {
  static_assert(2 * BP + 1 <= 32 * NCL, "a row must fit NCL columns a lane");
  constexpr int MAXW = (BP + RPW - 1) / RPW;
  static_assert(MAXW <= 32, "at most 32 warps a block");
  static size_t allowed = 48 * 1024;
  auto kernel = thomas_wide_kernel<real, NCL, RPW, NT, MAXW, EQ, PROF>;
  if (b > BP) return -1;
  const int nw = (b + RPW - 1) / RPW;
  const size_t need = wide_bytes(b, (int)sizeof(real), nw, NCL, RPW, NT);
  if (need != smem_bytes) return -2;   // the wrapper's layout is not this one
  if (need > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err != cudaSuccess) return (int)err;
    allowed = need;
  }
  kernel<<<s, 32 * nw, need, (cudaStream_t)stream>>>(
      (const real*)diag, (const real*)upper, (const real*)rhs, (real*)out,
      (real*)xs, (real*)ys, (real*)orig, prof, t_len, b, upper_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the element type this library was compiled for (8 or 4).
int block_thomas_wide_elem_bytes() { return (int)sizeof(real); }

// One thread block of 32 ceil(b / RPW) threads per system. bp, the width
// class (48, 64, 80, 97; float also 106, 138) with b <= bp; xs, ys and,
// equilibrated, orig are scratch; smem_bytes is the block's dynamic shared
// memory as the caller computed it. Returns 0, a cudaError, -1 for an
// argument no kernel was built for, or -2 when smem_bytes is not what this
// layout needs.
int block_thomas_wide(const void* diag, const void* upper, const void* rhs,
                      void* out, void* xs, void* ys, void* orig, int s,
                      int t_len, int b, int upper_len, int equilibrate, int bp,
                      size_t smem_bytes, void* stream) {
  if (b < 1 || s < 1 || t_len < 1 || (equilibrate && !orig)) return -1;
#define ARGS                                                              \
  diag, upper, rhs, out, xs, ys, orig, nullptr, s, t_len, b, upper_len, \
      smem_bytes, stream
// a class with both variants (RPW and NT of each) and one built
// unequilibrated only
#define CLASS(BP, NCL, RPW, NT, RPW_EQ, NT_EQ)                             \
  if (bp == BP)                                                           \
    return equilibrate ? launch<BP, NCL, RPW_EQ, NT_EQ, true, false>(ARGS) \
                       : launch<BP, NCL, RPW, NT, false, false>(ARGS);
#define CLASS_PLAIN(BP, NCL, RPW, NT)                             \
  if (bp == BP)                                                   \
    return equilibrate ? -1 : launch<BP, NCL, RPW, NT, false, false>(ARGS);
  CLASS(48, 4, 4, 0, 4, 0)
  if constexpr (sizeof(real) == 8) {
    CLASS(64, 5, 4, 0, 8, 0)
    CLASS(80, 6, 5, 0, 10, 2)
    CLASS_PLAIN(97, 7, 4, 2)
  } else {
    CLASS(64, 5, 4, 0, 4, 0)
    CLASS(80, 6, 5, 0, 5, 0)
    CLASS(97, 7, 4, 2, 14, 4)
    CLASS(106, 7, 4, 2, 14, 4)
    CLASS_PLAIN(138, 9, 5, 4)
  }
#undef CLASS_PLAIN
#undef CLASS
#undef ARGS
  return -1;
}

// The class-80 kernel (b <= 80) with clock64() counters: prof [S, 6]
// receives the clocks thread 0 of each system spent in (load and stage
// product, equilibration, elimination, refinement, storing X_k | y_k,
// back substitution). The float64 build runs unequilibrated, the float32
// build equilibrated, as the staged solver calls them.
int block_thomas_wide_profile(const void* diag, const void* upper,
                              const void* rhs, void* out, void* xs, void* ys,
                              void* orig, long long* prof, int s, int t_len,
                              int b, int upper_len, size_t smem_bytes,
                              void* stream) {
  constexpr bool kEq = sizeof(real) == 4;
  if (b < 1 || b > 80 || s < 1 || t_len < 1 || (kEq && !orig)) return -1;
  return launch<80, 6, 5, 0, kEq, true>(
      diag, upper, rhs, out, xs, ys, orig, prof, s, t_len, b, upper_len,
      smem_bytes, stream);
}

}  // extern "C"
