// Batched symmetric block-tridiagonal solve (block Thomas) for every block
// width past what a thread-block cluster holds on chip (float64 B > 384,
// float32 B > 528 on an H100; solvers/thomas.py, kernel_plan): a grid of R
// co-resident CTAs per system (one a panel and one more: R = 27 at B = 405,
// 39 at 605), the stage's tile split by column blocks over their shared
// memory (or, where it does not fit there, over a device workspace),
// Gauss-Jordan by panels of 16 columns, each panel published through L2.
//
// Replaces the Pallas kernel dlp_admm_tpu/solvers/thomas_pallas.py
// (block_thomas_solve_pallas, body _thomas_kernel) at these widths;
// block_thomas_warp.cu, block_thomas_wide.cu and block_thomas_cluster.cu
// compute the same function: block Thomas with a row-swapping Gauss-Jordan
// on each stage's [C_k | U_k | g_k] (row j swaps with the first row i >= j
// of largest |aug[i, j]| as updated so far, a NaN above everything; the
// pivot floored at +-1e-30), back substitution, and, in the equilibrated
// variant, d = 1/sqrt(max(rowmax|C_k|, 1e-30)), eliminate (D C D) Y =
// D [U_k | g_k], refine once on the scaled system, X = D Y.
// solvers/thomas.py (block_thomas_plain) is the same function in plain
// PyTorch.
//
// Layout: diag [S, T, B, B], upper [S, Tu, B, B] (Tu = T-1 or T; entry T-1
// is ignored), rhs [S, T, B], out [S, T, B], row-major and contiguous.
// Scratch the caller allocates (G groups of R CTAs; group g solves systems
// g, g + G, ...; Bp is B rounded up to 16, nq = Bp / 16, Wr = Bp + 16):
// xs [S, T, B, B] and ys [S, T, B] (every stage's X_k, y_k, for the back
// substitution); panels [G, nq, Bp, 16] (each panel's multipliers as its
// owner publishes them); sync, int [G, sync_ints(nq)], zeroed before the
// launch (each panel's pivot rows, its flag, the group's barrier count);
// tiles [G R, blocks, Bp, 17] where the blocks do not fit shared memory;
// equilibrated, orig [G, Bp, Bp + Wr] (the scaled stage system A_s | M_s),
// ysc [G, Bp, Wr] (the first solution Y) and rmaxw [G, R, Bp] (each CTA's
// row maxima). Every element the kernel reads there it has written first.
//
// What bounds it on this card. A stage is a serial chain of Bp dependent
// pivot steps; past the cluster kernel's 16 CTAs the earlier one-block
// kernel ran all T Bp of them on one SM, with two block barriers and a pass
// over the whole live tile (in a device workspace past 118 wide in float64)
// each: 162 ms at (1, 7, 320) in float64 against the cluster kernel's 6.2.
// The bytes (one read of the inputs) and the operations (about 3 B^3 a
// stage) are far below what the card moves and computes in that time, so
// the chain's latency bounds it: T Bp pivot steps in the panel factors,
// plus one flag round trip through L2 a panel (7 x 26 at B = 405).
//
// What the design does about it (the cluster kernel's ownership and order
// of work, over more CTAs than a cluster holds):
// * The tile is padded to Bp (identity in C, zeros in U and g: exact) and
//   cut into blocks of 16 columns: C block q and [U | g] block q live on
//   CTA q mod R (so the stage product C_{k+1} = D_{k+1} - U_k^T X_k of a
//   block needs only that CTA's own columns of X_k); g is block nq of
//   [U | g]. R is one CTA a panel and one more, so a CTA holds at most a C
//   block and a [U | g] block (2 x [416][17] doubles at B = 405; fewer CTAs
//   with more blocks each are slower, solvers/thomas.py big_ctas), with a
//   second tile where the next stage can be prefetched; where two blocks
//   do not fit (past 768 in float64), they live in a device workspace (L2
//   first) with the same order of work.
// * Gauss-Jordan by panels of 16 columns. The CTA that owns the panel
//   factors it with four warps, in place (a pivot step: the warps'
//   candidates by redux, two barriers of the four warps, each row read,
//   updated in registers and written once), keeping in its columns each
//   step's multipliers and 1 / pivot; then writes the panel's multipliers
//   and pivot rows to the group's workspace in L2, and releases the
//   panel's flag (st.release.gpu). Every other CTA acquires the flag
//   (ld.acquire.gpu), reads what was published past L1 (ld.global.cg: a
//   stale L1 line of the last stage's panel is the fault to avoid) and
//   updates its live blocks late: the rows the panel's swaps touch step by
//   step (one thread a column), every other row by its 16 multiply-
//   subtracts in order (one thread a row). So every entry takes the plain
//   elimination's operations in their order, multiply and subtract each
//   rounded once, and the pivots follow the plain version on near-ties.
//   The owner of the next panel updates that block first and factors it
//   with four warps while its other four update the rest (one panel of
//   look-ahead): a panel costs one flag round trip on the chain.
// * The CTAs of a system meet at a barrier of their own (an arrival count
//   in the workspace) at the end of each stage, before the equilibrated
//   variant's scales and residual, and between the back substitution's
//   stages.
// * Products: the stage product and, equilibrated, the residual A_s Y, in
//   float64 on the tensor cores (mma.sync m8n8k4 f64), in float32 the same
//   sums on the float32 units. U_k^T and A_s are read whole by every CTA,
//   through L2.
// * Where two tiles fit in a CTA's shared memory, stage k+1's D and U come
//   in by cp.async into the second one while stage k eliminates.
// * Equilibrated: the row maxima are exchanged through the workspace, and
//   the refinement applies the published factors again, panel by panel, to
//   the residual (no flag waits: all are in).
// * Back substitution from xs and ys, spread over the group's CTAs by rows
//   (a barrier a stage).
//
// Co-residency: a CTA spins on flags that other CTAs of its group set, so
// the launch is cooperative (cudaLaunchAttributeCooperative) and is refused
// (-3) when the grid exceeds what the device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs); nothing waits
// that out. The flags and the barrier count start at 0 in each launch (the
// caller zeroes them, also in a replayed CUDA graph) and only rise within
// it, so no epoch comes from the host.
//
// The file is compiled once per element type (-DBLOCK_THOMAS_REAL=double
// or float); the width, the CTAs a system, the groups and whether the tile
// is in shared memory and prefetched are run-time arguments.
// solvers/thomas.py mirrors the shared-memory layout (big_bytes) and the
// workspace's, and the launch refuses a call whose numbers differ.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#ifndef BLOCK_THOMAS_REAL
#error "compile with -DBLOCK_THOMAS_REAL=double or -DBLOCK_THOMAS_REAL=float"
#endif

// the barrier of the threads that factor a panel (named barrier 1; a host
// build of the file may supply its own)
#ifndef BLOCK_THOMAS_FACTOR_SYNC
#define BLOCK_THOMAS_FACTOR_SYNC() \
  asm volatile("bar.sync 1, %0;\n" ::"n"(kFactorThreads) : "memory")
#endif

namespace {

using real = BLOCK_THOMAS_REAL;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNb = 16;             // panel and block width
constexpr int kLdb = kNb + 1;       // a block's row stride: odd, so the rows
                                    // a warp walks fall in distinct banks
constexpr int kChunk = 6;           // blocks a thread updates at once
constexpr int kGroup = 4;           // 8-column tiles a warp sums at once
// ... where the blocks are in the device workspace, whose 64-bit addresses
// take more registers
constexpr int kChunkWs = 4;
constexpr int kGroupWs = 2;
constexpr int kFactorWarps = 4;     // warps that factor a panel
constexpr int kFactorThreads = 32 * kFactorWarps;
constexpr int kProf = 6;            // profiling slots

// profiling slots
constexpr int kFactor = 0, kWait = 1, kUpdate = 2, kProduct = 3, kCopy = 4,
              kBack = 5;

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

// a * b and a - b, each rounded once and never fused (the plain
// elimination's arithmetic: a multiplier, then a - m * p in two roundings)
template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b) {
  if constexpr (sizeof(T) == 8)
    return __dmul_rn(a, b);
  else
    return __fmul_rn(a, b);
}
template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b) {
  if constexpr (sizeof(T) == 8)
    return __dsub_rn(a, b);
  else
    return __fsub_rn(a, b);
}

// the larger of a and b, a NaN if either is one (torch.amax's rule)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// a load of what another CTA wrote, past L1
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldcg(p);
#else
  return *p;
#endif
}

__device__ __forceinline__ int load_acquire(const int* p) {
#if defined(__CUDA_ARCH__)
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}

__device__ __forceinline__ void store_release(int* p, int v) {
#if defined(__CUDA_ARCH__)
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELEASE);
#endif
}

__device__ __forceinline__ void arrive(int* p) {
#if defined(__CUDA_ARCH__)
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(p)
               : "memory");
#else
  __atomic_fetch_add(p, 1, __ATOMIC_ACQ_REL);
#endif
}

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

__host__ __device__ inline int padded(int b) {
  return (b + kNb - 1) / kNb * kNb;
}

// C blocks (q < nq) and [U | g] blocks (q <= nq) of the CTA that holds the
// most of them: q = rank + R m
__host__ __device__ inline int c_blocks(int nq, int r) {
  return (nq + r - 1) / r;
}
__host__ __device__ inline int rhs_blocks(int nq, int r) {
  return (nq + r) / r;
}

// Shared memory of one CTA, in bytes: in elements the blocks, where they
// live there ([1 or 2] tiles of [C blocks, then [U | g] blocks] x
// [Bp][kLdb]), each live block's pivot-row values of a panel
// ([blocks][kNb][kLdb]), the row maxima and the row scales ([2][Bp]), the
// multipliers of the rows a panel's swaps touch ([2 kNb][kLdb]); then the
// factor warps' pivot candidates (u64 keys, int rows, [2][kFactorWarps]),
// a panel's pivot rows, the rows its swaps touch, where each pivot row is
// among them, and their count (int[kNb + 2 kNb + kNb + 4]), and the pivot
// rows of the panel the CTA factors (int[kNb]).
__host__ __device__ inline size_t big_bytes(int b, int elem, int r,
                                            int prefetch, int smem_tile) {
  const int bp = padded(b), nq = bp / kNb;
  const size_t nblk = (size_t)(c_blocks(nq, r) + rhs_blocks(nq, r));
  const size_t tile = smem_tile ? (prefetch ? 2 : 1) * nblk * bp * kLdb : 0;
  const size_t n =
      tile + nblk * kNb * kLdb + 2 * (size_t)bp + 2 * kNb * kLdb;
  return round16((size_t)elem * n) + round16(12 * 2 * (size_t)kFactorWarps) +
         round16(4 * (size_t)(4 * kNb + 4)) + round16(4 * (size_t)kNb);
}

// ints of a group's sync workspace: each panel's pivot rows [nq][kNb], its
// flag [nq] and the barrier count, rounded up to 128 bytes
__host__ __device__ inline size_t sync_ints(int nq) {
  return ((size_t)nq * (kNb + 1) + 1 + 31) / 32 * 32;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// d += a b on one m8n8k4 tile, fragments as mma.sync lays them out: lane
// 4 g + t holds a = A[g][t], b = B[t][g] and d = D[g][2t], D[g][2t + 1]
__device__ __forceinline__ void mma_8x8x4(double (&d)[2], double a,
                                          double b) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
#else
  // the same product from the fragments by shuffles (a host build of the
  // file runs this)
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int kk = 0; kk < 4; ++kk) {
    const double av = __shfl_sync(kFull, a, 4 * g + kk);
    const double b0 = __shfl_sync(kFull, b, 4 * (2 * t) + kk);
    const double b1 = __shfl_sync(kFull, b, 4 * (2 * t + 1) + kk);
    d[0] = fma(av, b0, d[0]);
    d[1] = fma(av, b1, d[1]);
  }
#endif
}

// one element from device memory into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
#else
  *dst = *src;
#endif
}

// wait for this thread's asynchronous copies
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// out(u)[i][c] = base(u, i, c) - sum_q A(i, q) X(u, q, c) for the units
// u < nunits (8-column tiles of blocks, row stride kLdb; out(u) the tile's
// first entry), rows i < 8 ntile, columns c < 8, q < kq (a multiple of 4).
// Row tiles go to warps w0 .. w1-1, a warp's lanes as the m8n8k4 fragments:
// in float64 on the tensor cores, in float32 the same sums on the float32
// units; a warp sums G tiles at once. base may read out(u) (each entry
// is read, then written, by one lane).
template <typename T, int G, typename OutFn, typename AFn, typename XFn,
          typename BaseFn>
__device__ __forceinline__ void product(int ntile, int kq, int nunits,
                                        OutFn outp, AFn afn, XFn xfn,
                                        BaseFn base, int w0, int w1) {
  const int warp = threadIdx.x >> 5;
  if (warp < w0 || warp >= w1) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int rt = warp - w0; rt < ntile; rt += w1 - w0) {
    const int i = rt * 8 + g;
    for (int u0 = 0; u0 < nunits; u0 += G) {
      T acc[G][2];
#pragma unroll
      for (int uu = 0; uu < G; ++uu)
        if (u0 + uu < nunits) {
          acc[uu][0] = base(u0 + uu, i, 2 * t);
          acc[uu][1] = base(u0 + uu, i, 2 * t + 1);
        }
      if constexpr (sizeof(T) == 8) {
#pragma unroll 4
        for (int kc = 0; kc < kq; kc += 4) {
          const double av = -afn(i, kc + t);
#pragma unroll
          for (int uu = 0; uu < G; ++uu)
            if (u0 + uu < nunits)
              mma_8x8x4(acc[uu], av, xfn(u0 + uu, kc + t, g));
        }
      } else {
#pragma unroll 2
        for (int kc = 0; kc < kq; kc += 4) {
          T av[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) av[kk] = afn(i, kc + kk);
#pragma unroll
          for (int uu = 0; uu < G; ++uu)
            if (u0 + uu < nunits) {
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
                acc[uu][0] =
                    fma(-av[kk], xfn(u0 + uu, kc + kk, 2 * t), acc[uu][0]);
                acc[uu][1] =
                    fma(-av[kk], xfn(u0 + uu, kc + kk, 2 * t + 1), acc[uu][1]);
              }
            }
        }
      }
#pragma unroll
      for (int uu = 0; uu < G; ++uu)
        if (u0 + uu < nunits) {
          T* o = outp(u0 + uu);
          o[i * kLdb + 2 * t] = acc[uu][0];
          o[i * kLdb + 2 * t + 1] = acc[uu][1];
        }
    }
  }
}

// The first largest of the warp's candidates (keys as abs_key + 1, the
// lane's first row at its largest key): the largest key by redux, then the
// smallest row among the lanes that hold it. Every lane gets both.
template <typename T>
__device__ __forceinline__ int warp_winner(unsigned long long& key, int pos) {
  unsigned long long best;
  if constexpr (sizeof(T) == 8) {
    const unsigned hi = __reduce_max_sync(kFull, (unsigned)(key >> 32));
    const unsigned lo = __reduce_max_sync(
        kFull, (unsigned)(key >> 32) == hi ? (unsigned)key : 0u);
    best = ((unsigned long long)hi << 32) | lo;
  } else {
    best = __reduce_max_sync(kFull, (unsigned)key);
  }
  const int p = (int)__reduce_min_sync(
      kFull, key == best ? (unsigned)pos : 0xffffffffu);
  key = best;
  return p;
}

// The panel's Gauss-Jordan in place, by the CTA's first kFactorWarps warps,
// with the plain elimination's arithmetic on the panel's columns: the
// block [Bp][kLdb] holds the panel's 16 columns, j0 its first pivot row.
// On exit column t holds step t's multipliers, a[i][t] / pivot, at the
// rows' positions of step t (and 1 / pivot at the pivot row), and pv[t]
// the pivot row of step t: only the columns still live are swapped and
// updated, so a finished column keeps them. Thread f walks rows f, f + 128,
// ...; the steps are unrolled, so the columns are constants; each row is
// read, updated in registers and written once, and the next step's
// candidate is taken from the updated rows. A step has two barriers of the
// factor warps: the warps' candidates are in (then the swap), the swap is
// done (then the update). Pivot row j is written by the next step's
// swapping threads, since nobody reads it before; the last one after the
// last barrier.
template <typename T>
__device__ void factor_panel(T* blk, int bp, int j0, int* pv,
                             unsigned long long* ckey, int* cpos) {
  const int f = threadIdx.x, lane = f & 31, w = f >> 5;
  unsigned long long key = 0;
  int pos = INT_MAX;
  for (int i = f; i < bp; i += kFactorThreads)
    if (i >= j0) {
      const unsigned long long k = abs_key(blk[i * kLdb]) + 1ull;
      if (k > key) {          // rows rise with i: the first of a tie stays
        key = k;
        pos = i;
      }
    }
  T rj = T(0);                // column f of the last pivot row, scaled
#pragma unroll
  for (int t = 0; t < kNb; ++t) {
    const int j = j0 + t;
    {
      const int p = warp_winner<T>(key, pos);   // key: the warp's largest
      if (lane == 0) {
        ckey[(t & 1) * kFactorWarps + w] = key;
        cpos[(t & 1) * kFactorWarps + w] = p;
      }
    }
    BLOCK_THOMAS_FACTOR_SYNC();
    // the first largest of the warps' candidates
    unsigned long long best = 0;
    int p = INT_MAX;
#pragma unroll
    for (int q = 0; q < kFactorWarps; ++q) {
      const unsigned long long k = ckey[(t & 1) * kFactorWarps + q];
      const int r = cpos[(t & 1) * kFactorWarps + q];
      if (k > best || (k == best && r < p)) {
        best = k;
        p = r;
      }
    }
    if (f < kNb) {
      if (t > 0 && f >= t - 1) blk[(j - 1) * kLdb + f] = rj;
      if (p != j && f >= t) {
        const T v = blk[j * kLdb + f];
        blk[j * kLdb + f] = blk[p * kLdb + f];
        blk[p * kLdb + f] = v;
      }
    }
    BLOCK_THOMAS_FACTOR_SYNC();
    T prow[kNb];
#pragma unroll
    for (int c = t; c < kNb; ++c) prow[c] = blk[j * kLdb + c];
    const T inv = T(1) / floor_pivot(prow[t]);
    if (f < kNb && f >= t)
      rj = f == t ? inv : mul_rn(blk[j * kLdb + f], inv);
    key = 0;
    pos = INT_MAX;
    for (int i = f; i < bp; i += kFactorThreads) {
      if (i == j) continue;
      T* row = blk + i * kLdb;
      T v[kNb];
#pragma unroll
      for (int c = t; c < kNb; ++c) v[c] = row[c];
      const T m = mul_rn(v[t], inv);
#pragma unroll
      for (int c = t + 1; c < kNb; ++c) v[c] = sub_rn(v[c], mul_rn(m, prow[c]));
      v[t] = m;
#pragma unroll
      for (int c = t; c < kNb; ++c) row[c] = v[c];
      if (t + 1 < kNb && i > j) {
        const unsigned long long k =
            abs_key(v[t + 1 < kNb ? t + 1 : t]) + 1ull;
        if (k > key) {
          key = k;
          pos = i;
        }
      }
    }
    if (f == 0) pv[t] = p;
  }
  BLOCK_THOMAS_FACTOR_SYNC();
  if (f == kNb - 1) blk[(j0 + kNb - 1) * kLdb + kNb - 1] = rj;
}

template <typename T>
struct Params {
  const T* diag;
  const T* upper;
  const T* rhs;
  T* out;
  T* xs;
  T* ys;
  T* orig;            // equilibrated: [G][Bp][Bp + Wr], A_s | M_s
  T* ysc;             // equilibrated: [G][Bp][Wr], the first solution
  T* rmaxw;           // equilibrated: [G][R][Bp], each CTA's row maxima
  T* panels;          // [G][nq][Bp][kNb], the published multipliers
  T* tiles;           // [G R][blocks][Bp][kLdb] where not in shared memory
  int* sync;          // [G][sync_ints(nq)], zero at the launch
  long long* prof;    // profiling: [S][R][kProf] clocks
  int s_len, t_len, b, upper_len, r, groups, prefetch, smem_tile;
};

// Group blockIdx.x / R of R CTAs solves systems g, g + G, ... EQ: the
// equilibrated variant. TILE: the blocks in shared memory (else in
// a.tiles). PROF: the profiling build (clock64() per phase, thread 0 of
// each CTA). The workspace's pointers are computed from the parameters
// where they are used, which keeps them out of registers.
template <typename T, bool EQ, bool TILE, bool PROF>
__device__ void thomas_big(const Params<T>& a, unsigned char* smem) {
  const int nr = a.r;
  const int rank = (int)blockIdx.x % nr;
  const int grp = (int)blockIdx.x / nr;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int b = a.b, t_len = a.t_len;
  const int bp = padded(b), nq = bp / kNb;
  const int wr = (nq + 1) * kNb;         // [U | g] columns, padded
  const int ntile = bp / 8;
  const int mc_all = c_blocks(nq, nr), nblk = mc_all + rhs_blocks(nq, nr);
  const int mc = (nq - rank + nr - 1) / nr;   // my C blocks
  const int mr = (nq - rank + nr) / nr;       // my [U | g] blocks
  const int g_slot = nq % nr == rank ? nq / nr : -1;   // g's block, if mine
  const size_t blk = (size_t)bp * kLdb;
  const int nbuf = a.prefetch ? 2 : 1;
  const size_t tile = TILE ? (size_t)nbuf * nblk * blk : 0;
  constexpr int chunk = TILE ? kChunk : kChunkWs;
  constexpr int group = TILE ? kGroup : kGroupWs;
  T* sm = reinterpret_cast<T*>(smem);
  T* xbuf = sm + tile;
  T* rmax = xbuf + (size_t)nblk * kNb * kLdb;
  T* dsc = rmax + bp;
  T* lv = dsc + bp;                  // multipliers of the rows in vpos
  unsigned long long* ckey = reinterpret_cast<unsigned long long*>(
      smem + round16(sizeof(T) * (tile + (size_t)nblk * kNb * kLdb +
                                  2 * (size_t)bp + 2 * kNb * kLdb)));
  int* cpos = reinterpret_cast<int*>(ckey + 2 * kFactorWarps);
  int* pvl = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(ckey) +
      round16(12 * 2 * (size_t)kFactorWarps));   // a panel's pivot rows
  int* vpos = pvl + kNb;             // J, then the pivot rows below J
  int* vidx = vpos + 2 * kNb;        // pivot row t is vpos[vidx[t]]
  int* nvp = vidx + kNb;             // how many rows in vpos
  int* piv = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(pvl) +
                                    round16(4 * (size_t)(4 * kNb + 4)));
  // the blocks: in shared memory (TILE), else the CTA's in the workspace
  auto cblk = [&](int buf, int m) {
    return (TILE ? sm : a.tiles + (size_t)blockIdx.x * nblk * blk) +
           ((size_t)buf * nblk + m) * blk;
  };
  auto rblk = [&](int buf, int m) { return cblk(buf, mc_all + m); };

  // the group's workspace: each panel's pivot rows [nq][kNb], its flag
  // [nq], the barrier count; the published panels [nq][Bp][kNb];
  // equilibrated, A_s | M_s [Bp][Bp + Wr], Y [Bp][Wr], row maxima [R][Bp]
  auto pivg = [&]() { return a.sync + (size_t)grp * sync_ints(nq); };
  auto flag = [&](int p) { return pivg() + (size_t)nq * kNb + p; };
  auto panel = [&](int p) {
    return a.panels + ((size_t)grp * nq + p) * bp * kNb;
  };
  const size_t ldo = (size_t)bp + wr;
  auto as_s = [&]() { return a.orig + (size_t)grp * bp * ldo; };
  auto ysc_s = [&]() { return a.ysc + (size_t)grp * bp * wr; };
  auto rmaxw = [&]() { return a.rmaxw + (size_t)grp * nr * bp; };

  // clocks of system s, accumulated in a.prof by thread 0
  int s = grp;
  long long t0 = PROF ? clock64() : 0;
  auto mark = [&](int slot) {
    if (PROF) {
      const long long t1 = clock64();
      if (tid == 0) a.prof[((size_t)s * nr + rank) * kProf + slot] += t1 - t0;
      t0 = t1;
    }
  };
  // the group's barrier: the n-th waits for n R arrivals
  int nbar = 0;
  auto sync_group = [&]() {
    __syncthreads();
    mark(kWait);         // the wait for the CTA's own warps counts there too
    ++nbar;
    if (tid == 0) {
      int* bar = flag(nq);
      __threadfence();
      arrive(bar);
      while (load_acquire(bar) < nbar * nr) {
      }
      __threadfence();
    }
    __syncthreads();
    mark(kWait);
  };
  // stage seq's panel p is out once its flag reaches seq + 1
  int seq = 0;
  auto wait_panel = [&](int p) {
    if (tid == 0) {
      while (load_acquire(flag(p)) <= seq) {
      }
      __threadfence();
    }
    __syncthreads();
    mark(kWait);
  };
  // the factor warps: the factored panel p (block src) and its pivot rows
  // out to the workspace, then its flag
  auto publish = [&](int p, const T* src) {
    BLOCK_THOMAS_FACTOR_SYNC();      // the last pivot row's value is in
    T* dst = panel(p);
    for (int e = tid; e < bp * kNb; e += kFactorThreads)
      dst[e] = src[(e / kNb) * kLdb + e % kNb];
    if (tid < kNb) pivg()[p * kNb + tid] = piv[tid];
    __threadfence();
    BLOCK_THOMAS_FACTOR_SYNC();
    if (tid == 0) store_release(flag(p), seq + 1);
  };

  // A panel's update of the CTA's live blocks, late but with the plain
  // elimination's operations in their order on every entry: the panel's
  // pivot rows and the rows its swaps touch (V: J, then the pivot rows
  // below J) with their multipliers come from the workspace (setup); the
  // rows of V go step by step, swaps included, one thread a column, and
  // leave each step's pivot-row value in xbuf (phase A); every other row,
  // never swapped, takes its 16 multiply-subtracts in order (phase B, one
  // thread a row over the blocks [lb0, lb1)). f, pv: the published
  // multipliers [Bp][kNb] and pivot rows; live(lb): the live blocks.
  auto setup = [&](const T* f, const int* pv, int j0) {
    if (warp == 0) {
      const int lane = tid & 31;
      const int p = lane < kNb ? load_cg(pv + lane) : -1;
      int fq = lane;          // the first step whose pivot row is p
#pragma unroll
      for (int q = kNb - 1; q >= 0; --q) {
        const int pq = __shfl_sync(kFull, p, q);
        if (q < lane && pq == p) fq = q;
      }
      const bool below = lane < kNb && p >= j0 + kNb;
      const unsigned first = __ballot_sync(kFull, below && fq == lane);
      const int slot = kNb + __popc(first & ((1u << fq) - 1u));
      if (below && fq == lane) vpos[slot] = p;
      if (lane < kNb) {
        pvl[lane] = p;
        vpos[lane] = j0 + lane;
        vidx[lane] = below ? slot : p - j0;
      }
      if (lane == 0) *nvp = kNb + __popc(first);
    }
    __syncthreads();
    const int nv = *nvp;
    for (int e = tid; e < nv * kNb; e += kThreads)
      lv[(e / kNb) * kLdb + e % kNb] =
          load_cg(f + (size_t)vpos[e / kNb] * kNb + e % kNb);
    __syncthreads();
  };
  auto phase_a = [&](int j0, int nlive, auto live) {
    const int nv = *nvp;
    const int lane = tid & 31, ol = lane & 7, ob = lane & ~7;
    // eight threads a column, slots 4 ol .. 4 ol + 3 of vpos each, in four
    // named registers (a slot is picked by selects, never by an index); a
    // warp's lanes run the same trips (nlive * 128 is a multiple of 32)
    for (int item = tid; item < nlive * kNb * 8; item += kThreads) {
      const int lb = item / (8 * kNb), c = (item / 8) % kNb;
      T* x = live(lb) + c;
      T s0, s1, s2, s3;
      auto load = [&](int k) {
        return 4 * ol + k < nv ? x[vpos[4 * ol + k] * kLdb] : T(0);
      };
      s0 = load(0);
      s1 = load(1);
      s2 = load(2);
      s3 = load(3);
      auto pick = [&](int k) {
        return k == 0 ? s0 : k == 1 ? s1 : k == 2 ? s2 : s3;
      };
      for (int t = 0; t < kNb; ++t) {
        const int q = vidx[t];    // the pivot row's slot, >= t
        const T av = __shfl_sync(kFull, pick(t & 3), ob + (t >> 2));
        const T pj = __shfl_sync(kFull, pick(q & 3), ob + (q >> 2));
        if (ol == 0) xbuf[((size_t)lb * kNb + t) * kLdb + c] = pj;
        const T inv = lv[t * kLdb + t];
        // after the swap slot q holds row j's entry, slot t the pivot's
        auto step = [&](T& e, int k) {
          const int v = 4 * ol + k;
          const T x0 = v == q ? av : e;
          if (v == t)
            e = mul_rn(pj, inv);
          else if (v < nv)
            e = sub_rn(x0, mul_rn(lv[v * kLdb + t], pj));
        };
        step(s0, 0);
        step(s1, 1);
        step(s2, 2);
        step(s3, 3);
      }
      auto store = [&](int k, T e) {
        if (4 * ol + k < nv) x[vpos[4 * ol + k] * kLdb] = e;
      };
      store(0, s0);
      store(1, s1);
      store(2, s2);
      store(3, s3);
    }
  };
  auto phase_b = [&](const T* f, int j0, int lb0, int lb1, auto live,
                     int tt0, int nthr) {
    const int nv = *nvp;
    const int half = (tid & 31) & 16;
    // one (row, column) a thread over the blocks [lb0, lb1), chunk at a
    // time: a row's 16 multipliers are read once, coalesced, by its 16
    // threads, and shared by shuffles; a warp's lanes run the same trips
    // (bp * 16 is a multiple of 128)
    for (int c0 = lb0; c0 < lb1; c0 += chunk) {
      const int nb = lb1 - c0 < chunk ? lb1 - c0 : chunk;
      T next = tt0 < bp * kNb ? load_cg(f + tt0) : T(0);
      for (int item = tt0; item < bp * kNb; item += nthr) {
        const int i = item / kNb, c = item % kNb;
        const T mc_ = next;   // the next item's multiplier is on its way
        if (item + nthr < bp * kNb) next = load_cg(f + item + nthr);
        bool in_v = i >= j0 && i < j0 + kNb;
        for (int v = kNb; v < nv; ++v) in_v = in_v || vpos[v] == i;
        T av[chunk];
#pragma unroll
        for (int lb = 0; lb < chunk; ++lb)
          if (lb < nb) av[lb] = live(c0 + lb)[i * kLdb + c];
#pragma unroll
        for (int t = 0; t < kNb; ++t) {
          const T m = __shfl_sync(kFull, mc_, half + t);
#pragma unroll
          for (int lb = 0; lb < chunk; ++lb)
            if (lb < nb)
              av[lb] = sub_rn(
                  av[lb],
                  mul_rn(m, xbuf[((size_t)(c0 + lb) * kNb + t) * kLdb + c]));
        }
        if (!in_v)
#pragma unroll
          for (int lb = 0; lb < chunk; ++lb)
            if (lb < nb) live(c0 + lb)[i * kLdb + c] = av[lb];
      }
    }
  };

  // rows [i0, i1) of z_k = y_k - X_k z_{k+1}: four rows a warp at once, so
  // their loads are in flight together; z_next in shared memory, put(i, z)
  auto back_rows = [&](int k, int i0, int i1, const T* z_next, const T* x_s,
                       const T* y_s, auto put) {
    const int lane = tid & 31;
    const T* x_k = x_s + (size_t)k * b * b;
    for (int r0 = i0 + 4 * warp; r0 < i1; r0 += 4 * kWarps) {
      T acc[4] = {};
      for (int q = lane; q < b; q += 32) {
        const T zq = z_next[q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (r0 + r < i1)
            acc[r] = fma(load_cg(x_k + (size_t)(r0 + r) * b + q), zq, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r] = warp_sum(acc[r]);
        if (lane == 0 && r0 + r < i1)
          put(r0 + r, load_cg(y_s + (size_t)k * b + r0 + r) - acc[r]);
      }
    }
  };

  const size_t bb = (size_t)b * b;
  for (; s < a.s_len; s += a.groups) {
    // system s's inputs, outputs and X_k | y_k
    auto d_s = [&]() { return a.diag + (size_t)s * t_len * bb; };
    auto u_s = [&]() { return a.upper + (size_t)s * a.upper_len * bb; };
    auto r_s = [&]() { return a.rhs + (size_t)s * t_len * b; };
    auto x_s = [&]() { return a.xs + (size_t)s * t_len * bb; };
    auto y_s = [&]() { return a.ys + (size_t)s * t_len * b; };
    auto o_s = [&]() { return a.out + (size_t)s * t_len * b; };

    // D_k into the C blocks and U_k into the [U | g] blocks but g's, padded
    // with the identity and zeros; in-range entries by asynchronous copies
    // where the blocks are in shared memory
    auto load_stage = [&](int k, int buf, bool load_d, bool load_u) {
      const T* d_k = d_s() + (size_t)k * bb;
      const T* u_k = k < t_len - 1 ? u_s() + (size_t)k * bb : nullptr;
      for (int m = 0; load_d && m < mc; ++m) {
        T* dst = cblk(buf, m);
        const int c0 = (rank + nr * m) * kNb;
        for (int e = tid; e < bp * kNb; e += kThreads) {
          const int i = e / kNb, c = c0 + e % kNb;
          T* p = dst + i * kLdb + e % kNb;
          if (i < b && c < b) {
            if (TILE)
              copy_async(p, d_k + (size_t)i * b + c);
            else
              *p = d_k[(size_t)i * b + c];
          } else {
            *p = i == c ? T(1) : T(0);
          }
        }
      }
      for (int m = 0; load_u && m < mr; ++m) {
        if (m == g_slot) continue;
        T* dst = rblk(buf, m);
        const int c0 = (rank + nr * m) * kNb;
        for (int e = tid; e < bp * kNb; e += kThreads) {
          const int i = e / kNb, c = c0 + e % kNb;
          T* p = dst + i * kLdb + e % kNb;
          if (u_k && i < b && c < b) {
            if (TILE)
              copy_async(p, u_k + (size_t)i * b + c);
            else
              *p = u_k[(size_t)i * b + c];
          } else {
            *p = T(0);
          }
        }
      }
    };

    for (int k = 0; k < t_len; ++k) {
      const int cb = a.prefetch ? (k & 1) : 0;      // this stage's tile
      const int pb = a.prefetch ? ((k + 1) & 1) : 0;    // the last stage's
      T* gblk = g_slot >= 0 ? rblk(cb, g_slot) : nullptr;
      const T* r_k = r_s() + (size_t)k * b;
      if (k == 0) {
        load_stage(0, cb, true, true);
        if (gblk)
          for (int e = tid; e < bp * kNb; e += kThreads) {
            const int i = e / kNb, c = e % kNb;
            gblk[i * kLdb + c] = c == 0 && i < b ? r_k[i] : T(0);
          }
        copy_wait();
        __syncthreads();
        mark(kCopy);
      } else {
        // C = D_k - U_{k-1}^T X_{k-1} in the C blocks (D_k there), and
        // g = r_k - U_{k-1}^T y_{k-1} into columns 8-15 of g's block
        // (y_{k-1} in column 0 of the last stage's g block, columns 1-15
        // zero)
        if (!a.prefetch) load_stage(k, cb, true, false);
        if (gblk)
          for (int e = tid; e < bp * 8; e += kThreads) {
            const int i = e / 8, c = e % 8;
            gblk[i * kLdb + 8 + c] = c == 0 && i < b ? r_k[i] : T(0);
          }
        copy_wait();
        __syncthreads();
        mark(kCopy);
        const T* u_p = u_s() + (size_t)(k - 1) * bb;
        // units: my C blocks' two halves, then g
        auto outp = [&](int u) {
          return u < 2 * mc ? cblk(cb, u / 2) + 8 * (u % 2) : gblk + 8;
        };
        auto xin = [&](int u) {
          return u < 2 * mc ? rblk(pb, u / 2) + 8 * (u % 2)
                            : rblk(pb, g_slot);
        };
        product<T, group>(
            ntile, (b + 3) / 4 * 4, 2 * mc + (gblk ? 1 : 0), outp,
            [&](int i, int q) {
              return i < b && q < b ? u_p[(size_t)q * b + i] : T(0);
            },
            [&](int u, int q, int c) { return xin(u)[q * kLdb + c]; },
            [&](int u, int i, int c) { return outp(u)[i * kLdb + c]; }, 0,
            kWarps);
        __syncthreads();
        mark(kProduct);
        if (gblk)
          for (int e = tid; e < bp * kNb; e += kThreads) {
            const int i = e / kNb, c = e % kNb;
            if (c == 0) gblk[i * kLdb] = gblk[i * kLdb + 8];
            else if (c != 8) gblk[i * kLdb + c] = T(0);
          }
        __syncthreads();
        if (gblk)
          for (int i = tid; i < bp; i += kThreads) gblk[i * kLdb + 8] = T(0);
        if (!a.prefetch) {
          load_stage(k, cb, false, true);
          copy_wait();
        }
        __syncthreads();
        mark(kCopy);
      }
      // stage k+1's D and U into the other tile while this one eliminates
      if (a.prefetch && k + 1 < t_len) load_stage(k + 1, pb, true, true);

      if (EQ) {
        // row maxima of my C columns, then of the group's (every CTA the
        // same scales)
        for (int i = tid; i < bp; i += kThreads) {
          T mx = T(0);
          for (int m = 0; m < mc; ++m) {
            const T* row = cblk(cb, m) + i * kLdb;
            for (int c = 0; c < kNb; ++c) mx = nan_max(mx, T(fabs(row[c])));
          }
          rmaxw()[(size_t)rank * bp + i] = mx;
        }
        mark(kProduct);
        sync_group();
        for (int i = tid; i < bp; i += kThreads) {
          T mx = T(0);
          for (int q = 0; q < nr; ++q)
            mx = nan_max(mx, load_cg(rmaxw() + (size_t)q * bp + i));
          dsc[i] = T(1) / sqrt(mx != mx ? mx : fmax(mx, T(1e-30)));
        }
        __syncthreads();
        // D C D, D [U | g], kept in orig for the residual
        for (int m = 0; m < mc + mr; ++m) {
          const bool is_c = m < mc;
          const int q = rank + nr * (is_c ? m : m - mc);
          T* blk_m = is_c ? cblk(cb, m) : rblk(cb, m - mc);
          T* o = as_s() + (is_c ? 0 : bp) + (size_t)q * kNb;
          for (int e = tid; e < bp * kNb; e += kThreads) {
            const int i = e / kNb, c = e % kNb;
            T v = blk_m[i * kLdb + c] * dsc[i];
            if (is_c) v *= dsc[q * kNb + c];
            blk_m[i * kLdb + c] = v;
            o[(size_t)i * ldo + c] = v;
          }
        }
        __syncthreads();
        mark(kProduct);
      }

      // Gauss-Jordan by panels
      if (rank == 0 && warp < kFactorWarps) {
        factor_panel(cblk(cb, 0), bp, 0, piv, ckey, cpos);
        publish(0, cblk(cb, 0));
      }
      mark(kFactor);
      for (int p = 0; p < nq; ++p) {
        wait_panel(p);       // panel p's factors and pivots are out
        const T* f = panel(p);
        const int* pv = pivg() + p * kNb;
        const int m0 = p < rank ? 0 : (p - rank) / nr + 1;
        const int nlc = mc > m0 ? mc - m0 : 0;
        const int nlive = nlc + mr;
        auto live = [&](int lb) {
          return lb < nlc ? cblk(cb, m0 + lb) : rblk(cb, lb - nlc);
        };
        const int j0 = p * kNb;
        setup(f, pv, j0);
        phase_a(j0, nlive, live);
        __syncthreads();
        if (p + 1 < nq && rank == (p + 1) % nr) {
          // look-ahead: the next panel's block (my first live one) first,
          // then the factor warps factor and publish it while the others
          // update the rest
          phase_b(f, j0, 0, 1, live, tid, kThreads);
          __syncthreads();
          mark(kUpdate);
          if (warp < kFactorWarps) {
            factor_panel(cblk(cb, m0), bp, (p + 1) * kNb, piv, ckey, cpos);
            publish(p + 1, cblk(cb, m0));
            mark(kFactor);
          } else {
            phase_b(f, j0, 1, nlive, live, tid - kFactorThreads,
                    kThreads - kFactorThreads);
          }
        } else {
          phase_b(f, j0, 0, nlive, live, tid, kThreads);
        }
        __syncthreads();
        mark(kUpdate);
      }

      if (EQ) {
        // Y to ysc; the residual M_s - A_s Y into the [U | g] blocks (A_s
        // from every CTA: after a barrier); the panels' swaps and factors
        // again on it; X = D (Y + dY)
        for (int m = 0; m < mr; ++m) {
          const T* blk_m = rblk(cb, m);
          T* y = ysc_s() + (size_t)(rank + nr * m) * kNb;
          for (int e = tid; e < bp * kNb; e += kThreads)
            y[(size_t)(e / kNb) * wr + e % kNb] =
                blk_m[(e / kNb) * kLdb + e % kNb];
        }
        mark(kUpdate);
        sync_group();
        {
          auto outp = [&](int u) { return rblk(cb, u / 2) + (u % 2) * 8; };
          auto col0 = [&](int u) {
            return (rank + nr * (u / 2)) * kNb + (u % 2) * 8;
          };
          product<T, group>(
              ntile, bp, 2 * mr, outp,
              [&](int i, int q) {
                return load_cg(as_s() + (size_t)i * ldo + q);
              },
              [&](int u, int q, int c) {
                return ysc_s()[(size_t)q * wr + col0(u) + c];
              },
              [&](int u, int i, int c) {
                return as_s()[(size_t)i * ldo + bp + col0(u) + c];
              },
              0, kWarps);
        }
        __syncthreads();
        mark(kProduct);
        auto rhs_live = [&](int lb) { return rblk(cb, lb); };
        for (int p = 0; p < nq; ++p) {
          const T* f = panel(p);
          setup(f, pivg() + p * kNb, p * kNb);
          phase_a(p * kNb, mr, rhs_live);
          __syncthreads();
          phase_b(f, p * kNb, 0, mr, rhs_live, tid, kThreads);
          __syncthreads();
        }
        for (int m = 0; m < mr; ++m) {
          T* blk_m = rblk(cb, m);
          const T* y = ysc_s() + (size_t)(rank + nr * m) * kNb;
          for (int e = tid; e < bp * kNb; e += kThreads) {
            const int i = e / kNb, c = e % kNb;
            blk_m[i * kLdb + c] =
                (y[(size_t)i * wr + c] + blk_m[i * kLdb + c]) * dsc[i];
          }
        }
        __syncthreads();
        mark(kUpdate);
      }

      // X_k | y_k into the scratch the back substitution reads
      for (int m = 0; m < mr; ++m) {
        const T* blk_m = rblk(cb, m);
        if (m == g_slot) {
          for (int i = tid; i < b; i += kThreads)
            y_s()[(size_t)k * b + i] = blk_m[i * kLdb];
        } else {
          const int c0 = (rank + nr * m) * kNb;
          for (int e = tid; e < bp * kNb; e += kThreads) {
            const int i = e / kNb, c = c0 + e % kNb;
            if (i < b && c < b)
              x_s()[(size_t)k * bb + (size_t)i * b + c] =
                  blk_m[i * kLdb + e % kNb];
          }
        }
      }
      mark(kCopy);
      // nobody reads this stage's panels any more, and every X_k | y_k is
      // out, before a panel is published again or the back substitution
      // reads them
      sync_group();
      ++seq;
    }

    // back substitution, z_k = y_k - X_k z_{k+1}: rows [rank rows, ...)
    // of every stage, z_{k+1} from out, a barrier between stages
    const int rows = (b + nr - 1) / nr;
    const int i0 = rank * rows < b ? rank * rows : b;
    const int i1 = i0 + rows < b ? i0 + rows : b;
    for (int k = t_len - 1; k >= 0; --k) {
      for (int i = tid; i < b; i += kThreads)
        rmax[i] = k + 1 < t_len
                      ? load_cg(o_s() + (size_t)(k + 1) * b + i)
                      : T(0);
      __syncthreads();
      back_rows(k, i0, i1, rmax, x_s(), y_s(),
                [&](int i, T z) { o_s()[(size_t)k * b + i] = z; });
      mark(kBack);
      if (k > 0) sync_group();
      else __syncthreads();
    }
  }
}

template <bool EQ, bool TILE, bool PROF>
__global__ void __launch_bounds__(kThreads, 1)
thomas_big_kernel(const Params<real> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_big<real, EQ, TILE, PROF>(a, smem_raw);
}

// the kernel's dynamic shared memory, set once it is past the default
template <bool EQ, bool TILE, bool PROF>
cudaError_t prepare(size_t need) {
  static size_t allowed = 48 * 1024;
  if (need > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        thomas_big_kernel<EQ, TILE, PROF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err != cudaSuccess) return err;
    allowed = need;
  }
  return cudaSuccess;
}

// CTAs of the kernel the device holds at once, at this shared memory
template <bool EQ, bool TILE, bool PROF>
cudaError_t resident(size_t need, int* count) {
  cudaError_t err = prepare<EQ, TILE, PROF>(need);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, thomas_big_kernel<EQ, TILE, PROF>, kThreads, need);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *count = per_sm * sms;
  return cudaSuccess;
}

template <bool EQ, bool TILE, bool PROF>
int launch(const Params<real>& a, size_t need, void* stream) {
  int count = 0;
  cudaError_t err = resident<EQ, TILE, PROF>(need, &count);
  if (err != cudaSuccess) return (int)err;
  if (a.r * a.groups > count) return -3;   // not all co-resident
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.r * a.groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = need;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, thomas_big_kernel<EQ, TILE, PROF>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the element type this library was compiled for (8 or 4).
int block_thomas_big_elem_bytes() { return (int)sizeof(real); }

// Shared-memory bytes of one CTA of the plan (b, r, prefetch, smem_tile),
// and ints of a group's sync workspace, as this layout counts them.
size_t block_thomas_big_smem_bytes(int b, int r, int prefetch,
                                   int smem_tile) {
  return big_bytes(b, (int)sizeof(real), r, prefetch, smem_tile);
}
size_t block_thomas_big_sync_ints(int b) { return sync_ints(padded(b) / kNb); }

// G groups of r CTAs (256 threads each), group g solving systems g, g + G,
// ...; the blocks in shared memory (smem_tile, prefetched with prefetch)
// or in tiles. xs, ys, panels, sync (zeroed), tiles and, equilibrated,
// orig, ysc and rmaxw are scratch (see the top of this file); prof, if not
// null (and zeroed; the blocks in shared memory), selects the profiling
// build and receives [S][r][6] clocks (panel factor and publish, flag and
// barrier waits, panel updates, stage product and scaling, copies, back
// substitution). smem_bytes is a CTA's dynamic shared memory as the
// caller computed it. Returns 0, a cudaError, -1 for an argument the kernel
// does not take, -2 when smem_bytes is not what this layout needs, or -3
// when the device cannot hold every CTA at once.
int block_thomas_big(const void* diag, const void* upper, const void* rhs,
                     void* out, void* xs, void* ys, void* orig, void* ysc,
                     void* rmaxw, void* panels, void* tiles, void* sync,
                     void* prof, int s, int t_len, int b, int upper_len,
                     int equilibrate, int r, int groups, int prefetch,
                     int smem_tile, size_t smem_bytes, void* stream) {
  const int nq = padded(b > 0 ? b : 1) / kNb;
  if (b < 1 || s < 1 || t_len < 1 || r < 1 || r > nq + 1 || groups < 1 ||
      groups > s || (upper_len != t_len && upper_len != t_len - 1) ||
      !panels || !sync || (!smem_tile && (!tiles || prefetch || prof)) ||
      (equilibrate && (!orig || !ysc || !rmaxw)))
    return -1;
  const size_t need =
      big_bytes(b, (int)sizeof(real), r, prefetch, smem_tile);
  if (need != smem_bytes) return -2;   // the wrapper's layout is not this one
  Params<real> a;
  a.diag = (const real*)diag;
  a.upper = (const real*)upper;
  a.rhs = (const real*)rhs;
  a.out = (real*)out;
  a.xs = (real*)xs;
  a.ys = (real*)ys;
  a.orig = (real*)orig;
  a.ysc = (real*)ysc;
  a.rmaxw = (real*)rmaxw;
  a.panels = (real*)panels;
  a.tiles = (real*)tiles;
  a.sync = (int*)sync;
  a.prof = (long long*)prof;
  a.s_len = s;
  a.t_len = t_len;
  a.b = b;
  a.upper_len = upper_len;
  a.r = r;
  a.groups = groups;
  a.prefetch = prefetch ? 1 : 0;
  a.smem_tile = smem_tile ? 1 : 0;
  if (prof)
    return equilibrate ? launch<true, true, true>(a, need, stream)
                       : launch<false, true, true>(a, need, stream);
  if (smem_tile)
    return equilibrate ? launch<true, true, false>(a, need, stream)
                       : launch<false, true, false>(a, need, stream);
  return equilibrate ? launch<true, false, false>(a, need, stream)
                     : launch<false, false, false>(a, need, stream);
}

// How many CTAs of the plan (b, r, prefetch, smem_tile, variant) the device
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs) into
// *count. Returns 0 or a cudaError.
int block_thomas_big_max_active(int b, int r, int prefetch, int smem_tile,
                                int equilibrate, int* count) {
  const size_t need =
      big_bytes(b, (int)sizeof(real), r, prefetch, smem_tile);
  if (smem_tile)
    return (int)(equilibrate ? resident<true, true, false>(need, count)
                             : resident<false, true, false>(need, count));
  return (int)(equilibrate ? resident<true, false, false>(need, count)
                           : resident<false, false, false>(need, count));
}

}  // extern "C"
