// Hand-written Hopper kernels of the single- and block-Lanczos paths.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (lanczos_tpu_torch/ops/kernels/build.py):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblanczos_kernels.so lanczos_kernels.cu
//
// Every entry point takes its pointers and PyTorch's current stream as
// void*, launches on that stream without synchronising, allocates nothing
// (the Python wrapper hands in outputs and scratch from torch.empty) and
// returns cudaGetLastError(), which the wrapper raises on.  dtype 0 is
// float32, 1 is float64; both accumulate in their own type, except K7,
// which takes float32 and accumulates in float64.
//
// All six kernels stream the block state, (p, 6, Zc, P) per block, and do
// a handful of flops per element, so device memory bounds them all.  At
// the main path's shape (Maxwell N=160, p=4: Zc=176, P=26624) one block
// state is 449.8 MB; the bytes each moves per call are noted at each
// kernel.  This first version is plain: one element (or one position
// across the block) per thread in a grid-stride loop, neighbouring threads
// on neighbouring addresses, no shared-memory staging, no TMA or wgmma.
//
// Cross-block sums (K3, K4, K7) are deterministic: each block writes its
// partial sums into scratch, then sum_partials_kernel adds them in block
// order.  No float atomics, so the Lanczos coefficients repeat run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 4;  // taps feeding one output component

// Taps of one output component, derived on the host from StencilSpec.
struct CompTaps {
  int n;               // number of taps
  int t[kMaxTaps];     // column in the half's weight arrays
  int ic[kMaxTaps];    // global input component (0..5)
  int dz[kMaxTaps];    // z-row offset in {-1, 0, 1}
  int r[kMaxTaps];     // lane roll in [0, P): reads lane (l - r) mod P
};

// Taps come in (z-pair | plane-pair) twos: StencilSpec.paired.
struct StencilTaps {
  CompTaps comp[6];
};

struct Geometry {
  int zc;           // z capacity
  int plane;        // folded-plane capacity P
  int nt;           // taps per half (weight columns)
  long long state;  // 6 * zc * plane: elements of one block column
};

// Host int layout (see stencil_kernel.py tap_table): per output
// component, n, t[4], ic[4], dz[4], r[4].
StencilTaps unpack_taps(const int* h) {
  StencilTaps s;
  const int* c = h;
  for (int i = 0; i < 6; ++i) {
    s.comp[i].n = c[0];
    for (int k = 0; k < kMaxTaps; ++k) {
      s.comp[i].t[k] = c[1 + k];
      s.comp[i].ic[k] = c[1 + kMaxTaps + k];
      s.comp[i].dz[k] = c[1 + 2 * kMaxTaps + k];
      s.comp[i].r[k] = c[1 + 3 * kMaxTaps + k];
    }
    c += 1 + 4 * kMaxTaps;
  }
  return s;
}

// Offset, within one block column, of one tap's input: component ic
// shifted by dz z-rows and rolled by r lanes.  pltpu.roll follows jnp.roll,
// out[l] = in[(l - r) mod P]; the weights are zero on every lane a
// wrapped read reaches.  A z-row outside [0, Zc) gives -1 and reads as 0
// (the Pallas kernel clamps it; either way it meets only the zero weights
// of rows 0 and Zc-1).
__device__ __forceinline__ int tap_offset(int ic, int z, int dz, int l, int r,
                                          const Geometry& g) {
  const int zz = z + dz;
  if (zz < 0 || zz >= g.zc) return -1;
  int ll = l - r;
  if (ll < 0) ll += g.plane;
  return (ic * g.zc + zz) * g.plane + ll;
}

// acc[b] = (A u)[b, c, z, l] for the block columns b < min(p, MAXP) of u
// (columns state elements apart).  wzr = wz_t[h, z, :] and wpl =
// &wplane[h, 0, l] (tap t's plane weight at wpl[t * P]).  The paired form
// is the Pallas kernel's: a z-pair shares its plane weight, a plane-pair
// its z weight, so a pair costs three multiplies.  Each pair's weights are
// loaded once for all columns, and its input loads for all columns are
// issued together, before any of them is used.
template <typename T, int MAXP>
__device__ __forceinline__ void stencil_cols(
    const T* __restrict__ u, long long state, int p, const CompTaps& ct,
    const T* __restrict__ wzr, const T* __restrict__ wpl, int z, int l,
    const Geometry& g, T (&acc)[MAXP]) {
#pragma unroll
  for (int b = 0; b < MAXP; ++b) acc[b] = T(0);
  // unrolled over the (at most two) pairs, so that both pairs' loads can
  // be in flight together: at p = 1 there is no other parallelism per thread
#pragma unroll
  for (int k = 0; k + 1 < kMaxTaps; k += 2) {
    if (k + 1 >= ct.n) break;
    const int t0 = ct.t[k], t1 = ct.t[k + 1];
    const int o0 = tap_offset(ct.ic[k], z, ct.dz[k], l, ct.r[k], g);
    const int o1 = tap_offset(ct.ic[k + 1], z, ct.dz[k + 1], l, ct.r[k + 1], g);
    const bool zpair = ct.dz[k] != ct.dz[k + 1];
    const T w0 = zpair ? wzr[t0] : wpl[(long long)t0 * g.plane];
    const T w1 = zpair ? wzr[t1] : wpl[(long long)t1 * g.plane];
    const T ws = zpair ? wpl[(long long)t0 * g.plane] : wzr[t0];
    T v0[MAXP], v1[MAXP];
#pragma unroll
    for (int b = 0; b < MAXP; ++b) {
      v0[b] = (b < p && o0 >= 0) ? u[b * state + o0] : T(0);
      v1[b] = (b < p && o1 >= 0) ? u[b * state + o1] : T(0);
    }
#pragma unroll
    for (int b = 0; b < MAXP; ++b) acc[b] += (v0[b] * w0 + v1[b] * w1) * ws;
  }
}

// Sums acc[i] over the block, deterministically (fixed shuffle tree, then
// warps in order).  Afterwards red[i * kWarps] holds the block total.
template <typename T, int NACC>
__device__ __forceinline__ void block_sum(T (&acc)[NACC], T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    T v = acc[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[i * kWarps + warp] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NACC; i += blockDim.x) {
    T s = red[i * kWarps];
    for (int w = 1; w < kWarps; ++w) s += red[i * kWarps + w];
    red[i * kWarps] = s;
  }
  __syncthreads();
}

// Second pass of the cross-block sums: out[i] = sum_b partial[b, i], in
// block order, in T; rounded to TOut once at the end.
template <typename T, typename TOut>
__global__ void sum_partials_kernel(const T* __restrict__ partial,
                                    int nblocks, int nout,
                                    TOut* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nout) return;
  T s = T(0);
  for (int b = 0; b < nblocks; ++b) s += partial[(long long)b * nout + i];
  out[i] = TOut(s);
}

// ---------------------------------------------------------------------------
// K1: out = A u over p block columns.
// Replaces apply_stencil_pair (lanczos_tpu/ops/pallas/stencil_kernel.py:70),
// vmapped over p by PallasMaxwellOperator.mm.
// Bound: device memory.  One read and one write of the state, 2 * 449.8 MB
// at N=160 p=4, plus 2.6 MB of plane weights; the 4 tap reads of an output
// hit its neighbours (+-1 lane, +-xc lanes, +-1 z-row of the opposite half),
// which L1/L2 serve.  One thread per (z, l) position, looping over the six
// components and the p block columns, four per pass (one when p = 1;
// stencil_pair_body), keeps every load and store coalesced along the lane
// axis and decodes the position once.
// The body K1 and K5 share: out = A u, plus u itself when kAddInput, for
// output component c at (z, l) over the p block columns, COLS per pass.
// taps is the block's shared-memory copy.
template <typename T, bool kAddInput, int COLS>
__device__ __forceinline__ void stencil_comp(
    const T* __restrict__ u, T* __restrict__ out, const T* __restrict__ wz,
    const T* __restrict__ wp, const StencilTaps& taps, const Geometry& g,
    int p, int c, int z, int l, int s) {
  const int h = c / 3;
  const T* wzr = wz + ((long long)h * g.zc + z) * g.nt;
  const T* wpl = wp + (long long)h * g.nt * g.plane + l;
  const int e0 = c * g.zc * g.plane + s;  // < 2^30, checked by the wrapper
  for (int b0 = 0; b0 < p; b0 += COLS) {
    T acc[COLS];
    stencil_cols<T, COLS>(u + b0 * g.state, g.state, p - b0, taps.comp[c],
                          wzr, wpl, z, l, g, acc);
#pragma unroll
    for (int b = 0; b < COLS; ++b) {
      if (b0 + b < p) {
        const long long e = (b0 + b) * g.state + e0;
        out[e] = kAddInput ? u[e] + acc[b] : acc[b];
      }
    }
  }
}

// One thread owns one (z, l) position and writes all six output
// components there: a block then reads each input row's neighbourhood for
// all the taps that need it, and K5's identity read of u, close together
// in time, so L1 serves the repeats and device memory sees one read of u.
// The position is decoded once for all components and columns.  p = 1
// takes a one-column instantiation: the four-column one spends registers
// and predicated loads on three empty columns.  The component loop stays
// rolled: unrolled, it costs more occupancy than its overlapped loads gain
// (158 registers and 2.4x the time at p = 1 on the H100; PERF.md).
template <typename T, bool kAddInput, int COLS>
__device__ __forceinline__ void stencil_pair_body(
    const T* __restrict__ u, T* __restrict__ out, const T* __restrict__ wz,
    const T* __restrict__ wp, const StencilTaps& taps, const Geometry& g,
    int p) {
  const int comp = g.zc * g.plane;  // elements of one component
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < comp;
       s += gridDim.x * blockDim.x) {
    const int l = s % g.plane;
    const int z = s / g.plane;
#pragma unroll 1
    for (int c = 0; c < 6; ++c)
      stencil_comp<T, kAddInput, COLS>(u, out, wz, wp, taps, g, p, c, z, l, s);
  }
}

template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads)
    stencil_pair_kernel(const T* __restrict__ u, T* __restrict__ out,
                        const T* __restrict__ wz, const T* __restrict__ wp,
                        StencilTaps taps, Geometry g, int p) {
  __shared__ StencilTaps s_taps;
  if (threadIdx.x == 0) s_taps = taps;
  __syncthreads();
  stencil_pair_body<T, false, COLS>(u, out, wz, wp, s_taps, g, p);
}

// ---------------------------------------------------------------------------
// K2: out[j] = sum_k coeffs[k, j] * cat(x0, x1, x2)[k].
// Replaces block_mix (lanczos_tpu/ops/pallas/block_dense.py:104).
// Bound: device memory.  K input rows read once and p_out rows written
// once: 4 * 449.8 MB for the mono step's (3p -> p) mix at N=160 p=4.  The
// (K, p_out) coefficients sit in shared memory.  One thread owns one
// position across all rows and reads all K inputs there before it writes
// any output, so out may alias x0 (inplace=True) without a race; for that
// reason no pointer here is __restrict__.
template <typename T, int MAXPO>
__global__ void __launch_bounds__(kThreads)
    block_mix_kernel(const T* x0, int p0, const T* x1, int p1, const T* x2,
                     int p2, const T* coeffs, T* out, int p_out,
                     long long S) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sc = reinterpret_cast<T*>(smem);
  const int K = p0 + p1 + p2;
  for (int i = threadIdx.x; i < K * p_out; i += blockDim.x) sc[i] = coeffs[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += stride) {
    T acc[MAXPO];
#pragma unroll
    for (int j = 0; j < MAXPO; ++j) acc[j] = T(0);
    for (int k = 0; k < K; ++k) {
      const T* row = k < p0 ? x0 + (long long)k * S
                     : k < p0 + p1 ? x1 + (long long)(k - p0) * S
                                   : x2 + (long long)(k - p0 - p1) * S;
      const T xv = row[s];
      const T* ck = sc + k * p_out;
#pragma unroll
      for (int j = 0; j < MAXPO; ++j)
        if (j < p_out) acc[j] += ck[j] * xv;
    }
#pragma unroll
    for (int j = 0; j < MAXPO; ++j)
      if (j < p_out) out[(long long)j * S + s] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// K3: partial sums of gram(cat(x0..x3), z)[k, j] = <row_k, z_j>.
// Replaces block_grams (lanczos_tpu/ops/pallas/block_dense.py:210); with
// include_zz the wrapper passes z itself as x3.
// Bound: device memory.  Each operand is read once when the (K, p) result
// fits one 12 x 4 tile (every call of the main path at p <= 4): the
// prologue's gram(q0, v0) + gram(v0, v0) reads 2 * 449.8 MB at N=160 p=4.
// Each thread keeps its 12 x 4 tile of sums in registers over a
// grid-stride run of positions; larger (K, p) take more tiles on
// blockIdx.y/z, and each tile re-reads its rows.
constexpr int kGramRows = 12;
constexpr int kGramCols = 4;

template <typename T>
struct Rows {
  const T* x[4];
  int n[4];
  int total;
};

template <typename T>
__device__ __forceinline__ const T* row_ptr(const Rows<T>& rows, int k,
                                            long long S) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (k < rows.n[i]) return rows.x[i] + (long long)k * S;
    k -= rows.n[i];
  }
  return nullptr;
}

// The body K3 and K7 share: the block's partial sums of one R x C tile of
// the Gram, operands of type T accumulated in Acc.  red is the block's
// shared scratch of R * C * kWarps Acc.
template <typename T, typename Acc, int R, int C>
__device__ __forceinline__ void gram_tile(const Rows<T>& rows,
                                          const T* __restrict__ z, int p,
                                          long long S,
                                          Acc* __restrict__ partial,
                                          Acc* red) {
  const int K = rows.total;
  const int k0 = blockIdx.y * R, j0 = blockIdx.z * C;
  const T* xr[R];
  const T* zr[C];
#pragma unroll
  for (int k = 0; k < R; ++k)
    xr[k] = k0 + k < K ? row_ptr(rows, k0 + k, S) : nullptr;
#pragma unroll
  for (int j = 0; j < C; ++j)
    zr[j] = j0 + j < p ? z + (long long)(j0 + j) * S : nullptr;
  Acc acc[R * C];
#pragma unroll
  for (int i = 0; i < R * C; ++i) acc[i] = Acc(0);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += stride) {
    Acc zv[C];
#pragma unroll
    for (int j = 0; j < C; ++j) zv[j] = zr[j] ? Acc(zr[j][s]) : Acc(0);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const Acc xv = xr[k] ? Acc(xr[k][s]) : Acc(0);
#pragma unroll
      for (int j = 0; j < C; ++j) acc[k * C + j] += xv * zv[j];
    }
  }
  block_sum<Acc, R * C>(acc, red);
  Acc* part = partial + (long long)blockIdx.x * K * p;
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int k = k0 + i / C, j = j0 + i % C;
    if (k < K && j < p) part[k * p + j] = red[i * kWarps];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    block_grams_kernel(Rows<T> rows, const T* __restrict__ z, int p,
                       long long S, T* __restrict__ partial) {
  __shared__ T red[kGramRows * kGramCols * kWarps];
  gram_tile<T, T, kGramRows, kGramCols>(rows, z, p, S, partial, red);
}

// ---------------------------------------------------------------------------
// K4: v = A q written into dst's buffer, and partial sums of
// g3 = [gram(q, v); gram(v, v); gram(dst_old, q)], in one pass.
// Replaces apply_stencil_pair_gram (lanczos_tpu/ops/pallas/stencil_gram.py:96).
// Bound: device memory.  Reads q and dst, writes v: 3 * 449.8 MB at N=160
// p=4, against 5 passes for K1 followed by a separate Gram.  One thread
// owns one state position across all p block columns, so it holds q, v and
// dst_old of every column in registers for the 3 p^2 Gram sums.  It reads
// dst[e] before it writes v there, and no other thread reads dst[e]: the
// stencil's neighbour reads come from q only, so the aliasing is race-free.
template <typename T, int MAXP>
__global__ void __launch_bounds__(kThreads)
    stencil_gram_kernel(const T* __restrict__ q, T* __restrict__ dst,
                        const T* __restrict__ wz, const T* __restrict__ wp,
                        StencilTaps taps, Geometry g, int p,
                        T* __restrict__ partial) {
  constexpr int PP = MAXP * MAXP;
  __shared__ StencilTaps s_taps;
  __shared__ T red[3 * PP * kWarps];
  if (threadIdx.x == 0) s_taps = taps;
  __syncthreads();
  T acc[3 * PP];
#pragma unroll
  for (int i = 0; i < 3 * PP; ++i) acc[i] = T(0);
  const int state = (int)g.state;  // <= 2^30, checked by the wrapper
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < state;
       s += gridDim.x * blockDim.x) {
    const int l = s % g.plane;
    const int rz = s / g.plane;
    const int z = rz % g.zc;
    const int c = rz / g.zc;
    const int h = c / 3;
    const T* wzr = wz + ((long long)h * g.zc + z) * g.nt;
    const T* wpl = wp + (long long)h * g.nt * g.plane + l;
    // every read of dst[e] comes before the write of v there
    T qv[MAXP], dv[MAXP], vv[MAXP];
#pragma unroll
    for (int b = 0; b < MAXP; ++b) {
      qv[b] = b < p ? q[b * g.state + s] : T(0);
      dv[b] = b < p ? dst[b * g.state + s] : T(0);
    }
    stencil_cols<T, MAXP>(q, g.state, p, s_taps.comp[c], wzr, wpl, z, l, g,
                          vv);
#pragma unroll
    for (int b = 0; b < MAXP; ++b)
      if (b < p) dst[b * g.state + s] = vv[b];
#pragma unroll
    for (int k = 0; k < MAXP; ++k) {
#pragma unroll
      for (int j = 0; j < MAXP; ++j) {
        acc[k * MAXP + j] += qv[k] * vv[j];
        acc[PP + k * MAXP + j] += vv[k] * vv[j];
        acc[2 * PP + k * MAXP + j] += dv[k] * qv[j];
      }
    }
  }
  block_sum<T, 3 * PP>(acc, red);
  T* part = partial + (long long)blockIdx.x * 3 * p * p;
  for (int i = threadIdx.x; i < 3 * PP; i += blockDim.x) {
    const int blk = i / PP, k = (i / MAXP) % MAXP, j = i % MAXP;
    if (k < p && j < p) part[(blk * p + k) * p + j] = red[i * kWarps];
  }
}

// ---------------------------------------------------------------------------
// K5: out = u + (dt A) u over p block columns, one forward-Euler step.
// Replaces fdtd_step_inplace (lanczos_tpu/ops/pallas/stencil_fdtd.py:50).
// Bound: device memory.  One read of u and one write of out: 2 * 112.5 MB
// at N=160 p=1, 2 * 449.8 MB at p=4, against five passes for K1 and a
// separate add.  It is K1's body with the identity term added to the tap
// sum (the plain version's order; the Pallas kernel starts its sum at u,
// which differs in rounding only).  The Pallas kernel updates u in place,
// which the TPU's in-order grid and a VMEM delay ring make safe; CUDA
// blocks run in no order and would overwrite z-halo rows and +-xc lanes a
// neighbour still reads, so out is a second buffer (the caller swaps the
// two), never u.
template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads)
    fdtd_step_kernel(const T* __restrict__ u, T* __restrict__ out,
                     const T* __restrict__ wz, const T* __restrict__ wp,
                     StencilTaps taps, Geometry g, int p) {
  __shared__ StencilTaps s_taps;
  if (threadIdx.x == 0) s_taps = taps;
  __syncthreads();
  stencil_pair_body<T, true, COLS>(u, out, wz, wp, s_taps, g, p);
}

// ---------------------------------------------------------------------------
// K7: partial sums of gram(cat(x0..x3), z) of float32 operands in float64.
// Replaces block_grams_compensated (lanczos_tpu/ops/pallas/block_dense.py:361).
// The TPU has no f64, so the JAX kernel carries Dekker TwoProd/TwoSum
// two-float sums.  Here a float32 x float32 product is exact in float64,
// and every sum (per thread, the block tree, sum_partials in block order)
// runs in float64; the (K, p) total is rounded to float32 once: O(eps_f32)
// error instead of O(eps_f32 sqrt(n)).
// Bound: device memory, as K3: one read of each operand, 2 * 449.8 MB for
// (q,), v, include_zz at N=160 p=4.  The f64 sums double K3's register
// tile, so the tile is 8 x 4 (64 registers of sums) instead of 12 x 4;
// K = 8 rows of the main path's calls still fit one tile, read once.
constexpr int kCompRows = 8;
constexpr int kCompCols = 4;

__global__ void __launch_bounds__(kThreads)
    block_grams_compensated_kernel(Rows<float> rows,
                                   const float* __restrict__ z, int p,
                                   long long S, double* __restrict__ partial) {
  __shared__ double red[kCompRows * kCompCols * kWarps];
  gram_tile<float, double, kCompRows, kCompCols>(rows, z, p, S, partial, red);
}

// ---------------------------------------------------------------------------
// Launchers.

inline int finish() { return (int)cudaGetLastError(); }

template <typename T, typename TOut = T>
int sum_partials(const T* partial, int nblocks, int nout, TOut* out,
                 cudaStream_t st) {
  sum_partials_kernel<T, TOut>
      <<<(nout + kThreads - 1) / kThreads, kThreads, 0, st>>>(partial, nblocks,
                                                              nout, out);
  return finish();
}

template <typename T>
int stencil_pair(const void* u, void* out, const void* wz, const void* wp,
                 const int* taps, int p, int zc, int plane, int nt,
                 int nblocks, cudaStream_t st) {
  const Geometry g{zc, plane, nt, 6LL * zc * plane};
  auto kernel = p == 1 ? stencil_pair_kernel<T, 1> : stencil_pair_kernel<T, 4>;
  kernel<<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(u), static_cast<T*>(out),
      static_cast<const T*>(wz), static_cast<const T*>(wp), unpack_taps(taps),
      g, p);
  return finish();
}

template <typename T>
int fdtd_step(const void* u, void* out, const void* wz, const void* wp,
              const int* taps, int p, int zc, int plane, int nt, int nblocks,
              cudaStream_t st) {
  const Geometry g{zc, plane, nt, 6LL * zc * plane};
  auto kernel = p == 1 ? fdtd_step_kernel<T, 1> : fdtd_step_kernel<T, 4>;
  kernel<<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(u), static_cast<T*>(out),
      static_cast<const T*>(wz), static_cast<const T*>(wp), unpack_taps(taps),
      g, p);
  return finish();
}

template <typename T, int MAXPO>
int block_mix_t(const void* x0, int p0, const void* x1, int p1,
                const void* x2, int p2, const void* coeffs, void* out,
                int p_out, long long S, int nblocks, cudaStream_t st) {
  const size_t smem = sizeof(T) * (size_t)(p0 + p1 + p2) * p_out;
  block_mix_kernel<T, MAXPO><<<nblocks, kThreads, smem, st>>>(
      static_cast<const T*>(x0), p0, static_cast<const T*>(x1), p1,
      static_cast<const T*>(x2), p2, static_cast<const T*>(coeffs),
      static_cast<T*>(out), p_out, S);
  return finish();
}

template <typename T>
int block_mix(const void* x0, int p0, const void* x1, int p1, const void* x2,
              int p2, const void* coeffs, void* out, int p_out, long long S,
              int nblocks, cudaStream_t st) {
  if (p_out <= 4)
    return block_mix_t<T, 4>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out, S,
                             nblocks, st);
  if (p_out <= 8)
    return block_mix_t<T, 8>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out, S,
                             nblocks, st);
  if (p_out <= 16)
    return block_mix_t<T, 16>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out, S,
                              nblocks, st);
  if (p_out <= 32)
    return block_mix_t<T, 32>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out, S,
                              nblocks, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int block_grams(const void* x0, int p0, const void* x1, int p1,
                const void* x2, int p2, const void* x3, int p3, const void* z,
                int p, long long S, void* partial, int nblocks, void* out,
                cudaStream_t st) {
  Rows<T> rows{{static_cast<const T*>(x0), static_cast<const T*>(x1),
                static_cast<const T*>(x2), static_cast<const T*>(x3)},
               {p0, p1, p2, p3},
               p0 + p1 + p2 + p3};
  const dim3 grid(nblocks, (rows.total + kGramRows - 1) / kGramRows,
                  (p + kGramCols - 1) / kGramCols);
  block_grams_kernel<T><<<grid, kThreads, 0, st>>>(
      rows, static_cast<const T*>(z), p, S, static_cast<T*>(partial));
  const int err = finish();
  if (err) return err;
  return sum_partials<T>(static_cast<const T*>(partial), nblocks,
                         rows.total * p, static_cast<T*>(out), st);
}

int block_grams_compensated(const void* x0, int p0, const void* x1, int p1,
                            const void* x2, int p2, const void* x3, int p3,
                            const void* z, int p, long long S, void* partial,
                            int nblocks, void* out, cudaStream_t st) {
  Rows<float> rows{{static_cast<const float*>(x0),
                    static_cast<const float*>(x1),
                    static_cast<const float*>(x2),
                    static_cast<const float*>(x3)},
                   {p0, p1, p2, p3},
                   p0 + p1 + p2 + p3};
  const dim3 grid(nblocks, (rows.total + kCompRows - 1) / kCompRows,
                  (p + kCompCols - 1) / kCompCols);
  block_grams_compensated_kernel<<<grid, kThreads, 0, st>>>(
      rows, static_cast<const float*>(z), p, S, static_cast<double*>(partial));
  const int err = finish();
  if (err) return err;
  return sum_partials<double, float>(static_cast<const double*>(partial),
                                     nblocks, rows.total * p,
                                     static_cast<float*>(out), st);
}

template <typename T>
int stencil_pair_gram(const void* q, void* dst, const void* wz,
                      const void* wp, const int* taps, int p, int zc,
                      int plane, int nt, void* partial, int nblocks,
                      void* g3, cudaStream_t st) {
  const Geometry g{zc, plane, nt, 6LL * zc * plane};
  const StencilTaps tp = unpack_taps(taps);
  const T* qt = static_cast<const T*>(q);
  T* dt = static_cast<T*>(dst);
  const T* wzt = static_cast<const T*>(wz);
  const T* wpt = static_cast<const T*>(wp);
  T* part = static_cast<T*>(partial);
  if (p <= 4) {
    stencil_gram_kernel<T, 4><<<nblocks, kThreads, 0, st>>>(
        qt, dt, wzt, wpt, tp, g, p, part);
  } else if (p <= 8) {
    stencil_gram_kernel<T, 8><<<nblocks, kThreads, 0, st>>>(
        qt, dt, wzt, wpt, tp, g, p, part);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int err = finish();
  if (err) return err;
  return sum_partials<T>(part, nblocks, 3 * p * p, static_cast<T*>(g3), st);
}

}  // namespace

extern "C" {

int lt_stencil_pair(int dtype, const void* u, void* out, const void* wz,
                    const void* wp, const int* taps, int p, int zc, int plane,
                    int nt, int nblocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? stencil_pair<float>(u, out, wz, wp, taps, p, zc, plane,
                                          nt, nblocks, st)
                    : stencil_pair<double>(u, out, wz, wp, taps, p, zc, plane,
                                           nt, nblocks, st);
}

int lt_block_mix(int dtype, const void* x0, int p0, const void* x1, int p1,
                 const void* x2, int p2, const void* coeffs, void* out,
                 int p_out, long long S, int nblocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? block_mix<float>(x0, p0, x1, p1, x2, p2, coeffs, out,
                                       p_out, S, nblocks, st)
                    : block_mix<double>(x0, p0, x1, p1, x2, p2, coeffs, out,
                                        p_out, S, nblocks, st);
}

int lt_block_grams(int dtype, const void* x0, int p0, const void* x1, int p1,
                   const void* x2, int p2, const void* x3, int p3,
                   const void* z, int p, long long S, void* partial,
                   int nblocks, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? block_grams<float>(x0, p0, x1, p1, x2, p2, x3, p3, z, p, S,
                                  partial, nblocks, out, st)
             : block_grams<double>(x0, p0, x1, p1, x2, p2, x3, p3, z, p, S,
                                   partial, nblocks, out, st);
}

int lt_stencil_pair_gram(int dtype, const void* q, void* dst, const void* wz,
                         const void* wp, const int* taps, int p, int zc,
                         int plane, int nt, void* partial, int nblocks,
                         void* g3, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? stencil_pair_gram<float>(q, dst, wz, wp, taps, p, zc, plane,
                                        nt, partial, nblocks, g3, st)
             : stencil_pair_gram<double>(q, dst, wz, wp, taps, p, zc, plane,
                                         nt, partial, nblocks, g3, st);
}

int lt_fdtd_step(int dtype, const void* u, void* out, const void* wz,
                 const void* wp, const int* taps, int p, int zc, int plane,
                 int nt, int nblocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fdtd_step<float>(u, out, wz, wp, taps, p, zc, plane,
                                       nt, nblocks, st)
                    : fdtd_step<double>(u, out, wz, wp, taps, p, zc, plane,
                                        nt, nblocks, st);
}

int lt_block_grams_compensated(const void* x0, int p0, const void* x1, int p1,
                               const void* x2, int p2, const void* x3, int p3,
                               const void* z, int p, long long S,
                               void* partial, int nblocks, void* out,
                               void* stream) {
  return block_grams_compensated(x0, p0, x1, p1, x2, p2, x3, p3, z, p, S,
                                 partial, nblocks, out,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
