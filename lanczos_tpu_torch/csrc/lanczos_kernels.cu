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
// K1-K7 stream the block state, (p, 6, Zc, P) per block (K6 any number of
// (Zc, P) fields), and do a handful of flops per element, so device memory
// bounds them all; so it does K8, the windowed-ELL SpMM of assembled
// matrices (see its section).  At
// the main path's shape (Maxwell N=160, p=4: Zc=176, P=26624) one block
// state is 449.8 MB; the bytes each moves per call are noted at each
// kernel.  K1, K2 and K4-K6 are plain first versions: one element (or one
// position across the block) per thread in a grid-stride loop,
// neighbouring threads on neighbouring addresses, no shared-memory
// staging, no TMA or wgmma.  K3 (with K7, which shares its kernel) and K8
// were redesigned for the card: exact-size register tiles, 16-byte loads
// and a one-launch Gram; K8 16-byte plane loads, four rows a lane, with
// the next planes' loads in flight before this plane's gathers (see their
// sections).
//
// Cross-block sums (K3, K4, K7) are deterministic: each block writes its
// partial sums into scratch, then they are added in block order (K4: by
// sum_partials_kernel; K3 and K7: by the grid's last block).  No float
// atomics, so the Lanczos coefficients repeat run to run.

#include <cuda_runtime.h>

#include <cstdint>

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
// K3: gram(cat(x0..x3), z)[k, j] = <row_k, z_j>, f32 sums for f32 and f64
// for f64; K7 runs the same kernel with f64 sums of f32 operands.
// Replaces block_grams (lanczos_tpu/ops/pallas/block_dense.py:210); with
// include_zz the wrapper passes z itself as x3.
// Bound: device memory.  Each operand row is read once; the main path's
// (q,), v, include_zz call reads 2 * 112.5 MB at N=160 p=1 and
// 2 * 449.8 MB at p=4, for 2 K p flops per element of z, far below the
// card's rate.  What the design does about it:
// * exact-size register tiles: the wrapper picks R x C from (K, p)
//   (block_dense.gram_tile): 1 x 1 and 2 x 1 at p=1, 4 x 4 and 8 x 4 at
//   p=4 (K = p and 2p, the fused recurrence's calls), and a 12 x 4 tile
//   for every other shape.  The main path's calls carry no dead
//   accumulator; on them each exact tile beats 12 x 4 (PERF.md: 3.05x,
//   2.23x, 1.29x, 1.05x at N=160).  The 12 x 4 tile points its
//   rows and columns past K and p at the last real one, once before the
//   loop, and drops their sums, so no loop trip tests a pointer; larger
//   (K, p) take more tiles on blockIdx.y/z, each re-reading its rows.
// * 16-byte loads: VEC elements a load per operand row (float4 /
//   double2), two vectors a trip at the small tiles, so one thread keeps
//   (R + C) * 32 bytes in flight at p=1.  The wrapper takes the scalar
//   instantiation (VEC = 1) when a row does not start on a 16-byte
//   boundary (block_dense.gram_vector_width).
// * whole waves: at most kGramBlocksPerSM blocks per SM in the grid
//   (the wrapper reads it, build.gram_grid_cap), and __launch_bounds__ that keep a tile's
//   registers low enough for 4, 2 or 1 of its blocks to share an SM.
// * one launch: each block writes its partial sums; the last block to
//   finish (an atomic ticket after __threadfence) adds every block's
//   partials in block order, one warp per output with a fixed shuffle
//   tree, and re-arms the ticket to 0.  The grid is a function of S, so
//   the order of every sum, and the result's bits, repeat run to run.  The
//   ticket is one word per stream that the wrapper zeroes once, when it
//   first launches on that stream.
constexpr int kGramBlocksPerSM = 4;

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

// VEC consecutive elements at p: one 16-byte load when VEC > 1 (p then
// 16-byte aligned), else one scalar load.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         T (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = __ldg(p);
  } else if constexpr (VEC == 4) {
    static_assert(sizeof(T) == 4, "four-wide loads are float4");
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    static_assert(VEC == 2 && sizeof(T) == 8, "two-wide loads are double2");
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = d.x;
    v[1] = d.y;
  }
}

// Register budget of an R x C tile summed in Acc: its accumulators take
// R * C * sizeof(Acc) / 4 registers.  Up to 8 leave room for 4 blocks of
// 256 threads on an SM (64 registers a thread) and two vectors a trip; up
// to 32, 2 blocks (128 registers); more, 1 block.  Each is a divisor of
// kGramBlocksPerSM, so the grid runs in whole waves.
template <typename Acc, int R, int C>
struct GramTraits {
  static constexpr int kAccRegs = R * C * (int)sizeof(Acc) / 4;
  static constexpr int kMinBlocks = kAccRegs <= 8    ? kGramBlocksPerSM
                                    : kAccRegs <= 32 ? kGramBlocksPerSM / 2
                                                     : 1;
  static constexpr int kVecsPerTrip = kMinBlocks == kGramBlocksPerSM ? 2 : 1;
};

// acc[k * C + j] += <x_k, z_j> over NV vectors, `stride` vectors apart,
// from vector v on: every load is issued before the first product.
template <typename T, typename Acc, int R, int C, int VEC, int NV>
__device__ __forceinline__ void gram_trip(const T* (&xr)[R],
                                          const T* (&zr)[C],
                                          long long v, long long stride,
                                          Acc (&acc)[R * C]) {
  T xv[NV][R][VEC], zv[NV][C][VEC];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const long long e = (v + u * stride) * VEC;
#pragma unroll
    for (int j = 0; j < C; ++j) load_vec<T, VEC>(zr[j] + e, zv[u][j]);
#pragma unroll
    for (int k = 0; k < R; ++k) load_vec<T, VEC>(xr[k] + e, xv[u][k]);
  }
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[k * C + j] += Acc(xv[u][k][i]) * Acc(zv[u][j][i]);
}

// The (K, p) Gram of operands of type T with sums in Acc, rounded to TOut
// once.  partial holds gridDim.x * K * p Acc; ticket is 0 at launch and
// is 0 again when the kernel ends.
template <typename T, typename Acc, typename TOut, int R, int C, int VEC>
__global__ void __launch_bounds__(kThreads,
                                  GramTraits<Acc, R, C>::kMinBlocks)
    gram_kernel(Rows<T> rows, const T* __restrict__ z, int p, long long S,
                Acc* __restrict__ partial, unsigned* __restrict__ ticket,
                TOut* __restrict__ out) {
  constexpr int U = GramTraits<Acc, R, C>::kVecsPerTrip;
  __shared__ Acc red[R * C * kWarps];
  __shared__ bool last;
  const int K = rows.total;
  const int k0 = blockIdx.y * R, j0 = blockIdx.z * C;
  const T* xr[R];
  const T* zr[C];
#pragma unroll
  for (int k = 0; k < R; ++k) xr[k] = row_ptr(rows, min(k0 + k, K - 1), S);
#pragma unroll
  for (int j = 0; j < C; ++j) zr[j] = z + (long long)min(j0 + j, p - 1) * S;
  Acc acc[R * C];
#pragma unroll
  for (int i = 0; i < R * C; ++i) acc[i] = Acc(0);
  const long long nvec = S / VEC;  // S % VEC == 0: the wrapper's choice
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; v + (U - 1) * stride < nvec; v += U * stride)
    gram_trip<T, Acc, R, C, VEC, U>(xr, zr, v, stride, acc);
  if (v < nvec) gram_trip<T, Acc, R, C, VEC, 1>(xr, zr, v, stride, acc);

  block_sum<Acc, R * C>(acc, red);
  const int nout = K * p;
  Acc* part = partial + (long long)blockIdx.x * nout;
  for (int i = threadIdx.x; i < R * C; i += blockDim.x) {
    const int k = k0 + i / C, j = j0 + i % C;
    if (k < K && j < p) part[k * p + j] = red[i * kWarps];
  }
  // the last block to finish adds every block's partials, in block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y * gridDim.z - 1;
  __syncthreads();
  if (!last) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = warp; o < nout; o += kWarps) {
    Acc s = Acc(0);
    for (int b = lane; b < (int)gridDim.x; b += 32)
      s += __ldcg(partial + (long long)b * nout + o);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d);
    if (lane == 0) out[o] = TOut(s);
  }
  if (threadIdx.x == 0) *ticket = 0u;
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
// K7: gram(cat(x0..x3), z) of float32 operands with float64 sums.
// Replaces block_grams_compensated (lanczos_tpu/ops/pallas/block_dense.py:361).
// The TPU has no f64, so the JAX kernel carries Dekker TwoProd/TwoSum
// two-float sums.  Here a float32 x float32 product is exact in float64,
// and every sum (per thread, the block tree, the last block's sum in block
// order) runs in float64; the (K, p) total is rounded to float32 once:
// O(eps_f32) error instead of O(eps_f32 sqrt(n)).
// Bound: device memory, as K3: one read of each operand, 2 * 449.8 MB for
// (q,), v, include_zz at N=160 p=4.  It is K3's gram_kernel with Acc =
// double: the same tiles and float4 loads; the f64 sums double each
// tile's accumulator registers, so its 8 x 4 tile runs one block per SM
// (GramTraits) where K3's runs two.

// ---------------------------------------------------------------------------
// K8: the windowed-ELL SpMM, Y = A X on planes of an assembled matrix.
// Replaces _windowed_spmm (lanczos_tpu/ops/pallas/window_ell.py:691,
// kernel :624).  Row r of chunk c = r / 128 (lane l = r % 128) sums, over
// the chunk's ppc planes k, data[c*ppc+k][l] * X[:, col] with col =
// wb[c / cpg] + off[c*ppc+k] * 128 + lidx[c*ppc+k][l].  The Pallas kernel
// DMAs each group's band of x into VMEM and rebuilds the gather from two
// 128-lane register selects: the TPU cannot gather.
// Bound: device memory.  At the assembled slice's shape (10.5M rows, ppc
// 15): planes 631 MB + indices 158 MB + offsets 5 MB, plus one read of X
// and one write of Y, 42 MB each a column: 878 MB a call at p=1, 1.47 GB
// at p=8.  A warp owns one 128-row chunk and a lane four of its rows: it
// reads the plane's values as a float4 (or two double2) and its four uint8
// indices as one 4-byte word, with streaming loads; the plane's offset is a
// warp-uniform load.  The gathers of x go through the read-only path and
// mostly hit L1 and L2: a plane's 128 rows gather inside one 256-wide
// window, 1 KB of x a column.  The next stage's value, index and offset
// loads are issued before the current stage's gathers, so the load ->
// gather chain does not set the pace.  One launch covers up to kSpmmCols
// columns.  No bounds logic: the plan guarantees off * 128 + lidx < wsz and
// wb + wsz <= n128 (WindowedEllMatrix checks it once per plan); empty slots
// are value 0 at index 0.  f32 sums in f32 (as the Pallas
// kernel), f64 in f64.
// Staging a group's band of x in shared memory, as the Pallas kernel does
// in VMEM, fits one column in f32 on the slice (43,008 elements), but was
// measured slower at p=1 than these L1/L2 gathers, whose windows L1 already
// serves (PERF.md, NVIDIA H100 80GB HBM3, 700 W: 0.319 against 0.303 ms),
// so K8 has this one kernel.  p=1 0.303 ms against a 0.262 ms bound; p=8
// 0.784 ms against 0.438.
constexpr int kSpmmCols = 8;  // columns per launch; wider states loop

// Four consecutive T at p (16-byte aligned), one float4 or two double2,
// as streaming loads: the planes are read once, so their lines are the
// first evicted, and x's stay in L1 and L2.
template <typename T>
__device__ __forceinline__ void load4_stream(const T* __restrict__ p,
                                             T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
    const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// Four consecutive T to p: 16-byte stores where p is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void store4(T* __restrict__ p, const T (&v)[4],
                                       bool aligned) {
  if (!aligned) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = v[i];
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
}

// One plane as a lane sees it: its four rows' values and uint8 indices,
// and the plane's offset in 128-blocks from the group's window base.
template <typename T>
struct PlaneSlot {
  T v[4];
  unsigned li;
  int off;
};

// Planes k0 .. k0 + U - 1 (those below ppc) of the chunk whose planes
// start at plane0.
template <typename T, int U>
__device__ __forceinline__ void load_planes(
    const T* __restrict__ data, const unsigned* __restrict__ lidx,
    const int* __restrict__ off, long long plane0, int k0, int ppc, int lane,
    PlaneSlot<T> (&st)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (k0 + u < ppc) {
      const long long j = plane0 + k0 + u;
      load4_stream(data + j * 128 + 4 * lane, st[u].v);
      st[u].li = __ldcs(lidx + j * 32 + lane);
      st[u].off = __ldg(off + j);
    }
  }
}

template <typename T, int MAXP>
__global__ void __launch_bounds__(kThreads)
    windowed_spmm_kernel(const T* __restrict__ data,
                         const unsigned* __restrict__ lidx,
                         const int* __restrict__ off,
                         const int* __restrict__ wb, const T* __restrict__ x,
                         T* __restrict__ y, int p, int ppc, int cpg,
                         long long n128) {
  // planes a stage; the next stage's loads go out before this stage's
  // gathers
  constexpr int U = MAXP == 1 ? 4 : 2;
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c * 128 >= n128) return;
  const long long base = wb[c / cpg];
  T acc[MAXP][4];
#pragma unroll
  for (int b = 0; b < MAXP; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = T(0);
  PlaneSlot<T> cur[U], nxt[U];
  load_planes<T, U>(data, lidx, off, c * ppc, 0, ppc, lane, cur);
  for (int k0 = 0; k0 < ppc; k0 += U) {
    if (k0 + U < ppc)
      load_planes<T, U>(data, lidx, off, c * ppc, k0 + U, ppc, lane, nxt);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (k0 + u < ppc) {
        const long long col = base + (long long)cur[u].off * 128;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long ce = col + ((cur[u].li >> (8 * e)) & 255);
#pragma unroll
          for (int b = 0; b < MAXP; ++b)
            if (b < p) acc[b][e] += cur[u].v[e] * __ldg(x + b * n128 + ce);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
  }
  const bool aligned = (reinterpret_cast<uintptr_t>(y) & 15) == 0;
#pragma unroll
  for (int b = 0; b < MAXP; ++b)
    if (b < p) store4(y + b * n128 + c * 128 + 4 * lane, acc[b], aligned);
}

// ---------------------------------------------------------------------------
// K6: the generic separable stencil, out = S u over p block columns, with
// u (p, n_in, Zc, P) and out (p, n_out, Zc, P) and unpaired taps:
//   out[oc, z, l] = sum over oc's taps t, in spec order, of
//                   (u[ic_t, z + dz_t, (l - r_t) mod P] * wp[t, l]) * wz[t, z]
// Replaces apply_stencil (lanczos_tpu/ops/pallas/stencil_kernel.py:276).
// u and out are component slices of larger states: fields contiguous,
// block columns in_stride / out_stride elements apart, so an unpaired curl
// pair reads u[:, 3:6] and writes out[:, 0:3] of one (p, 6, Zc, P) state
// with no copy.  wz is read through (tap, z) strides, so the pair's
// transposed wz_t[h] needs no copy either.
// Bound: device memory.  One read of the n_in input and one write of the
// n_out output fields per column: a Maxwell half-call at N=160 p=4 moves
// 3 + 3 fields of 18.7 MB per column, 449.8 MB.  The Pallas kernel double-
// buffers (n_in, tz, P) blocks through VMEM; here, as in K1, one thread
// owns one (z, l) position for every component and column, its neighbour
// reads (+-1 z-row, lane rolls) come from L1/L2, and each tap's two weights
// are loaded once for up to COLS columns, whose input loads go out
// together.  The tap table (2.6 KB, under the 4 KB parameter limit) is
// copied into shared memory by the whole block.  Unlike K1's taps, which
// come in pairs that share a weight row, each tap costs three multiplies.
constexpr int kGenComps = 6;  // components in and out
constexpr int kGenTaps = 27;  // taps per output component: a 3x3x3 stencil

// Host int layout (see stencil_kernel.py generic_tap_table): n_out, then
// per output component n, t[27], ic[27], dz[27], r[27].
struct GenericTaps {
  int n_out;
  int n[kGenComps];
  int t[kGenComps][kGenTaps];   // row in the weight arrays
  int ic[kGenComps][kGenTaps];  // input component, local to u
  int dz[kGenComps][kGenTaps];  // z-row offset in {-1, 0, 1}
  int r[kGenComps][kGenTaps];   // lane roll in [0, P)
};

struct GenericArgs {
  int zc, plane, p;
  long long in_stride, out_stride;  // elements between block columns
  long long wz_tap, wz_z;           // wz[t, z] at t * wz_tap + z * wz_z
};

GenericTaps unpack_generic_taps(const int* h) {
  GenericTaps s;
  s.n_out = h[0];
  const int* c = h + 1;
  for (int i = 0; i < kGenComps; ++i) {
    s.n[i] = c[0];
    for (int k = 0; k < kGenTaps; ++k) {
      s.t[i][k] = c[1 + k];
      s.ic[i][k] = c[1 + kGenTaps + k];
      s.dz[i][k] = c[1 + 2 * kGenTaps + k];
      s.r[i][k] = c[1 + 3 * kGenTaps + k];
    }
    c += 1 + 4 * kGenTaps;
  }
  return s;
}

template <typename T, int COLS>
__global__ void __launch_bounds__(kThreads)
    apply_stencil_kernel(const T* __restrict__ u, T* __restrict__ out,
                         const T* __restrict__ wz, const T* __restrict__ wp,
                         GenericTaps taps, GenericArgs a) {
  __shared__ GenericTaps s;
  {
    const int* src = reinterpret_cast<const int*>(&taps);
    int* dst = reinterpret_cast<int*>(&s);
    for (int i = threadIdx.x; i < (int)(sizeof(GenericTaps) / sizeof(int));
         i += blockDim.x)
      dst[i] = src[i];
  }
  __syncthreads();
  const Geometry g{a.zc, a.plane, 0, 0};
  const int comp = a.zc * a.plane;  // n * comp < 2^30, checked by the wrapper
  for (int pos = blockIdx.x * blockDim.x + threadIdx.x; pos < comp;
       pos += gridDim.x * blockDim.x) {
    const int l = pos % a.plane;
    const int z = pos / a.plane;
    for (int b0 = 0; b0 < a.p; b0 += COLS) {
      const T* ub = u + b0 * a.in_stride;
      T* ob = out + b0 * a.out_stride;
#pragma unroll 1
      for (int oc = 0; oc < s.n_out; ++oc) {
        T acc[COLS];
#pragma unroll
        for (int b = 0; b < COLS; ++b) acc[b] = T(0);
#pragma unroll 1
        for (int k = 0; k < s.n[oc]; ++k) {
          const int t = s.t[oc][k];
          const int o = tap_offset(s.ic[oc][k], z, s.dz[oc][k], l,
                                   s.r[oc][k], g);
          const T w_p = wp[(long long)t * a.plane + l];
          const T w_z = wz[t * a.wz_tap + z * a.wz_z];
          T v[COLS];
#pragma unroll
          for (int b = 0; b < COLS; ++b)
            v[b] = (b0 + b < a.p && o >= 0) ? ub[b * a.in_stride + o] : T(0);
#pragma unroll
          for (int b = 0; b < COLS; ++b) acc[b] += (v[b] * w_p) * w_z;
        }
#pragma unroll
        for (int b = 0; b < COLS; ++b)
          if (b0 + b < a.p) ob[b * a.out_stride + oc * comp + pos] = acc[b];
      }
    }
  }
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

// The (R, C) tiles and vector widths the wrapper may pick
// (block_dense.gram_tile); another combination is refused.
template <typename T, typename Acc, typename TOut>
struct GramLaunch {
  Rows<T> rows;
  const T* z;
  int p;
  long long S;
  Acc* partial;
  unsigned* ticket;
  TOut* out;
  dim3 grid;
  cudaStream_t st;

  template <int R, int C>
  int run(int vec) const {
    constexpr int kVec = 16 / (int)sizeof(T);
    if (vec == kVec)
      gram_kernel<T, Acc, TOut, R, C, kVec><<<grid, kThreads, 0, st>>>(
          rows, z, p, S, partial, ticket, out);
    else
      gram_kernel<T, Acc, TOut, R, C, 1><<<grid, kThreads, 0, st>>>(
          rows, z, p, S, partial, ticket, out);
    return finish();
  }
};

template <typename T, typename Acc, typename TOut>
int gram(const void* x0, int p0, const void* x1, int p1, const void* x2,
         int p2, const void* x3, int p3, const void* z, int p, long long S,
         int tile_r, int tile_c, int vec, void* partial, int nblocks,
         void* ticket, void* out, cudaStream_t st) {
  const Rows<T> rows{{static_cast<const T*>(x0), static_cast<const T*>(x1),
                      static_cast<const T*>(x2), static_cast<const T*>(x3)},
                     {p0, p1, p2, p3},
                     p0 + p1 + p2 + p3};
  if ((vec != 1 && vec != 16 / (int)sizeof(T)) || S % vec)
    return (int)cudaErrorInvalidValue;
  const GramLaunch<T, Acc, TOut> g{
      rows, static_cast<const T*>(z), p, S, static_cast<Acc*>(partial),
      static_cast<unsigned*>(ticket), static_cast<TOut*>(out),
      dim3(nblocks, (rows.total + tile_r - 1) / tile_r,
           (p + tile_c - 1) / tile_c),
      st};
  if (tile_c == 1 && tile_r == 1) return g.template run<1, 1>(vec);
  if (tile_c == 1 && tile_r == 2) return g.template run<2, 1>(vec);
  if (tile_c == 4 && tile_r == 4) return g.template run<4, 4>(vec);
  if (tile_c == 4 && tile_r == 8) return g.template run<8, 4>(vec);
  if (tile_c == 4 && tile_r == 12) return g.template run<12, 4>(vec);
  return (int)cudaErrorInvalidValue;
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

template <typename T>
int windowed_spmm(const void* data, const void* lidx, const void* off,
                  const void* wb, const void* x, void* y, int p, int ppc,
                  int cpg, long long n128, cudaStream_t st) {
  const T* dt = static_cast<const T*>(data);
  const unsigned* li = static_cast<const unsigned*>(lidx);
  const int* of = static_cast<const int*>(off);
  const int* w = static_cast<const int*>(wb);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const unsigned nblocks = (unsigned)((n128 / 128 + kWarps - 1) / kWarps);
  for (int b0 = 0; b0 < p; b0 += kSpmmCols) {
    const int pk = p - b0 < kSpmmCols ? p - b0 : kSpmmCols;
    auto kernel = pk == 1   ? windowed_spmm_kernel<T, 1>
                  : pk <= 4 ? windowed_spmm_kernel<T, 4>
                            : windowed_spmm_kernel<T, kSpmmCols>;
    kernel<<<nblocks, kThreads, 0, st>>>(dt, li, of, w, xt + b0 * n128,
                                         yt + b0 * n128, pk, ppc, cpg, n128);
    const int err = finish();
    if (err) return err;
  }
  return 0;
}

template <typename T>
int apply_stencil(const void* u, void* out, const void* wz, const void* wp,
                  const int* taps, int p, int zc, int plane,
                  long long in_stride, long long out_stride, long long wz_tap,
                  long long wz_z, int nblocks, cudaStream_t st) {
  const GenericArgs a{zc, plane, p, in_stride, out_stride, wz_tap, wz_z};
  auto kernel =
      p == 1 ? apply_stencil_kernel<T, 1> : apply_stencil_kernel<T, 4>;
  kernel<<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(u), static_cast<T*>(out),
      static_cast<const T*>(wz), static_cast<const T*>(wp),
      unpack_generic_taps(taps), a);
  return finish();
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
                   const void* z, int p, long long S, int tile_r, int tile_c,
                   int vec, void* partial, int nblocks, void* ticket,
                   void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? gram<float, float, float>(x0, p0, x1, p1, x2, p2, x3, p3, z,
                                         p, S, tile_r, tile_c, vec, partial,
                                         nblocks, ticket, out, st)
             : gram<double, double, double>(x0, p0, x1, p1, x2, p2, x3, p3,
                                            z, p, S, tile_r, tile_c, vec,
                                            partial, nblocks, ticket, out,
                                            st);
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
                               const void* z, int p, long long S, int tile_r,
                               int tile_c, int vec, void* partial,
                               int nblocks, void* ticket, void* out,
                               void* stream) {
  return gram<float, double, float>(x0, p0, x1, p1, x2, p2, x3, p3, z, p, S,
                                    tile_r, tile_c, vec, partial, nblocks,
                                    ticket, out,
                                    static_cast<cudaStream_t>(stream));
}

int lt_windowed_spmm(int dtype, const void* data, const void* lidx,
                     const void* off, const void* wb, const void* x, void* y,
                     int p, int ppc, int cpg, long long n128, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? windowed_spmm<float>(data, lidx, off, wb, x, y, p, ppc,
                                           cpg, n128, st)
                    : windowed_spmm<double>(data, lidx, off, wb, x, y, p,
                                            ppc, cpg, n128, st);
}

// Blocks of the Gram kernel an SM holds, the grid's cap per SM
// (build.gram_grid_cap).
int lt_gram_blocks_per_sm() { return kGramBlocksPerSM; }

int lt_apply_stencil(int dtype, const void* u, void* out, const void* wz,
                     const void* wp, const int* taps, int p, int zc,
                     int plane, long long in_stride, long long out_stride,
                     long long wz_tap, long long wz_z, int nblocks,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? apply_stencil<float>(u, out, wz, wp, taps, p, zc, plane,
                                    in_stride, out_stride, wz_tap, wz_z,
                                    nblocks, st)
             : apply_stencil<double>(u, out, wz, wp, taps, p, zc, plane,
                                     in_stride, out_stride, wz_tap, wz_z,
                                     nblocks, st);
}

}  // extern "C"
