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
// matrices (see its section).  At the main path's shape (Maxwell N=160,
// p=4: Zc=176, P=26624) one block state is 449.8 MB; the bytes each moves
// per call are noted at each kernel.  K2, K4 and K6 are plain first
// versions: one element (or one position across the block) per thread in
// a grid-stride loop, neighbouring threads on neighbouring addresses, no
// shared-memory staging, no TMA or wgmma.  The others were redesigned for
// the card: K1 and K5 stage strips of rows in shared memory with cp.async
// and keep their plane weights in registers along z; K3 (with K7, which
// shares its kernel) takes exact-size register tiles, 16-byte loads and a
// one-launch Gram; K8 16-byte plane loads, four rows a lane, with the next
// planes' loads in flight before this plane's gathers (see their
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

// Taps of the six output components.  A paired half's come in (z-pair |
// plane-pair) twos (StencilSpec.paired); K4 takes paired halves only.
struct StencilTaps {
  CompTaps comp[6];
  int paired[2];  // per half
};

struct Geometry {
  int zc;           // z capacity
  int plane;        // folded-plane capacity P
  int nt;           // taps per half (weight columns)
  long long state;  // 6 * zc * plane: elements of one block column
};

// Host int layout (see stencil_kernel.py tap_table): per output
// component, n, t[4], ic[4], dz[4], r[4]; then paired[2].
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
  s.paired[0] = c[0];
  s.paired[1] = c[1];
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
// K1 and K5: the curl pair on strips of lanes staged in shared memory.
// K1, stencil_pair_kernel: out = A u over p block columns.  Replaces
// apply_stencil_pair (lanczos_tpu/ops/pallas/stencil_kernel.py:70), vmapped
// over p by PallasMaxwellOperator.mm.
// K5, fdtd_step_kernel: out = u + (dt A) u, one forward-Euler step.
// Replaces fdtd_step_inplace (lanczos_tpu/ops/pallas/stencil_fdtd.py:50).
// Bound: device memory.  One read and one write of the state, 2 * 112.5 MB
// at N=160 p=1 and 2 * 449.8 MB at p=4 (0.0671 and 0.2686 ms at 3.35
// TB/s); the ~12 flops an output element are far below the card's rate.
// The first versions (one thread a position, every tap read through L1/L2,
// plane weights re-read for every z-row) ran at 23-25% of that bound at p=1
// and 45-51% at p=4.  What this design does about it:
// * a block of 256 threads owns a strip of W = 512 lanes (two a thread,
//   256 apart; f64: 256 lanes, one a thread) of all six components over a
//   range of z-rows, and marches along z.  It reads its strip's plane
//   weights once, into registers, and keeps them for every row and block
//   column of its range; a row's z-weights are fetched once into shared
//   memory and read as 16-byte words;
// * input rows are staged once, in shared memory: a ring of kStencilSlots
//   rows (z-1, z, z+1, two ahead and one behind) of the six components
//   over the strip and its halo, filled with 16-byte cp.async whose
//   sources each thread works out once.  Every tap, and K5's identity
//   term, reads shared memory, so device memory sees each input element
//   once, plus the halo's share (22% more reads at N=160, mostly from L2).
//   The halo comes from the tap table's rolls, per input component and
//   side (+-1 lane for the x-pairs, xc lanes on one side for the y-pairs),
//   rounded to 16 bytes; its lanes wrap mod P.  Rows outside [0, Zc) are
//   staged as zeros, so no tap ever reads a slot that was not written
//   (NaN * 0 is NaN).  One barrier a row;
// * the grid is strips x z-chunks, which the wrapper sizes to whole waves
//   (stencil_kernel.stencil_plan: at N=160 f32, 52 x 5 blocks of 36 rows,
//   two an SM); a block loops over the block columns and keeps its
//   weights.  A warp stores 32 consecutive lanes: 128 contiguous bytes in
//   f32.  A pair's form (z-pair or plane-pair) is a uniform branch.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md): K1
// 0.116 ms at p=1 and 0.431 at p=4, K5 0.118 and 0.437, 57-62% of the
// bound, against 0.263/0.529 (K1) and 0.292/0.593 (K5) for the first
// versions.  256-lane
// strips (four blocks an SM, more halo) run slower (probes
// --stencil-tiles).  What is left is inside the SM: the
// kernel without its taps and without its staging each take most of its
// time, and the two overlap only in part at two blocks an SM (probes
// --stencil-parts; PERF.md).
// A paired half sums (v0 w0 + v1 w1) ws per tap pair, the Pallas kernel's
// factored form; an unpaired half (v wp) wz per tap, in spec order (K5
// only: K1's wrapper sends unpaired specs to K6).  K5 adds u to the tap sum
// (the plain version's order; the Pallas kernel starts its sum at u, which
// differs in rounding only).  The Pallas K5 updates u in place, which the
// TPU's in-order grid and a VMEM delay ring make safe; CUDA blocks run in
// no order and would overwrite rows a neighbour still stages, so out is a
// second buffer (the caller swaps the two), never u.  No sum crosses a
// block: the result repeats bit for bit.

// staged rows: z-1, z, z+1, two ahead, and the row the slowest warp may
// still read while the others stage the next one
constexpr int kStencilSlots = 6;
constexpr int kStencilAhead = kStencilSlots - 4;
constexpr int kStageCopies = 8;  // 16-byte copies a thread stages a row
constexpr int kRowWeights = 6 * kMaxTaps;  // z-weights of one row, (c, k)

// What a launch of K1/K5 knows, built on the host from the tap table and
// the wrapper's plan.  Indexed with compile-time indices only, so it stays
// in the parameter space.
struct StripArgs {
  int zc, plane, nt, p;
  int width;            // W: lanes a block owns
  int zchunk;           // z-rows a block owns
  long long state;      // 6 * zc * plane: elements of one block column
  int row;              // elements of one staged row (six components)
  int off[6];           // component c's lanes start at off[c] of a row
  int left[6];          // staged lanes left of the strip, component c
  int n[6];             // taps of output component c
  int t[6][kMaxTaps];   // weight column of each tap
  int dz[6][kMaxTaps];  // z-row offset in {-1, 0, 1}
  // staged element that lane 0 of the strip reads for each tap:
  // off[ic] + left[ic] - s, s the roll as a signed shift in (-P/2, P/2]
  int soff[6][kMaxTaps];
  int paired[2];        // per half: the factored form
};

// Blocks of 256 threads an SM must hold, for __launch_bounds__ (mirrored
// by stencil_kernel.STENCIL_MIN_BLOCKS): four blocks leave 64 registers a
// thread, for one f32 lane a thread; two 128.
template <typename T, int LPT>
struct StripTraits {
  static constexpr int kMinBlocks = LPT == 1 && sizeof(T) == 4 ? 4 : 2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive T of shared memory (16-byte aligned) into v.
template <typename T>
__device__ __forceinline__ void lds4(const T* p, T* v) {
  if constexpr (sizeof(T) == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// out = A u, plus u itself when kAddInput, on this block's strip and
// z-range for every block column, LPT lanes a thread, 256 apart.  The
// staged rows' lane mapping is the same for every row, so it is worked out
// once: copy m of a row lands at element (threadIdx.x + 256 m) * V of the
// slot, from offset src[m] of the row's z-plane.  Thread j < kRowWeights
// fetches each row's z-weight (c, k) = (j / 4, j % 4) into wrow (two
// buffers, by the row's parity), which every thread then reads as 16-byte
// words.  One barrier a row: a thread may stage a row, or fetch the next
// row's z-weights, while a slower warp still computes the previous row,
// whose slots and z-weight buffer the new ones do not touch.
template <typename T, bool kAddInput, int LPT>
__device__ __forceinline__ void strip_stencil_body(
    const T* __restrict__ u, T* __restrict__ out, const T* __restrict__ wz,
    const T* __restrict__ wp, const StripArgs& a) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char stencil_smem[];
  T* ring = reinterpret_cast<T*>(stencil_smem);
  T* wrows = ring + kStencilSlots * a.row;  // 16-byte aligned: row % V == 0
  const int l0 = blockIdx.x * a.width;
  const int w = min(a.width, a.plane - l0);
  const int z0 = blockIdx.y * a.zchunk;
  const int z1 = min(z0 + a.zchunk, a.zc);
  const int nr = z1 - z0 + 2;  // staged rows a column: z0 - 1 .. z1
  const int items = a.p * nr;
  const int comp = a.zc * a.plane;  // < 2^30, checked by the wrapper

  // where this thread's staging copies come from, within a z-plane
  int src[kStageCopies];
#pragma unroll
  for (int m = 0; m < kStageCopies; ++m) {
    const int e = (threadIdx.x + m * kThreads) * V;
    int c = 0, off = a.off[0], left = a.left[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      if (e >= a.off[k]) {
        c = k;
        off = a.off[k];
        left = a.left[k];
      }
    }
    int g = (l0 - left + e - off) % a.plane;
    if (g < 0) g += a.plane;
    src[m] = e < a.row ? c * comp + g : -1;
  }
  // the z-weight this thread fetches for each row
  int wcol = -1, wh = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k)
      if (threadIdx.x == c * kMaxTaps + k && k < a.n[c]) {
        wcol = a.t[c][k];
        wh = c / 3;
      }
  // the strip's plane weights, kept for every row and column
  T wpr[6][kMaxTaps][LPT];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const T* wph = wp + (long long)(c / 3) * a.nt * a.plane + l0;
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int i = threadIdx.x + j * kThreads;
        wpr[c][k][j] = k < a.n[c] && i < w
                           ? __ldg(wph + (long long)a.t[c][k] * a.plane + i)
                           : T(0);
      }
    }
  }

  // item s of the staging sequence is row z0 - 1 + s % nr of column s / nr,
  // in slot s % kStencilSlots
  int issued = 0;
  for (int b = 0; b < a.p; ++b) {
    for (int z = z0; z < z1; ++z) {
      const int sc = b * nr + (z - z0 + 1);  // this row's item
      T* wrow = wrows + (sc & 1) * kRowWeights;
      // items up to sc + 1 + kStencilAhead go into the slots of items
      // before sc - 2, whose last reader finished before the last barrier;
      // a new column's first row skips two items, so it waits for the
      // previous row's readers too
      if (z == z0 && b > 0) __syncthreads();
      for (; issued <= sc + 1 + kStencilAhead; ++issued) {
        if (issued < items) {
          const int bb = issued / nr;
          const int zz = z0 - 1 + issued - bb * nr;
          T* slot = ring + (issued % kStencilSlots) * a.row;
          if (zz < 0 || zz >= a.zc) {
            for (int e = threadIdx.x; e < a.row; e += kThreads) slot[e] = T(0);
          } else {
            const T* plane = u + bb * a.state + (long long)zz * a.plane;
#pragma unroll
            for (int m = 0; m < kStageCopies; ++m)
              if (src[m] >= 0)
                cp_async16(slot + (threadIdx.x + m * kThreads) * V,
                           plane + src[m]);
          }
        }
        cp_async_commit();  // one group an item, empty past the end
      }
      if (threadIdx.x < kRowWeights)
        wrow[threadIdx.x] =
            wcol >= 0 ? __ldg(wz + ((long long)wh * a.zc + z) * a.nt + wcol)
                      : T(0);
      cp_async_wait<kStencilAhead>();  // items up to sc + 1 have landed
      __syncthreads();  // ... for every thread, with zeros and z-weights
      const int rm = ((sc - 1) % kStencilSlots) * a.row;
      const int r0 = (sc % kStencilSlots) * a.row;
      const int rp = ((sc + 1) % kStencilSlots) * a.row;
      T* ob = out + b * a.state + (long long)z * a.plane + l0;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const int h = c / 3;
        T wzv[kMaxTaps];
        lds4(wrow + c * kMaxTaps, wzv);
        // each tap's staged row at this thread's first lane; lane j is
        // j * kThreads elements on
        const T* rt[kMaxTaps];
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          const int d = a.dz[c][k];
          rt[k] = ring + (d < 0 ? rm : d == 0 ? r0 : rp) + a.soff[c][k] +
                  threadIdx.x;
        }
        // every lane of the strip reads staged lanes (a plane narrower
        // than the strip is staged wrapped); only the stores stop at w
        auto tap = [&](int k, int j) { return rt[k][j * kThreads]; };
        T acc[LPT];
#pragma unroll
        for (int j = 0; j < LPT; ++j) acc[j] = T(0);
        if (a.paired[h]) {
#pragma unroll
          for (int k = 0; k + 1 < kMaxTaps; k += 2) {
            if (k + 1 >= a.n[c]) break;
            // the pair's form is uniform: a branch, not a select a lane
            if (a.dz[c][k] != a.dz[c][k + 1]) {  // z-pair: one plane weight
#pragma unroll
              for (int j = 0; j < LPT; ++j)
                acc[j] += (tap(k, j) * wzv[k] + tap(k + 1, j) * wzv[k + 1]) *
                          wpr[c][k][j];
            } else {  // plane-pair: one z-weight
#pragma unroll
              for (int j = 0; j < LPT; ++j)
                acc[j] += (tap(k, j) * wpr[c][k][j] +
                           tap(k + 1, j) * wpr[c][k + 1][j]) *
                          wzv[k];
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < kMaxTaps; ++k) {
            if (k >= a.n[c]) break;
#pragma unroll
            for (int j = 0; j < LPT; ++j)
              acc[j] += (tap(k, j) * wpr[c][k][j]) * wzv[k];
          }
        }
        const T* center = ring + r0 + a.off[c] + a.left[c] + threadIdx.x;
        T* oc = ob + (long long)c * comp + threadIdx.x;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          if (threadIdx.x + j * kThreads < w)
            oc[j * kThreads] = kAddInput ? center[j * kThreads] + acc[j] : acc[j];
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can still be open
}

template <typename T, int LPT>
__global__ void __launch_bounds__(kThreads, StripTraits<T, LPT>::kMinBlocks)
    stencil_pair_kernel(const T* __restrict__ u, T* __restrict__ out,
                        const T* __restrict__ wz, const T* __restrict__ wp,
                        const __grid_constant__ StripArgs a) {
  strip_stencil_body<T, false, LPT>(u, out, wz, wp, a);
}

template <typename T, int LPT>
__global__ void __launch_bounds__(kThreads, StripTraits<T, LPT>::kMinBlocks)
    fdtd_step_kernel(const T* __restrict__ u, T* __restrict__ out,
                     const T* __restrict__ wz, const T* __restrict__ wp,
                     const __grid_constant__ StripArgs a) {
  strip_stencil_body<T, true, LPT>(u, out, wz, wp, a);
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

// The plan of a K1/K5 launch, from the wrapper (stencil_kernel.StencilPlan):
// width, lanes a thread, z-chunk, strips, chunks, shared-memory bytes
// (kStencilSlots rows and two rows' kRowWeights z-weights), then the
// staged lanes left of the strip and right of it per input component.
//
// StripArgs of a launch; a plan or tap table the kernel cannot run
// (a halo short of a tap's roll, a grid that misses a lane or a row, a
// shared-memory size that is not the plan's) gives cudaErrorInvalidValue.
template <typename T>
int strip_args(const int* taps, const int* plan, int p, int zc, int plane,
               int nt, StripArgs& a, dim3& grid, size_t& smem, int& lpt) {
  constexpr int V = 16 / (int)sizeof(T);
  const int bad = (int)cudaErrorInvalidValue;
  const StencilTaps tp = unpack_taps(taps);
  a.zc = zc;
  a.plane = plane;
  a.nt = nt;
  a.p = p;
  a.width = plan[0];
  lpt = plan[1];
  a.zchunk = plan[2];
  grid = dim3(plan[3], plan[4]);
  a.state = 6LL * zc * plane;
  if (p < 1 || (lpt != 1 && lpt != 2) || a.width != kThreads * lpt ||
      plane % V || a.zchunk < 1 ||
      (long long)grid.x * a.width < plane ||
      (long long)(grid.x - 1) * a.width >= plane ||
      (long long)grid.y * a.zchunk < zc ||
      (long long)(grid.y - 1) * a.zchunk >= zc)
    return bad;
  int row = 0;
  int right[6];
  for (int c = 0; c < 6; ++c) {
    a.left[c] = plan[6 + c];
    right[c] = plan[12 + c];
    if (a.left[c] < 0 || right[c] < 0 || a.left[c] % V || right[c] % V)
      return bad;
    a.off[c] = row;
    row += a.width + a.left[c] + right[c];
  }
  a.row = row;
  smem = ((size_t)kStencilSlots * row + 2 * kRowWeights) * sizeof(T);
  if (row > kStageCopies * kThreads * V || smem != (size_t)plan[5]) return bad;
  for (int h = 0; h < 2; ++h) a.paired[h] = tp.paired[h];
  for (int c = 0; c < 6; ++c) {
    const CompTaps& ct = tp.comp[c];
    if (ct.n < 0 || ct.n > kMaxTaps || (a.paired[c / 3] && ct.n % 2))
      return bad;
    a.n[c] = ct.n;
    for (int k = 0; k < kMaxTaps; ++k) {
      a.t[c][k] = a.dz[c][k] = a.soff[c][k] = 0;
      if (k >= ct.n) continue;
      const int ic = ct.ic[k], r = ct.r[k];
      const int s = r <= plane / 2 ? r : r - plane;  // reads lane l - s
      if (ic < 0 || ic >= 6 || ct.t[k] < 0 || ct.t[k] >= nt || r < 0 ||
          r >= plane || ct.dz[k] < -1 || ct.dz[k] > 1 || s > a.left[ic] ||
          -s > right[ic])
        return bad;
      a.t[c][k] = ct.t[k];
      a.dz[c][k] = ct.dz[k];
      a.soff[c][k] = a.off[ic] + a.left[ic] - s;
    }
  }
  return 0;
}

// Lets `kernel` take up to the device's opt-in shared memory, and asks
// for the largest shared-memory carveout of the SM's L1 (so as many
// blocks fit as the shared memory allows), once per device (the bit of
// `done`), not per launch.
template <typename Kernel>
int allow_shared_memory(Kernel kernel, unsigned long long& done) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (done >> dev & 1ull) return 0;
  int optin = 0;
  err = (int)cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (!err)
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  if (!err) done |= 1ull << dev;
  return err;
}

// K1/K5 (kAddInput) blocks an SM holds at `smem` bytes of shared memory,
// by the occupancy calculator; -1 on an error.
// One K1/K5 instantiation: its launch, and its blocks an SM by the
// occupancy calculator (-1 on an error).  The shared-memory attributes
// are set once per device.
template <typename T, bool kAddInput, int LPT>
struct Strip {
  static auto kernel() {
    return kAddInput ? fdtd_step_kernel<T, LPT> : stencil_pair_kernel<T, LPT>;
  }

  static int prepare() {
    static unsigned long long configured = 0;  // devices, one bit each
    return allow_shared_memory(kernel(), configured);
  }

  static int launch(const void* u, void* out, const void* wz, const void* wp,
                    const StripArgs& a, dim3 grid, size_t smem,
                    cudaStream_t st) {
    const int err = prepare();
    if (err) return err;
    kernel()<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(u), static_cast<T*>(out),
        static_cast<const T*>(wz), static_cast<const T*>(wp), a);
    return finish();
  }

  static int occupancy(size_t smem) {
    int blocks = 0;
    if (prepare() || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, kernel(), kThreads, smem))
      return -1;
    return blocks;
  }
};

template <typename T, bool kAddInput>
int strip_stencil(const void* u, void* out, const void* wz, const void* wp,
                  const int* taps, const int* plan, int p, int zc, int plane,
                  int nt, cudaStream_t st) {
  StripArgs a;
  dim3 grid;
  size_t smem = 0;
  int lpt = 0;
  const int err = strip_args<T>(taps, plan, p, zc, plane, nt, a, grid, smem,
                                lpt);
  if (err) return err;
  return lpt == 1 ? Strip<T, kAddInput, 1>::launch(u, out, wz, wp, a, grid,
                                                   smem, st)
                  : Strip<T, kAddInput, 2>::launch(u, out, wz, wp, a, grid,
                                                   smem, st);
}

template <typename T, bool kAddInput>
int strip_occupancy(int lpt, size_t smem) {
  if (lpt == 1) return Strip<T, kAddInput, 1>::occupancy(smem);
  if (lpt == 2) return Strip<T, kAddInput, 2>::occupancy(smem);
  return -1;
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
                    const void* wp, const int* taps, const int* plan, int p,
                    int zc, int plane, int nt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? strip_stencil<float, false>(u, out, wz, wp, taps, plan,
                                                  p, zc, plane, nt, st)
                    : strip_stencil<double, false>(u, out, wz, wp, taps, plan,
                                                   p, zc, plane, nt, st);
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
                 const void* wp, const int* taps, const int* plan, int p,
                 int zc, int plane, int nt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? strip_stencil<float, true>(u, out, wz, wp, taps, plan,
                                                 p, zc, plane, nt, st)
                    : strip_stencil<double, true>(u, out, wz, wp, taps, plan,
                                                  p, zc, plane, nt, st);
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

// Blocks of K1 (add_input 0) or K5 (1) an SM holds on the current device
// with `lpt` lanes a thread and `smem` bytes of shared memory (what the
// plan assumes; probes print it); -1 on an error.
int lt_stencil_blocks_per_sm(int dtype, int add_input, int lpt,
                             long long smem) {
  const size_t b = (size_t)smem;
  if (dtype == 0)
    return add_input ? strip_occupancy<float, true>(lpt, b)
                     : strip_occupancy<float, false>(lpt, b);
  return add_input ? strip_occupancy<double, true>(lpt, b)
                   : strip_occupancy<double, false>(lpt, b);
}

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
