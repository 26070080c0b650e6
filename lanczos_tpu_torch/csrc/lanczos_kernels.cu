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
// which takes float32 and accumulates in float64.  dtype 2 is a bfloat16
// state (K1, K2, K3 and K7 only; the others refuse it): bf16 loads and
// stores, float32 weights, coefficients and sums, one round-to-nearest-
// even store (JAX's astype), as the Pallas kernels promote a bf16 state to
// their f32 weights (lanczos_tpu/ops/pallas/stencil_kernel.py:193-197).
//
// K1-K7 stream the block state, (p, 6, Zc, P) per block (K6 any number of
// (Zc, P) fields), and do a handful of flops per element, so device memory
// bounds them all; so it does K8, the windowed-ELL SpMM of assembled
// matrices (see its section).  At the main path's shape (Maxwell N=160,
// p=4: Zc=176, P=26624) one block state is 449.8 MB; the bytes each moves
// per call are noted at each kernel.  K2 is a plain first version: one
// position per thread in a grid-stride loop, neighbouring threads on
// neighbouring addresses.  The others were redesigned for the card: the
// stencils (K1 and K5, K4, K6) march strips of lanes along z, staging rows
// in shared memory with cp.async and keeping their plane weights in
// registers; K3 (with K7, which shares its kernel) takes exact-size
// register tiles, 16-byte loads and a one-launch Gram; K8 16-byte plane
// loads, four rows a lane, with the next planes' loads in flight before
// this plane's gathers (see their sections).
//
// Cross-block sums (K3, K4, K7) are deterministic: each block writes its
// partial sums into scratch, and the grid's last block (an atomic ticket)
// adds them in block order.  No float atomics, so the Lanczos
// coefficients repeat run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// A state element of type S as the compute type W, and back: bf16 widens
// exactly to float and is stored rounded to nearest even; float32 and
// float64 states compute in their own type.
template <typename W, typename S>
__device__ __forceinline__ W widen(S v) {
  if constexpr (std::is_same_v<S, bf16>)
    return W(__bfloat162float(v));
  else
    return W(v);
}

template <typename S, typename W>
__device__ __forceinline__ S narrow(W v) {
  if constexpr (std::is_same_v<S, bf16>)
    return __float2bfloat16_rn(float(v));
  else
    return S(v);
}

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
// plane-pair) twos (StencilSpec.paired); an unpaired half's one at a time.
struct StencilTaps {
  CompTaps comp[6];
  int paired[2];  // per half
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

// Sums acc[i] over the block of NW warps, deterministically (fixed shuffle
// tree, then warps in order).  Afterwards red[i * NW] holds the block
// total.
template <typename T, int NACC, int NW = kWarps>
__device__ __forceinline__ void block_sum(T (&acc)[NACC], T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    T v = acc[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[i * NW + warp] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NACC; i += blockDim.x) {
    T s = red[i * NW];
    for (int w = 1; w < NW; ++w) s += red[i * NW + w];
    red[i * NW] = s;
  }
  __syncthreads();
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
// and K4; K1's wrapper sends unpaired specs to K6).  K5 adds u to the tap sum
// (the plain version's order; the Pallas kernel starts its sum at u, which
// differs in rounding only).  The Pallas K5 updates u in place, which the
// TPU's in-order grid and a VMEM delay ring make safe; CUDA blocks run in
// no order and would overwrite rows a neighbour still stages, so out is a
// second buffer (the caller swaps the two), never u.  No sum crosses a
// block: the result repeats bit for bit.
// K1 also takes a bf16 state (dtype 2), as the Pallas kernel does
// (stencil_kernel.py:109-113, :193-197): the same strips, 512 lanes, and
// f32 plane weights in registers; a staged row is bf16, 8 lanes a 16-byte
// cp.async (halos in whole 8-lane words, so row % 8 == 0 and the f32
// z-weights after the ring stay 16-byte aligned); a tap widens its bf16
// read from shared memory to f32, the sums run in f32 and the store
// rounds once, to nearest even.  Half the bytes of f32 at the same
// arithmetic: 2 * 449.8 MB at N=160 p=8 (0.2686 ms at 3.35 TB/s), 2 *
// 56.2 MB at p=1.  K5 takes no bf16 (JAX's plan refuses it).

// staged rows: z-1, z, z+1, two ahead, and the row the slowest warp may
// still read while the others stage the next one
constexpr int kStencilSlots = 6;
constexpr int kStencilAhead = kStencilSlots - 4;
constexpr int kStageCopies = 8;  // 16-byte copies a thread stages a row
constexpr int kRowWeights = 6 * kMaxTaps;  // z-weights of one row, (c, k)

// What a launch of K1/K5 (and K4) knows, built on the host from the tap
// table and the wrapper's plan.  Indexed with compile-time indices only, so
// it stays in the parameter space.
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
  // K4's z-taps (dz != 0, roll 0) read their input at the thread's own
  // lanes from device memory: ic * Zc * P + dz * P from the tap's row
  int goff[6][kMaxTaps];
  int ptile;            // K4: block columns staged at once (a tile)
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

// Where this thread's staging copies of a row come from, within a z-plane
// of a column (component c's field at c * comp): copy m lands at element
// (tid + kThreads m) V of the slot (tid: threadIdx.x), the row holding
// components 0..ncomp-1, component c's strip and halo from off[c] on; -1
// past the row.  The halo's lanes wrap mod P, so every copy reads inside
// the plane.
template <int V>
__device__ __forceinline__ void stage_sources(const int (&off)[6],
                                              const int (&left)[6], int ncomp,
                                              int row, int l0, int plane,
                                              int comp,
                                              int (&src)[kStageCopies],
                                              int tid = threadIdx.x) {
#pragma unroll
  for (int m = 0; m < kStageCopies; ++m) {
    const int e = (tid + m * kThreads) * V;
    int c = 0, o = off[0], lf = left[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      if (k < ncomp && e >= off[k]) {
        c = k;
        o = off[k];
        lf = left[k];
      }
    }
    int g = (l0 - lf + e - o) % plane;
    if (g < 0) g += plane;
    src[m] = e < row ? c * comp + g : -1;
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
// The state (u, out, the staged rows) is of type S, the weights and sums of
// type W: S = W for float32 and float64; a bf16 state (S = bf16, W =
// float) is staged as it is stored, 8 lanes a 16-byte copy, widened when a
// tap reads it from shared memory, and rounded once on store.
template <typename S, typename W, bool kAddInput, int LPT>
__device__ __forceinline__ void strip_stencil_body(
    const S* __restrict__ u, S* __restrict__ out, const W* __restrict__ wz,
    const W* __restrict__ wp, const StripArgs& a) {
  constexpr int V = 16 / (int)sizeof(S);
  extern __shared__ __align__(16) unsigned char stencil_smem[];
  S* ring = reinterpret_cast<S*>(stencil_smem);
  // 16-byte aligned: row % V == 0, so the ring is whole 16-byte words
  W* wrows = reinterpret_cast<W*>(ring + kStencilSlots * a.row);
  const int l0 = blockIdx.x * a.width;
  const int w = min(a.width, a.plane - l0);
  const int z0 = blockIdx.y * a.zchunk;
  const int z1 = min(z0 + a.zchunk, a.zc);
  const int nr = z1 - z0 + 2;  // staged rows a column: z0 - 1 .. z1
  const int items = a.p * nr;
  const int comp = a.zc * a.plane;  // < 2^30, checked by the wrapper

  int src[kStageCopies];
  stage_sources<V>(a.off, a.left, 6, a.row, l0, a.plane, comp, src);
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
  W wpr[6][kMaxTaps][LPT];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const W* wph = wp + (long long)(c / 3) * a.nt * a.plane + l0;
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int i = threadIdx.x + j * kThreads;
        wpr[c][k][j] = k < a.n[c] && i < w
                           ? __ldg(wph + (long long)a.t[c][k] * a.plane + i)
                           : W(0);
      }
    }
  }

  // item s of the staging sequence is row z0 - 1 + s % nr of column s / nr,
  // in slot s % kStencilSlots
  int issued = 0;
  for (int b = 0; b < a.p; ++b) {
    for (int z = z0; z < z1; ++z) {
      const int sc = b * nr + (z - z0 + 1);  // this row's item
      W* wrow = wrows + (sc & 1) * kRowWeights;
      // items up to sc + 1 + kStencilAhead go into the slots of items
      // before sc - 2, whose last reader finished before the last barrier;
      // a new column's first row skips two items, so it waits for the
      // previous row's readers too
      if (z == z0 && b > 0) __syncthreads();
      for (; issued <= sc + 1 + kStencilAhead; ++issued) {
        if (issued < items) {
          const int bb = issued / nr;
          const int zz = z0 - 1 + issued - bb * nr;
          S* slot = ring + (issued % kStencilSlots) * a.row;
          if (zz < 0 || zz >= a.zc) {
            for (int e = threadIdx.x; e < a.row; e += kThreads)
              slot[e] = narrow<S>(W(0));
          } else {
            const S* plane = u + bb * a.state + (long long)zz * a.plane;
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
                      : W(0);
      cp_async_wait<kStencilAhead>();  // items up to sc + 1 have landed
      __syncthreads();  // ... for every thread, with zeros and z-weights
      const int rm = ((sc - 1) % kStencilSlots) * a.row;
      const int r0 = (sc % kStencilSlots) * a.row;
      const int rp = ((sc + 1) % kStencilSlots) * a.row;
      S* ob = out + b * a.state + (long long)z * a.plane + l0;
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const int h = c / 3;
        W wzv[kMaxTaps];
        lds4(wrow + c * kMaxTaps, wzv);
        // each tap's staged row at this thread's first lane; lane j is
        // j * kThreads elements on
        const S* rt[kMaxTaps];
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) {
          const int d = a.dz[c][k];
          rt[k] = ring + (d < 0 ? rm : d == 0 ? r0 : rp) + a.soff[c][k] +
                  threadIdx.x;
        }
        // every lane of the strip reads staged lanes (a plane narrower
        // than the strip is staged wrapped); only the stores stop at w
        auto tap = [&](int k, int j) { return widen<W>(rt[k][j * kThreads]); };
        W acc[LPT];
#pragma unroll
        for (int j = 0; j < LPT; ++j) acc[j] = W(0);
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
        const S* center = ring + r0 + a.off[c] + a.left[c] + threadIdx.x;
        S* oc = ob + (long long)c * comp + threadIdx.x;
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          if (threadIdx.x + j * kThreads < w)
            oc[j * kThreads] = narrow<S>(
                kAddInput ? widen<W>(center[j * kThreads]) + acc[j] : acc[j]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can still be open
}

template <typename S, typename W, int LPT>
__global__ void __launch_bounds__(kThreads, StripTraits<S, LPT>::kMinBlocks)
    stencil_pair_kernel(const S* __restrict__ u, S* __restrict__ out,
                        const W* __restrict__ wz, const W* __restrict__ wp,
                        const __grid_constant__ StripArgs a) {
  strip_stencil_body<S, W, false, LPT>(u, out, wz, wp, a);
}

template <typename S, typename W, int LPT>
__global__ void __launch_bounds__(kThreads, StripTraits<S, LPT>::kMinBlocks)
    fdtd_step_kernel(const S* __restrict__ u, S* __restrict__ out,
                     const W* __restrict__ wz, const W* __restrict__ wp,
                     const __grid_constant__ StripArgs a) {
  strip_stencil_body<S, W, true, LPT>(u, out, wz, wp, a);
}

// ---------------------------------------------------------------------------
// K2: out[j] = sum_k coeffs[k, j] * cat(x0, x1, x2)[k].
// Replaces block_mix (lanczos_tpu/ops/pallas/block_dense.py:104).
// Bound: device memory.  K input rows read once and p_out rows written
// once: 4 * 449.8 MB for the mono step's (3p -> p) mix at N=160 p=4.  The
// (K, p_out) coefficients sit in shared memory.  One thread owns one
// position across all rows and reads all K inputs there before it writes
// any output, so out may alias x0 (inplace=True) without a race; for that
// reason no pointer here is __restrict__.  States of type T, coefficients
// and sums of type W (T = W, but float for a bf16 state: one rounding on
// store, block_dense.py:142-143; 4 * 56.2 MB for the fused vector route's
// 3-operand call at N=160 p=1).
template <typename T, typename W, int MAXPO>
__global__ void __launch_bounds__(kThreads)
    block_mix_kernel(const T* x0, int p0, const T* x1, int p1, const T* x2,
                     int p2, const W* coeffs, T* out, int p_out,
                     long long S) {
  extern __shared__ __align__(16) unsigned char smem[];
  W* sc = reinterpret_cast<W*>(smem);
  const int K = p0 + p1 + p2;
  for (int i = threadIdx.x; i < K * p_out; i += blockDim.x) sc[i] = coeffs[i];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += stride) {
    W acc[MAXPO];
#pragma unroll
    for (int j = 0; j < MAXPO; ++j) acc[j] = W(0);
    for (int k = 0; k < K; ++k) {
      const T* row = k < p0 ? x0 + (long long)k * S
                     : k < p0 + p1 ? x1 + (long long)(k - p0) * S
                                   : x2 + (long long)(k - p0 - p1) * S;
      const W xv = widen<W>(row[s]);
      const W* ck = sc + k * p_out;
#pragma unroll
      for (int j = 0; j < MAXPO; ++j)
        if (j < p_out) acc[j] += ck[j] * xv;
    }
#pragma unroll
    for (int j = 0; j < MAXPO; ++j)
      if (j < p_out) out[(long long)j * S + s] = narrow<T>(acc[j]);
  }
}

// ---------------------------------------------------------------------------
// K3: gram(cat(x0..x3), z)[k, j] = <row_k, z_j>, f32 sums for f32 and f64
// for f64; K7 runs the same kernel with f64 sums of f32 operands.  bf16
// operands (gram<bf16, float, float>, and K7's gram<bf16, double, float>)
// load 8 a 16-byte word, keep them packed (Pack<bf16, 8>) and widen each
// exactly to the sum type: an f32 Gram, as JAX's (block_dense.py:232).
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
// 16-byte aligned), else one scalar load.  Element i as the sum type Acc:
// get<Acc>(i).
template <typename T, int VEC>
struct Pack {
  T v[VEC];

  __device__ __forceinline__ void load(const T* __restrict__ p) {
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

  template <typename Acc>
  __device__ __forceinline__ Acc get(int i) const {
    return Acc(v[i]);
  }
};

// Eight bf16 a 16-byte load, kept as the four 32-bit words they arrive in
// (half the registers of eight widened floats); a bf16 is the high half of
// the float it widens to, so element i widens exactly by a shift or a mask.
template <>
struct Pack<bf16, 8> {
  uint4 w;

  __device__ __forceinline__ void load(const bf16* __restrict__ p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }

  template <typename Acc>
  __device__ __forceinline__ Acc get(int i) const {
    const unsigned word = i < 4 ? (i < 2 ? w.x : w.y) : (i < 6 ? w.z : w.w);
    return Acc(__uint_as_float(i & 1 ? word & 0xffff0000u : word << 16));
  }
};

template <>
struct Pack<bf16, 1> {
  bf16 v;

  __device__ __forceinline__ void load(const bf16* __restrict__ p) {
    v = __ldg(p);
  }

  template <typename Acc>
  __device__ __forceinline__ Acc get(int) const {
    return widen<Acc>(v);
  }
};

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
  Pack<T, VEC> xv[NV][R], zv[NV][C];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const long long e = (v + u * stride) * VEC;
#pragma unroll
    for (int j = 0; j < C; ++j) zv[u][j].load(zr[j] + e);
#pragma unroll
    for (int k = 0; k < R; ++k) xv[u][k].load(xr[k] + e);
  }
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[k * C + j] += xv[u][k].template get<Acc>(i) *
                            zv[u][j].template get<Acc>(i);
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
// K4: v = A q written into dst's buffer, and g3 = [gram(q, v); gram(v, v);
// gram(dst_old, q)], (3p, p), in one pass and one launch.
// Replaces apply_stencil_pair_gram (lanczos_tpu/ops/pallas/stencil_gram.py:96).
// Bound: device memory.  Reads q and dst, writes v: 3 * 449.8 MB at N=160
// p=4 (0.4028 ms at 3.35 TB/s), against 5 passes for K1 followed by a
// separate Gram; its 3 p^2 multiply-adds a position (12 an element at
// p=4) are far below the card's rate.  The first version (one thread a
// position, every tap read through L1/L2, plane weights re-read every row,
// a second launch for the sums) ran at 37% of the bound.  A Gram needs
// every column's q, v and dst_old at the same position, so this kernel
// marches z outermost with the block columns inside (K1 does the
// opposite):
// * a block owns a strip of W = 256 lanes of all six components over a
//   range of z-rows, for every column, with 512 threads at p <= 4: thread
//   t takes lane t % 256 of the output components of half t / 256 (E:
//   0..2, H: 3..5), so 16 warps an SM share the arithmetic and each keeps
//   only its half's plane weights in registers for the whole range (the
//   Gram sums over components, so the halves' sums meet in the block's
//   tree); at p = 5..8, 256 threads of both halves (GramShape); a row's
//   z-weights sit in shared memory;
// * every device-memory read is a 16-byte cp.async issued a row ahead, so
//   no load's latency stalls the arithmetic: q's rows, with the lane halo
//   of the taps' rolls (K1's copies: sources worked out once, lanes
//   wrapped mod P), in a ring of kGramSlots items (rows z-1, z, z+1, and
//   z+2 landing), and dst_old's rows at the strip's own lanes in two
//   buffers (row z read, z+1 landing); every thread issues its share of
//   both.  One barrier a row;
// * v is stored into dst after dst_old was staged, and every neighbour
//   read comes from q, so the in-place write races with nothing;
// * the 3 p^2 Gram sums stay in registers over the thread's lanes and
//   rows (gram(v, v) over k <= j, mirrored at the end), then go through a
//   fixed shuffle tree and the warps in order, and the grid's last block
//   (K3's atomic ticket) adds every block's partials in block order: one
//   launch, the same bits on every run.
// An item is row z of every column where that fits a block (the main
// path: stencil_kernel.gram_plan).  Where it does not (wide planes, f64,
// p up to 8), an item is row z of a tile of ptile columns in a ring of
// kGramTileSlots, and the TILED instantiation reads the z-taps' rows z+-1
// at the thread's own lane from device memory (in the Maxwell operator,
// and by the plan's check, every z-tap has roll 0) and takes the Gram's
// other columns there too: q from device memory, v of earlier tiles back
// from dst (this thread wrote it); gram(dst_old, q) sums each tile's
// dst_old before it is overwritten.  p <= 4 runs the MAXP = 4
// instantiation (42 sums), p = 5..8 MAXP = 8 (164).  A half sums its taps
// in K1's forms: a paired half (v0 w0 + v1 w1) ws per pair, an unpaired
// one (v wp) wz per tap, so an unpaired K4 is this one launch too.
// What sets its time is the arithmetic, not the copies, which it does
// not fully overlap at one block an SM: instructions removed from the
// row loop (the FULL instantiation at p == MAXP drops the column guards;
// lanes past the plane carry zero weights instead of selects) each
// showed in the time (probes --stencil-parts; PERF.md).
constexpr int kGramSlots = 4;      // q items staged: z-1, z, z+1, z+2
constexpr int kGramTileSlots = 2;  // TILED: row z, and z's next tile landing

// Threads of a K4 block: a lane's six output components split over two
// threads, E's and H's (p <= 4), or all on one, whose 255 registers hold
// MAXP = 8's sums with fewer spills.  (Three threads a lane, two
// components each, spill at their 80 registers.)
template <int MAXP>
struct GramShape {
  static constexpr int kGroups = MAXP == 4 ? 2 : 1;  // threads a lane
  static constexpr int kThreadsPer = kThreads * kGroups;
  static constexpr int kWarpsPer = kThreadsPer / 32;
  static constexpr int kComps = 6 / kGroups;  // output components a thread
};

template <typename T, int MAXP, bool TILED, bool FULL>
__global__ void __launch_bounds__(GramShape<MAXP>::kThreadsPer, 1)
    stencil_gram_kernel(const T* __restrict__ q, T* __restrict__ dst,
                        const T* __restrict__ wz, const T* __restrict__ wp,
                        const __grid_constant__ StripArgs a,
                        T* __restrict__ partial, unsigned* __restrict__ ticket,
                        T* __restrict__ g3) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int PP = MAXP * MAXP;
  constexpr int kSlots = TILED ? kGramTileSlots : kGramSlots;
  constexpr int kLag = TILED ? 0 : 1;  // items held either side of row z
  constexpr int kGroups = GramShape<MAXP>::kGroups;
  constexpr int kComps = GramShape<MAXP>::kComps;
  constexpr int kBlock = GramShape<MAXP>::kThreadsPer;
  // dynamic shared memory only: a static byte more would put the opt-in
  // size the launcher allows over the card's limit
  extern __shared__ __align__(16) unsigned char stencil_smem[];
  const int p = a.p;
  const int pt = a.ptile;                  // == p unless TILED
  const int ntiles = (p + pt - 1) / pt;
  const int slot = pt * a.row;             // one ring item
  const int dcol = 6 * a.width;            // one column's staged dst_old row
  T* ring = reinterpret_cast<T*>(stencil_smem);
  T* dbuf = ring + kSlots * slot;          // two items of dst_old
  T* wrows = dbuf + 2 * pt * dcol;         // 16-byte aligned: row % V == 0
  const int l0 = blockIdx.x * a.width;
  const int w = min(a.width, a.plane - l0);
  const int z0 = blockIdx.y * a.zchunk;
  const int z1 = min(z0 + a.zchunk, a.zc);
  // item m: row z0 - kLag + m / ntiles, tile m % ntiles; rows z0 - 1 and
  // z1 only as neighbours (kLag = 1, one tile)
  const int items = (z1 - z0 + 2 * kLag) * ntiles;
  const int comp = a.zc * a.plane;         // < 2^30, checked by the wrapper
  const int i = threadIdx.x % kThreads;    // the thread's lane of the strip
  const int group = threadIdx.x / kThreads;  // its output components' group
  // lanes past the plane: no store; their plane weights and staged
  // dst_old are 0, so their v is 0 and they add nothing to the Gram
  const bool live = i < w;

  // every thread stages q's copies group, group + kGroups, ... of K1's
  // mapping for its lane, and its share of dst_old's copies (below)
  int src[kStageCopies];
  stage_sources<V>(a.off, a.left, 6, a.row, l0, a.plane, comp, src, i);
  int wcol = -1, wh = 0;
#pragma unroll
  for (int c = 0; c < 6; ++c)
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k)
      if (threadIdx.x == c * kMaxTaps + k && k < a.n[c]) {
        wcol = a.t[c][k];
        wh = c / 3;
      }
  // runs f(std::integral_constant<int, G>) for the thread's group G
  auto on_group = [&](auto f) {
    if (kGroups > 1 && group == 1)
      f(std::integral_constant<int, 1>{});
    else
      f(std::integral_constant<int, 0>{});
  };
  // the plane weights of the group's components, c = G * kComps + cc
  T wpr[kComps][kMaxTaps];
  on_group([&](auto gc) {
    constexpr int G = decltype(gc)::value;
#pragma unroll
    for (int cc = 0; cc < kComps; ++cc) {
      const int c = G * kComps + cc;
      const T* wph = wp + (long long)(c / 3) * a.nt * a.plane + l0 + i;
#pragma unroll
      for (int k = 0; k < kMaxTaps; ++k)
        wpr[cc][k] = k < a.n[c] && live
                         ? __ldg(wph + (long long)a.t[c][k] * a.plane)
                         : T(0);
    }
  });
  T acc[3 * PP];
#pragma unroll
  for (int m = 0; m < 3 * PP; ++m) acc[m] = T(0);

  // q's rows of item m into ring slot m % kSlots (zeros for a row outside
  // [0, Zc): it only feeds taps whose z-weight is 0 there)
  auto stage_q = [&](int m) {
    if (m >= items) return;
    const int zz = z0 - kLag + m / ntiles, b0 = (m % ntiles) * pt;
    const int nb = min(pt, p - b0);
    T* sl = ring + (m % kSlots) * slot;
    if (zz < 0 || zz >= a.zc) {
      for (int e = threadIdx.x; e < nb * a.row; e += kBlock) sl[e] = T(0);
      return;
    }
    for (int bb = 0; bb < nb; ++bb) {
      const T* plane = q + (b0 + bb) * a.state + (long long)zz * a.plane;
      T* sb = sl + bb * a.row;
#pragma unroll
      for (int k = 0; k < kStageCopies; ++k)
        if (k % kGroups == group && src[k] >= 0)
          cp_async16(sb + (i + k * kThreads) * V, plane + src[k]);
    }
  };
  // dst_old's rows of item m (a row inside [z0, z1)) at the strip's lanes
  // into buffer m & 1, column bb's component c at (bb * 6 + c) * W: this
  // thread copies the same kDstCopies (component, 16-byte chunk) pairs of
  // every column, whose offsets it works out once (-1: none)
  constexpr int kChunks = kThreads / V;  // 16-byte copies a component
  constexpr int kDstCopies = (6 * kChunks + kBlock - 1) / kBlock;
  int dsrc[kDstCopies], ddst[kDstCopies];
#pragma unroll
  for (int j = 0; j < kDstCopies; ++j) {
    const int e = threadIdx.x + j * kBlock;  // c * kChunks + chunk
    const bool ok = e < 6 * kChunks && (e % kChunks) * V < w;
    dsrc[j] = ok ? (e / kChunks) * comp + l0 + (e % kChunks) * V : -1;
    ddst[j] = (e / kChunks) * a.width + (e % kChunks) * V;
  }
  auto stage_dst = [&](int m) {
    if (m >= items - kLag * ntiles) return;
    const int zz = z0 - kLag + m / ntiles, b0 = (m % ntiles) * pt;
    const int nb = min(pt, p - b0);
    T* db = dbuf + (m & 1) * pt * dcol;
    for (int bb = 0; bb < nb; ++bb) {
      const T* row = dst + (b0 + bb) * a.state + (long long)zz * a.plane;
#pragma unroll
      for (int j = 0; j < kDstCopies; ++j)
        if (dsrc[j] >= 0)
          cp_async16(db + bb * dcol + ddst[j], row + dsrc[j]);
    }
  };
  auto zweight = [&](int z) {
    return wcol >= 0 ? __ldg(wz + ((long long)wh * a.zc + z) * a.nt + wcol)
                     : T(0);
  };
  // dst_old's lanes past the plane are never staged: zeros, before any copy
  for (int e = threadIdx.x; e < 2 * pt * dcol; e += kBlock) dbuf[e] = T(0);
  __syncthreads();
  const int first = kLag * ntiles;  // the first item whose row is computed
  for (int m = 0; m <= first + kLag; ++m) stage_q(m);
  stage_dst(first);
  cp_async_commit();
  T wnext = zweight(z0);
  for (int m = first; m < items - kLag * ntiles; ++m) {
    const int z = z0 - kLag + m / ntiles, t = m % ntiles;
    const int b0 = t * pt, b1 = min(p, b0 + pt);  // the tile's columns
    T* wrow = wrows + (z & 1) * kRowWeights;
    // the readers of this parity's z-weights (row z - 2) passed the last
    // barrier
    if (t == 0 && threadIdx.x < kRowWeights) wrow[threadIdx.x] = wnext;
    cp_async_wait<0>();  // item m + kLag's q and item m's dst_old landed
    __syncthreads();     // ... for every thread, with zeros and z-weights
    // the next group: q of item m + 1 + kLag, whose slot held item m + 1 +
    // kLag - kSlots (last read in step m - 1), and dst_old of item m + 1,
    // whose buffer held item m - 1's; both readers passed the barrier
    stage_q(m + 1 + kLag);
    stage_dst(m + 1);
    cp_async_commit();
    if (t == 0 && z + 1 < z1) wnext = zweight(z + 1);
    // column b's staged rows at b * a.row from these (rows z-1, z, z+1)
    const T* rz = ring + (m % kSlots) * slot - b0 * a.row;
    const T* rm = ring + ((m + kSlots - 1) % kSlots) * slot - b0 * a.row;
    const T* rp = ring + ((m + 1) % kSlots) * slot - b0 * a.row;
    const T* ds = dbuf + (m & 1) * pt * dcol - b0 * 6 * a.width + i;
    const long long zl = (long long)z * a.plane + l0 + i;
    // FULL: p == MAXP, untiled (the main path), so every column is in
    auto in_tile = [&](int b) {
      return TILED ? b >= b0 && b < b1 : FULL || b < p;
    };
    // group G's output components at this lane
    on_group([&](auto gc) {
      constexpr int G = decltype(gc)::value;
#pragma unroll
      for (int cc = 0; cc < kComps; ++cc) {
        const int c = G * kComps + cc, H = c / 3;
        T wzv[kMaxTaps];
        lds4(wrow + c * kMaxTaps, wzv);
        T* dc = dst + (long long)c * comp + zl;
        const T* center = rz + a.off[c] + a.left[c] + i;
        T qv[MAXP], vv[MAXP], dv[MAXP];
#pragma unroll
        for (int b = 0; b < MAXP; ++b) {
          dv[b] = in_tile(b) ? ds[(b * 6 + c) * a.width] : T(0);
          if (in_tile(b))
            qv[b] = center[b * a.row];
          else  // TILED: another tile's column, at this lane
            qv[b] = b < p && live ? __ldg(q + b * a.state + c * comp + zl)
                                  : T(0);
        }
#pragma unroll
        for (int b = 0; b < MAXP; ++b) {
          // the taps' inputs: staged rows z-1..z+1 (TILED: row z staged,
          // rows z+-1 at this lane from device memory)
          T x[kMaxTaps];
#pragma unroll
          for (int k = 0; k < kMaxTaps; ++k) {
            const int d = a.dz[c][k];
            const int o = b * a.row + a.soff[c][k] + i;
            if (k >= a.n[c] || !in_tile(b))
              x[k] = T(0);
            else if (d == 0)
              x[k] = rz[o];
            else if (!TILED)
              x[k] = d < 0 ? rm[o] : rp[o];
            else
              x[k] = live && z + d >= 0 && z + d < a.zc
                         ? __ldg(q + b * a.state + a.goff[c][k] + zl)
                         : T(0);
          }
          T sum = T(0);
          if (a.paired[H]) {
#pragma unroll
            for (int k = 0; k + 1 < kMaxTaps; k += 2) {
              if (k + 1 >= a.n[c]) break;
              if (a.dz[c][k] != a.dz[c][k + 1])  // z-pair: one plane weight
                sum += (x[k] * wzv[k] + x[k + 1] * wzv[k + 1]) * wpr[cc][k];
              else  // plane-pair: one z-weight
                sum += (x[k] * wpr[cc][k] + x[k + 1] * wpr[cc][k + 1]) *
                       wzv[k];
            }
          } else {
#pragma unroll
            for (int k = 0; k < kMaxTaps; ++k) {
              if (k >= a.n[c]) break;
              sum += (x[k] * wpr[cc][k]) * wzv[k];
            }
          }
          if (in_tile(b))
            vv[b] = sum;
          else  // TILED: an earlier tile's v, stored by this thread
            vv[b] = b < b0 && live ? dc[b * a.state] : T(0);
        }
#pragma unroll
        for (int b = 0; b < MAXP; ++b)
          if (in_tile(b) && live) dc[b * a.state] = vv[b];
#pragma unroll
        for (int k = 0; k < MAXP; ++k) {
#pragma unroll
          for (int j = 0; j < MAXP; ++j) {
            if (!TILED || in_tile(j)) {
              acc[k * MAXP + j] += qv[k] * vv[j];
              if (k <= j) acc[PP + k * MAXP + j] += vv[k] * vv[j];
            }
            if (!TILED || in_tile(k))
              acc[2 * PP + k * MAXP + j] += dv[k] * qv[j];
          }
        }
      }
    });
  }
  cp_async_wait<0>();  // only empty groups can still be open
  __syncthreads();     // the ring is free: it takes the block's sums
  block_sum<T, 3 * PP, GramShape<MAXP>::kWarpsPer>(acc, ring);
  const int nout = 3 * p * p;
  const int nblocks = gridDim.x * gridDim.y;
  T* part = partial + (long long)(blockIdx.y * gridDim.x + blockIdx.x) * nout;
  for (int m = threadIdx.x; m < 3 * PP; m += kBlock) {
    const int g = m / PP, k = (m / MAXP) % MAXP, j = m % MAXP;
    // gram(v, v) was summed over k <= j: mirror the rest
    const int from = g == 1 && k > j ? PP + j * MAXP + k : m;
    if (k < p && j < p)
      part[(g * p + k) * p + j] = ring[from * GramShape<MAXP>::kWarpsPer];
  }
  // the last block to finish adds every block's partials, in block order
  int* last = reinterpret_cast<int*>(wrows);  // the z-weights are done
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(ticket, 1u) == (unsigned)nblocks - 1;
  __syncthreads();
  if (!*last) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = warp; o < nout; o += GramShape<MAXP>::kWarpsPer) {
    T sum = T(0);
    for (int b = lane; b < nblocks; b += 32)
      sum += __ldcg(partial + (long long)b * nout + o);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, d);
    if (lane == 0) g3[o] = sum;
  }
  if (threadIdx.x == 0) *ticket = 0u;
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
// 3 + 3 fields of 18.7 MB per column, 449.8 MB.  The first version (one
// thread a position, taps and components in loops that were not unrolled,
// every tap's two weights loaded from device memory at every position)
// ran at 45% of the bound.  This one is K1's strip march for any spec:
// * a block of 256 threads owns a strip of W lanes (512 in f32, two a
//   thread; 256 in f64) of every component over a range of z-rows, loops
//   over the block columns and marches along z;
// * the n_in input rows are staged in K1's ring of kStencilSlots items
//   (z-1, z, z+1 and ahead; 16-byte cp.async, zeros outside [0, Zc), one
//   barrier a row), each component with the halo its taps' rolls reach
//   (stencil_kernel.generic_halos), so every tap reads shared memory;
// * a row's z-weights, one a tap, are fetched once into shared memory;
// * the plane weights of up to kGenRegTaps taps (the Maxwell half: three
//   components of four taps) sit in registers for the whole range, and the
//   tap loop is unrolled; a spec with more taps (a 27-point stencil) runs
//   the same body with a loop over its taps that reads plane weights
//   through L1.
// The launch (strip, z-chunk, halos, shared bytes) is
// stencil_kernel.generic_plan's; the .cu rechecks it.
constexpr int kGenComps = 6;  // components in and out
constexpr int kGenTaps = 27;  // taps per output component: a 3x3x3 stencil
constexpr int kGenRowWeights = kGenComps * kGenTaps;  // a row's z-weights
constexpr int kGenRegTaps = 12;  // taps with plane weights in registers

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

// One tap of a K6 launch; taps run in output-component order, each
// component's in spec order.
struct GenTap {
  int w;     // row of the weight arrays
  int dz;    // z-row offset in {-1, 0, 1}
  int soff;  // staged element lane 0 of the strip reads: off + left - s
  int oc;    // output component
};

// What a K6 launch knows (2.7 KB of kernel parameters).
struct GenericArgs {
  int zc, plane, p, n_in, ntap;
  int width, zchunk, row;
  int cols;  // block columns staged a step (an item)
  long long in_stride, out_stride;  // elements between block columns
  long long wz_tap, wz_z;           // wz[t, z] at t * wz_tap + z * wz_z
  int off[kGenComps], left[kGenComps];
  GenTap tap[kGenComps * kGenTaps];
};

template <typename T, int LPT, int NREG>
__global__ void __launch_bounds__(kThreads, StripTraits<T, LPT>::kMinBlocks)
    apply_stencil_kernel(const T* __restrict__ u, T* __restrict__ out,
                         const T* __restrict__ wz, const T* __restrict__ wp,
                         const __grid_constant__ GenericArgs a) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char stencil_smem[];
  T* ring = reinterpret_cast<T*>(stencil_smem);
  const int slot = a.cols * a.row;  // an item: a row of a.cols columns
  T* wrows = ring + kStencilSlots * slot;
  const int l0 = blockIdx.x * a.width;
  const int w = min(a.width, a.plane - l0);
  const int z0 = blockIdx.y * a.zchunk;
  const int z1 = min(z0 + a.zchunk, a.zc);
  const int nr = z1 - z0 + 2;  // staged rows a column: z0 - 1 .. z1
  const int groups = (a.p + a.cols - 1) / a.cols;
  const int items = groups * nr;
  const int comp = a.zc * a.plane;  // n * comp < 2^30, checked by the wrapper

  int src[kStageCopies];
  stage_sources<V>(a.off, a.left, a.n_in, a.row, l0, a.plane, comp, src);
  // thread t < ntap fetches tap t's z-weight of every row
  const int wt = threadIdx.x < a.ntap ? a.tap[threadIdx.x].w : -1;
  // the strip's plane weights of the first NREG taps
  T wpr[NREG > 0 ? NREG : 1][LPT];
#pragma unroll
  for (int t = 0; t < NREG; ++t)
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int i = threadIdx.x + j * kThreads;
      wpr[t][j] = t < a.ntap && i < w
                      ? __ldg(wp + (long long)a.tap[t].w * a.plane + l0 + i)
                      : T(0);
    }

  // item s of the staging sequence is row z0 - 1 + s % nr of the columns
  // of group s / nr, in slot s % kStencilSlots (K1's ring, a.cols rows a slot)
  int issued = 0;
  for (int gr = 0; gr < groups; ++gr) {
    const int b0 = gr * a.cols, nb = min(a.cols, a.p - b0);
    for (int z = z0; z < z1; ++z) {
      const int sc = gr * nr + (z - z0 + 1);  // this row's item
      T* wrow = wrows + (sc & 1) * kGenRowWeights;
      if (z == z0 && gr > 0) __syncthreads();
      for (; issued <= sc + 1 + kStencilAhead; ++issued) {
        if (issued < items) {
          const int ig = issued / nr;
          const int zz = z0 - 1 + issued - ig * nr;
          const int ib = ig * a.cols, ic = min(a.cols, a.p - ib);
          T* sl = ring + (issued % kStencilSlots) * slot;
          if (zz < 0 || zz >= a.zc) {
            for (int e = threadIdx.x; e < ic * a.row; e += kThreads)
              sl[e] = T(0);
          } else {
            for (int bb = 0; bb < ic; ++bb) {
              const T* plane =
                  u + (ib + bb) * a.in_stride + (long long)zz * a.plane;
#pragma unroll
              for (int m = 0; m < kStageCopies; ++m)
                if (src[m] >= 0)
                  cp_async16(sl + bb * a.row + (threadIdx.x + m * kThreads) * V,
                             plane + src[m]);
            }
          }
        }
        cp_async_commit();  // one group an item, empty past the end
      }
      if (wt >= 0) wrow[threadIdx.x] = __ldg(wz + wt * a.wz_tap + z * a.wz_z);
      cp_async_wait<kStencilAhead>();  // items up to sc + 1 have landed
      __syncthreads();  // ... for every thread, with zeros and z-weights
      // each column of the item in turn
      for (int bb = 0; bb < nb; ++bb) {
        const int rm = ((sc - 1) % kStencilSlots) * slot + bb * a.row;
        const int r0 = (sc % kStencilSlots) * slot + bb * a.row;
        const int rp = ((sc + 1) % kStencilSlots) * slot + bb * a.row;
        T* ob = out + (b0 + bb) * a.out_stride + (long long)z * a.plane + l0 +
                threadIdx.x;
        T acc[LPT];
#pragma unroll
        for (int j = 0; j < LPT; ++j) acc[j] = T(0);
        // tap t's term, in spec order; the component's last tap stores it
        auto term = [&](int t, const T (&wpt)[LPT]) {
          const GenTap& tp = a.tap[t];
          const T* rt = ring + (tp.dz < 0 ? rm : tp.dz == 0 ? r0 : rp) +
                        tp.soff + threadIdx.x;
          const T wzt = wrow[t];
#pragma unroll
          for (int j = 0; j < LPT; ++j)
            acc[j] += (rt[j * kThreads] * wpt[j]) * wzt;
          if (t + 1 == a.ntap || a.tap[t + 1].oc != tp.oc) {
            T* oc = ob + (long long)tp.oc * comp;
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              if (threadIdx.x + j * kThreads < w) oc[j * kThreads] = acc[j];
              acc[j] = T(0);
            }
          }
        };
        if constexpr (NREG > 0) {
#pragma unroll
          for (int t = 0; t < NREG; ++t)
            if (t < a.ntap) term(t, wpr[t]);
        } else {
          for (int t = 0; t < a.ntap; ++t) {
            const T* wpl = wp + (long long)a.tap[t].w * a.plane + l0;
            T wpt[LPT];
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
              const int i = threadIdx.x + j * kThreads;
              wpt[j] = i < w ? __ldg(wpl + i) : T(0);
            }
            term(t, wpt);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can still be open
}

// ---------------------------------------------------------------------------
// Launchers.

inline int finish() { return (int)cudaGetLastError(); }

// A strip kernel's plan, from the wrapper (stencil_kernel.StencilPlan):
// width, lanes a thread, z-chunk, strips, chunks, shared-memory bytes, then
// the staged lanes left of the strip and right of it per input component
// (six, zero past K6's n_in).  The geometry every strip kernel shares:
// lanes a thread, a grid that covers every lane and row exactly once,
// halos in whole 16-byte copies, and each of the ncomp components' offset
// in a staged row of at most kStageCopies copies a thread.  0 if the plan
// is one the kernels can run, else cudaErrorInvalidValue.
struct StripPlan {
  int width, lpt, zchunk, row;
  dim3 grid;
  int off[6], left[6], right[6];
};

int strip_plan(const int* plan, int zc, int plane, int ncomp, int vec,
               StripPlan& s) {
  const int bad = (int)cudaErrorInvalidValue;
  s.width = plan[0];
  s.lpt = plan[1];
  s.zchunk = plan[2];
  s.grid = dim3(plan[3], plan[4]);
  if ((s.lpt != 1 && s.lpt != 2) || s.width != kThreads * s.lpt ||
      plane % vec || s.zchunk < 1 ||
      (long long)s.grid.x * s.width < plane ||
      (long long)(s.grid.x - 1) * s.width >= plane ||
      (long long)s.grid.y * s.zchunk < zc ||
      (long long)(s.grid.y - 1) * s.zchunk >= zc)
    return bad;
  s.row = 0;
  for (int c = 0; c < 6; ++c) {
    s.left[c] = plan[6 + c];
    s.right[c] = plan[12 + c];
    if (s.left[c] < 0 || s.right[c] < 0 || s.left[c] % vec ||
        s.right[c] % vec || (c >= ncomp && s.left[c] + s.right[c]))
      return bad;
    s.off[c] = s.row;
    if (c < ncomp) s.row += s.width + s.left[c] + s.right[c];
  }
  return s.row > kStageCopies * kThreads * vec ? bad : 0;
}

// StripArgs of a K1/K5 launch (ring_rows = kStencilSlots, extra = two
// rows' z-weights) or a K4 launch (its ring and dst_old buffers, and
// own_lane_z: every z-tap has roll 0, as K4's tiled form reads rows z+-1
// at the thread's own lanes); a plan or tap table the kernel cannot run (a
// halo short of a tap's roll, a plan that strip_plan refuses, a
// shared-memory size that is not the plan's) gives cudaErrorInvalidValue.
// The ring holds state elements (T), the extra ones weights (W: float for
// a bf16 state; K4 takes f32 and f64 only, so its dst_old rows are W too).
template <typename T, typename W = T>
int strip_args(const int* taps, const int* plan, int p, int zc, int plane,
               int nt, int ring_rows, int extra, bool own_lane_z,
               StripArgs& a, dim3& grid, size_t& smem, int& lpt) {
  constexpr int V = 16 / (int)sizeof(T);
  const int bad = (int)cudaErrorInvalidValue;
  const StencilTaps tp = unpack_taps(taps);
  StripPlan sp;
  if (p < 1 || strip_plan(plan, zc, plane, 6, V, sp)) return bad;
  a.zc = zc;
  a.plane = plane;
  a.nt = nt;
  a.p = p;
  a.width = sp.width;
  a.zchunk = sp.zchunk;
  a.state = 6LL * zc * plane;
  a.row = sp.row;
  grid = sp.grid;
  lpt = sp.lpt;
  for (int c = 0; c < 6; ++c) {
    a.off[c] = sp.off[c];
    a.left[c] = sp.left[c];
  }
  smem = (size_t)ring_rows * a.row * sizeof(T) + (size_t)extra * sizeof(W);
  if (smem != (size_t)plan[5]) return bad;
  for (int h = 0; h < 2; ++h) a.paired[h] = tp.paired[h];
  for (int c = 0; c < 6; ++c) {
    const CompTaps& ct = tp.comp[c];
    if (ct.n < 0 || ct.n > kMaxTaps || (a.paired[c / 3] && ct.n % 2))
      return bad;
    a.n[c] = ct.n;
    for (int k = 0; k < kMaxTaps; ++k) {
      a.t[c][k] = a.dz[c][k] = a.soff[c][k] = a.goff[c][k] = 0;
      if (k >= ct.n) continue;
      const int ic = ct.ic[k], r = ct.r[k];
      const int s = r <= plane / 2 ? r : r - plane;  // reads lane l - s
      if (ic < 0 || ic >= 6 || ct.t[k] < 0 || ct.t[k] >= nt || r < 0 ||
          r >= plane || ct.dz[k] < -1 || ct.dz[k] > 1 ||
          s > sp.left[ic] || -s > sp.right[ic] ||
          (own_lane_z && ct.dz[k] != 0 && r != 0))
        return bad;
      a.t[c][k] = ct.t[k];
      a.dz[c][k] = ct.dz[k];
      a.soff[c][k] = a.off[ic] + a.left[ic] - s;
      a.goff[c][k] = ic * zc * plane + ct.dz[k] * plane;
    }
  }
  return 0;
}

// GenericArgs of a K6 launch: the plan's geometry for n_in components
// (strip_plan) and the taps in output-component order; a tap or plan the
// kernel cannot run, or a u or in_stride off 16-byte alignment (the
// staging copies), gives cudaErrorInvalidValue.
template <typename T>
int generic_args(const void* u, const int* taps, const int* plan, int cols,
                 int p, int n_in, int zc, int plane, long long in_stride,
                 long long out_stride, long long wz_tap, long long wz_z,
                 GenericArgs& a, dim3& grid, size_t& smem, int& lpt) {
  constexpr int V = 16 / (int)sizeof(T);
  const int bad = (int)cudaErrorInvalidValue;
  const GenericTaps g = unpack_generic_taps(taps);
  StripPlan sp;
  if (p < 1 || n_in < 1 || n_in > kGenComps || g.n_out < 1 ||
      g.n_out > kGenComps || reinterpret_cast<uintptr_t>(u) % 16 ||
      in_stride % V || strip_plan(plan, zc, plane, n_in, V, sp))
    return bad;
  a.zc = zc;
  a.plane = plane;
  a.p = p;
  a.n_in = n_in;
  a.width = sp.width;
  a.zchunk = sp.zchunk;
  a.in_stride = in_stride;
  a.out_stride = out_stride;
  a.wz_tap = wz_tap;
  a.wz_z = wz_z;
  grid = sp.grid;
  lpt = sp.lpt;
  a.row = sp.row;
  a.cols = cols;
  for (int c = 0; c < kGenComps; ++c) {
    a.off[c] = sp.off[c];
    a.left[c] = sp.left[c];
  }
  if (cols < 1 || cols > p) return bad;
  smem = ((size_t)kStencilSlots * cols * a.row + 2 * kGenRowWeights) *
         sizeof(T);
  if (smem != (size_t)plan[5]) return bad;
  a.ntap = 0;
  for (int oc = 0; oc < g.n_out; ++oc) {
    if (g.n[oc] < 1 || g.n[oc] > kGenTaps) return bad;
    for (int k = 0; k < g.n[oc]; ++k) {
      const int ic = g.ic[oc][k], r = g.r[oc][k];
      const int s = r <= plane / 2 ? r : r - plane;  // reads lane l - s
      if (ic < 0 || ic >= n_in || g.t[oc][k] < 0 || r < 0 || r >= plane ||
          g.dz[oc][k] < -1 || g.dz[oc][k] > 1 || s > sp.left[ic] ||
          -s > sp.right[ic])
        return bad;
      a.tap[a.ntap++] = GenTap{g.t[oc][k], g.dz[oc][k],
                               a.off[ic] + a.left[ic] - s, oc};
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

// Blocks of `kernel` an SM holds at `smem` bytes of shared memory, by the
// occupancy calculator, after `prepared` (its shared-memory attributes);
// -1 on an error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int prepared, size_t smem,
                  int threads = kThreads) {
  int blocks = 0;
  if (prepared || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &blocks, kernel, threads, smem))
    return -1;
  return blocks;
}

// One K1/K5 instantiation: its launch, and its blocks an SM.  The
// shared-memory attributes are set once per device.  State T, weights W.
template <typename T, typename W, bool kAddInput, int LPT>
struct Strip {
  static auto kernel() {
    if constexpr (kAddInput)
      return fdtd_step_kernel<T, W, LPT>;
    else
      return stencil_pair_kernel<T, W, LPT>;
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
        static_cast<const W*>(wz), static_cast<const W*>(wp), a);
    return finish();
  }

  static int occupancy(size_t smem) {
    return blocks_per_sm(kernel(), prepare(), smem);
  }
};

template <typename T, bool kAddInput, typename W = T>
int strip_stencil(const void* u, void* out, const void* wz, const void* wp,
                  const int* taps, const int* plan, int p, int zc, int plane,
                  int nt, cudaStream_t st) {
  StripArgs a;
  dim3 grid;
  size_t smem = 0;
  int lpt = 0;
  const int err = strip_args<T, W>(taps, plan, p, zc, plane, nt,
                                   kStencilSlots, 2 * kRowWeights, false, a,
                                   grid, smem, lpt);
  if (err) return err;
  return lpt == 1 ? Strip<T, W, kAddInput, 1>::launch(u, out, wz, wp, a,
                                                      grid, smem, st)
                  : Strip<T, W, kAddInput, 2>::launch(u, out, wz, wp, a,
                                                      grid, smem, st);
}

template <typename T, bool kAddInput, typename W = T>
int strip_occupancy(int lpt, size_t smem) {
  if (lpt == 1) return Strip<T, W, kAddInput, 1>::occupancy(smem);
  if (lpt == 2) return Strip<T, W, kAddInput, 2>::occupancy(smem);
  return -1;
}

// One K4 instantiation, as Strip.
template <typename T, int MAXP, bool TILED, bool FULL = false>
struct GramStrip {
  static auto kernel() { return stencil_gram_kernel<T, MAXP, TILED, FULL>; }

  static int prepare() {
    static unsigned long long configured = 0;
    return allow_shared_memory(kernel(), configured);
  }

  static int launch(const void* q, void* dst, const void* wz, const void* wp,
                    const StripArgs& a, void* partial, void* ticket, void* g3,
                    dim3 grid, size_t smem, cudaStream_t st) {
    const int err = prepare();
    if (err) return err;
    constexpr int kBlock = GramShape<MAXP>::kThreadsPer;
    kernel()<<<grid, kBlock, smem, st>>>(
        static_cast<const T*>(q), static_cast<T*>(dst),
        static_cast<const T*>(wz), static_cast<const T*>(wp), a,
        static_cast<T*>(partial), static_cast<unsigned*>(ticket),
        static_cast<T*>(g3));
    return finish();
  }

  static int occupancy(size_t smem) {
    return blocks_per_sm(kernel(), prepare(), smem,
                         GramShape<MAXP>::kThreadsPer);
  }
};

// K4 from the wrapper's plan (stencil_kernel.gram_plan), pt its columns a
// staged tile: one lane a thread, p <= 8; partial holds a (3p, p) sum for
// each of the plan's blocks.
template <typename T>
int stencil_pair_gram(const void* q, void* dst, const void* wz,
                      const void* wp, const int* taps, const int* plan,
                      int pt, int p, int zc, int plane, int nt,
                      void* partial, void* ticket, void* g3,
                      cudaStream_t st) {
  StripArgs a;
  dim3 grid;
  size_t smem = 0;
  int lpt = 0;
  if (pt < 1 || pt > p || p > 8) return (int)cudaErrorInvalidValue;
  // the ring of q items, two items of dst_old rows, two rows' z-weights
  const int slots = pt == p ? kGramSlots : kGramTileSlots;
  const int err = strip_args<T>(taps, plan, p, zc, plane, nt, slots * pt,
                                2 * pt * 6 * plan[0] + 2 * kRowWeights, true,
                                a, grid, smem, lpt);
  if (err) return err;
  if (lpt != 1) return (int)cudaErrorInvalidValue;
  a.ptile = pt;
  if (p == 4 && pt == p)
    return GramStrip<T, 4, false, true>::launch(q, dst, wz, wp, a, partial,
                                                ticket, g3, grid, smem, st);
  if (p <= 4)
    return pt == p ? GramStrip<T, 4, false>::launch(q, dst, wz, wp, a, partial,
                                                    ticket, g3, grid, smem, st)
                   : GramStrip<T, 4, true>::launch(q, dst, wz, wp, a, partial,
                                                   ticket, g3, grid, smem, st);
  return pt == p ? GramStrip<T, 8, false>::launch(q, dst, wz, wp, a, partial,
                                                  ticket, g3, grid, smem, st)
                 : GramStrip<T, 8, true>::launch(q, dst, wz, wp, a, partial,
                                                 ticket, g3, grid, smem, st);
}

// One K6 instantiation, as Strip.
template <typename T, int LPT, int NREG>
struct GenStrip {
  static auto kernel() { return apply_stencil_kernel<T, LPT, NREG>; }

  static int prepare() {
    static unsigned long long configured = 0;
    return allow_shared_memory(kernel(), configured);
  }

  static int launch(const void* u, void* out, const void* wz, const void* wp,
                    const GenericArgs& a, dim3 grid, size_t smem,
                    cudaStream_t st) {
    const int err = prepare();
    if (err) return err;
    kernel()<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(u), static_cast<T*>(out),
        static_cast<const T*>(wz), static_cast<const T*>(wp), a);
    return finish();
  }
};

// K6 from the wrapper's plan (stencil_kernel.generic_plan): the register
// instantiation when every tap's plane weights fit (kGenRegTaps), else the
// tap loop.
template <typename T>
int apply_stencil(const void* u, void* out, const void* wz, const void* wp,
                  const int* taps, const int* plan, int cols, int p, int n_in,
                  int zc,
                  int plane, long long in_stride, long long out_stride,
                  long long wz_tap, long long wz_z, cudaStream_t st) {
  GenericArgs a;
  dim3 grid;
  size_t smem = 0;
  int lpt = 0;
  const int err =
      generic_args<T>(u, taps, plan, cols, p, n_in, zc, plane, in_stride,
                      out_stride, wz_tap, wz_z, a, grid, smem, lpt);
  if (err) return err;
  const bool reg = a.ntap <= kGenRegTaps;
  if (lpt == 1)
    return reg ? GenStrip<T, 1, kGenRegTaps>::launch(u, out, wz, wp, a, grid,
                                                     smem, st)
               : GenStrip<T, 1, 0>::launch(u, out, wz, wp, a, grid, smem, st);
  return reg ? GenStrip<T, 2, kGenRegTaps>::launch(u, out, wz, wp, a, grid,
                                                   smem, st)
             : GenStrip<T, 2, 0>::launch(u, out, wz, wp, a, grid, smem, st);
}

template <typename T, typename W, int MAXPO>
int block_mix_t(const void* x0, int p0, const void* x1, int p1,
                const void* x2, int p2, const void* coeffs, void* out,
                int p_out, long long S, int nblocks, cudaStream_t st) {
  const size_t smem = sizeof(W) * (size_t)(p0 + p1 + p2) * p_out;
  block_mix_kernel<T, W, MAXPO><<<nblocks, kThreads, smem, st>>>(
      static_cast<const T*>(x0), p0, static_cast<const T*>(x1), p1,
      static_cast<const T*>(x2), p2, static_cast<const W*>(coeffs),
      static_cast<T*>(out), p_out, S);
  return finish();
}

template <typename T, typename W = T>
int block_mix(const void* x0, int p0, const void* x1, int p1, const void* x2,
              int p2, const void* coeffs, void* out, int p_out, long long S,
              int nblocks, cudaStream_t st) {
  if (p_out <= 4)
    return block_mix_t<T, W, 4>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out,
                                S, nblocks, st);
  if (p_out <= 8)
    return block_mix_t<T, W, 8>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out,
                                S, nblocks, st);
  if (p_out <= 16)
    return block_mix_t<T, W, 16>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out,
                                 S, nblocks, st);
  if (p_out <= 32)
    return block_mix_t<T, W, 32>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out,
                                 S, nblocks, st);
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

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64, 2 a bf16 state (f32 weights, coefficients
// and sums) where the kernel has it; any other code is refused.
constexpr int kF32 = 0, kF64 = 1, kBF16 = 2;
constexpr int kBadType = (int)cudaErrorInvalidValue;

int lt_stencil_pair(int dtype, const void* u, void* out, const void* wz,
                    const void* wp, const int* taps, const int* plan, int p,
                    int zc, int plane, int nt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return strip_stencil<float, false>(u, out, wz, wp, taps, plan, p, zc,
                                         plane, nt, st);
    case kF64:
      return strip_stencil<double, false>(u, out, wz, wp, taps, plan, p, zc,
                                          plane, nt, st);
    case kBF16:
      return strip_stencil<bf16, false, float>(u, out, wz, wp, taps, plan, p,
                                               zc, plane, nt, st);
  }
  return kBadType;
}

int lt_block_mix(int dtype, const void* x0, int p0, const void* x1, int p1,
                 const void* x2, int p2, const void* coeffs, void* out,
                 int p_out, long long S, int nblocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return block_mix<float>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out, S,
                              nblocks, st);
    case kF64:
      return block_mix<double>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out, S,
                               nblocks, st);
    case kBF16:
      return block_mix<bf16, float>(x0, p0, x1, p1, x2, p2, coeffs, out,
                                    p_out, S, nblocks, st);
  }
  return kBadType;
}

int lt_block_grams(int dtype, const void* x0, int p0, const void* x1, int p1,
                   const void* x2, int p2, const void* x3, int p3,
                   const void* z, int p, long long S, int tile_r, int tile_c,
                   int vec, void* partial, int nblocks, void* ticket,
                   void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return gram<float, float, float>(x0, p0, x1, p1, x2, p2, x3, p3, z, p,
                                       S, tile_r, tile_c, vec, partial,
                                       nblocks, ticket, out, st);
    case kF64:
      return gram<double, double, double>(x0, p0, x1, p1, x2, p2, x3, p3, z,
                                          p, S, tile_r, tile_c, vec, partial,
                                          nblocks, ticket, out, st);
    case kBF16:  // an f32 Gram of bf16 states (block_dense.py:232)
      return gram<bf16, float, float>(x0, p0, x1, p1, x2, p2, x3, p3, z, p,
                                      S, tile_r, tile_c, vec, partial,
                                      nblocks, ticket, out, st);
  }
  return kBadType;
}

int lt_stencil_pair_gram(int dtype, const void* q, void* dst, const void* wz,
                         const void* wp, const int* taps, const int* plan,
                         int pt, int p, int zc, int plane, int nt,
                         void* partial, void* ticket, void* g3,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return stencil_pair_gram<float>(q, dst, wz, wp, taps, plan, pt, p, zc,
                                      plane, nt, partial, ticket, g3, st);
    case kF64:
      return stencil_pair_gram<double>(q, dst, wz, wp, taps, plan, pt, p, zc,
                                       plane, nt, partial, ticket, g3, st);
  }
  return kBadType;
}

int lt_fdtd_step(int dtype, const void* u, void* out, const void* wz,
                 const void* wp, const int* taps, const int* plan, int p,
                 int zc, int plane, int nt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return strip_stencil<float, true>(u, out, wz, wp, taps, plan, p, zc,
                                        plane, nt, st);
    case kF64:
      return strip_stencil<double, true>(u, out, wz, wp, taps, plan, p, zc,
                                         plane, nt, st);
  }
  return kBadType;
}

// K7: float32 states (dtype 0), or bf16 ones (2) widened to float32 as
// JAX's K7 upcasts them (block_dense.py:495,500); f64 sums, an f32 Gram.
int lt_block_grams_compensated(int dtype, const void* x0, int p0,
                               const void* x1, int p1, const void* x2,
                               int p2, const void* x3, int p3, const void* z,
                               int p, long long S, int tile_r, int tile_c,
                               int vec, void* partial, int nblocks,
                               void* ticket, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return gram<float, double, float>(x0, p0, x1, p1, x2, p2, x3, p3, z, p,
                                        S, tile_r, tile_c, vec, partial,
                                        nblocks, ticket, out, st);
    case kBF16:
      return gram<bf16, double, float>(x0, p0, x1, p1, x2, p2, x3, p3, z, p,
                                       S, tile_r, tile_c, vec, partial,
                                       nblocks, ticket, out, st);
  }
  return kBadType;
}

int lt_windowed_spmm(int dtype, const void* data, const void* lidx,
                     const void* off, const void* wb, const void* x, void* y,
                     int p, int ppc, int cpg, long long n128, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return windowed_spmm<float>(data, lidx, off, wb, x, y, p, ppc, cpg,
                                  n128, st);
    case kF64:
      return windowed_spmm<double>(data, lidx, off, wb, x, y, p, ppc, cpg,
                                   n128, st);
  }
  return kBadType;
}

// Blocks of the Gram kernel an SM holds, the grid's cap per SM
// (build.gram_grid_cap).
int lt_gram_blocks_per_sm() { return kGramBlocksPerSM; }

// Blocks an SM holds on the current device of K1 (kernel 0) or K5 (1)
// with `variant` lanes a thread, or of K4 (2) for p <= `variant` (4 or 8),
// at `smem` bytes of shared memory (what the plan assumes; probes print
// it); -1 on an error.  K1 takes dtype 0, 1 and 2; K4 and K5 0 and 1.
int lt_stencil_blocks_per_sm(int dtype, int kernel, int variant,
                             long long smem) {
  const size_t b = (size_t)smem;
  if (kernel == 2 && (variant == 4 || variant == 8)) {
    if (dtype == kF32)
      return variant == 4 ? GramStrip<float, 4, false, true>::occupancy(b)
                          : GramStrip<float, 8, false>::occupancy(b);
    if (dtype == kF64)
      return variant == 4 ? GramStrip<double, 4, false, true>::occupancy(b)
                          : GramStrip<double, 8, false>::occupancy(b);
    return -1;
  }
  if (kernel != 0 && kernel != 1) return -1;
  if (dtype == kF32)
    return kernel ? strip_occupancy<float, true>(variant, b)
                  : strip_occupancy<float, false>(variant, b);
  if (dtype == kF64)
    return kernel ? strip_occupancy<double, true>(variant, b)
                  : strip_occupancy<double, false>(variant, b);
  if (dtype == kBF16 && kernel == 0)
    return strip_occupancy<bf16, false, float>(variant, b);
  return -1;
}

int lt_apply_stencil(int dtype, const void* u, void* out, const void* wz,
                     const void* wp, const int* taps, const int* plan,
                     int cols, int p, int n_in, int zc, int plane,
                     long long in_stride, long long out_stride,
                     long long wz_tap, long long wz_z, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return apply_stencil<float>(u, out, wz, wp, taps, plan, cols, p, n_in,
                                  zc, plane, in_stride, out_stride, wz_tap,
                                  wz_z, st);
    case kF64:
      return apply_stencil<double>(u, out, wz, wp, taps, plan, cols, p, n_in,
                                   zc, plane, in_stride, out_stride, wz_tap,
                                   wz_z, st);
  }
  return kBadType;
}

}  // extern "C"
