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
// S1, the p x p Jacobi sqrtm of the block recurrence (no Pallas kernel in
// the JAX package: its jitted `jacobi_eigh`), takes all three; on bf16 it
// rounds every op to bf16, as torch's bf16 ops do (see its section).  T1,
// the Householder TSQR of a block (no Pallas kernel either: JAX's vmapped
// `jnp.linalg.qr`), takes float32 and float64 (see its section); so does
// C1, the CGS2 of a block against the stored Krylov basis (none either:
// JAX's two pairs of jnp.einsum).
//
// K1-K7 stream the block state, (p, 6, Zc, P) per block (K6 any number of
// (Zc, P) fields), and do a handful of flops per element, so device memory
// bounds them all; so it does K8, the windowed-ELL SpMM of assembled
// matrices (see its section).  At the main path's shape (Maxwell N=160,
// p=4: Zc=176, P=26624) one block state is 449.8 MB; the bytes each moves
// per call are noted at each kernel.  Each was redesigned for the card
// after a plain first version: the stencils (K1 and K5, K4, K6) march
// strips of lanes along z, staging rows in shared memory with cp.async and
// keeping their plane weights in registers, K1 on a bf16 state two
// adjacent lanes a thread; K2 takes 16-byte loads with every row in flight
// before its sums, compiled for the (K, p_out) the paths run; K3 (with K7,
// which shares its kernel) exact-size register tiles, 16-byte loads and a
// one-launch Gram; K8 16-byte plane loads, four rows a lane, with the next
// planes' loads in flight before this plane's gathers (see their
// sections).
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
// z-weights after the ring stay 16-byte aligned); the sums run in f32 and
// the store rounds once, to nearest even.  Half the bytes of f32 at the
// same arithmetic: 2 * 449.8 MB at N=160 p=8 (0.2686 ms at 3.35 TB/s), 2 *
// 56.2 MB at p=1.  The f32 body, run on bf16 (a lane a thread, each tap a
// 2-byte shared load widened to f32), took 0.788 ms at p=8, 34% of that
// bound, a column costing what it costs in f32: the time is set inside the
// SM, not by bytes.  Without its taps it took 0.404 ms, without its
// staging 0.668 (probes --stencil-parts): the taps cost most, and in the
// taps the integer work of their general form (a row picked by a runtime
// dz, a pair form by a branch, a tap count checked), not the loads.  So
// where the tap table is the Maxwell curl's, as every operator's is, a
// thread takes two adjacent lanes and stencil_row_curl computes each row
// with the taps' rows, pair forms and roll-0 loads compiled in: a tap is
// one 32-bit shared load of both lanes, two and a byte permute for a
// rolled one, and an output pair one 32-bit store (0.534 ms at p=8).
// Each row's z-weights, an L2 round trip that every row's barrier waited
// on (0.427 ms without them), are then loaded a row ahead.  The same bits,
// 0.493 ms at p=8 (54% of the bound), 0.255 at p=4 and 0.070 at p=1
// (probes --ab: NVIDIA H100 80GB HBM3, 700.00 W; PERF.md); without
// its taps or its staging it takes 0.38 and 0.37 ms.  Other tap tables
// on bf16 take the f32 body, and f32 and f64 compile as they did.  K5
// takes no bf16 (JAX's plan refuses it).

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

// The Maxwell curl pair's taps, which every PallasMaxwellOperator's tap
// table has (models/maxwell_pallas.py, at every geometry): each output
// component sums two paired taps twice; components 0, 1, 3 and 4 a z-pair
// (rows z and z+1 in the E half, z and z-1 in the H half, roll 0) and then
// a plane-pair, components 2 and 5 two plane-pairs; a plane-pair's first
// tap has roll 0, its second rolls by the x- or y-shift.  Tap k of output
// component c: its z-row offset, and whether it rolls.  curl_taps says
// whether a tap table has this structure (stencil_kernel.curl_taps).
__host__ __device__ constexpr int curl_dz(int c, int k) {
  return k == 1 && c % 3 < 2 ? (c < 3 ? 1 : -1) : 0;
}

__host__ __device__ constexpr bool curl_rolled(int c, int k) {
  return k == 3 || (k == 1 && c % 3 == 2);
}

// Whether a tap table has the curl's structure (host).
bool curl_taps(const StencilTaps& tp) {
  bool curl = tp.paired[0] && tp.paired[1];
  for (int c = 0; c < 6; ++c) {
    const CompTaps& ct = tp.comp[c];
    curl = curl && ct.n == kMaxTaps;
    for (int k = 0; k < kMaxTaps; ++k)
      curl = curl && ct.dz[k] == curl_dz(c, k) &&
             (curl_rolled(c, k) || ct.r[k] == 0);
  }
  return curl;
}

// One staged row of K1 on a bf16 state with the curl's taps, lanes 2 tid
// and 2 tid + 1 of the strip a thread (a lane a thread reads a 2-byte
// lane a tap and pays for every tap's general form: its row picked by a
// runtime dz, its pair form by a branch; PERF.md).  Each tap's
// row, pair form and roll-0-ness are compile-time here; a roll-0 tap
// starts on an even element (halos are whole 16-byte words), so its lane
// pair is one 32-bit shared load; a rolled tap's two lanes straddle two
// words where its offset is odd, so it loads both and joins them with a
// byte permute (the identity where the offset is even).  The sums are
// strip_stencil_body's, in its order and factored form, in f32; the store
// rounds each lane once, to nearest even, two lanes a 32-bit store.  rm,
// r0, rp: the slots' first elements of rows z-1, z, z+1; ob: row z of the
// block column at the strip's first lane; w: the lanes to store (even:
// plane % 8 == 0).
__device__ __forceinline__ void stencil_row_curl(
    const bf16* ring, int rm, int r0, int rp, const float* wrow,
    const float (&wpr)[6][kMaxTaps][2], const StripArgs& a, bf16* ob,
    int comp, int w) {
  const unsigned* words = reinterpret_cast<const unsigned*>(ring);
  const int lane = 2 * threadIdx.x;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float wzv[kMaxTaps];
    lds4(wrow + c * kMaxTaps, wzv);
    // tap k's two lanes, widened exactly: the staged element u + 2 tid on
    auto pair = [&](int k) {
      const int d = curl_dz(c, k);
      const int u = (d < 0 ? rm : d == 0 ? r0 : rp) + a.soff[c][k];
      const unsigned* q = words + (u >> 1) + threadIdx.x;
      const unsigned v =
          curl_rolled(c, k) ? __byte_perm(q[0], q[1], u & 1 ? 0x5432 : 0x3210)
                            : q[0];
      return make_float2(__uint_as_float(v << 16),
                         __uint_as_float(v & 0xffff0000u));
    };
    auto at = [](float2 t, int j) { return j ? t.y : t.x; };
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kMaxTaps; k += 2) {
      const float2 t0 = pair(k), t1 = pair(k + 1);
      if (curl_dz(c, k) != curl_dz(c, k + 1)) {  // z-pair: one plane weight
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[j] += (at(t0, j) * wzv[k] + at(t1, j) * wzv[k + 1]) *
                    wpr[c][k][j];
      } else {  // plane-pair: one z-weight
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[j] += (at(t0, j) * wpr[c][k][j] + at(t1, j) * wpr[c][k + 1][j]) *
                    wzv[k];
      }
    }
    if (lane < w)
      *reinterpret_cast<unsigned*>(ob + (long long)c * comp + lane) =
          (unsigned)__bfloat16_as_ushort(narrow<bf16>(acc[0])) |
          (unsigned)__bfloat16_as_ushort(narrow<bf16>(acc[1])) << 16;
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
// tap reads it from shared memory, and rounded once on store; with the
// curl's taps (`curl`) at two lanes a thread it takes them adjacent and
// computes each row with stencil_row_curl.
template <typename S, typename W, bool kAddInput, int LPT>
__device__ __forceinline__ void strip_stencil_body(
    const S* __restrict__ u, S* __restrict__ out, const W* __restrict__ wz,
    const W* __restrict__ wp, const StripArgs& a, bool curl) {
  constexpr int V = 16 / (int)sizeof(S);
  constexpr bool kCurl = std::is_same_v<S, bf16> && LPT == 2;
  static_assert(!(kCurl && kAddInput), "K5 takes no bf16 state");
  const bool pairs = kCurl && curl;
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
        const int i = pairs ? 2 * threadIdx.x + j : threadIdx.x + j * kThreads;
        wpr[c][k][j] = k < a.n[c] && i < w
                           ? __ldg(wph + (long long)a.t[c][k] * a.plane + i)
                           : W(0);
      }
    }
  }

  // item s of the staging sequence is row z0 - 1 + s % nr of column s / nr,
  // in slot s % kStencilSlots
  int issued = 0;
  W wnext = W(0);  // the row's z-weight (on stencil_row_curl's path, the next row's)
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
      if (threadIdx.x < kRowWeights) {
        const bool ahead = kCurl && pairs;
        if (!ahead || (b == 0 && z == z0))
          wnext =
            wcol >= 0 ? __ldg(wz + ((long long)wh * a.zc + z) * a.nt + wcol)
                      : W(0);
        wrow[threadIdx.x] = wnext;
        if (ahead) {  // the next row's, a row ahead: no barrier waits on it
          const int zn = z + 1 < z1 ? z + 1 : z0;
          wnext = wcol >= 0 ? __ldg(wz + ((long long)wh * a.zc + zn) * a.nt + wcol)
                            : W(0);
        }
      }
      cp_async_wait<kStencilAhead>();  // items up to sc + 1 have landed
      __syncthreads();  // ... for every thread, with zeros and z-weights
      const int rm = ((sc - 1) % kStencilSlots) * a.row;
      const int r0 = (sc % kStencilSlots) * a.row;
      const int rp = ((sc + 1) % kStencilSlots) * a.row;
      S* ob = out + b * a.state + (long long)z * a.plane + l0;
      if constexpr (kCurl) {
        if (pairs) {
          stencil_row_curl(ring, rm, r0, rp, wrow, wpr, a, ob, comp, w);
          continue;
        }
      }
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

// curl: the taps have the curl's structure (curl_taps); bf16 at two lanes
// a thread reads them with stencil_row_curl, every other state ignores it
template <typename S, typename W, int LPT>
__global__ void __launch_bounds__(kThreads, StripTraits<S, LPT>::kMinBlocks)
    stencil_pair_kernel(const S* __restrict__ u, S* __restrict__ out,
                        const W* __restrict__ wz, const W* __restrict__ wp,
                        const __grid_constant__ StripArgs a, int curl) {
  strip_stencil_body<S, W, false, LPT>(u, out, wz, wp, a, curl);
}

template <typename S, typename W, int LPT>
__global__ void __launch_bounds__(kThreads, StripTraits<S, LPT>::kMinBlocks)
    fdtd_step_kernel(const S* __restrict__ u, S* __restrict__ out,
                     const W* __restrict__ wz, const W* __restrict__ wp,
                     const __grid_constant__ StripArgs a) {
  strip_stencil_body<S, W, true, LPT>(u, out, wz, wp, a, false);
}

// ---------------------------------------------------------------------------
// K2: out[j] = sum_k coeffs[k, j] * cat(x0, x1, x2)[k].
// Replaces block_mix (lanczos_tpu/ops/pallas/block_dense.py:104).
// Bound: device memory.  K input rows read once and p_out rows written
// once: 4 * 449.8 MB for the mono step's (3p -> p) mix at N=160 p=4, 4 *
// 112.5 MB for the vector route's 3-operand call at p=1 (half that on a
// bf16 state); 2 K flops an output element, far below the card's rate.
// The first version, one position a thread with one scalar load a row in
// a runtime-K loop, kept few loads in flight and spent a handful of
// instructions on each element, the same on a 2-byte bf16 as on an f32:
// 66% of the bound at p=4, 35% on bf16 (PERF.md).  What this
// design does about it:
// * 16-byte loads and stores: a thread owns V consecutive positions (4
//   f32, 8 bf16), one load a row and one store an output row; bf16 stays
//   packed until its FMAs and widens exactly by a shift or a mask.  Where
//   a row does not start on a 16-byte boundary the wrapper takes the
//   scalar instantiation (V = 1) of the same kernel
//   (block_dense.mix_vector_width); a tail of S % V positions (possible
//   only when every operand and out hold one row) is summed one element a
//   thread at the end.  An f64 state takes V = 1, one 8-byte load a row:
//   two f64 a 16-byte word (1.378 ms at N=160 p=4) lost to the first
//   version (1.228) in the same call, one a load (1.203) does not (probes
//   --ab);
// * every load in flight before the first FMA: block_mix_fixed_kernel is
//   instantiated for the (K, p_out) the paths run, (12, 4), (8, 4), (4, 4)
//   at p=4 and (3, 1), (2, 1), (1, 1) at p=1 (block_dense.MIX_SHAPES), with
//   the row pointers in the parameter space and the coefficients read from
//   shared memory as uniform broadcasts; a thread loads 8 or more 16-byte
//   words (all K rows of U = max(1, 8 / K) vectors) before its first sum.
//   block_mix_kernel, the runtime-K loop, takes every other shape (p_out <=
//   32; 16-byte loads up to p_out = 8, whose V x p_out sums fit in
//   registers);
// * whole waves: kMixBlocksPerSM blocks an SM (128 registers a thread
//   under __launch_bounds__: (12, 4) holds 12 16-byte words and 16 or 32
//   sums; at three or four blocks it spilled and ran slower), the grid at
//   most that times the SMs (build.mix_grid_cap, block_dense.mix_blocks),
//   not a fixed 1024.
// out may alias x0 (inplace=True), so no pointer is __restrict__ and the
// loads take the coherent path: a thread loads all K inputs at its
// positions before it stores any output there.  The sums keep the first
// version's order, k = 0 .. K-1, acc += c * x in W (float for a bf16
// state: one rounding on store, block_dense.py:142-143), so every
// instantiation gives that version's bits.  Measured against it in one
// call (probes --ab, N=160, 3 operands; NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md): f32 p=4 in place 0.595 ms (0.814; 90% of the bound),
// f32 p=1 0.152 (0.211), bf16 p=1 0.080 (0.187), bf16 p=4 0.300 (0.702),
// f64 p=4 1.203 (1.227), bit for bit.
constexpr int kMixBlocksPerSM = 2;
constexpr int kMixMaxK = 12;        // rows of the fixed instantiations
constexpr int kMixVecMaxPOut = 8;   // the generic kernel's 16-byte loads

// V consecutive state elements of type T: one 16-byte word (V > 1: f32 or
// bf16) or one element (V = 1), plain loads and stores.  Element i as the
// sum type W: f32 as it is, bf16 widened exactly (the high half of a float).
template <typename T, int V>
struct MixVec {
  static_assert(V == 1 || (V * sizeof(T) == 16 && sizeof(T) < 8),
                "one element, or 16 bytes of f32 or bf16");
  std::conditional_t<V == 1, T, uint4> v;

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V == 1)
      v = *p;
    else
      v = *reinterpret_cast<const uint4*>(p);
  }

  __device__ __forceinline__ unsigned word(int i) const {
    return i < 2 ? (i == 0 ? v.x : v.y) : (i == 2 ? v.z : v.w);
  }

  template <typename W>
  __device__ __forceinline__ W get(int i) const {
    if constexpr (V == 1)
      return widen<W>(v);
    else if constexpr (std::is_same_v<T, float>)
      return __uint_as_float(word(i));
    else
      return W(__uint_as_float(i & 1 ? word(i >> 1) & 0xffff0000u
                                     : word(i >> 1) << 16));
  }
};

// The V sums acc, rounded to T once, into V consecutive elements at p.
template <typename T, int V, typename W>
__device__ __forceinline__ void mix_store(T* p, const W (&acc)[V]) {
  if constexpr (V == 1) {
    *p = narrow<T>(acc[0]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (std::is_same_v<T, float>) {
        w[i] = __float_as_uint(acc[i]);
      } else {
        w[i] = (unsigned)__bfloat16_as_ushort(narrow<T>(acc[2 * i])) |
               (unsigned)__bfloat16_as_ushort(narrow<T>(acc[2 * i + 1])) << 16;
      }
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Row k of cat(x0, x1, x2) for k < K, set on the host.
template <typename T>
struct MixRows {
  const T* x[kMixMaxK];
};

// U vectors of V positions, `stride` vectors apart from vector v: every
// row's load of all U is issued before the first sum, and every sum is
// done before the first store.
template <typename T, typename W, int K, int PO, int V, int U>
__device__ __forceinline__ void mix_trip(const MixRows<T>& rows, const W* sc,
                                         T* out, long long S, long long v,
                                         long long stride) {
  MixVec<T, V> x[U][K];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int k = 0; k < K; ++k) x[u][k].load(rows.x[k] + (v + u * stride) * V);
  W acc[U][PO][V];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int j = 0; j < PO; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[u][j][i] = W(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < PO; ++j) {
        const W c = sc[k * PO + j];
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[u][j][i] += c * x[u][k].template get<W>(i);
      }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < PO; ++j)
      mix_store<T, V>(out + (long long)j * S + (v + u * stride) * V, acc[u][j]);
}

// K2 for one (K, p_out), V positions a thread.
template <typename T, typename W, int K, int PO, int V>
__global__ void __launch_bounds__(kThreads, kMixBlocksPerSM)
    block_mix_fixed_kernel(const __grid_constant__ MixRows<T> rows,
                           const W* coeffs, T* out, long long S) {
  constexpr int U = K >= 8 ? 1 : 8 / K;
  __shared__ __align__(16) W sc[K * PO];
  for (int i = threadIdx.x; i < K * PO; i += kThreads) sc[i] = coeffs[i];
  __syncthreads();
  const long long nvec = S / V;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long v = t;
  for (; v + (U - 1) * stride < nvec; v += U * stride)
    mix_trip<T, W, K, PO, V, U>(rows, sc, out, S, v, stride);
  for (; v < nvec; v += stride)
    mix_trip<T, W, K, PO, V, 1>(rows, sc, out, S, v, stride);
  if constexpr (V > 1)  // the tail, one position a thread
    if (t < S - nvec * V)
      mix_trip<T, W, K, PO, 1, 1>(rows, sc, out, S, nvec * V + t, 0);
}

// K2 for every other shape: a runtime K, p_out <= MAXPO, V positions a
// thread (V > 1 for MAXPO <= kMixVecMaxPOut only).
template <typename T, typename W, int MAXPO, int V>
__device__ __forceinline__ void mix_at(const T* x0, int p0, const T* x1,
                                       int p1, const T* x2, const W* sc,
                                       int K, T* out, int p_out, long long S,
                                       long long e) {
  W acc[MAXPO][V];
#pragma unroll
  for (int j = 0; j < MAXPO; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = W(0);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const T* row = k < p0 ? x0 + (long long)k * S
                   : k < p0 + p1 ? x1 + (long long)(k - p0) * S
                                 : x2 + (long long)(k - p0 - p1) * S;
    MixVec<T, V> xv;
    xv.load(row + e);
    const W* ck = sc + k * p_out;
#pragma unroll
    for (int j = 0; j < MAXPO; ++j)
      if (j < p_out) {
#pragma unroll
        for (int i = 0; i < V; ++i) acc[j][i] += ck[j] * xv.template get<W>(i);
      }
  }
#pragma unroll
  for (int j = 0; j < MAXPO; ++j)
    if (j < p_out) mix_store<T, V>(out + (long long)j * S + e, acc[j]);
}

template <typename T, typename W, int MAXPO, int V>
__global__ void __launch_bounds__(kThreads, kMixBlocksPerSM)
    block_mix_kernel(const T* x0, int p0, const T* x1, int p1, const T* x2,
                     int p2, const W* coeffs, T* out, int p_out,
                     long long S) {
  extern __shared__ __align__(16) unsigned char smem[];
  W* sc = reinterpret_cast<W*>(smem);
  const int K = p0 + p1 + p2;
  for (int i = threadIdx.x; i < K * p_out; i += blockDim.x) sc[i] = coeffs[i];
  __syncthreads();
  const long long nvec = S / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long v = t; v < nvec; v += stride)
    mix_at<T, W, MAXPO, V>(x0, p0, x1, p1, x2, sc, K, out, p_out, S, v * V);
  if constexpr (V > 1)  // the tail, one position a thread
    if (t < S - nvec * V)
      mix_at<T, W, MAXPO, 1>(x0, p0, x1, p1, x2, sc, K, out, p_out, S,
                             nvec * V + t);
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
// S1: (sqrtm(A), pinv(sqrtm(A))) of a batch of p x p symmetric Grams by
// parallel cyclic Jacobi with a fixed sweep count.
//
// Replaces the JAX package's jitted `jacobi_eigh` + `sqrtm_invsqrtm`
// (lanczos_tpu/ops/smalleig.py:44, :201): no Pallas kernel, a chain of
// p x p matmuls that XLA fuses inside the Lanczos `lax.scan`.  Eager torch
// launched ~40 ops a rotation round from the host (about 1,200 launches a
// call at p=4); here the whole solve is one launch.
//
// What bounds it: neither bytes (3 p^2 elements) nor operations (about
// 11 pp^2 a round): it is a chain of sweeps * (pp - 1) dependent rounds,
// 30 at p=4, so its time is latency.  One block per matrix; A, the next A
// and V live in shared memory, one thread a pair computes the rotation's
// (c, s), one thread an element the products, four barriers a round.
//
// Arithmetic: the plain version's (`ops/kernels/smalleig.py`), op for op.
// Each scalar op of (tau, t, c, s) and of the epilogue is one IEEE op
// rounded to the matrix type T, as each torch op rounds: the *_rn
// intrinsics, which nvcc never contracts into an FMA, and for a bf16 T an
// f32 op rounded to bf16.  J^T A, (J^T A) J and V J are the dense products
// of the plain version in its association, each an in-order FMA sum in the
// accumulation type (f32 for f32 and bf16, f64 for f64) rounded once to T;
// J has two nonzeros a column, and fma(0, x, acc) = acc, so the sum skips
// J's zeros and keeps the two nonzero terms in index order.  The result
// differs from torch's by the order cuBLAS (or the host BLAS) sums in: a
// few ulps.  Odd p is padded with a decoupled unit row, as the plain one.

constexpr int kSqrtmMaxP = 64;          // ops/kernels/smalleig.py MAX_P
constexpr int kSqrtmMaxThreads = 1024;  // one thread an element up to 32 x 32
constexpr int kSqrtmElems =
    kSqrtmMaxP * kSqrtmMaxP / kSqrtmMaxThreads;  // elements a thread, at most

template <typename T>
using SqrtmAcc = std::conditional_t<std::is_same_v<T, double>, double, float>;

// One IEEE op, rounded to nearest, never contracted into an FMA.
#define LT_RN(name, f32, f64)                                   \
  __device__ __forceinline__ float name(float a, float b) {    \
    return f32(a, b);                                           \
  }                                                             \
  __device__ __forceinline__ double name(double a, double b) { \
    return f64(a, b);                                           \
  }
LT_RN(add_rn, __fadd_rn, __dadd_rn)
LT_RN(sub_rn, __fsub_rn, __dsub_rn)
LT_RN(mul_rn, __fmul_rn, __dmul_rn)
LT_RN(div_rn, __fdiv_rn, __ddiv_rn)
#undef LT_RN
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// x rounded to T and back: the identity for f32 and f64
template <typename T, typename A>
__device__ __forceinline__ A round_to(A x) {
  return widen<A>(narrow<T>(x));
}

// The circle method's lineup of round r (ops/smalleig.py
// `_round_robin_pairs`): 0 fixed, 1..pp-1 rotated right r times; pair k
// of the round is (lineup(k), lineup(pp - 1 - k)).
__device__ __forceinline__ int sqrtm_lineup(int i, int r, int pp) {
  const int m = pp - 1;
  return i == 0 ? 0 : 1 + ((i - 1 - r) % m + m) % m;
}

// sum_k x[k] y[k] over the two nonzero terms k0 < k1, an in-order FMA sum
template <typename A>
__device__ __forceinline__ A two_terms(A x0, A y0, A x1, A y1) {
  return fma_rn(x1, y1, mul_rn(x0, y0));
}

template <typename T>
__global__ void __launch_bounds__(kSqrtmMaxThreads)
    jacobi_sqrtm_kernel(const T* __restrict__ a_in, T* __restrict__ sq_out,
                        T* __restrict__ inv_out, int p, int sweeps,
                        double breakdown_eps) {
  using A = SqrtmAcc<T>;
  extern __shared__ __align__(16) unsigned char sqrtm_smem[];
  const int pp = p + (p & 1);
  const int n2 = pp * pp;
  T* a = reinterpret_cast<T*>(sqrtm_smem);
  T* next = a + n2;
  T* v = next + n2;
  T* jd = v + n2;  // J[x][x]; in the epilogue sqrt(|w|)
  T* jo = jd + pp;  // J[x][partner(x)]; in the epilogue the inverse's
  int* partner = reinterpret_cast<int*>(jo + pp);
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* src = a_in + (long long)blockIdx.x * p * p;

  // the padded matrix (a unit pad diagonal) and V = I
  for (int e = tid; e < n2; e += nt) {
    const int x = e / pp, y = e - x * pp;
    a[e] = x < p && y < p ? src[x * p + y] : narrow<T>(A(x == y));
    v[e] = narrow<T>(A(x == y));
  }
  __syncthreads();

  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < pp - 1; ++r) {
      if (tid < pp / 2) {  // the rotation of pair tid (sym.schur2)
        const int i = sqrtm_lineup(tid, r, pp);
        const int j = sqrtm_lineup(pp - 1 - tid, r, pp);
        const A app = widen<A>(a[i * pp + i]), aqq = widen<A>(a[j * pp + j]);
        const A apq = widen<A>(a[i * pp + j]);
        const bool nz = apq != A(0);
        const A den = nz ? round_to<T>(mul_rn(A(2), apq)) : A(1);
        const A tau = round_to<T>(div_rn(round_to<T>(sub_rn(aqq, app)), den));
        const A sgn = tau >= A(0) ? A(1) : A(-1);
        const A tau2 = round_to<T>(add_rn(A(1), round_to<T>(mul_rn(tau, tau))));
        const A root = round_to<T>(sqrt_rn(tau2));
        A t = round_to<T>(div_rn(sgn, round_to<T>(add_rn(fabs(tau), root))));
        if (!nz) t = A(0);
        const A t2 = round_to<T>(add_rn(A(1), round_to<T>(mul_rn(t, t))));
        const A c = round_to<T>(div_rn(A(1), round_to<T>(sqrt_rn(t2))));
        const A s = round_to<T>(mul_rn(t, c));
        jd[i] = jd[j] = narrow<T>(c);
        jo[i] = narrow<T>(s);
        jo[j] = narrow<T>(-s);
        partner[i] = j;
        partner[j] = i;
      }
      __syncthreads();
      // next = J^T A: row x mixes rows x and partner(x)
      for (int e = tid; e < n2; e += nt) {
        const int x = e / pp, y = e - x * pp, q = partner[x];
        const A dx = widen<A>(jd[x]), oq = widen<A>(jo[q]);
        const A ax = widen<A>(a[e]), aq = widen<A>(a[q * pp + y]);
        next[e] = narrow<T>(x < q ? two_terms(dx, ax, oq, aq)
                                  : two_terms(oq, aq, dx, ax));
      }
      __syncthreads();
      // a = (J^T A) J and V J: column y mixes columns y and partner(y)
      A vj[kSqrtmElems];
#pragma unroll
      for (int n = 0; n < kSqrtmElems; ++n) {
        const int e = tid + n * nt;
        if (e < n2) {
          const int x = e / pp, y = e - x * pp, q = partner[y];
          const A dy = widen<A>(jd[y]), oq = widen<A>(jo[q]);
          const A by = widen<A>(next[e]), bq = widen<A>(next[x * pp + q]);
          a[e] = narrow<T>(y < q ? two_terms(by, dy, bq, oq)
                                 : two_terms(bq, oq, by, dy));
          const A vy = widen<A>(v[e]), vq = widen<A>(v[x * pp + q]);
          vj[n] = y < q ? two_terms(vy, dy, vq, oq) : two_terms(vq, oq, vy, dy);
        }
      }
      __syncthreads();
      // V <- V J; the symmetrized a into `next`, which becomes a
#pragma unroll
      for (int n = 0; n < kSqrtmElems; ++n) {
        const int e = tid + n * nt;
        if (e < n2) {
          const int x = e / pp, y = e - x * pp;
          v[e] = narrow<T>(vj[n]);
          const A sum = round_to<T>(
              add_rn(widen<A>(a[e]), widen<A>(a[y * pp + x])));
          next[e] = narrow<T>(mul_rn(A(0.5), sum));
        }
      }
      __syncthreads();
      T* t = a;
      a = next;
      next = t;
    }
  }

  // epilogue: s = sqrt(|w|), the (pseudo-)inverse's 1/s, then V diag V^T
  if (tid < p) {
    const A wab = fabs(widen<A>(a[tid * pp + tid]));
    const A s = round_to<T>(sqrt_rn(wab));
    A s_inv;
    if (breakdown_eps > 0.0) {
      A wmax = fabs(widen<A>(a[0]));
      for (int k = 1; k < p; ++k) {
        const A w = fabs(widen<A>(a[k * pp + k]));
        if (w > wmax || w != w) wmax = w;  // amax: a NaN wins
      }
      const A thresh = round_to<T>(mul_rn(A(breakdown_eps), wmax));
      s_inv = wab > thresh ? round_to<T>(div_rn(A(1), s)) : A(0);
    } else {
      s_inv = round_to<T>(div_rn(A(1), s));
    }
    jd[tid] = narrow<T>(s);
    jo[tid] = narrow<T>(s_inv);
  }
  __syncthreads();
  T* sq = sq_out + (long long)blockIdx.x * p * p;
  T* inv = inv_out + (long long)blockIdx.x * p * p;
  for (int e = tid; e < p * p; e += nt) {
    const int x = e / p, y = e - x * p;
    A acc_s = A(0), acc_i = A(0);
    for (int k = 0; k < p; ++k) {
      const A vx = widen<A>(v[x * pp + k]), vy = widen<A>(v[y * pp + k]);
      acc_s = fma_rn(round_to<T>(mul_rn(vx, widen<A>(jd[k]))), vy, acc_s);
      acc_i = fma_rn(round_to<T>(mul_rn(vx, widen<A>(jo[k]))), vy, acc_i);
    }
    sq[e] = narrow<T>(acc_s);
    inv[e] = narrow<T>(acc_i);
  }
}

// ---------------------------------------------------------------------------
// T1: the tall-skinny QR of a block-major (p, n) block by a tree of
// Householder QRs of row tiles (ops/kernels/tsqr.py; the tree is its
// docstring's).
//
// Replaces no Pallas kernel: the JAX package's tsqr is a vmapped
// jnp.linalg.qr of 8 chunks (lanczos_tpu/ops/tsqr.py), which batched
// torch.linalg.qr ran on the card as cuSOLVER's unblocked panel QR over 8
// panels of 1.3M rows, a few SMs walking them serially (90 ms a call at
// n = 10,485,760, p = 8).
//
// What bounds it: device memory.  A call reads the block twice (for R,
// then for Q) and writes q once, 3 * 335.5 MB at n = 10,485,760, p = 8
// f32 (0.300 ms at 3.35 TB/s); its ~4 p^2 flops a row are far below the
// card's rate.  What the design does about it:
// * one block of kTsqrThreads threads takes a tile of up to `tile`
//   consecutive rows of all p columns and holds it in registers (rows tid,
//   tid + 256, ...), read straight from the block-major state, so each
//   column's run is one coalesced sweep: no pad and no transpose;
// * the p reflections of the tile work on those registers (the steps
//   unrolled at compile time, so the tile never leaves them).  Each needs
//   one block-wide sum of W values (for every column j, the sum over the
//   rows below the pivot k of a[r][k] a[r][j]): a halving exchange in each
//   warp (W - 1 + 5 - log2 W shuffles, not 5 W), the warps' sums in
//   shared memory (two buffers, so one barrier a reflection), then each
//   warp adds them with its lanes and broadcasts them.  The columns j < k
//   give v_j^T v_k, which the compact WY form needs;
// * the QR pass (APPLY false) writes only the tile's p x p R to the stack
//   of the level above (2.6 MB at n = 10.5M in tiles of 1,024 rows).  The
//   same kernel QRs the stacks, level by level, down to one tile; the root
//   writes R with its signs fixed by D = sign(diag R) and takes D as its
//   factor;
// * each level's apply pass (APPLY true) repeats its tiles' reflections
//   (the same code on the same input, so the same bits) and writes
//   Q_t F_t, F_t the tile's p x p factor from the level above, by the
//   compact WY form: T from the reflections' tau and v_i^T v_k (dlarft),
//   M = T V_top^T F_t (p x p, V_top the tile's first p rows), then each
//   row y = [F_t; 0] - v M from registers.  The stacks' passes write in
//   place; the leaves' writes q block-major.
//
// Arithmetic: LAPACK's reflections (dlarfg: beta = -sign(x) ||x||, v[k] =
// 1, tau = (beta - x) / beta, no reflection where the column below the
// pivot is zero) in the block's type with sums in it, as the plain version
// (tile_tree_plain) computes them.  A tile whose sums may under- or
// overflow is factored again with its columns scaled by powers of two, by
// a function the kernel calls and does not inline (W <= 8): the test costs
// nothing beside the unscaled reflection, but scaling code inside the
// unrolled reflections took 7-14% (f32 and f64 at p = 8) and an inlined
// retry up to 45%.  The sums run in another order (per thread, then a fixed tree over
// the lanes and warps), so the two differ by rounding; every thread of a
// block gets the same bits of each sum, and a run repeats its bits.

constexpr int kTsqrThreads = 256;  // ops/kernels/tsqr.py THREADS
constexpr int kTsqrWarps = kTsqrThreads / 32;
constexpr int kTsqrRegisters = 32;  // ops/kernels/tsqr.py REGISTERS
constexpr int kTsqrMaxLevels = 64;
// blocks an SM of an apply pass at W <= 8: at f32 p = 8 its 88 registers
// a thread held two, 0.487 ms a leaf pass; held to 80 registers for three,
// 0.388-0.409.  W = 16 spills under it (644 bytes a thread in f64); the
// QR pass's bound is tsqr_min_blocks'
constexpr int kTsqrApplyBlocks = 3;

// rows a thread holds at width W: kTsqrRegisters 32-bit registers of
// tile values (ops/kernels/tsqr.py tile_rows)
template <typename T, int W>
__host__ __device__ constexpr int tsqr_slots() {
  return kTsqrRegisters / (W * (int)(sizeof(T) / 4));
}

// The least x^2 plus sum of squares below the pivot that a tile's
// reflections take unscaled: the smallest normal number over eps^2 (2^-80
// in float32), so that terms lost below the normal range cost under eps
// of it (ops/kernels/tsqr.py _tiny)
template <typename T>
__host__ __device__ constexpr T tsqr_tiny() {
  if constexpr (sizeof(T) == 4) return 0x1p-80f;
  else return 0x1p-918;
}

// f(std::integral_constant<int, K>()) for K = 0 .. N - 1 in order: a loop
// whose body indexes register arrays by K at compile time
template <int K, int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (K < N) {
    f(std::integral_constant<int, K>());
    static_for<K + 1, N>(f);
  }
}

// The warp's sums of v[0..W) (W a power of two <= 32): a halving exchange
// (W - 1 shuffles) leaves lane l the sum over its group of W lanes of
// element l % W, then a butterfly over the groups (5 - log2 W shuffles)
// the warp's.  Lane l returns element l % W's total; every lane holding
// one element holds the same bits.
template <typename T, int W>
__device__ __forceinline__ T warp_sum_scatter(T (&v)[W], int lane) {
#pragma unroll
  for (int h = W / 2; h > 0; h >>= 1) {
    const bool upper = lane & h;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const T send = upper ? v[i] : v[i + h];
      const T keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, h);
    }
  }
  T s = v[0];
#pragma unroll
  for (int o = W; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The block's totals of the warps' sums red[w][j] (w < NW, j < W), the
// same bits in every thread: lane l adds element l % W over its share of
// the warps (in warp order), a butterfly over the lanes holding one
// element adds the shares, and lane j broadcasts element j.
template <typename T, int W, int NW>
__device__ __forceinline__ void block_totals(const T (&red)[NW][W],
                                             T (&sum)[W], int lane) {
  constexpr int G = 32 / W;  // lanes an element
  static_assert(NW % G == 0, "the warps split evenly over the lanes");
  const int j = lane % W, g = lane / W;
  T t = red[g][j];
#pragma unroll
  for (int i = 1; i < NW / G; ++i) t += red[g + i * G][j];
#pragma unroll
  for (int o = W; o < 32; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
#pragma unroll
  for (int i = 0; i < W; ++i) sum[i] = __shfl_sync(0xffffffffu, t, i);
}

// The shared arrays of a block of tsqr_tile_kernel
template <typename T, int W>
struct TsqrShared {
  alignas(16) T red[2][kTsqrWarps][W];
  alignas(16) T rowk[2][W];
  T tau[W], diag[W];
  T g[W][W];  // v_i^T v_k, i < k
  T vt[W][W];  // V_top, unit lower triangular
  T f[W][W];
  T z[W][W];  // V_top^T F
  alignas(16) T m[W][W];  // T V_top^T F
};

// A block's tile.  SCALED false: factored unscaled; where a reflection's
// sums may under- or overflow (x^2 plus the squares below the pivot under
// tsqr_tiny and not all zero, or a sum not finite: the same test in every
// thread and in both passes) it returns true before it writes anything.
// SCALED true: factored with each column scaled by a power of two, which
// is exact and leaves the reflections (v, tau) as they are: only R's
// columns are scaled back.  APPLY false: QR the tile, write its R to rows
// blockIdx.x * p.. of the stack `out` (leading dimension ld_out).  APPLY
// true: QR the tile again, then write Q_t F_t to its rows of `out` (which
// may be `in`): F_t from rows blockIdx.x * p.. of `f`, or, at the root (f
// null), D, with D R written to r_out (row-major p x p) and `out` null for
// R alone.
template <typename T, int W, bool APPLY, bool SCALED>
__device__ __forceinline__ bool tsqr_tile(TsqrShared<T, W>& sh, const T* in,
                                          long long rows, T* out,
                                          long long ld_out,
                                          const T* __restrict__ f,
                                          long long ld_f,
                                          T* __restrict__ r_out, int tile,
                                          int p) {
  constexpr int S = tsqr_slots<T, W>();
  constexpr int NW = kTsqrWarps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * tile;
  const int valid = rows - base < tile ? (int)(rows - base) : tile;

  // SCALED: each column j scaled by 2^-e_j, its largest entry then in
  // [0.5, 1), from the tile's column maxima
  T scale[W];
  if constexpr (SCALED) {
    __syncthreads();  // the unscaled attempt's last reads of sh are done
#pragma unroll
    for (int j = 0; j < W; ++j) scale[j] = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = tid + s * kTsqrThreads;
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (j < p && r < valid)
          scale[j] = fmax(scale[j], fabs(in[j * rows + base + r]));
    }
#pragma unroll
    for (int j = 0; j < W; ++j) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        scale[j] = fmax(scale[j], __shfl_xor_sync(0xffffffffu, scale[j], o));
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < W; ++j) sh.red[0][warp][j] = scale[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < W; ++j) {
      T m = T(0);
#pragma unroll
      for (int w = 0; w < NW; ++w) m = fmax(m, sh.red[0][w][j]);
      int e;
      frexp(m, &e);
      scale[j] = m > T(0) ? ldexp(T(1), -e) : T(1);
    }
    __syncthreads();  // sh.red read before the first reflection writes it
  }

  T a[S][W];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int r = tid + s * kTsqrThreads;
#pragma unroll
    for (int j = 0; j < W; ++j)
      a[s][j] = !(j < p && r < valid) ? T(0)
                : SCALED                 ? in[j * rows + base + r] * scale[j]
                                         : in[j * rows + base + r];
  }

  bool wild = false;
  static_for<0, W>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    if (k >= p) return;
    constexpr int buf = k & 1;
    // sums over this thread's rows below the pivot: for j >= k the
    // reflection's, for j < k v_j^T a[:, k] (T's)
    T acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = T(0);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (tid + s * kTsqrThreads > k) {
        const T ak = a[s][k];
#pragma unroll
        for (int j = APPLY ? 0 : k; j < W; ++j) acc[j] = fma(ak, a[s][j], acc[j]);
      }
    }
    const T total = warp_sum_scatter<T, W>(acc, lane);
    if (lane < W) sh.red[buf][warp][lane] = total;
    if (tid == k) {  // the pivot row is slot 0 of thread k
#pragma unroll
      for (int j = 0; j < W; ++j) sh.rowk[buf][j] = a[0][j];
    }
    __syncthreads();
    T sum[W];
    block_totals<T, W, NW>(sh.red[buf], sum, lane);
    // the reflection H = I - tau v v^T, v = (1, a[r][k] * inv below)
    const T x = sh.rowk[buf][k];
    T alpha = x, tau = T(0), inv = T(0);
    if (sum[k] != T(0)) {
      const T norm = sqrt(x * x + sum[k]);
      alpha = x >= T(0) ? -norm : norm;
      tau = (alpha - x) / alpha;
      inv = T(1) / (x - alpha);
    }
    if constexpr (!SCALED) {  // the test, beside the reflection
      T finite = x * x + sum[k];
#pragma unroll
      for (int j = k + 1; j < W; ++j) finite = fma(T(0), sum[j], finite);
      const bool zero = x == T(0) && sum[k] == T(0);
      wild = wild || (!(finite >= tsqr_tiny<T>()) && !zero) ||
             !isfinite(finite);
    }
    T c[W];  // tau v^T a[:, j]
#pragma unroll
    for (int j = k + 1; j < W; ++j)
      c[j] = tau * (sum[j] * inv + sh.rowk[buf][j]);
    if (APPLY && tid == 0) {
      sh.tau[k] = tau;
      sh.diag[k] = alpha;
#pragma unroll
      for (int i = 0; i < k; ++i) sh.g[i][k] = sum[i] * inv + sh.rowk[buf][i];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = tid + s * kTsqrThreads;
      if (r > k) {
        const T v = a[s][k] * inv;
        a[s][k] = v;
#pragma unroll
        for (int j = k + 1; j < W; ++j) a[s][j] = fma(-c[j], v, a[s][j]);
      } else if (r == k) {
#pragma unroll
        for (int j = k + 1; j < W; ++j) a[s][j] -= c[j];
        a[s][k] = alpha;
      }
    }
  });

  if (wild) return true;  // the same in every thread

  if constexpr (!APPLY) {
    if (tid < p) {  // R's row tid
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (j < p)
          out[j * ld_out + (long long)blockIdx.x * p + tid] =
              j < tid  ? T(0)
              : SCALED ? a[0][j] / scale[j]
                       : a[0][j];
    }
  } else {
    __syncthreads();  // tau_s, diag_s and g_s of the last reflection
    if (tid < p) {  // V_top's row tid
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < p) sh.vt[tid][c] = c < tid ? a[0][c] : T(c == tid);
    }
    const int pp = p * p;
    if (f == nullptr) {  // the root: R = D R, its factor D
      if (tid < p) {
        const T d = sh.diag[tid] < T(0) ? T(-1) : T(1);
#pragma unroll
        for (int j = 0; j < W; ++j)
          if (j < p)
            r_out[tid * p + j] = j < tid  ? T(0)
                                 : SCALED ? d * a[0][j] / scale[j]
                                          : d * a[0][j];
      }
      if (out == nullptr) return false;
      for (int e = tid; e < pp; e += kTsqrThreads) {
        const int i = e / p, j = e - i * p;
        sh.f[i][j] = i != j ? T(0) : sh.diag[i] < T(0) ? T(-1) : T(1);
      }
    } else {
      for (int e = tid; e < pp; e += kTsqrThreads) {
        const int i = e / p, j = e - i * p;
        sh.f[i][j] = f[j * ld_f + (long long)blockIdx.x * p + i];
      }
    }
    __syncthreads();
    for (int e = tid; e < pp; e += kTsqrThreads) {  // Z = V_top^T F
      const int c = e / p, j = e - c * p;
      T z = T(0);
      for (int r = c; r < p; ++r) z = fma(sh.vt[r][c], sh.f[r][j], z);
      sh.z[c][j] = z;
    }
    __syncthreads();
    if (tid < W) {  // T's row tid (dlarft, forward columnwise), M = T Z's
      const int i = tid;
      T trow[W];
      static_for<0, W>([&](auto kc) {
        constexpr int k = decltype(kc)::value;
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < k; ++c) acc = fma(trow[c], sh.g[c][k], acc);
        trow[k] = k >= p || k < i ? T(0)
                  : k == i        ? sh.tau[k]
                                  : -sh.tau[k] * acc;
      });
#pragma unroll
      for (int j = 0; j < W; ++j) {
        T m = T(0);
#pragma unroll
        for (int k = 0; k < W; ++k)
          if (k < p && j < p) m = fma(trow[k], sh.z[k][j], m);
        sh.m[i][j] = m;
      }
    }
    __syncthreads();
    // y = [F; 0] - v M, v the row's reflectors (1 on the diagonal)
    T y[S][W];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int j = 0; j < W; ++j) y[s][j] = T(0);
    static_for<0, W>([&](auto cc) {
      constexpr int c = decltype(cc)::value;
      if (c >= p) return;
      T mrow[W];
#pragma unroll
      for (int j = 0; j < W; ++j) mrow[j] = sh.m[c][j];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int r = tid + s * kTsqrThreads;
        const T v = r > c ? a[s][c] : T(r == c);
#pragma unroll
        for (int j = 0; j < W; ++j) y[s][j] = fma(v, mrow[j], y[s][j]);
      }
    });
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = tid + s * kTsqrThreads;
      if (r < valid) {
#pragma unroll
        for (int j = 0; j < W; ++j)
          if (j < p)
            out[j * ld_out + base + r] = (r < p ? sh.f[r][j] : T(0)) - y[s][j];
      }
    }
  }
  return false;
}

// The scaled attempt, apart from the kernel's own code (at W <= 8; at W =
// 16 the call's frame took the kernels to 2x their time, and the retry is
// inlined there): it runs only where the unscaled one found its sums out
// of range
template <typename T, int W, bool APPLY>
__device__ __noinline__ void tsqr_tile_scaled(TsqrShared<T, W>& sh,
                                              const T* in, long long rows,
                                              T* out, long long ld_out,
                                              const T* f, long long ld_f,
                                              T* r_out, int tile, int p) {
  tsqr_tile<T, W, APPLY, true>(sh, in, rows, out, ld_out, f, ld_f, r_out,
                               tile, p);
}

// Blocks an SM holds of each pass, which caps the registers a thread may
// take: the unscaled code's own need (ptxas, before the scaled retry was
// added: QR pass 55-80 registers, 108 in f64 at W = 16), so that the
// retry's call does not raise it (uncapped, the f32 W = 8 QR pass took
// 104 registers and ran 45% slower)
template <typename T, int W, bool APPLY>
constexpr int tsqr_min_blocks() {
  if (APPLY) return W <= 8 ? kTsqrApplyBlocks : 1;
  return sizeof(T) == 4 ? (W <= 8 ? 4 : 3) : (W <= 8 ? 3 : 2);
}

template <typename T, int W, bool APPLY>
__global__ void __launch_bounds__(kTsqrThreads,
                                  tsqr_min_blocks<T, W, APPLY>())
    tsqr_tile_kernel(const T* in, long long rows, T* out, long long ld_out,
                     const T* __restrict__ f, long long ld_f,
                     T* __restrict__ r_out, int tile, int p) {
  __shared__ TsqrShared<T, W> sh;
  if (tsqr_tile<T, W, APPLY, false>(sh, in, rows, out, ld_out, f, ld_f, r_out,
                                    tile, p)) {
    if constexpr (W > 8)
      tsqr_tile<T, W, APPLY, true>(sh, in, rows, out, ld_out, f, ld_f, r_out,
                                   tile, p);
    else
      tsqr_tile_scaled<T, W, APPLY>(sh, in, rows, out, ld_out, f, ld_f, r_out,
                                    tile, p);
  }
}

// ---------------------------------------------------------------------------
// C1: CGS2 of a block-major (p, S) block w against b stored blocks of the
// Krylov basis, Q (K = b p rows of S), as one schedule of three passes
// (ops/kernels/cgs2.py; the caller sums c1 and c2 over the ranks between
// them):
//   A  cgs2_kernel<GRAM>:         c1 = Q w^T (K x p)
//   B  cgs2_kernel<UPDATE_GRAM>:  w' = w - c1^T Q, and c2 = Q w'^T summed
//                                 from the same staged tile of Q
//   C  cgs2_kernel<UPDATE>:       w'' = w' - c2^T Q, in place on w'
//
// Replaces no Pallas kernel: the JAX package's block_cgs2 is two pairs of
// jnp.einsum (lanczos_tpu/methods/block_lanczos.py:339), which the port
// ran as two torch.mm passes: a library SGEMM for the Gram, another for
// Q^T c, and a block-sized subtract, (4b + 10) blocks of traffic a call
// (a block S: p rows of the state).
//
// Bound: device memory.  Each pass reads Q once: A moves (b + 1) S, B
// (b + 2) S (Q and w read, w' written), C (b + 2) S, so a call (3b + 5) S.
// The least a CGS2 can move is (3b + 4) S: pass C could read w and redo
// B's update on chip in B's order (the same bits), so that B writes
// nothing; that doubles C's shared-memory sums, and on an H100 B ran no
// faster and C 15% slower (PERF.md).
// At p = 8, b = 12 and 10,485,760 rows in f32 that least is 40 x 335.5 MB
// (4.01 ms at 3.35 TB/s).  The Gram of pass B saves a fourth pass, a whole
// read of Q and of w' ((b + 1) S), against an unfused A / C / A / C (the
// chunked schedule, (4b + 6 chunks) S); its 2 K p flops an element of w
// are far below the card's f32 rate.  Design:
// * persistent blocks of kCgs2Threads threads, one an SM, each owning a
//   contiguous run of tiles of kCgs2Vectors 16-byte vectors of every row
//   (128 positions in f32, 64 in f64);
// * a tile's K + p rows are staged in shared memory by cp.async in a ring
//   of `stages` (2..kCgs2MaxStages) slots, stages - 1 tiles in flight
//   ahead of the one computed; copies past S fill zeros, so a ragged tail
//   adds nothing;
// * a thread is (vector v = lane, column quad jq, k-slice ks), its warp
//   (jq, ks).  The update sums c[k][4 jq .. 4 jq + 3] Q[k][v] over its
//   slice's rows k = ks, ks + slices, ... (each coefficient a shared-memory
//   broadcast); the slices' partials meet in shared memory and are added
//   in slice order.  Pass B writes w' to device memory and over the
//   tile's w rows, and its Gram then reads Q from the same slot, so Q
//   leaves shared memory once;
// * the Gram sums Q[k][v] w[4 jq + j][v] over the same rows into registers
//   (cgs2_slice_rows<T>() rows a slice at most, so K <= slices x that; more
//   rows take chunks of blocks, the wrapper's plan), held over the block's
//   whole run and reduced once: the lanes by a fixed shuffle tree, then the
//   blocks' partials in block order by the grid's last block (a ticket, as
//   K3's).
// Sums in the block's own type (f32 or f64), no float atomics: the same
// input gives the same bits.  Against two torch.mm passes only the order
// of the sums differs.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 4.83 ms a call at
// b = 12, p = 8, 10,518,528 rows f32, 83% of the least (3b + 4) S, against
// 11.98 ms for the two torch.mm passes.  Pass B is the slowest (76% of its
// (b + 2) S: its shared-memory traffic, not its bytes, sets it), and a call
// against b <= 4 blocks runs at 35-61% of that least (a tile's fixed cost
// of barriers and short sums).

constexpr int kCgs2Threads = 512;  // ops/kernels/cgs2.py THREADS
constexpr int kCgs2Warps = kCgs2Threads / 32;
constexpr int kCgs2Vectors = 32;  // ops/kernels/cgs2.py VECTORS
constexpr int kCgs2Cols = 4;      // ops/kernels/cgs2.py COLS
constexpr int kCgs2MaxP = 16;     // ops/kernels/cgs2.py MAX_P
// ops/kernels/cgs2.py MAX_STAGES: deeper rings ran no faster (H100, p = 8,
// b = 1 and 4: 6 stages took 2.040 and 2.696 ms a call, 8 stages 2.088 and
// 2.743; PERF.md)
constexpr int kCgs2MaxStages = 6;
enum { kCgs2Gram = 0, kCgs2Update = 1, kCgs2UpdateGram = 2 };

// Basis rows a k-slice takes: kCgs2Cols x that Gram accumulators a thread,
// 64 registers (ops/kernels/cgs2.py slice_rows)
template <typename T>
__host__ __device__ constexpr int cgs2_slice_rows() {
  return sizeof(T) == 4 ? 16 : 8;
}

// Dynamic shared memory of a launch (ops/kernels/cgs2.py smem_bytes): the
// ring of rows + pw staged rows of kCgs2Vectors 16-byte vectors, the
// update's partials (a row a warp and column) and the coefficients (rows x
// pw).
__host__ __device__ inline long long cgs2_smem_bytes(int rows, int pw,
                                                     int stages,
                                                     int itemsize) {
  const long long row = kCgs2Vectors * 16;
  return stages * (rows + pw) * row + kCgs2Warps * kCgs2Cols * row +
         (long long)rows * pw * itemsize;
}

// cp.async of BYTES (16: .cg, 4 or 8: .ca), zero-filled where `in` is
// false (nothing is read then).
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem,
                                               bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = in ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(gmem), "n"(BYTES), "r"(n)
                 : "memory");
}

// Waits until at most n of this thread's cp.async groups are open (n <=
// kCgs2MaxStages - 2).
__device__ __forceinline__ void cp_async_wait_open(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// One 16-byte vector (VEC = 16 / sizeof(T) elements) of shared memory.
template <typename T>
struct Cgs2Vec {
  static constexpr int VEC = 16 / sizeof(T);
  T v[VEC];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (sizeof(T) == 4) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
      const double2 d = *reinterpret_cast<const double2*>(p);
      v[0] = d.x;
      v[1] = d.y;
    }
  }

  __device__ __forceinline__ void store(T* p) const {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};

// Half of a warp's M sums of a[0..M-1] over the lane pairs lane, lane ^ o:
// a lane with bit o keeps the upper half, the other the lower, each adding
// its partner's copy, into a[0..M/2-1].  Five folds (o = 16 .. 1) leave
// lane L the warp's totals of entries (M / 32) L .. (M / 32) (L + 1) - 1.
template <typename T, int M>
__device__ __forceinline__ void cgs2_fold(T* a, int lane, int o) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const bool up = lane & o;
    const T send = up ? a[i] : a[i + M / 2];
    const T keep = up ? a[i + M / 2] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

// One pass of the schedule over `rows` basis rows q (rows, S) and w (p,
// S).  UPDATE kinds: out = w - coeff^T q (coeff rows x p; out may be w).
// GRAM kinds: gram = q x^T (rows x p), x = w, or out for UPDATE_GRAM;
// partial holds gridDim.x * rows * p, and ticket is 0 at launch and again
// when the kernel ends.  pw = p rounded up to kCgs2Cols, slices =
// kCgs2Warps / (pw / kCgs2Cols), rows <= slices x cgs2_slice_rows<T>().
// Shared memory holds 16-byte vectors either way; ALIGNED (every row
// 16-byte aligned) copies a vector at once, else element by element.
template <typename T, bool ALIGNED, int KIND>
__global__ void __launch_bounds__(kCgs2Threads, 1)
    cgs2_kernel(const T* __restrict__ q, int rows, const T* w, int p, int pw,
                int slices, long long S, int stages,
                const T* __restrict__ coeff, T* out,
                T* __restrict__ partial, unsigned* __restrict__ ticket,
                T* __restrict__ gram) {
  constexpr bool kUpdate = KIND != kCgs2Gram, kGram = KIND != kCgs2Update;
  constexpr int VEC = Cgs2Vec<T>::VEC;
  constexpr int RS = kCgs2Vectors * VEC;  // elements of a staged row
  constexpr int SR = cgs2_slice_rows<T>();
  // all of it dynamic: a static byte would exceed the opt-in maximum that
  // allow_shared_memory grants the dynamic part
  extern __shared__ __align__(16) unsigned char cgs2_smem[];
  T* ring = reinterpret_cast<T*>(cgs2_smem);
  const int slot_elems = (rows + pw) * RS;
  T* red = ring + stages * slot_elems;  // [slice][pw][RS]
  T* cf = red + kCgs2Warps * kCgs2Cols * RS;  // [rows][pw]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int quads = pw / kCgs2Cols;
  // warp (jq, ks); at three quads (p = 9..12) the last warp only stages
  const int jq = warp % quads, ks = warp / quads;
  const int kps = ks < slices && ks < rows ? (rows - ks + slices - 1) / slices : 0;

  // this block's tiles: a contiguous run of n from t0 (handing them out
  // block by block in turn ran no faster; PERF.md)
  const long long ntiles = (S + RS - 1) / RS;
  const long long t0 = ntiles * blockIdx.x / gridDim.x;
  const int n = (int)(ntiles * (blockIdx.x + 1) / gridDim.x - t0);

  // rows p..pw-1 of every slot stay zero; the coefficients, zero past p
  for (int s = 0; s < stages; ++s)
    for (int i = threadIdx.x; i < (pw - p) * RS; i += kCgs2Threads)
      ring[s * slot_elems + (rows + p) * RS + i] = T(0);
  if constexpr (kUpdate)
    for (int i = threadIdx.x; i < rows * pw; i += kCgs2Threads) {
      const int k = i / pw, j = i % pw;
      cf[i] = j < p ? coeff[k * p + j] : T(0);
    }

  // tile t into slot s: this thread copies vector `lane` of rows warp,
  // warp + kCgs2Warps, ... of q, and of w's row `warp`
  auto stage = [&](long long t, int s) {
    T* dst = ring + s * slot_elems + warp * RS + lane * VEC;
    const long long e = t * RS + lane * VEC;
    auto copy = [&](T* d, const T* src) {
      if constexpr (ALIGNED) {
        cp_async_zfill<16>(d, src + (e < S ? e : 0), e < S);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          cp_async_zfill<sizeof(T)>(d + i, src + (e + i < S ? e + i : 0),
                                    e + i < S);
      }
    };
    const T* src = q + warp * S;
    for (int r = warp; r < rows; r += kCgs2Warps) {
      copy(dst, src);
      dst += kCgs2Warps * RS;
      src += kCgs2Warps * S;
    }
    if (warp < p) copy(ring + s * slot_elems + (rows + warp) * RS + lane * VEC, w + warp * S);
  };

  // the Gram: each thread's sums over its vector of 32 tiles at most
  // (acc), folded over the warp's lanes into the lanes' totals (tot, entry
  // (NA / 32) lane + r of acc), so no sum runs over more than 32 tiles
  constexpr int NA = SR * kCgs2Cols;
  T acc[SR][kCgs2Cols], tot[NA / 32];
#pragma unroll
  for (int kk = 0; kk < SR; ++kk)
#pragma unroll
    for (int j = 0; j < kCgs2Cols; ++j) acc[kk][j] = T(0);
#pragma unroll
  for (int r = 0; r < NA / 32; ++r) tot[r] = T(0);
  auto fold = [&] {
    T* a = &acc[0][0];
    cgs2_fold<T, NA>(a, lane, 16);
    cgs2_fold<T, NA / 2>(a, lane, 8);
    cgs2_fold<T, NA / 4>(a, lane, 4);
    cgs2_fold<T, NA / 8>(a, lane, 2);
    cgs2_fold<T, NA / 16>(a, lane, 1);
#pragma unroll
    for (int r = 0; r < NA / 32; ++r) tot[r] += a[r];
#pragma unroll
    for (int i = 0; i < NA; ++i) a[i] = T(0);
  };

  for (int s = 0; s + 1 < stages; ++s) {
    if (s < n) stage(t0 + s, s);
    cp_async_commit();  // one group a tile, empty past the run
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait_open(stages - 2);  // tile i's copies have landed
    // every thread is done with tile i - 1: its slot takes tile i +
    // stages - 1, and the partials are free
    __syncthreads();
    if (i + stages - 1 < n) stage(t0 + i + stages - 1, (i + stages - 1) % stages);
    cp_async_commit();
    const T* slot = ring + (i % stages) * slot_elems;
    T* ws = ring + (i % stages) * slot_elems + rows * RS;
    const T* qk = slot + ks * RS + lane * VEC;  // row ks + kk slices: + kk * qstep
    const int qstep = slices * RS;
    if constexpr (kUpdate) {
      T part[kCgs2Cols][VEC];
#pragma unroll
      for (int j = 0; j < kCgs2Cols; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) part[j][e] = T(0);
#pragma unroll
      for (int kk = 0; kk < SR; ++kk) {
        if (kk == kps) break;  // a warp-uniform exit: no test past kps
        Cgs2Vec<T> qv;
        qv.load(qk + kk * qstep);
        T c[kCgs2Cols];
        lds4(cf + (ks + kk * slices) * pw + jq * kCgs2Cols, c);
#pragma unroll
        for (int j = 0; j < kCgs2Cols; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) part[j][e] = fma(c[j], qv.v[e], part[j][e]);
      }
      if (ks < slices) {
#pragma unroll
        for (int j = 0; j < kCgs2Cols; ++j) {
          Cgs2Vec<T> pv;
#pragma unroll
          for (int e = 0; e < VEC; ++e) pv.v[e] = part[j][e];
          pv.store(red + (ks * pw + jq * kCgs2Cols + j) * RS + lane * VEC);
        }
      }
      __syncthreads();
      // the slices' partials in slice order; w - their sum, out and (B)
      // the tile's w rows
      const long long tile = t0 + i;
      for (int o = threadIdx.x; o < p * kCgs2Vectors; o += kCgs2Threads) {
        const int j = o / kCgs2Vectors, v = o % kCgs2Vectors;
        Cgs2Vec<T> sum, x;
        sum.load(red + j * RS + v * VEC);
        for (int z0 = 1; z0 < slices; z0 += 4) {
          Cgs2Vec<T> y[4];  // four loads in flight, then added in order
#pragma unroll
          for (int z = 0; z < 4; ++z)
            if (z0 + z < slices) y[z].load(red + ((z0 + z) * pw + j) * RS + v * VEC);
#pragma unroll
          for (int z = 0; z < 4; ++z)
            if (z0 + z < slices)
#pragma unroll
              for (int e = 0; e < VEC; ++e) sum.v[e] += y[z].v[e];
        }
        x.load(ws + j * RS + v * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) x.v[e] -= sum.v[e];
        const long long e0 = tile * RS + v * VEC;
        T* dst = out + j * S + e0;
        if constexpr (ALIGNED) {
          if (e0 < S) x.store(dst);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            if (e0 + e < S) dst[e] = x.v[e];
        }
        if constexpr (kGram) x.store(ws + j * RS + v * VEC);
      }
      if constexpr (kGram) __syncthreads();
    }
    if constexpr (kGram) {
      T x[kCgs2Cols][VEC];
#pragma unroll
      for (int j = 0; j < kCgs2Cols; ++j) {
        Cgs2Vec<T> xv;
        xv.load(ws + (jq * kCgs2Cols + j) * RS + lane * VEC);
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[j][e] = xv.v[e];
      }
#pragma unroll
      for (int kk = 0; kk < SR; ++kk) {
        if (kk == kps) break;
        Cgs2Vec<T> qv;
        qv.load(qk + kk * qstep);
        // the vector's products summed apart, then added: the running sum
        // takes one add a tile
#pragma unroll
        for (int j = 0; j < kCgs2Cols; ++j) {
          T t = qv.v[0] * x[j][0];
#pragma unroll
          for (int e = 1; e < VEC; ++e) t = fma(qv.v[e], x[j][e], t);
          acc[kk][j] += t;
        }
      }
      if ((i & 31) == 31) fold();
    }
  }
  cp_async_wait<0>();  // only empty groups can still be open
  if constexpr (kGram) {
    fold();  // the last tiles; lane L holds entries (NA / 32) L + r
    const int nout = rows * p;
    T* part = partial + (long long)blockIdx.x * nout;
#pragma unroll
    for (int r = 0; r < NA / 32; ++r) {
      const int f = NA / 32 * lane + r, kk = f / kCgs2Cols;
      const int j = jq * kCgs2Cols + f % kCgs2Cols;
      if (kk < kps && j < p) part[(ks + kk * slices) * p + j] = tot[r];
    }
    // the last block to finish adds every block's partials in block order,
    // sixteen blocks at a time (its flag in the partials' shared memory,
    // which no thread reads any more)
    unsigned* last = reinterpret_cast<unsigned*>(red);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!*last) return;
    for (int o = threadIdx.x; o < nout; o += kCgs2Threads) {
      T s = T(0);
      for (unsigned b0 = 0; b0 < gridDim.x; b0 += 16) {
        T y[16];  // sixteen loads in flight, then their sum in order
#pragma unroll
        for (int b = 0; b < 16; ++b)
          y[b] = b0 + b < gridDim.x ? __ldcg(partial + (long long)(b0 + b) * nout + o) : T(0);
        T t = y[0];
#pragma unroll
        for (int b = 1; b < 16; ++b) t += y[b];
        s += t;
      }
      gram[o] = s;
    }
    if (threadIdx.x == 0) *ticket = 0u;
  }
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
                    const StripArgs& a, bool curl, dim3 grid, size_t smem,
                    cudaStream_t st) {
    const int err = prepare();
    if (err) return err;
    if constexpr (kAddInput)
      kernel()<<<grid, kThreads, smem, st>>>(
          static_cast<const T*>(u), static_cast<T*>(out),
          static_cast<const W*>(wz), static_cast<const W*>(wp), a);
    else
      kernel()<<<grid, kThreads, smem, st>>>(
          static_cast<const T*>(u), static_cast<T*>(out),
          static_cast<const W*>(wz), static_cast<const W*>(wp), a, (int)curl);
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
  const bool curl = curl_taps(unpack_taps(taps));
  return lpt == 1 ? Strip<T, W, kAddInput, 1>::launch(u, out, wz, wp, a, curl,
                                                      grid, smem, st)
                  : Strip<T, W, kAddInput, 2>::launch(u, out, wz, wp, a, curl,
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

// The rows of a K2 call start on 16-byte boundaries, as a V > 1 launch
// needs (block_dense.mix_vector_width): every operand's and out's pointer
// is aligned, and so is a row of S elements unless each holds one row.
template <typename T>
bool mix_rows_aligned(const void* x0, int p0, const void* x1, int p1,
                      const void* x2, int p2, const void* out, int p_out,
                      long long S) {
  const void* ptrs[4] = {x0, x1, x2, out};
  const int rows[4] = {p0, p1, p2, p_out};
  bool one_row = true;
  for (int i = 0; i < 4; ++i) {
    if (rows[i] && reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    one_row = one_row && rows[i] <= 1;
  }
  return one_row || S * (long long)sizeof(T) % 16 == 0;
}

template <typename T, typename W, int K, int PO, int V>
int mix_fixed_launch(const MixRows<T>& rows, const void* coeffs, void* out,
                     long long S, int nblocks, cudaStream_t st) {
  block_mix_fixed_kernel<T, W, K, PO, V><<<nblocks, kThreads, 0, st>>>(
      rows, static_cast<const W*>(coeffs), static_cast<T*>(out), S);
  return finish();
}

// The fixed instantiation of (K, p_out) (block_dense.MIX_SHAPES), V
// positions a thread; another shape is refused.
template <typename T, typename W, int V>
int mix_fixed(int K, int p_out, const MixRows<T>& rows, const void* coeffs,
              void* out, long long S, int nblocks, cudaStream_t st) {
  if (p_out == 4 && K == 12)
    return mix_fixed_launch<T, W, 12, 4, V>(rows, coeffs, out, S, nblocks, st);
  if (p_out == 4 && K == 8)
    return mix_fixed_launch<T, W, 8, 4, V>(rows, coeffs, out, S, nblocks, st);
  if (p_out == 4 && K == 4)
    return mix_fixed_launch<T, W, 4, 4, V>(rows, coeffs, out, S, nblocks, st);
  if (p_out == 1 && K == 3)
    return mix_fixed_launch<T, W, 3, 1, V>(rows, coeffs, out, S, nblocks, st);
  if (p_out == 1 && K == 2)
    return mix_fixed_launch<T, W, 2, 1, V>(rows, coeffs, out, S, nblocks, st);
  if (p_out == 1 && K == 1)
    return mix_fixed_launch<T, W, 1, 1, V>(rows, coeffs, out, S, nblocks, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename W, int MAXPO, int V>
int mix_generic(const void* x0, int p0, const void* x1, int p1,
                const void* x2, int p2, const void* coeffs, void* out,
                int p_out, long long S, int nblocks, cudaStream_t st) {
  const size_t smem = sizeof(W) * (size_t)(p0 + p1 + p2) * p_out;
  block_mix_kernel<T, W, MAXPO, V><<<nblocks, kThreads, smem, st>>>(
      static_cast<const T*>(x0), p0, static_cast<const T*>(x1), p1,
      static_cast<const T*>(x2), p2, static_cast<const W*>(coeffs),
      static_cast<T*>(out), p_out, S);
  return finish();
}

// K2 as the wrapper picks it (block_dense.block_mix): the fixed
// instantiation or the generic kernel (`fixed`), `vec` positions a thread,
// `nblocks` blocks.
template <typename T, typename W = T>
int block_mix(const void* x0, int p0, const void* x1, int p1, const void* x2,
              int p2, const void* coeffs, void* out, int p_out, long long S,
              int fixed, int vec, int nblocks, cudaStream_t st) {
  constexpr int kVec = sizeof(T) == 8 ? 1 : 16 / (int)sizeof(T);
  const int bad = (int)cudaErrorInvalidValue;
  const int K = p0 + p1 + p2;
  if (p0 < 0 || p1 < 0 || p2 < 0 || K < 1 || p_out < 1 || S < 1 ||
      nblocks < 1 ||
      (vec != 1 && vec != kVec) ||
      (vec > 1 && !mix_rows_aligned<T>(x0, p0, x1, p1, x2, p2, out, p_out, S)))
    return bad;
  if (fixed) {
    if (K > kMixMaxK) return bad;
    MixRows<T> rows{};
    for (int k = 0; k < K; ++k)
      rows.x[k] = k < p0 ? static_cast<const T*>(x0) + (long long)k * S
                  : k < p0 + p1
                      ? static_cast<const T*>(x1) + (long long)(k - p0) * S
                      : static_cast<const T*>(x2) + (long long)(k - p0 - p1) * S;
    return vec == 1 ? mix_fixed<T, W, 1>(K, p_out, rows, coeffs, out, S,
                                         nblocks, st)
                    : mix_fixed<T, W, kVec>(K, p_out, rows, coeffs, out, S,
                                            nblocks, st);
  }
  if (vec > 1) {
    if (p_out <= 4)
      return mix_generic<T, W, 4, kVec>(x0, p0, x1, p1, x2, p2, coeffs, out,
                                        p_out, S, nblocks, st);
    if (p_out <= kMixVecMaxPOut)
      return mix_generic<T, W, kMixVecMaxPOut, kVec>(
          x0, p0, x1, p1, x2, p2, coeffs, out, p_out, S, nblocks, st);
    return bad;
  }
  if (p_out <= 4)
    return mix_generic<T, W, 4, 1>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out,
                                   S, nblocks, st);
  if (p_out <= 8)
    return mix_generic<T, W, 8, 1>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out,
                                   S, nblocks, st);
  if (p_out <= 16)
    return mix_generic<T, W, 16, 1>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out,
                                    S, nblocks, st);
  if (p_out <= 32)
    return mix_generic<T, W, 32, 1>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out,
                                    S, nblocks, st);
  return bad;
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

// S1's launch plan (ops/kernels/smalleig.py `sqrtm_plan`): one thread an
// element of the padded pp x pp matrix up to kSqrtmMaxThreads, in whole
// warps; shared memory for a, next, V (pp^2 each), J's diagonal and
// off-diagonal and the pair partners (pp each).
inline int sqrtm_threads(int pp) {
  const int warps = (pp * pp + 31) / 32 * 32;
  return warps < kSqrtmMaxThreads ? warps : kSqrtmMaxThreads;
}

template <typename T>
long long sqrtm_smem_bytes(int pp) {
  return (3LL * pp * pp + 2LL * pp) * (long long)sizeof(T) +
         (long long)pp * (long long)sizeof(int);
}

template <typename T>
int sqrtm_invsqrtm(const void* a, void* sq, void* inv, int batch, int p,
                   int sweeps, double breakdown_eps, int threads, int smem,
                   cudaStream_t st) {
  const int pp = p + (p & 1);
  if (p < 1 || p > kSqrtmMaxP || batch < 1 || sweeps < 0 ||
      threads != sqrtm_threads(pp) || smem != sqrtm_smem_bytes<T>(pp))
    return (int)cudaErrorInvalidValue;
  static unsigned long long configured = 0;  // devices, one bit each
  const int err = allow_shared_memory(jacobi_sqrtm_kernel<T>, configured);
  if (err) return err;
  jacobi_sqrtm_kernel<T><<<batch, threads, smem, st>>>(
      static_cast<const T*>(a), static_cast<T*>(sq), static_cast<T*>(inv), p,
      sweeps, breakdown_eps);
  return finish();
}

// T1's tree (ops/kernels/tsqr.py `tsqr_plan`): levels[0] = n rows, then
// each R stack's rows, ceil(levels[l] / tile) * p, down to the root's,
// which one tile holds; rechecked here.  The stacks lie one after another
// in `work`.  QR passes up the tree, the root, then (q not null) apply
// passes down it, the last writing q.
template <typename T, int W>
int tsqr_tree(const T* x, T* q, T* r, T* work, const long long* levels,
              int nlevels, int p, int tile, cudaStream_t st) {
  constexpr int S = tsqr_slots<T, W>();
  if (p < 1 || p > W || tile < 2 * p || tile > S * kTsqrThreads ||
      nlevels < 1 || nlevels > kTsqrMaxLevels || levels[0] < p ||
      levels[nlevels - 1] > tile)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l + 1 < nlevels; ++l)
    if (levels[l] <= tile || levels[l + 1] != (levels[l] + tile - 1) / tile * p)
      return (int)cudaErrorInvalidValue;
  const int h = nlevels - 1;
  T* stack[kTsqrMaxLevels];  // stack[l], l >= 1: level l's input
  long long off = 0;
  for (int l = 1; l <= h; ++l) {
    stack[l] = work + off;
    off += (long long)p * levels[l];
  }
  auto input = [&](int l) -> const T* { return l ? stack[l] : x; };
  auto blocks = [&](int l) { return (unsigned)((levels[l] + tile - 1) / tile); };
  for (int l = 0; l < h; ++l) {
    tsqr_tile_kernel<T, W, false><<<blocks(l), kTsqrThreads, 0, st>>>(
        input(l), levels[l], stack[l + 1], levels[l + 1], nullptr, 0, nullptr,
        tile, p);
    const int err = finish();
    if (err) return err;
  }
  T* root_q = q == nullptr ? nullptr : h ? stack[h] : q;
  tsqr_tile_kernel<T, W, true><<<1, kTsqrThreads, 0, st>>>(
      input(h), levels[h], root_q, levels[h], nullptr, 0, r, tile, p);
  int err = finish();
  for (int l = h - 1; q != nullptr && l >= 0 && !err; --l) {
    tsqr_tile_kernel<T, W, true><<<blocks(l), kTsqrThreads, 0, st>>>(
        input(l), levels[l], l ? stack[l] : q, levels[l], stack[l + 1],
        levels[l + 1], nullptr, tile, p);
    err = finish();
  }
  return err;
}

template <typename T>
int tsqr_width(const void* x, void* q, void* r, void* work,
               const long long* levels, int nlevels, int p, int width,
               int tile, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T *qt = static_cast<T*>(q), *rt = static_cast<T*>(r);
  T* wt = static_cast<T*>(work);
  switch (width) {
    case 4:
      return tsqr_tree<T, 4>(xt, qt, rt, wt, levels, nlevels, p, tile, st);
    case 8:
      return tsqr_tree<T, 8>(xt, qt, rt, wt, levels, nlevels, p, tile, st);
    case 16:
      return tsqr_tree<T, 16>(xt, qt, rt, wt, levels, nlevels, p, tile, st);
  }
  return (int)cudaErrorInvalidValue;
}

// One C1 pass: its shared-memory attributes set once per device, then the
// launch.
template <typename T, bool ALIGNED, int KIND>
int cgs2_go(const T* q, int rows, const T* w, int p, int pw, int slices,
            long long S, int stages, long long smem, const T* coeff, T* out,
            T* partial, int nblocks, unsigned* ticket, T* gram,
            cudaStream_t st) {
  static unsigned long long prepared = 0;
  const auto kernel = cgs2_kernel<T, ALIGNED, KIND>;
  const int err = allow_shared_memory(kernel, prepared);
  if (err) return err;
  kernel<<<nblocks, kCgs2Threads, (size_t)smem, st>>>(
      q, rows, w, p, pw, slices, S, stages, coeff, out, partial, ticket, gram);
  return finish();
}

// C1's plan (ops/kernels/cgs2.py cgs2_plan), rechecked: pw is p rounded
// up to kCgs2Cols, slices = kCgs2Warps / (pw / kCgs2Cols), at most slices
// x cgs2_slice_rows<T>() rows, 2..kCgs2MaxStages stages, and `smem` holds
// the ring, the partials and the coefficients.
template <typename T, bool ALIGNED>
int cgs2_pass(int kind, const void* q, int rows, const void* w, int p,
              void* out, const void* coeff, void* gram, void* partial,
              int nblocks, void* ticket, long long S, int pw, int slices,
              int stages, long long smem, cudaStream_t st) {
  if (p < 1 || p > kCgs2MaxP ||
      pw != (p + kCgs2Cols - 1) / kCgs2Cols * kCgs2Cols ||
      slices != kCgs2Warps / (pw / kCgs2Cols) || rows < 1 ||
      rows > slices * cgs2_slice_rows<T>() || S < 1 ||
      (ALIGNED && S % (16 / (long long)sizeof(T))) || stages < 2 ||
      stages > kCgs2MaxStages || nblocks < 1 ||
      cgs2_smem_bytes(rows, pw, stages, sizeof(T)) > smem)
    return (int)cudaErrorInvalidValue;
  const T* qt = static_cast<const T*>(q);
  const T* wt = static_cast<const T*>(w);
  const T* ct = static_cast<const T*>(coeff);
  T *ot = static_cast<T*>(out), *gt = static_cast<T*>(gram);
  T* pt = static_cast<T*>(partial);
  unsigned* tk = static_cast<unsigned*>(ticket);
  switch (kind) {
    case kCgs2Gram:
      return cgs2_go<T, ALIGNED, kCgs2Gram>(qt, rows, wt, p, pw, slices, S,
                                            stages, smem, ct, ot, pt, nblocks,
                                            tk, gt, st);
    case kCgs2Update:
      return cgs2_go<T, ALIGNED, kCgs2Update>(qt, rows, wt, p, pw, slices, S,
                                              stages, smem, ct, ot, pt,
                                              nblocks, tk, gt, st);
    case kCgs2UpdateGram:
      return cgs2_go<T, ALIGNED, kCgs2UpdateGram>(qt, rows, wt, p, pw, slices,
                                                  S, stages, smem, ct, ot, pt,
                                                  nblocks, tk, gt, st);
  }
  return (int)cudaErrorInvalidValue;
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
                 int p_out, long long S, int fixed, int vec, int nblocks,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return block_mix<float>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out, S,
                              fixed, vec, nblocks, st);
    case kF64:
      return block_mix<double>(x0, p0, x1, p1, x2, p2, coeffs, out, p_out, S,
                               fixed, vec, nblocks, st);
    case kBF16:
      return block_mix<bf16, float>(x0, p0, x1, p1, x2, p2, coeffs, out,
                                    p_out, S, fixed, vec, nblocks, st);
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

// S1: (sqrtm, pinv-sqrtm) of `batch` contiguous p x p symmetric matrices
// of type dtype (0, 1 or 2: bf16 matrices, f32 arithmetic rounded to bf16
// at every op), `sweeps` Jacobi sweeps; breakdown_eps > 0 zeroes the
// inverse's eigenvalues under breakdown_eps * max |w|.  threads and smem
// are the wrapper's plan, rechecked here.
int lt_sqrtm_invsqrtm(int dtype, const void* a, void* sq, void* inv,
                      int batch, int p, int sweeps, double breakdown_eps,
                      int threads, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return sqrtm_invsqrtm<float>(a, sq, inv, batch, p, sweeps,
                                   breakdown_eps, threads, smem, st);
    case kF64:
      return sqrtm_invsqrtm<double>(a, sq, inv, batch, p, sweeps,
                                    breakdown_eps, threads, smem, st);
    case kBF16:
      return sqrtm_invsqrtm<bf16>(a, sq, inv, batch, p, sweeps,
                                  breakdown_eps, threads, smem, st);
  }
  return kBadType;
}

// T1: (q, r) of the block-major (p, levels[0]) block x of type dtype (0
// or 1): q (p, n) block-major with orthonormal rows (null: R alone), r
// (p x p, row-major) upper triangular with a non-negative diagonal;
// `work` holds the R stacks.  width, tile and the levels are the
// wrapper's plan, rechecked here.
int lt_tsqr(int dtype, const void* x, void* q, void* r, void* work,
            const long long* levels, int nlevels, int p, int width, int tile,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return tsqr_width<float>(x, q, r, work, levels, nlevels, p, width,
                               tile, st);
    case kF64:
      return tsqr_width<double>(x, q, r, work, levels, nlevels, p, width,
                                tile, st);
  }
  return kBadType;
}

// C1: one pass of CGS2 (kind 0 the Gram, 1 the update, 2 both) over the
// `rows` basis rows q (rows, S) and the block w (p, S) of type dtype (0
// or 1): gram = q w^T (rows x p); out = w - coeff^T q (out may be w);
// kind 2 writes out and gram = q out^T.  aligned (every row starts on a
// 16-byte boundary), pw, slices, stages, smem and the grid (nblocks, with
// partial's nblocks x rows x p) are the wrapper's plan, rechecked here;
// ticket is K3's word for this stream.
int lt_cgs2(int dtype, int kind, const void* q, int rows, const void* w,
            int p, void* out, const void* coeff, void* gram, void* partial,
            int nblocks, void* ticket, long long S, int aligned, int pw,
            int slices, int stages, long long smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && aligned)
    return cgs2_pass<float, true>(kind, q, rows, w, p, out, coeff, gram,
                                  partial, nblocks, ticket, S, pw, slices,
                                  stages, smem, st);
  if (dtype == kF32)
    return cgs2_pass<float, false>(kind, q, rows, w, p, out, coeff, gram,
                                   partial, nblocks, ticket, S, pw, slices,
                                   stages, smem, st);
  if (dtype == kF64 && aligned)
    return cgs2_pass<double, true>(kind, q, rows, w, p, out, coeff, gram,
                                   partial, nblocks, ticket, S, pw, slices,
                                   stages, smem, st);
  if (dtype == kF64)
    return cgs2_pass<double, false>(kind, q, rows, w, p, out, coeff, gram,
                                    partial, nblocks, ticket, S, pw, slices,
                                    stages, smem, st);
  return kBadType;
}

// Blocks of the Gram kernel an SM holds, the grid's cap per SM
// (build.gram_grid_cap).
int lt_gram_blocks_per_sm() { return kGramBlocksPerSM; }

// Blocks of K2 an SM holds, the grid's cap per SM (build.mix_grid_cap).
int lt_mix_blocks_per_sm() { return kMixBlocksPerSM; }

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
