// Host-side assembly and packing engine of lanczos_tpu_torch.
//
// The port's own copy of the JAX package's C++ engine
// (lanczos_tpu/native/src/lanczos_native.cpp): the O(nnz) loops that fill
// the big host arrays of the assembled operators on all host cores, where
// the NumPy versions take seconds to minutes at the 10M-24.6M-row sizes.
//
//   ell_from_csr_{f32,f64}     CSR -> padded ELL (data, int32 columns)
//   halo_ell_from_csr_{f32,f64} CSR -> a row-sharded ELL whose columns are
//                              positions in each shard's halo window
//   window_pack_count          windowed-ELL planner, pass 1: planes/chunk
//   window_pack_fill_{f32,f64} windowed-ELL planner, pass 2: the planes
//   maxwell_ell_{f32,f64}      the Maxwell operator A = D diag(w) as ELL,
//                              straight from its separable taps
//
// Every output is bit-equal to the NumPy path it replaces
// (lanczos_tpu_torch/ops/formats.py `ell_from_scipy`,
// ops/window_ell.py `_pack_planes`); maxwell_ell puts each row's entries
// in the order scipy's canonical CSR of A has them (ascending columns,
// packed to the left), with values rounded once from the f64 product of
// the tap weights.  Built with g++ -O3 -pthread -shared -fPIC at first use
// and loaded through ctypes (lanczos_tpu_torch/native).
//
// The loops run on POSIX threads (`parallel_for`), not OpenMP, so that the
// engine builds with a g++ that ships no OpenMP runtime.  Every
// index writes its own outputs and the reductions are maxima, so the
// results do not depend on the thread count or the schedule.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <type_traits>
#include <vector>

#include <pthread.h>
#include <unistd.h>

namespace {

constexpr int64_t kLanes = 128;
// the most taps one output component may have (the Maxwell operator has 4)
constexpr int64_t kMaxTaps = 16;

// f(i) for i in [0, n), in chunks of `grain` indices handed out to one
// POSIX thread per online core (plain pthreads: nothing of the C++
// runtime's thread support, so the library loads beside any libstdc++)
template <typename F>
struct ForJob {
    F* f;
    int64_t n, grain;
    std::atomic<int64_t> next;

    void run() {
        for (;;) {
            const int64_t begin = next.fetch_add(grain);
            if (begin >= n) return;
            const int64_t end = std::min(n, begin + grain);
            for (int64_t i = begin; i < end; ++i) (*f)(i);
        }
    }

    static void* entry(void* job) {
        static_cast<ForJob*>(job)->run();
        return nullptr;
    }
};

template <typename F>
void parallel_for(int64_t n, int64_t grain, F&& f) {
    using Fn = std::remove_reference_t<F>;
    ForJob<Fn> job{&f, n, grain, {0}};
    const int64_t cores = std::max<int64_t>(1, sysconf(_SC_NPROCESSORS_ONLN));
    const int64_t workers = std::min<int64_t>({cores, (n + grain - 1) / grain, 256});
    std::vector<pthread_t> pool;
    for (int64_t t = 1; t < workers; ++t) {
        pthread_t th;
        if (pthread_create(&th, nullptr, &ForJob<Fn>::entry, &job) == 0)
            pool.push_back(th);  // a thread that fails to start leaves its share to the rest
    }
    job.run();
    for (pthread_t th : pool) pthread_join(th, nullptr);
}

inline void atomic_max(std::atomic<int64_t>& a, int64_t v) {
    int64_t cur = a.load();
    while (v > cur && !a.compare_exchange_weak(cur, v)) {
    }
}

template <typename T>
void ell_from_csr(int64_t n_rows, int64_t rows_pad, int64_t width,
                  const int64_t* indptr, const int64_t* indices,
                  const double* data, T* out_data, int32_t* out_idx) {
    parallel_for(rows_pad, 1 << 14, [&](int64_t i) {
        T* dst = out_data + i * width;
        int32_t* idx = out_idx + i * width;
        int64_t k = 0;
        if (i < n_rows) {
            for (int64_t j = indptr[i]; j < indptr[i + 1] && k < width; ++j, ++k) {
                dst[k] = static_cast<T>(data[j]);
                idx[k] = static_cast<int32_t>(indices[j]);
            }
        }
        for (; k < width; ++k) { dst[k] = T(0); idx[k] = 0; }
    });
}

// Rows [row0, row0 + rows_out) of the row-sharded halo ELL
// (lanczos_tpu_torch/parallel/dist_operator.py HaloShardedEll): row i of
// shard i / rows_loc holds its entries in CSR order with column c stored
// as c - base + halo, base = (i / rows_loc) rows_loc, its position in the
// shard's window [halo | rows_loc local rows | halo]; then pad entries,
// data 0 at position `halo`.  Rows at or past n_rows are all pad.
template <typename T>
void halo_ell_from_csr(int64_t n_rows, int64_t row0, int64_t rows_out,
                       int64_t width, int64_t rows_loc, int64_t halo,
                       const int64_t* indptr, const int64_t* indices,
                       const double* data, T* out_data, int32_t* out_idx) {
    parallel_for(rows_out, 1 << 14, [&](int64_t t) {
        const int64_t i = row0 + t;
        const int64_t base = (i / rows_loc) * rows_loc;
        T* dst = out_data + t * width;
        int32_t* idx = out_idx + t * width;
        int64_t k = 0;
        if (i < n_rows) {
            for (int64_t j = indptr[i]; j < indptr[i + 1] && k < width; ++j, ++k) {
                dst[k] = static_cast<T>(data[j]);
                idx[k] = static_cast<int32_t>(indices[j] - base + halo);
            }
        }
        for (; k < width; ++k) { dst[k] = T(0); idx[k] = static_cast<int32_t>(halo); }
    });
}

// ---------------------------------------------------------------------------
// Maxwell ELL straight from the taps.
//
// A tap t is (out_comp, in_comp, axis, offset) in tap_meta[4t..4t+3] and
// three 1-D weights over the OUTPUT component's extents, wz/wy/wx at
// w*_off[t] (the input column's weight folded in, as
// lanczos_tpu_torch.models.maxwell._build_taps makes them).  Component c
// has extents comp_shape[3c..3c+2] = (zl, yl, xl) and starts at row
// comp_off[c].  A row's entries are the taps of its component that land
// inside the input component with a nonzero weight, sorted by column.
// Returns 0, or 1 if a row holds more than `width` entries, 2 if a
// component has more than kMaxTaps taps.
// ---------------------------------------------------------------------------
template <typename T>
int maxwell_ell(int64_t n_rows, int64_t rows_pad, int64_t width,
                int64_t n_taps, int64_t n_comps, const int64_t* tap_meta,
                const double* wz, const int64_t* wz_off,
                const double* wy, const int64_t* wy_off,
                const double* wx, const int64_t* wx_off,
                const int64_t* comp_shape, const int64_t* comp_off,
                T* out_data, int32_t* out_idx) {
    std::atomic<int64_t> err(0);
    for (int64_t i = n_rows * width; i < rows_pad * width; ++i) {
        out_data[i] = T(0);
        out_idx[i] = 0;
    }
    for (int64_t oc = 0; oc < n_comps; ++oc) {
        int64_t taps[kMaxTaps];
        int64_t nt = 0;
        for (int64_t t = 0; t < n_taps; ++t) {
            if (tap_meta[4 * t] != oc) continue;
            if (nt == kMaxTaps) return 2;
            taps[nt++] = t;
        }
        const int64_t zl = comp_shape[3 * oc], yl = comp_shape[3 * oc + 1],
                      xl = comp_shape[3 * oc + 2];
        // one (z, y) line of x positions an index
        parallel_for(zl * yl, 64, [&](int64_t zy) {
            const int64_t z = zy / yl, y = zy % yl;
            for (int64_t x = 0; x < xl; ++x) {
                int64_t cols[kMaxTaps];
                double vals[kMaxTaps];
                int64_t cnt = 0;
                for (int64_t s = 0; s < nt; ++s) {
                    const int64_t t = taps[s];
                    const int64_t ic = tap_meta[4 * t + 1],
                                  ax = tap_meta[4 * t + 2],
                                  off = tap_meta[4 * t + 3];
                    int64_t iz = z, iy = y, ix = x;
                    if (ax == 0) iz += off;
                    else if (ax == 1) iy += off;
                    else ix += off;
                    const int64_t izl = comp_shape[3 * ic],
                                  iyl = comp_shape[3 * ic + 1],
                                  ixl = comp_shape[3 * ic + 2];
                    const double v = wz[wz_off[t] + z] * wy[wy_off[t] + y] *
                                     wx[wx_off[t] + x];
                    if (iz < 0 || iy < 0 || ix < 0 || iz >= izl ||
                        iy >= iyl || ix >= ixl || v == 0.0)
                        continue;
                    // insertion by column: a row has a handful of entries
                    const int64_t col = comp_off[ic] + (iz * iyl + iy) * ixl + ix;
                    int64_t k = cnt++;
                    for (; k > 0 && cols[k - 1] > col; --k) {
                        cols[k] = cols[k - 1];
                        vals[k] = vals[k - 1];
                    }
                    cols[k] = col;
                    vals[k] = v;
                }
                const int64_t row = comp_off[oc] + (z * yl + y) * xl + x;
                T* dst = out_data + row * width;
                int32_t* idx = out_idx + row * width;
                if (cnt > width) {
                    atomic_max(err, 1);
                    cnt = width;
                }
                int64_t k = 0;
                for (; k < cnt; ++k) {
                    dst[k] = static_cast<T>(vals[k]);
                    idx[k] = static_cast<int32_t>(cols[k]);
                }
                for (; k < width; ++k) { dst[k] = T(0); idx[k] = 0; }
            }
        });
    }
    return static_cast<int>(err.load());
}

// ---------------------------------------------------------------------------
// Windowed-ELL plane packing (the planner of
// lanczos_tpu_torch.ops.window_ell._pack_planes, bit-compatible).
//
// Two passes over the CSR matrix, parallel over 128-row chunks:
//   pass 1 (window_pack_count): per-chunk plane count -> the caller takes
//     the max as ppc, checks its cap and allocates (C, ppc, 128) outputs;
//   pass 2 (window_pack_fill_*): fill planes_{data,lidx,fabs}.
// A plane holds at most one nonzero per lane (row % 128), all of whose
// column indices fall in one 256-element, 128-aligned window; the k-th
// nonzeros of a chunk are split into groups by a stable-sorted greedy
// scan over their 128-block ids (the NumPy planner's grouping).
// ---------------------------------------------------------------------------

struct LaneF { int64_t f; int32_t lane; };

// the groups of the k-th nonzeros of a chunk: `emit(group, count, f_base)`
// for each.  cols[lane] is the column of the lane's k-th nonzero, or -1.
template <typename Emit>
inline void for_each_group(const int64_t* cols, Emit&& emit) {
    LaneF buf[kLanes];
    int cnt = 0;
    int64_t fmin = INT64_MAX, fmax = -1;
    for (int32_t l = 0; l < kLanes; ++l) {
        if (cols[l] < 0) continue;
        const int64_t f = cols[l] >> 7;
        buf[cnt++] = {f, l};
        fmin = std::min(fmin, f);
        fmax = std::max(fmax, f);
    }
    if (!cnt) return;
    if (fmax <= fmin + 1) {  // one window: lanes stay in lane order
        emit(buf, cnt, fmin);
        return;
    }
    std::stable_sort(buf, buf + cnt,
                     [](const LaneF& a, const LaneF& b) { return a.f < b.f; });
    int start = 0;
    while (start < cnt) {
        const int64_t base = buf[start].f;
        int end = start;
        while (end < cnt && buf[end].f <= base + 1) ++end;
        emit(buf + start, end - start, base);
        start = end;
    }
}

// cols[lane] of the k-th nonzero of each lane of the chunk at row r0
inline void gather_k(const int64_t* indptr, const int64_t* indices,
                     int64_t n_rows, int64_t r0, int64_t k, int64_t* cols) {
    for (int64_t l = 0; l < kLanes; ++l) {
        const int64_t r = r0 + l;
        cols[l] = (r < n_rows && indptr[r] + k < indptr[r + 1])
                      ? indices[indptr[r] + k] : -1;
    }
}

inline int64_t chunk_width(const int64_t* indptr, int64_t n_rows, int64_t r0) {
    int64_t w = 0;
    for (int64_t l = 0; l < kLanes && r0 + l < n_rows; ++l)
        w = std::max(w, indptr[r0 + l + 1] - indptr[r0 + l]);
    return w;
}

template <typename T>
void window_pack_fill(int64_t n_rows, int64_t ppc, const int64_t* indptr,
                      const int64_t* indices, const T* data, T* planes_dat,
                      int32_t* planes_lidx, int64_t* planes_fabs) {
    const int64_t n_chunks = (n_rows + kLanes - 1) / kLanes;
    parallel_for(n_chunks, 8, [&](int64_t c) {
        T* dat = planes_dat + c * ppc * kLanes;
        int32_t* lid = planes_lidx + c * ppc * kLanes;
        int64_t* fab = planes_fabs + c * ppc;
        for (int64_t i = 0; i < ppc * kLanes; ++i) { dat[i] = T(0); lid[i] = 0; }
        for (int64_t i = 0; i < ppc; ++i) fab[i] = -1;

        const int64_t r0 = c * kLanes;
        const int64_t width_c = chunk_width(indptr, n_rows, r0);
        int64_t slot = 0;
        int64_t cols[kLanes];
        for (int64_t k = 0; k < width_c; ++k) {
            gather_k(indptr, indices, n_rows, r0, k, cols);
            for_each_group(cols, [&](const LaneF* g, int n, int64_t fa) {
                fab[slot] = fa;
                for (int i = 0; i < n; ++i) {
                    const int32_t l = g[i].lane;
                    dat[slot * kLanes + l] = data[indptr[r0 + l] + k];
                    lid[slot * kLanes + l] = static_cast<int32_t>(cols[l] - (fa << 7));
                }
                ++slot;
            });
        }
    });
}

}  // namespace

extern "C" {

void ell_from_csr_f32(int64_t n_rows, int64_t rows_pad, int64_t width,
                      const int64_t* indptr, const int64_t* indices,
                      const double* data, float* out_data, int32_t* out_idx) {
    ell_from_csr<float>(n_rows, rows_pad, width, indptr, indices, data,
                        out_data, out_idx);
}

void ell_from_csr_f64(int64_t n_rows, int64_t rows_pad, int64_t width,
                      const int64_t* indptr, const int64_t* indices,
                      const double* data, double* out_data, int32_t* out_idx) {
    ell_from_csr<double>(n_rows, rows_pad, width, indptr, indices, data,
                         out_data, out_idx);
}

void halo_ell_from_csr_f32(int64_t n_rows, int64_t row0, int64_t rows_out,
                           int64_t width, int64_t rows_loc, int64_t halo,
                           const int64_t* indptr, const int64_t* indices,
                           const double* data, float* out_data, int32_t* out_idx) {
    halo_ell_from_csr<float>(n_rows, row0, rows_out, width, rows_loc, halo,
                             indptr, indices, data, out_data, out_idx);
}

void halo_ell_from_csr_f64(int64_t n_rows, int64_t row0, int64_t rows_out,
                           int64_t width, int64_t rows_loc, int64_t halo,
                           const int64_t* indptr, const int64_t* indices,
                           const double* data, double* out_data, int32_t* out_idx) {
    halo_ell_from_csr<double>(n_rows, row0, rows_out, width, rows_loc, halo,
                              indptr, indices, data, out_data, out_idx);
}

int maxwell_ell_f32(int64_t n_rows, int64_t rows_pad, int64_t width,
                    int64_t n_taps, int64_t n_comps, const int64_t* tap_meta,
                    const double* wz, const int64_t* wz_off,
                    const double* wy, const int64_t* wy_off,
                    const double* wx, const int64_t* wx_off,
                    const int64_t* comp_shape, const int64_t* comp_off,
                    float* out_data, int32_t* out_idx) {
    return maxwell_ell<float>(n_rows, rows_pad, width, n_taps, n_comps, tap_meta,
                              wz, wz_off, wy, wy_off, wx, wx_off, comp_shape,
                              comp_off, out_data, out_idx);
}

int maxwell_ell_f64(int64_t n_rows, int64_t rows_pad, int64_t width,
                    int64_t n_taps, int64_t n_comps, const int64_t* tap_meta,
                    const double* wz, const int64_t* wz_off,
                    const double* wy, const int64_t* wy_off,
                    const double* wx, const int64_t* wx_off,
                    const int64_t* comp_shape, const int64_t* comp_off,
                    double* out_data, int32_t* out_idx) {
    return maxwell_ell<double>(n_rows, rows_pad, width, n_taps, n_comps, tap_meta,
                               wz, wz_off, wy, wy_off, wx, wx_off, comp_shape,
                               comp_off, out_data, out_idx);
}

// pass 1: the most planes any chunk needs (the caller's ppc)
int64_t window_pack_count(int64_t n_rows, const int64_t* indptr,
                          const int64_t* indices) {
    const int64_t n_chunks = (n_rows + kLanes - 1) / kLanes;
    std::atomic<int64_t> ppc(0);
    parallel_for(n_chunks, 8, [&](int64_t c) {
        const int64_t r0 = c * kLanes;
        const int64_t width_c = chunk_width(indptr, n_rows, r0);
        int64_t slots = 0;
        int64_t cols[kLanes];
        for (int64_t k = 0; k < width_c; ++k) {
            gather_k(indptr, indices, n_rows, r0, k, cols);
            for_each_group(cols, [&](const LaneF*, int, int64_t) { ++slots; });
        }
        atomic_max(ppc, slots);
    });
    return ppc.load();
}

void window_pack_fill_f32(int64_t n_rows, int64_t ppc, const int64_t* indptr,
                          const int64_t* indices, const float* data,
                          float* planes_dat, int32_t* planes_lidx,
                          int64_t* planes_fabs) {
    window_pack_fill<float>(n_rows, ppc, indptr, indices, data, planes_dat,
                            planes_lidx, planes_fabs);
}

void window_pack_fill_f64(int64_t n_rows, int64_t ppc, const int64_t* indptr,
                          const int64_t* indices, const double* data,
                          double* planes_dat, int32_t* planes_lidx,
                          int64_t* planes_fabs) {
    window_pack_fill<double>(n_rows, ppc, indptr, indices, data, planes_dat,
                             planes_lidx, planes_fabs);
}

}  // extern "C"
