// Native IO runtime of speedy_ml_tpu_torch (host C++, built with g++).
//
// The reference feeds its training loop through parallel NetCDF reads and
// Fortran direct-access record files (mod_io.f90, ini_inbcon.f90).  This
// library is the port's equivalent of that native IO layer: it keeps
// file decoding, latitude flipping, and per-region patch gathers off the
// Python interpreter (no GIL stalls while the card is being fed),
// with a std::thread pool for the gather fan-out.
//
// Exposed as a plain C ABI consumed through ctypes
// (speedy_ml_tpu_torch/runtime/native.py).  No external dependencies.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Read `count` float32 values at byte offset `offset` from `path`.
// Returns 0 on success, negative errno-style codes otherwise.
int read_f32(const char* path, int64_t offset_bytes, int64_t count,
             float* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, static_cast<long>(offset_bytes), SEEK_SET) != 0) {
        std::fclose(f);
        return -2;
    }
    size_t got = std::fread(out, sizeof(float), static_cast<size_t>(count), f);
    std::fclose(f);
    return got == static_cast<size_t>(count) ? 0 : -3;
}

// Read one boundary-field record group (ini_inbcon.f90 layout: nlat
// records of nlon little-endian float32, stored north->south) and return
// it as float64, south->north, with the <=-999 missing-value fix applied.
int read_boundary_field(const char* path, int64_t group, int64_t nlon,
                        int64_t nlat, double* out) {
    std::vector<float> buf(nlon * nlat);
    int rc = read_f32(path, group * nlon * nlat * 4, nlon * nlat, buf.data());
    if (rc != 0) return rc;
    for (int64_t j = 0; j < nlat; ++j) {
        const float* src = buf.data() + (nlat - 1 - j) * nlon;  // flip N->S
        double* dst = out + j * nlon;
        for (int64_t i = 0; i < nlon; ++i) {
            double v = static_cast<double>(src[i]);
            dst[i] = (v <= -999.0) ? 0.0 : v;
        }
    }
    return 0;
}

// Gather per-region patches from a global (nlat, nlon) float32 field:
//   out[r, jy, jx] = field[iy[r, jy], ix[r, jx]]
// iy: (R, ny), ix: (R, nx).  Threaded over regions.
int gather_patches(const float* field, int64_t nlat, int64_t nlon,
                   const int32_t* iy, const int32_t* ix, int64_t R,
                   int64_t ny, int64_t nx, float* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        for (;;) {
            int64_t r = next.fetch_add(1);
            if (r >= R) break;
            const int32_t* ry = iy + r * ny;
            const int32_t* rx = ix + r * nx;
            float* dst = out + r * ny * nx;
            for (int64_t j = 0; j < ny; ++j) {
                const float* row = field + static_cast<int64_t>(ry[j]) * nlon;
                for (int64_t i = 0; i < nx; ++i) {
                    dst[j * nx + i] = row[rx[i]];
                }
            }
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    return 0;
}

// Gather a full packed training series in one call:
//   fields: (T, nlat, nlon) float32, contiguous
//   out:    (T, R, ny*nx)
// Threaded over (T x R) work items.
int gather_series(const float* fields, int64_t T, int64_t nlat, int64_t nlon,
                  const int32_t* iy, const int32_t* ix, int64_t R,
                  int64_t ny, int64_t nx, float* out, int n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::atomic<int64_t> next(0);
    const int64_t total = T * R;
    auto worker = [&]() {
        for (;;) {
            int64_t w = next.fetch_add(1);
            if (w >= total) break;
            int64_t t = w / R;
            int64_t r = w % R;
            const float* field = fields + t * nlat * nlon;
            const int32_t* ry = iy + r * ny;
            const int32_t* rx = ix + r * nx;
            float* dst = out + (t * R + r) * ny * nx;
            for (int64_t j = 0; j < ny; ++j) {
                const float* row = field + static_cast<int64_t>(ry[j]) * nlon;
                for (int64_t i = 0; i < nx; ++i) {
                    dst[j * nx + i] = row[rx[i]];
                }
            }
        }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < n_threads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
