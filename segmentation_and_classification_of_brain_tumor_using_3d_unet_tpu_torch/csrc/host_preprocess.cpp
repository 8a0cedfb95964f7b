// Native host-side data path of the port (a copy of the JAX package's
// csrc/host_preprocess.cpp, kept apart so the port loads nothing of that
// package): NIfTI-1 decode (.nii/.nii.gz), trilinear and nearest
// resample, percentile clip + z-score, multithreaded with OpenMP.
//
// Exposed via a C ABI for ctypes (data/native.py). It is a host library,
// not a kernel: ops/native.py hashes and compiles only *.cu / *.cuh, so
// this file enters neither the CUDA library nor its build's name.
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -lz
//
// All volume buffers are float32 in NIfTI disk order (Fortran: x
// fastest); the Python wrapper reinterprets with order='F'.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kHdrSize = 348;

struct Header {
    int32_t sizeof_hdr;
    int16_t dim[8];
    int16_t datatype;
    int16_t bitpix;
    float pixdim[8];
    float vox_offset;
    float scl_slope;
    float scl_inter;
};

// max_bytes == 0 reads everything; a positive cap stops early (header
// -only shape queries need just kHdrSize bytes — inflating a whole
// .nii.gz twice per read doubled the decode cost on this 1-CPU host).
bool read_file(const char* path, std::vector<uint8_t>& out,
               size_t max_bytes = 0) {
    const size_t len = std::strlen(path);
    const bool gz = len > 3 && std::strcmp(path + len - 3, ".gz") == 0;
    if (gz) {
        // cap decompressed size: gzip expands up to ~1000x, so an
        // uploaded bomb could otherwise exhaust host memory (largest
        // legitimate volume is ~70 MB; 2 GB = 30x headroom)
        const size_t kMaxDecompressed = size_t(2) << 30;
        gzFile f = gzopen(path, "rb");
        if (!f) return false;
        gzbuffer(f, 1 << 20);
        out.clear();
        out.reserve(1 << 24);
        uint8_t buf[1 << 20];
        int n = 0;
        while ((n = gzread(f, buf, sizeof(buf))) > 0) {
            if (out.size() + size_t(n) > kMaxDecompressed) {
                gzclose(f);
                return false;
            }
            out.insert(out.end(), buf, buf + n);
            if (max_bytes && out.size() >= max_bytes) break;
        }
        gzclose(f);
        return n >= 0;
    }
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    if (sz < 0) {   // unseekable (FIFO etc.): resize(-1) would throw
        std::fclose(f);
        return false;
    }
    std::fseek(f, 0, SEEK_SET);
    size_t want = static_cast<size_t>(sz);
    if (max_bytes && want > max_bytes) want = max_bytes;
    out.resize(want);
    size_t got = std::fread(out.data(), 1, want, f);
    std::fclose(f);
    return got == want;
}

bool parse_header(const uint8_t* raw, size_t n, Header* h) {
    if (n < static_cast<size_t>(kHdrSize)) return false;
    std::memcpy(&h->sizeof_hdr, raw + 0, 4);
    if (h->sizeof_hdr != kHdrSize) return false;   // big-endian unsupported
    std::memcpy(h->dim, raw + 40, 16);
    std::memcpy(&h->datatype, raw + 70, 2);
    std::memcpy(&h->bitpix, raw + 72, 2);
    std::memcpy(h->pixdim, raw + 76, 32);
    std::memcpy(&h->vox_offset, raw + 108, 4);
    std::memcpy(&h->scl_slope, raw + 112, 4);
    std::memcpy(&h->scl_inter, raw + 116, 4);
    return std::memcmp(raw + 344, "n+1", 3) == 0 ||
           std::memcmp(raw + 344, "ni1", 3) == 0;
}

template <typename T>
void convert(const uint8_t* src, float* dst, int64_t n, float slope,
             float inter) {
    const T* s = reinterpret_cast<const T*>(src);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
        dst[i] = static_cast<float>(s[i]) * slope + inter;
}

}  // namespace

extern "C" {

// Reads shape into shape[0..2] (trailing dims collapsed into count
// check); returns voxel count, or -1 on error. Call once with out=null
// to query the shape, then again with a buffer.
int64_t nifti_read_f32(const char* path, float* out, int64_t out_cap,
                       int32_t* shape) try {
    std::vector<uint8_t> raw;
    // header-only read for the shape query (out == null)
    if (!read_file(path, raw, out ? 0 : static_cast<size_t>(kHdrSize)))
        return -1;
    Header h;
    if (!parse_header(raw.data(), raw.size(), &h)) return -1;
    int ndim = h.dim[0];
    if (ndim < 3 || ndim > 7) return -1;   // NIfTI-1: dim[0] in 1..7
    int64_t count = 1;
    for (int i = 0; i < 3; ++i) {
        if (h.dim[i + 1] < 1) return -1;   // corrupt/negative dims
        shape[i] = h.dim[i + 1];
        count *= shape[i];
    }
    for (int i = 4; i <= ndim; ++i)
        if (h.dim[i] > 1) return -2;   // >3D volumes unsupported here
    // element size from DATATYPE — bitpix is an independent header
    // field an attacker can shrink to sneak an undersized data section
    // past the bounds check and make convert<T> read out of bounds
    size_t esize;
    switch (h.datatype) {
        case 2: case 256:  esize = 1; break;
        case 4: case 512:  esize = 2; break;
        case 8: case 16:   esize = 4; break;
        case 64:           esize = 8; break;
        default:           return -5;
    }
    if (!out) return count;
    if (out_cap < count) return -3;

    // NIfTI-1: single-file ("n+1") data starts at vox_offset >= 352;
    // clamp smaller/fractional values to the header size so a lying
    // field can't alias header bytes as voxels (and so this matches
    // the Python codec exactly — found by tests/test_nifti_fuzz.py)
    size_t off = h.vox_offset >= static_cast<float>(kHdrSize)
                     ? static_cast<size_t>(h.vox_offset)
                     : kHdrSize;
    size_t need = off + static_cast<size_t>(count) * esize;
    if (raw.size() < need) return -4;
    const uint8_t* data = raw.data() + off;
    float slope = (h.scl_slope == 0.0f || h.scl_slope == 1.0f)
                      ? 1.0f : h.scl_slope;
    float inter = h.scl_inter;
    switch (h.datatype) {
        case 2:   convert<uint8_t>(data, out, count, slope, inter); break;
        case 4:   convert<int16_t>(data, out, count, slope, inter); break;
        case 8:   convert<int32_t>(data, out, count, slope, inter); break;
        case 16:  convert<float>(data, out, count, slope, inter); break;
        case 64:  convert<double>(data, out, count, slope, inter); break;
        case 256: convert<int8_t>(data, out, count, slope, inter); break;
        case 512: convert<uint16_t>(data, out, count, slope, inter); break;
        default:  return -5;
    }
    return count;
} catch (...) {
    // never let C++ exceptions (bad_alloc, length_error) cross the C
    // ABI into ctypes — that std::terminate()s the serving process
    return -1;
}

// Half-pixel-center trilinear resample, Fortran-order buffers.
void zoom_trilinear_f32(const float* in, int32_t ix, int32_t iy,
                        int32_t iz, float* out, int32_t ox, int32_t oy,
                        int32_t oz) {
    const float sx = static_cast<float>(ix) / ox;
    const float sy = static_cast<float>(iy) / oy;
    const float sz = static_cast<float>(iz) / oz;
    const int64_t ixy = static_cast<int64_t>(ix) * iy;
#pragma omp parallel for collapse(2) schedule(static)
    for (int z = 0; z < oz; ++z) {
        for (int y = 0; y < oy; ++y) {
            float fz = (z + 0.5f) * sz - 0.5f;
            float fy = (y + 0.5f) * sy - 0.5f;
            int z0 = static_cast<int>(std::floor(fz));
            int y0 = static_cast<int>(std::floor(fy));
            float wz = fz - z0, wy = fy - y0;
            int z0c = std::max(0, std::min(z0, iz - 1));
            int z1c = std::max(0, std::min(z0 + 1, iz - 1));
            int y0c = std::max(0, std::min(y0, iy - 1));
            int y1c = std::max(0, std::min(y0 + 1, iy - 1));
            float* dst = out + (static_cast<int64_t>(z) * oy + y) * ox;
            const float* p00 = in + z0c * ixy + y0c * ix;
            const float* p01 = in + z0c * ixy + y1c * ix;
            const float* p10 = in + z1c * ixy + y0c * ix;
            const float* p11 = in + z1c * ixy + y1c * ix;
            for (int x = 0; x < ox; ++x) {
                float fx = (x + 0.5f) * sx - 0.5f;
                int x0 = static_cast<int>(std::floor(fx));
                float wx = fx - x0;
                int x0c = std::max(0, std::min(x0, ix - 1));
                int x1c = std::max(0, std::min(x0 + 1, ix - 1));
                float v00 = p00[x0c] * (1 - wx) + p00[x1c] * wx;
                float v01 = p01[x0c] * (1 - wx) + p01[x1c] * wx;
                float v10 = p10[x0c] * (1 - wx) + p10[x1c] * wx;
                float v11 = p11[x0c] * (1 - wx) + p11[x1c] * wx;
                float v0 = v00 * (1 - wy) + v01 * wy;
                float v1 = v10 * (1 - wy) + v11 * wy;
                dst[x] = v0 * (1 - wz) + v1 * wz;
            }
        }
    }
}

// Nearest-neighbour resample (labels).
void zoom_nearest_f32(const float* in, int32_t ix, int32_t iy,
                      int32_t iz, float* out, int32_t ox, int32_t oy,
                      int32_t oz) {
    const float sx = static_cast<float>(ix) / ox;
    const float sy = static_cast<float>(iy) / oy;
    const float sz = static_cast<float>(iz) / oz;
    const int64_t ixy = static_cast<int64_t>(ix) * iy;
#pragma omp parallel for collapse(2) schedule(static)
    for (int z = 0; z < oz; ++z) {
        for (int y = 0; y < oy; ++y) {
            int zi = std::min(static_cast<int>((z + 0.5f) * sz), iz - 1);
            int yi = std::min(static_cast<int>((y + 0.5f) * sy), iy - 1);
            float* dst = out + (static_cast<int64_t>(z) * oy + y) * ox;
            const float* src = in + zi * ixy + yi * ix;
            for (int x = 0; x < ox; ++x) {
                int xi = std::min(static_cast<int>((x + 0.5f) * sx),
                                  ix - 1);
                dst[x] = src[xi];
            }
        }
    }
}

// In-place percentile clip (exact, via nth_element on a copy) then
// z-score ((x-mean)/(std+eps)); matches reference training.py:117-132.
// Returns 0 on success, nonzero when the buffer was left UNNORMALIZED
// (e.g. bad_alloc on the tmp copy) so the Python wrapper can fall back
// instead of trusting un-z-scored intensities.
int clip_zscore_f32(float* buf, int64_t n, float p_lo, float p_hi,
                    float eps) try {
    if (n <= 0) return 0;
    std::vector<float> tmp(buf, buf + n);
    // linear interpolation between adjacent order stats
    auto pct = [&](double q) {
        double idx = q / 100.0 * (n - 1);
        int64_t lo = static_cast<int64_t>(std::floor(idx));
        double w = idx - lo;
        std::nth_element(tmp.begin(), tmp.begin() + lo, tmp.end());
        float vlo = tmp[lo];
        if (w == 0.0 || lo + 1 >= n) return vlo;
        float vhi = *std::min_element(tmp.begin() + lo + 1, tmp.end());
        return static_cast<float>(vlo * (1.0 - w) + vhi * w);
    };
    float lo = pct(p_lo);
    float hi = pct(p_hi);
    double sum = 0.0, sumsq = 0.0;
#pragma omp parallel for reduction(+ : sum, sumsq) schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float v = std::min(std::max(buf[i], lo), hi);
        buf[i] = v;
        sum += v;
        sumsq += static_cast<double>(v) * v;
    }
    double mean = sum / n;
    double var = sumsq / n - mean * mean;
    float denom = static_cast<float>(std::sqrt(std::max(var, 0.0)) + eps);
    float m = static_cast<float>(mean);
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) buf[i] = (buf[i] - m) / denom;
    return 0;
} catch (...) {
    // bad_alloc on the tmp copy must not cross the C ABI; the buffer
    // may be partially clipped but is not z-scored — report failure
    return 1;
}

int host_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
