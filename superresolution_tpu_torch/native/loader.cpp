// Native data-loader: minimal TIFF (grayscale 8/16-bit, uncompressed,
// striped) decode to float32 [0,1], with a std::thread batch API.
//
// This is the framework's native runtime tier for the input pipeline: the
// host-side decode cost of the 16-bit scientific TIFF pairs (the dataset
// format contract of the reference pipeline, written by
// scripts/Dataset_step4_normalization.py:159-184 and read by
// src/dataset.py:24-48) must never starve the accelerator. PIL costs a Python
// round-trip per image; this decoder runs lock-free across a thread pool
// and is exposed to Python via ctypes (superresolution_tpu_torch/data/
// native_io.py, which builds it at first use into
// superresolution_tpu_torch/_build/).
//
// The PyTorch port's own copy of superresolution_tpu/native/loader.cpp,
// unchanged but for this header.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp -o libsrloader.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Tiff {
    std::vector<uint8_t> buf;
    bool little = true;
    // set when any read touches bytes outside the buffer: every offset
    // here is FILE-SUPPLIED, so a corrupt/truncated TIFF must fail the
    // parse (rc<0 -> PIL fallback), never read out of bounds
    mutable bool bad = false;

    uint16_t u16(size_t off) const {
        if (off + 2 > buf.size()) { bad = true; return 0; }
        uint16_t v;
        std::memcpy(&v, buf.data() + off, 2);
        if (!little) v = (uint16_t)((v >> 8) | (v << 8));
        return v;
    }
    uint32_t u32(size_t off) const {
        if (off + 4 > buf.size()) { bad = true; return 0; }
        uint32_t v;
        std::memcpy(&v, buf.data() + off, 4);
        if (!little)
            v = ((v >> 24) & 0xff) | ((v >> 8) & 0xff00) |
                ((v << 8) & 0xff0000) | (v << 24);
        return v;
    }
};

struct Ifd {
    uint32_t width = 0, height = 0, bits = 0, compression = 1;
    uint32_t samples = 1, photometric = 1;
    std::vector<uint32_t> strip_offsets, strip_counts;
    uint32_t rows_per_strip = 0xffffffff;
};

// Reads one IFD entry's value array (SHORT or LONG).
static std::vector<uint32_t> read_values(const Tiff& t, uint16_t type,
                                         uint32_t count, size_t value_off) {
    std::vector<uint32_t> out;
    size_t elem = (type == 3) ? 2 : 4;
    size_t src = (count * elem <= 4) ? value_off : t.u32(value_off);
    if (src + (size_t)count * elem > t.buf.size()) {
        t.bad = true;
        return out;  // empty: the caller's parse fails cleanly
    }
    for (uint32_t i = 0; i < count; ++i) {
        out.push_back(type == 3 ? t.u16(src + i * 2) : t.u32(src + i * 4));
    }
    return out;
}

static uint32_t first_value(const Tiff& t, uint16_t type, size_t voff) {
    auto v = read_values(t, type, 1, voff);
    return v.empty() ? 0 : v[0];
}

static bool parse(const Tiff& t, Ifd& ifd) {
    if (t.buf.size() < 8) return false;
    size_t ifd_off = t.u32(4);
    if (ifd_off + 2 > t.buf.size()) return false;
    uint16_t n = t.u16(ifd_off);
    for (uint16_t i = 0; i < n; ++i) {
        size_t e = ifd_off + 2 + i * 12;
        if (e + 12 > t.buf.size()) return false;
        uint16_t tag = t.u16(e), type = t.u16(e + 2);
        uint32_t count = t.u32(e + 4);
        size_t voff = e + 8;
        switch (tag) {
            case 256: ifd.width = first_value(t, type, voff); break;
            case 257: ifd.height = first_value(t, type, voff); break;
            case 258: ifd.bits = first_value(t, type, voff); break;
            case 259: ifd.compression = first_value(t, type, voff); break;
            case 262: ifd.photometric = first_value(t, type, voff); break;
            case 273: ifd.strip_offsets = read_values(t, type, count, voff); break;
            case 277: ifd.samples = first_value(t, type, voff); break;
            case 278: ifd.rows_per_strip = first_value(t, type, voff); break;
            case 279: ifd.strip_counts = read_values(t, type, count, voff); break;
            default: break;
        }
    }
    // only single-sample grayscale (photometric 0/1) decodes correctly
    // here; anything else must return false so the caller falls back
    return !t.bad && ifd.width && ifd.height &&
           (ifd.bits == 8 || ifd.bits == 16) && ifd.compression == 1 &&
           ifd.samples == 1 && ifd.photometric <= 1 &&
           !ifd.strip_offsets.empty();
}

static bool load_file(const char* path, std::vector<uint8_t>& buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    if (sz < 0) {  // non-seekable (FIFO/device): not a TIFF file
        std::fclose(f);
        return false;
    }
    std::fseek(f, 0, SEEK_SET);
    buf.resize((size_t)sz);
    size_t got = std::fread(buf.data(), 1, (size_t)sz, f);
    std::fclose(f);
    return got == (size_t)sz;
}

// Decode one TIFF into out[h*w] float32 in [0,1]. Returns 0 on success,
// negative error codes otherwise. Checks out capacity via out_len.
static int decode_one(const char* path, float* out, int64_t out_len,
                      int64_t* h_out, int64_t* w_out) try {
    Tiff t;
    if (!load_file(path, t.buf)) return -1;
    if (t.buf.size() < 8) return -2;
    if (t.buf[0] == 'I' && t.buf[1] == 'I') t.little = true;
    else if (t.buf[0] == 'M' && t.buf[1] == 'M') t.little = false;
    else return -2;
    Ifd ifd;
    if (!parse(t, ifd)) return -3;
    int64_t total = (int64_t)ifd.width * ifd.height;
    if (total > out_len) return -4;

    const float inv = ifd.bits == 16 ? 1.0f / 65535.0f : 1.0f / 255.0f;
    size_t bytes_pp = ifd.bits / 8;
    size_t written = 0;
    for (size_t s = 0; s < ifd.strip_offsets.size(); ++s) {
        size_t off = ifd.strip_offsets[s];
        size_t cnt = s < ifd.strip_counts.size()
                         ? ifd.strip_counts[s]
                         : (size_t)total * bytes_pp - written * bytes_pp;
        if (off + cnt > t.buf.size()) return -5;
        size_t px = cnt / bytes_pp;
        for (size_t i = 0; i < px && written < (size_t)total; ++i, ++written) {
            float v;
            if (ifd.bits == 16) {
                uint16_t raw;
                std::memcpy(&raw, t.buf.data() + off + i * 2, 2);
                if (!t.little) raw = (uint16_t)((raw >> 8) | (raw << 8));
                v = raw * inv;
            } else {
                v = t.buf[off + i] * inv;
            }
            out[written] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
        }
    }
    if (written != (size_t)total) return -6;
    *h_out = ifd.height;
    *w_out = ifd.width;
    return 0;
} catch (...) {
    // e.g. bad_alloc on a huge declared size: an exception escaping onto
    // a batch worker thread would std::terminate the whole process
    return -7;
}

}  // namespace

extern "C" {

int srloader_decode(const char* path, float* out, int64_t out_len,
                    int64_t* h, int64_t* w) {
    return decode_one(path, out, out_len, h, w);
}

// Decode `n` files in parallel into a contiguous [n, max_len] buffer.
// status[i] = 0 ok; shapes in h[i], w[i].
int srloader_decode_batch(const char** paths, int64_t n, float* out,
                          int64_t max_len, int64_t* h, int64_t* w,
                          int32_t* status, int32_t num_threads) {
    if (num_threads < 1) num_threads = 1;
    std::vector<std::thread> pool;
    auto work = [&](int tid) {
        for (int64_t i = tid; i < n; i += num_threads) {
            status[i] = decode_one(paths[i], out + i * max_len, max_len,
                                   h + i, w + i);
        }
    };
    for (int32_t tdx = 0; tdx < num_threads; ++tdx) pool.emplace_back(work, tdx);
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
