// Native TIFF codec hot paths for nellie_tpu's IO layer.
//
// The reference delegates compressed-TIFF decoding to the imagecodecs
// C extensions (reference pyproject.toml:15-24).  This library provides
// the equivalent native implementations for nellie_tpu's self-contained
// codec (nellie_tpu/io/tiff.py): TIFF-variant LZW (MSB-first with early
// code change), PackBits, horizontal-predictor undo, and a
// multi-threaded batch strip decoder used by the streaming frame reader
// so host-side decode keeps up with device compute.
//
// Built with: g++ -O3 -std=c++17 -shared -fPIC -pthread
// Loaded via ctypes (no pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PackBits
// ---------------------------------------------------------------------------
// Returns number of bytes written, or -1 on overflow.
long long nellie_packbits_decode(const uint8_t* src, long long src_len,
                                 uint8_t* dst, long long dst_cap) {
    long long i = 0, o = 0;
    while (i < src_len) {
        uint8_t header = src[i++];
        if (header < 128) {
            long long count = header + 1;
            if (i + count > src_len || o + count > dst_cap) return -1;
            std::memcpy(dst + o, src + i, count);
            i += count;
            o += count;
        } else if (header > 128) {
            long long count = 257 - header;
            if (i >= src_len || o + count > dst_cap) return -1;
            std::memset(dst + o, src[i], count);
            i += 1;
            o += count;
        }
        // header == 128: no-op
    }
    return o;
}

// ---------------------------------------------------------------------------
// TIFF LZW (MSB-first bit packing, early code change, 9..12 bit codes)
// ---------------------------------------------------------------------------
// Table entries are stored as (prev_code, first_byte, last_byte, length)
// so decoding never allocates per-entry strings; output is materialised
// by walking the prefix chain backwards.
namespace {
struct LzwEntry {
    int32_t prev;     // previous code in chain, -1 for literals
    uint8_t first;    // first byte of the sequence
    uint8_t last;     // last byte of the sequence
    int32_t length;   // sequence length
};
}  // namespace

long long nellie_lzw_decode(const uint8_t* src, long long src_len,
                            uint8_t* dst, long long dst_cap) {
    constexpr int kClear = 256;
    constexpr int kEoi = 257;
    constexpr int kMaxEntries = 1 << 12;

    std::vector<LzwEntry> table(kMaxEntries);
    auto reset = [&]() {
        for (int i = 0; i < 256; ++i)
            table[i] = {-1, (uint8_t)i, (uint8_t)i, 1};
        return 258;
    };

    int next_code = reset();
    int nbits = 9;
    long long bitpos = 0;
    const long long total_bits = src_len * 8;
    long long out = 0;
    int prev = -1;

    auto emit = [&](int code) -> bool {
        int32_t len = table[code].length;
        if (out + len > dst_cap) return false;
        long long pos = out + len;
        int c = code;
        while (c >= 0) {
            dst[--pos] = table[c].last;
            c = table[c].prev;
        }
        out += len;
        return true;
    };

    while (bitpos + nbits <= total_bits) {
        long long byte_idx = bitpos >> 3;
        uint32_t window = 0;
        for (int k = 0; k < 4; ++k)
            window = (window << 8) | (byte_idx + k < src_len ? src[byte_idx + k] : 0);
        int shift = 32 - (int)(bitpos & 7) - nbits;
        int code = (window >> shift) & ((1 << nbits) - 1);
        bitpos += nbits;

        if (code == kEoi) break;
        if (code == kClear) {
            next_code = reset();
            nbits = 9;
            prev = -1;
            continue;
        }
        if (prev < 0) {
            if (code >= 256) return -1;
            if (!emit(code)) return -1;
        } else if (code < next_code) {
            if (!emit(code)) return -1;
            if (next_code < kMaxEntries) {
                table[next_code] = {prev, table[prev].first, table[code].first,
                                    table[prev].length + 1};
                ++next_code;
            }
        } else if (code == next_code && next_code < kMaxEntries) {
            table[next_code] = {prev, table[prev].first, table[prev].first,
                                table[prev].length + 1};
            ++next_code;
            if (!emit(code)) return -1;
        } else {
            return -1;  // corrupt stream
        }
        prev = code;
        // early code change: widen one code before the table fills
        if (next_code >= (1 << nbits) - 1 && nbits < 12) ++nbits;
    }
    return out;
}

// ---------------------------------------------------------------------------
// Horizontal predictor undo (TIFF predictor=2): per-row cumulative sum.
// ---------------------------------------------------------------------------
void nellie_undo_predictor(uint8_t* data, long long rows, long long cols,
                           long long samples, int itemsize) {
    const long long stride = cols * samples;
    if (itemsize == 1) {
        for (long long r = 0; r < rows; ++r) {
            uint8_t* row = data + r * stride;
            for (long long c = samples; c < stride; ++c) row[c] += row[c - samples];
        }
    } else if (itemsize == 2) {
        for (long long r = 0; r < rows; ++r) {
            uint16_t* row = reinterpret_cast<uint16_t*>(data) + r * stride;
            for (long long c = samples; c < stride; ++c) row[c] += row[c - samples];
        }
    } else if (itemsize == 4) {
        for (long long r = 0; r < rows; ++r) {
            uint32_t* row = reinterpret_cast<uint32_t*>(data) + r * stride;
            for (long long c = samples; c < stride; ++c) row[c] += row[c - samples];
        }
    }
}

// ---------------------------------------------------------------------------
// Multi-threaded batch strip decode.
// ---------------------------------------------------------------------------
// src: the whole file buffer (or a window); strips are (offset, length)
// pairs decoded into dst at dst_offsets.  compression: 1=none, 5=LZW,
// 32773=PackBits.  Returns 0 on success, index+1 of the first failing
// strip otherwise.
long long nellie_decode_strips(const uint8_t* src,
                               const long long* offsets,
                               const long long* lengths,
                               long long n_strips,
                               uint8_t* dst,
                               const long long* dst_offsets,
                               const long long* dst_lengths,
                               int compression,
                               int n_threads) {
    if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;

    std::vector<long long> failed(n_threads, 0);
    auto work = [&](int tid) {
        for (long long s = tid; s < n_strips; s += n_threads) {
            const uint8_t* sp = src + offsets[s];
            uint8_t* dp = dst + dst_offsets[s];
            long long produced;
            switch (compression) {
                case 1:
                    produced = lengths[s] <= dst_lengths[s] ? lengths[s] : -1;
                    if (produced > 0) std::memcpy(dp, sp, produced);
                    break;
                case 5:
                    produced = nellie_lzw_decode(sp, lengths[s], dp, dst_lengths[s]);
                    break;
                case 32773:
                    produced = nellie_packbits_decode(sp, lengths[s], dp, dst_lengths[s]);
                    break;
                default:
                    produced = -1;
            }
            if (produced < 0 && failed[tid] == 0) failed[tid] = s + 1;
        }
    };

    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& t : threads) t.join();
    for (int t = 0; t < n_threads; ++t)
        if (failed[t]) return failed[t];
    return 0;
}

}  // extern "C"
