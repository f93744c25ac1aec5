// A copy of nic/native/rans.cpp for nic_torch: built with g++ at first
// use by nic_torch/native/__init__.py into build/nic_torch/<key>/.
//
// rANS entropy coder (host-side bitstream I/O for the hyperprior codec).
//
// The reference repo has no entropy coding at all (fixed-length num_bits
// quantization only — SURVEY.md §0); the north star calls for
// "hyperprior entropy-model likelihood/rate-loss ... with bitstream I/O
// kept host-side". This is that bitstream layer: a 32-bit rANS coder with
// 16-bit quantized CDFs (scale_bits = 16), byte-wise renormalization
// (state lower bound 1<<23), encoding in reverse symbol order so decode
// streams forward. Symbols are indices into per-element CDF rows selected
// by a bin index (scale bins for y under N(0,σ); one bin per channel for
// the factorized z prior).
//
// API (extern "C", ctypes-bound):
//   nic_rans_encode(symbols, bins, n, cdf, cdf_len, max_sym, out, out_cap)
//     → bytes written (or -1 if out_cap too small / symbol out of range)
//   nic_rans_decode(bytes, n_bytes, bins, n, cdf, cdf_len, max_sym, out)
//     → 0 on success
//
// cdf layout: int32 [n_bins, max_sym + 1], row b monotonically increasing
// from 0 to 1<<16; symbol s of bin b spans [cdf[b][s], cdf[b][s+1]).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;  // renorm lower bound
}  // namespace

extern "C" {

int64_t nic_rans_encode(const int32_t* symbols, const int32_t* bins,
                        int64_t n, const int32_t* cdf, int64_t cdf_cols,
                        uint8_t* out, int64_t out_cap) {
    std::vector<uint8_t> buf;
    buf.reserve(static_cast<size_t>(n) * 2 + 16);
    uint32_t x = kRansL;
    // encode in reverse so the decoder reads symbols forward
    for (int64_t i = n - 1; i >= 0; --i) {
        const int32_t* row = cdf + static_cast<int64_t>(bins[i]) * cdf_cols;
        const int32_t s = symbols[i];
        if (s < 0 || s + 1 >= cdf_cols) return -1;
        const uint32_t start = static_cast<uint32_t>(row[s]);
        const uint32_t freq = static_cast<uint32_t>(row[s + 1]) - start;
        if (freq == 0) return -1;
        // renorm: keep x < ((L >> prob_bits) << 8) * freq
        const uint32_t x_max = ((kRansL >> kProbBits) << 8) * freq;
        while (x >= x_max) {
            buf.push_back(static_cast<uint8_t>(x & 0xff));
            x >>= 8;
        }
        x = ((x / freq) << kProbBits) + (x % freq) + start;
    }
    // flush state (little-endian, 4 bytes)
    for (int k = 0; k < 4; ++k) {
        buf.push_back(static_cast<uint8_t>(x & 0xff));
        x >>= 8;
    }
    const int64_t total = static_cast<int64_t>(buf.size());
    if (total > out_cap) return -1;
    // bytes were produced backwards; reverse into out
    for (int64_t i = 0; i < total; ++i) out[i] = buf[total - 1 - i];
    return total;
}

int nic_rans_decode(const uint8_t* bytes, int64_t n_bytes,
                    const int32_t* bins, int64_t n, const int32_t* cdf,
                    int64_t cdf_cols, int32_t* out) {
    int64_t pos = 0;
    auto rd = [&]() -> uint32_t {
        return pos < n_bytes ? bytes[pos++] : 0u;
    };
    // state was flushed little-endian then the whole buffer reversed, so
    // the stream starts with the state bytes most-significant first
    uint32_t x = 0;
    for (int k = 0; k < 4; ++k) x = (x << 8) | rd();
    const uint32_t mask = kProbScale - 1;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t* row = cdf + static_cast<int64_t>(bins[i]) * cdf_cols;
        const uint32_t cum = x & mask;
        // binary search: largest s with row[s] <= cum
        int32_t lo = 0, hi = static_cast<int32_t>(cdf_cols) - 1;
        while (hi - lo > 1) {
            const int32_t mid = (lo + hi) / 2;
            if (static_cast<uint32_t>(row[mid]) <= cum) lo = mid;
            else hi = mid;
        }
        const int32_t s = lo;
        const uint32_t start = static_cast<uint32_t>(row[s]);
        const uint32_t freq = static_cast<uint32_t>(row[s + 1]) - start;
        out[i] = s;
        x = freq * (x >> kProbBits) + cum - start;
        while (x < kRansL) x = (x << 8) | rd();
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Interleaved word-renormalized rANS (stream format 2).
//
// Format-1 (above) is a single scalar state with byte renormalization —
// every decoded symbol is a serial dependency on the previous one, which
// caps host decode at ~10 Msym/s. Format-2 splits symbols round-robin
// across L independent states (lane l owns symbols i ≡ l mod L), giving
// the CPU L independent dependency chains to pipeline, and renormalizes
// 16 bits at a time so each symbol does at most ONE stream read:
//   state x ∈ [2^16, 2^32); encode emits one u16 iff x ≥ freq·2^16;
//   decode refills one u16 iff x < 2^16.  (prob_bits = 16.)
// Lane streams are stored back-to-back; per-lane byte lengths live in the
// Python-side header (nic/native/__init__.py prepends b"NR2\x01").
//
// Decode symbol lookup: either a branchless binary search over the CDF row
// (no mispredict stalls; the row fits in L1) or an optional dense
// cum→symbol table (one load per symbol) built by nic_rans_build_lut —
// the Python wrapper caches the table per CDF and uses it when the symbol
// count amortizes the build.
// ---------------------------------------------------------------------------

namespace {
constexpr uint32_t kWordL = 1u << 16;  // word-renorm lower bound

// branchless "largest s with row[s] <= cum"; rows are monotone with
// row[0] = 0 and row[cols-1] = 2^16, so the probe never reads past the row.
inline int32_t find_symbol(const int32_t* row, int32_t cols, uint32_t cum) {
    int32_t lo = 0;
    int32_t n = cols - 1;  // number of symbols
    // classic meta-binary search over [0, n)
    for (int32_t step = 1 << (31 - __builtin_clz(static_cast<uint32_t>(n)));
         step > 0; step >>= 1) {
        int32_t cand = lo + step;
        if (cand < n && static_cast<uint32_t>(row[cand]) <= cum) lo = cand;
    }
    return lo;
}

template <int LANES>
int decode_ilv_body(const uint8_t* bytes, const int64_t* lane_off,
                    const int32_t* bins, int64_t n, const int32_t* cdf,
                    int64_t cdf_cols, const uint16_t* lut, int32_t* out) {
    uint32_t x[LANES];
    const uint8_t* p[LANES];
    const uint8_t* pend[LANES];
    for (int l = 0; l < LANES; ++l) {
        p[l] = bytes + lane_off[l];
        pend[l] = bytes + lane_off[l + 1];
        // state flushed as two u16 words, most-significant first
        uint32_t hi = static_cast<uint32_t>(p[l][0]) |
                      (static_cast<uint32_t>(p[l][1]) << 8);
        uint32_t lo = static_cast<uint32_t>(p[l][2]) |
                      (static_cast<uint32_t>(p[l][3]) << 8);
        x[l] = (hi << 16) | lo;
        p[l] += 4;
    }
    const int64_t body = n - (n % LANES);
    for (int64_t i = 0; i < body; i += LANES) {
#if defined(__GNUC__)
#pragma GCC unroll 16
#endif
        for (int l = 0; l < LANES; ++l) {
            const int64_t b = bins[i + l];
            const uint32_t cum = x[l] & 0xffffu;
            int32_t s;
            if (lut) {
                s = lut[(b << 16) | cum];
            } else {
                s = find_symbol(cdf + b * cdf_cols, static_cast<int32_t>(cdf_cols), cum);
            }
            const int32_t* row = cdf + b * cdf_cols;
            const uint32_t start = static_cast<uint32_t>(row[s]);
            const uint32_t freq = static_cast<uint32_t>(row[s + 1]) - start;
            out[i + l] = s;
            x[l] = freq * (x[l] >> 16) + cum - start;
            if (x[l] < kWordL) {
                uint32_t w = 0;
                if (p[l] + 1 < pend[l]) {
                    w = static_cast<uint32_t>(p[l][0]) |
                        (static_cast<uint32_t>(p[l][1]) << 8);
                    p[l] += 2;
                }
                x[l] = (x[l] << 16) | w;
            }
        }
    }
    for (int64_t i = body; i < n; ++i) {
        const int l = static_cast<int>(i - body);
        const int64_t b = bins[i];
        const uint32_t cum = x[l] & 0xffffu;
        const int32_t* row = cdf + b * cdf_cols;
        const int32_t s = lut ? lut[(b << 16) | cum]
                              : find_symbol(row, static_cast<int32_t>(cdf_cols), cum);
        const uint32_t start = static_cast<uint32_t>(row[s]);
        const uint32_t freq = static_cast<uint32_t>(row[s + 1]) - start;
        out[i] = s;
        x[l] = freq * (x[l] >> 16) + cum - start;
        if (x[l] < kWordL) {
            uint32_t w = 0;
            if (p[l] + 1 < pend[l]) {
                w = static_cast<uint32_t>(p[l][0]) |
                    (static_cast<uint32_t>(p[l][1]) << 8);
                p[l] += 2;
            }
            x[l] = (x[l] << 16) | w;
        }
    }
    return 0;
}
}  // namespace

extern "C" {

// Dense cum→symbol table: lut[b * 2^16 + c] = symbol s of bin b whose CDF
// span contains c. uint16 is enough (alphabets here are ≤ a few hundred).
void nic_rans_build_lut(const int32_t* cdf, int64_t n_bins, int64_t cdf_cols,
                        uint16_t* lut) {
    for (int64_t b = 0; b < n_bins; ++b) {
        const int32_t* row = cdf + b * cdf_cols;
        uint16_t* dst = lut + (b << 16);
        for (int64_t s = 0; s + 1 < cdf_cols; ++s) {
            const int32_t lo = row[s], hi = row[s + 1];
            for (int32_t c = lo; c < hi; ++c) dst[c] = static_cast<uint16_t>(s);
        }
    }
}

// Encode n symbols over `lanes` interleaved states. Writes the lane streams
// back-to-back into `out` and the per-lane byte counts into lane_lens.
// Returns total bytes (or -1 on overflow / bad symbol).
int64_t nic_rans_encode_ilv(const int32_t* symbols, const int32_t* bins,
                            int64_t n, const int32_t* cdf, int64_t cdf_cols,
                            int32_t lanes, uint8_t* out, int64_t out_cap,
                            int64_t* lane_lens) {
    if (lanes < 1 || lanes > 64) return -1;
    // Single reverse pass: symbol i belongs to lane i % lanes, and within a
    // lane the global reverse order IS the lane's reverse order — so one
    // streaming pass over symbols/bins (cache-friendly) feeds all `lanes`
    // independent states (pipelinable: consecutive symbols hit different
    // states). Emitted words are buffered per lane, then written out in
    // decode order (reversed).
    std::vector<std::vector<uint16_t>> bufs(lanes);
    const int64_t reserve = n / (lanes > 0 ? lanes : 1) / 2 + 16;
    for (auto& b : bufs) b.reserve(static_cast<size_t>(reserve));
    std::vector<uint32_t> x(lanes, kWordL);
    for (int64_t i = n - 1; i >= 0; --i) {
        const int32_t l = static_cast<int32_t>(i % lanes);
        const int32_t* row = cdf + static_cast<int64_t>(bins[i]) * cdf_cols;
        const int32_t s = symbols[i];
        if (s < 0 || s + 1 >= cdf_cols) return -1;
        const uint32_t start = static_cast<uint32_t>(row[s]);
        const uint32_t freq = static_cast<uint32_t>(row[s + 1]) - start;
        if (freq == 0) return -1;
        uint32_t xl = x[l];
        if (xl >= (freq << 16)) {  // at most one word out per symbol
            bufs[l].push_back(static_cast<uint16_t>(xl & 0xffffu));
            xl >>= 16;
        }
        x[l] = ((xl / freq) << 16) + (xl % freq) + start;
    }
    int64_t total = 0;
    for (int32_t l = 0; l < lanes; ++l) {
        const auto& buf = bufs[l];
        const int64_t lane_bytes = 4 + static_cast<int64_t>(buf.size()) * 2;
        if (total + lane_bytes > out_cap) return -1;
        uint8_t* dst = out + total;
        // state first (two u16, most-significant first), then the words in
        // decode order (reverse of emission order), all little-endian u16
        const uint32_t xl = x[l];
        dst[0] = static_cast<uint8_t>((xl >> 16) & 0xff);
        dst[1] = static_cast<uint8_t>((xl >> 24) & 0xff);
        dst[2] = static_cast<uint8_t>(xl & 0xff);
        dst[3] = static_cast<uint8_t>((xl >> 8) & 0xff);
        dst += 4;
        for (int64_t k = static_cast<int64_t>(buf.size()) - 1; k >= 0; --k) {
            *dst++ = static_cast<uint8_t>(buf[k] & 0xff);
            *dst++ = static_cast<uint8_t>(buf[k] >> 8);
        }
        lane_lens[l] = lane_bytes;
        total += lane_bytes;
    }
    return total;
}

// lane_off: lanes+1 byte offsets into `bytes` (prefix sums of lane_lens).
// lut may be NULL (branchless binary search per symbol instead).
int nic_rans_decode_ilv(const uint8_t* bytes, const int64_t* lane_off,
                        int32_t lanes, const int32_t* bins, int64_t n,
                        const int32_t* cdf, int64_t cdf_cols,
                        const uint16_t* lut, int32_t* out) {
    switch (lanes) {
        case 4:  return decode_ilv_body<4>(bytes, lane_off, bins, n, cdf, cdf_cols, lut, out);
        case 8:  return decode_ilv_body<8>(bytes, lane_off, bins, n, cdf, cdf_cols, lut, out);
        case 16: return decode_ilv_body<16>(bytes, lane_off, bins, n, cdf, cdf_cols, lut, out);
        default: break;
    }
    // generic lane count: correct but unpipelined
    std::vector<int64_t> off(lane_off, lane_off + lanes + 1);
    std::vector<uint32_t> x(lanes);
    std::vector<const uint8_t*> p(lanes), pe(lanes);
    for (int32_t l = 0; l < lanes; ++l) {
        p[l] = bytes + off[l];
        pe[l] = bytes + off[l + 1];
        uint32_t hi = p[l][0] | (static_cast<uint32_t>(p[l][1]) << 8);
        uint32_t lo = p[l][2] | (static_cast<uint32_t>(p[l][3]) << 8);
        x[l] = (hi << 16) | lo;
        p[l] += 4;
    }
    for (int64_t i = 0; i < n; ++i) {
        const int32_t l = static_cast<int32_t>(i % lanes);
        const int64_t b = bins[i];
        const uint32_t cum = x[l] & 0xffffu;
        const int32_t* row = cdf + b * cdf_cols;
        const int32_t s = lut ? lut[(b << 16) | cum]
                              : find_symbol(row, static_cast<int32_t>(cdf_cols), cum);
        const uint32_t start = static_cast<uint32_t>(row[s]);
        const uint32_t freq = static_cast<uint32_t>(row[s + 1]) - start;
        out[i] = s;
        x[l] = freq * (x[l] >> 16) + cum - start;
        if (x[l] < kWordL) {
            uint32_t w = 0;
            if (p[l] + 1 < pe[l]) {
                w = static_cast<uint32_t>(p[l][0]) |
                    (static_cast<uint32_t>(p[l][1]) << 8);
                p[l] += 2;
            }
            x[l] = (x[l] << 16) | w;
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Stream format 3: 16-lane SINGLE-STREAM word rANS, decodable with AVX-512.
//
// Format 2's per-lane streams give the CPU independent dependency chains,
// but refill still advances 8 separate pointers — unvectorizable. Format 3
// uses the classic SIMD-rANS construction (one shared u16 word stream,
// lanes refill from it in lane order within each 16-symbol batch), so the
// whole decode step vectorizes over one zmm of states:
//   cum   = x & 0xffff                        (vpandd)
//   s     = lut[(bin << 16) | cum]            (one vpgatherdd, u16 table)
//   start = cdf[bin*cols + s], freq = next-start   (two vpgatherdd)
//   x     = freq * (x >> 16) + cum - start    (vpmulld/vpsrld/…)
//   m     = x < 2^16                          (vpcmpltud → k-mask)
//   x     = m ? (x << 16) | expand(words, m) : x   (vpexpandd — consecutive
//           stream words distribute to refilling lanes in lane order)
//   ptr  += 2·popcount(m)
// The ENCODER (scalar, reverse symbol order) emits at most one u16 per
// symbol into one buffer and reverses it once at the end — rANS's
// encode/decode duality makes that byte order exactly the decoder's
// consumption order (batches ascending, lanes ascending within a batch;
// the n%16 tail decodes scalar after the batches and encodes first).
//
// Payload layout (after the Python-side b"NR3\x01" + u8 lanes header):
//   u32le state[16]  |  u16le words...  |  32 zero pad bytes
// (the pad keeps the decoder's unconditional 32-byte word loads in
// bounds; refills past the real stream read zeros, same as format 2).
// ---------------------------------------------------------------------------

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {
// 64 lanes = 4 independent 16-lane zmm groups: one vector of rANS states
// is a SERIAL dependency chain across batches (the state update's gather+
// mullo latency, ~150 cycles, would bound throughput); four groups give
// the OoO core four chains to overlap. All groups share ONE word stream —
// within a 64-symbol batch, groups refill in group order, lanes in lane
// order (the encoder's reverse pass + final buffer reversal reproduces
// exactly this consumption order).
constexpr int kLanes3 = 64;
constexpr int kGroup3 = 16;
constexpr int64_t kPad3 = 32 * 4;

// scalar reference decode of the format-3 stream (also the tail handler
// and the no-AVX512 fallback)
int decode3_scalar(const uint8_t* bytes, int64_t n_bytes,
                   const int32_t* bins, int64_t i0, int64_t n,
                   const int32_t* cdf, int64_t cdf_cols,
                   const uint16_t* lut, int32_t shift, uint32_t* x,
                   const uint8_t** pp, const uint8_t* pend, int32_t* out) {
    (void)bytes; (void)n_bytes;
    const uint8_t* p = *pp;
    for (int64_t i = i0; i < n; ++i) {
        const int l = static_cast<int>((i - i0) % kLanes3);
        const int64_t b = bins[i];
        const uint32_t cum = x[l] & 0xffffu;
        const int32_t* row = cdf + b * cdf_cols;
        int32_t s;
        if (lut) {
            s = lut[(b << (16 - shift)) | (cum >> shift)];
            while (s + 2 < cdf_cols &&
                   static_cast<uint32_t>(row[s + 1]) <= cum) ++s;
        } else {
            s = find_symbol(row, static_cast<int32_t>(cdf_cols), cum);
        }
        const uint32_t start = static_cast<uint32_t>(row[s]);
        const uint32_t freq = static_cast<uint32_t>(row[s + 1]) - start;
        out[i] = s;
        x[l] = freq * (x[l] >> 16) + cum - start;
        if (x[l] < kWordL) {
            uint32_t w = 0;
            if (p + 1 < pend) {
                w = static_cast<uint32_t>(p[0]) |
                    (static_cast<uint32_t>(p[1]) << 8);
            }
            p += 2;
            x[l] = (x[l] << 16) | w;
        }
    }
    *pp = p;
    return 0;
}

#if defined(__x86_64__)
__attribute__((target("avx512f,avx512bw,avx512vl,avx512dq,popcnt")))
int64_t decode3_avx512(const int32_t* bins, int64_t body, const int32_t* cdf,
                       int64_t cdf_cols, const uint16_t* lut, int32_t shift,
                       uint32_t* xs, const uint8_t** pp,
                       const uint8_t* pend, int32_t* out) {
    constexpr int NG = kLanes3 / kGroup3;  // 4 zmm groups
    __m512i x[NG];
    for (int g = 0; g < NG; ++g)
        x[g] = _mm512_loadu_si512(
            reinterpret_cast<const void*>(xs + g * kGroup3));
    const __m512i m16 = _mm512_set1_epi32(0xffff);
    const __m512i cols = _mm512_set1_epi32(static_cast<int32_t>(cdf_cols));
    const __m512i one = _mm512_set1_epi32(1);
    const __m512i low = _mm512_set1_epi32(1 << 16);
    const uint8_t* p = *pp;
    int64_t i = 0;
    for (; i < body; i += kLanes3) {
        // the unconditional 32-byte word loads must stay inside the padded
        // buffer; a truncated/corrupt stream falls through to the scalar
        // (bounds-checked) path for the rest
        if (p + kPad3 > pend + kPad3) break;
        __m512i s[NG], cum[NG], rowb0[NG];
        // stage 1 for all groups first (independent gathers in flight)
        for (int g = 0; g < NG; ++g) {
            const __m512i b = _mm512_loadu_si512(
                reinterpret_cast<const void*>(bins + i + g * kGroup3));
            cum[g] = _mm512_and_si512(x[g], m16);
            // coarse lookup: s ≤ true symbol (bucket lower bound), then a
            // correction loop over the cache-hot CDF rows
            const __m512i lidx = _mm512_or_si512(
                _mm512_slli_epi32(b, 16 - shift),
                _mm512_srli_epi32(cum[g], shift));
            s[g] = _mm512_and_si512(_mm512_i32gather_epi32(
                lidx, reinterpret_cast<const int*>(lut), 2), m16);
            rowb0[g] = _mm512_mullo_epi32(b, cols);
        }
        for (int g = 0; g < NG; ++g) {
            for (;;) {
                const __m512i probe = _mm512_i32gather_epi32(
                    _mm512_add_epi32(_mm512_add_epi32(rowb0[g], s[g]), one),
                    reinterpret_cast<const int*>(cdf), 4);
                const __mmask16 bump = _mm512_cmple_epu32_mask(probe, cum[g]);
                if (bump == 0) break;
                s[g] = _mm512_mask_add_epi32(s[g], bump, s[g], one);
            }
        }
        for (int g = 0; g < NG; ++g) {
            const __m512i rowb = _mm512_add_epi32(rowb0[g], s[g]);
            const __m512i start = _mm512_i32gather_epi32(
                rowb, reinterpret_cast<const int*>(cdf), 4);
            const __m512i nxt = _mm512_i32gather_epi32(
                _mm512_add_epi32(rowb, one),
                reinterpret_cast<const int*>(cdf), 4);
            const __m512i freq = _mm512_sub_epi32(nxt, start);
            _mm512_storeu_si512(
                reinterpret_cast<void*>(out + i + g * kGroup3), s[g]);
            // x = freq * (x >> 16) + cum - start
            x[g] = _mm512_add_epi32(
                _mm512_mullo_epi32(freq, _mm512_srli_epi32(x[g], 16)),
                _mm512_sub_epi32(cum[g], start));
            // refill: consecutive stream words → refilling lanes in order
            const __mmask16 m = _mm512_cmplt_epu32_mask(x[g], low);
            const __m256i w16 = _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(p));
            const __m512i words = _mm512_cvtepu16_epi32(w16);
            const __m512i exp = _mm512_maskz_expand_epi32(m, words);
            x[g] = _mm512_mask_blend_epi32(
                m, x[g], _mm512_or_si512(_mm512_slli_epi32(x[g], 16), exp));
            p += 2 * _mm_popcnt_u32(m);
        }
    }
    for (int g = 0; g < NG; ++g)
        _mm512_storeu_si512(reinterpret_cast<void*>(xs + g * kGroup3), x[g]);
    *pp = p;
    return i;
}
#endif
}  // namespace

extern "C" {

int nic_rans_simd_available(void) {
#if defined(__x86_64__)
    return __builtin_cpu_supports("avx512f") &&
           __builtin_cpu_supports("avx512bw") &&
           __builtin_cpu_supports("avx512vl") &&
           __builtin_cpu_supports("avx512dq");
#else
    return 0;
#endif
}

// Coarse cum→symbol table: bucket k of bin b (k = cum >> shift) stores the
// symbol whose span contains cum = k << shift — a LOWER BOUND for every cum
// in the bucket, corrected by a short increment loop over the (tiny,
// cache-hot) CDF rows. shift=6 puts a 64-bin table at 128 KB (L2-resident)
// where the exact 16-bit table is 8.4 MB (gathers miss to L3/DRAM — the
// measured bottleneck of the dense-LUT SIMD decode).
void nic_rans_build_lut_coarse(const int32_t* cdf, int64_t n_bins,
                               int64_t cdf_cols, int32_t shift,
                               uint16_t* lut) {
    const int64_t buckets = 1ll << (16 - shift);
    for (int64_t b = 0; b < n_bins; ++b) {
        const int32_t* row = cdf + b * cdf_cols;
        uint16_t* dst = lut + b * buckets;
        int64_t s = 0;
        for (int64_t k = 0; k < buckets; ++k) {
            const int32_t cum = static_cast<int32_t>(k << shift);
            while (s + 2 < cdf_cols && row[s + 1] <= cum) ++s;
            dst[k] = static_cast<uint16_t>(s);
        }
    }
}

// Encode n symbols into one 16-lane shared-stream payload (format 3).
// Returns total bytes (64 states + words + 32 pad) or -1 on error.
int64_t nic_rans_encode_ilv3(const int32_t* symbols, const int32_t* bins,
                             int64_t n, const int32_t* cdf, int64_t cdf_cols,
                             uint8_t* out, int64_t out_cap) {
    std::vector<uint16_t> buf;
    buf.reserve(static_cast<size_t>(n) / 2 + 16);
    uint32_t x[kLanes3];
    for (int l = 0; l < kLanes3; ++l) x[l] = kWordL;
    const int64_t body = n - (n % kLanes3);
    for (int64_t i = n - 1; i >= 0; --i) {
        // lane of symbol i: batch-local position for the vector body,
        // tail-local position for the trailing n % 16 symbols
        const int l = static_cast<int>(i >= body ? i - body : i % kLanes3);
        const int32_t* row = cdf + static_cast<int64_t>(bins[i]) * cdf_cols;
        const int32_t s = symbols[i];
        if (s < 0 || s + 1 >= cdf_cols) return -1;
        const uint32_t start = static_cast<uint32_t>(row[s]);
        const uint32_t freq = static_cast<uint32_t>(row[s + 1]) - start;
        if (freq == 0) return -1;
        uint32_t xl = x[l];
        if (xl >= (freq << 16)) {
            buf.push_back(static_cast<uint16_t>(xl & 0xffffu));
            xl >>= 16;
        }
        x[l] = ((xl / freq) << 16) + (xl % freq) + start;
    }
    const int64_t total = 4 * kLanes3 +
                          static_cast<int64_t>(buf.size()) * 2 + kPad3;
    if (total > out_cap) return -1;
    uint8_t* dst = out;
    for (int l = 0; l < kLanes3; ++l) {
        const uint32_t xl = x[l];
        dst[0] = static_cast<uint8_t>(xl & 0xff);
        dst[1] = static_cast<uint8_t>((xl >> 8) & 0xff);
        dst[2] = static_cast<uint8_t>((xl >> 16) & 0xff);
        dst[3] = static_cast<uint8_t>((xl >> 24) & 0xff);
        dst += 4;
    }
    for (int64_t k = static_cast<int64_t>(buf.size()) - 1; k >= 0; --k) {
        *dst++ = static_cast<uint8_t>(buf[k] & 0xff);
        *dst++ = static_cast<uint8_t>(buf[k] >> 8);
    }
    std::memset(dst, 0, kPad3);
    return total;
}

int nic_rans_decode_ilv3(const uint8_t* bytes, int64_t n_bytes,
                         const int32_t* bins, int64_t n, const int32_t* cdf,
                         int64_t cdf_cols, const uint16_t* lut,
                         int32_t shift, int32_t* out) {
    if (n_bytes < 4 * kLanes3 + kPad3) return -1;
    uint32_t x[kLanes3];
    const uint8_t* p = bytes;
    for (int l = 0; l < kLanes3; ++l) {
        x[l] = static_cast<uint32_t>(p[0]) |
               (static_cast<uint32_t>(p[1]) << 8) |
               (static_cast<uint32_t>(p[2]) << 16) |
               (static_cast<uint32_t>(p[3]) << 24);
        p += 4;
    }
    const uint8_t* pend = bytes + n_bytes - kPad3;
    const int64_t body = n - (n % kLanes3);
    int64_t done = 0;
#if defined(__x86_64__)
    if (lut && nic_rans_simd_available()) {
        done = decode3_avx512(bins, body, cdf, cdf_cols, lut, shift, x, &p,
                              pend, out);
    }
#endif
    // rest of the batched region (no-AVX512 fallback or a truncated
    // stream), then the n % 16 tail — both share the scalar state machine
    decode3_scalar(bytes, n_bytes, bins, done, body, cdf, cdf_cols, lut,
                   shift, x, &p, pend, out);
    return decode3_scalar(bytes, n_bytes, bins, body, n, cdf,
                          cdf_cols, lut, shift, x, &p, pend, out);
}

}  // extern "C"
