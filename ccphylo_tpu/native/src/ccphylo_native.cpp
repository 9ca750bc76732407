// ccphylo_native — host-side runtime kernels for the framework.
//
// The device compute path (distance kernels, join engines) lives in
// JAX/XLA; this library is the *runtime around it*: the data-loader and
// formatter hot loops that the reference implements in C
// (phy.c:251-507 loadPhy, phy.c:59-123 printphy, matparse.c:45-317,
// qseqs.c:60-88).  Python keeps the orchestration and the exact error
// semantics (on any native parse error the caller re-runs the Python
// path); these functions only accelerate the success path, with
// byte-identical results (fuzz-tested against the Python parser).
//
// Plain C ABI, consumed through ctypes.  No Python.h dependency.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

// Clinger fast path: a decimal with mantissa <= 2^53 and decimal
// exponent |e| <= 22 converts exactly with one double divide/multiply
// (both operands exactly representable -> IEEE op is correctly
// rounded).  Anything else falls back to strtod.  Returns false when
// the token isn't a plain short decimal.
static bool parse_short_decimal(const char *src, const char *tend,
                                double *out) {
    static const double POW10[23] = {
        1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
        1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
        1e22};
    const char *q = src;
    bool neg = false;
    if (q < tend && (*q == '-' || *q == '+')) {
        neg = (*q == '-');
        ++q;
    }
    uint64_t m = 0;
    int ndig = 0;
    int frac = 0;
    bool seen_dot = false, seen_digit = false;
    for (; q < tend; ++q) {
        char c = *q;
        if (c >= '0' && c <= '9') {
            seen_digit = true;
            if (ndig >= 19) return false;  // mantissa may overflow
            m = 10 * m + (uint64_t)(c - '0');
            if (m) ++ndig;
            if (seen_dot) ++frac;
        } else if (c == '.' && !seen_dot) {
            seen_dot = true;
        } else {
            return false;  // exponent form, whitespace, etc -> strtod
        }
    }
    if (!seen_digit) return false;
    if (m > (1ULL << 53) || frac > 22) return false;
    double d = (double)m;
    if (frac) d /= POW10[frac];
    *out = neg ? -d : d;
    return true;
}

extern "C" {

// ---------------------------------------------------------------------------
// Phylip body parser (loadPhy row loop, phy.c:384-507).
//
// Parses `n` rows starting at *pos: a name terminated by `sep` or
// newline (rstripped of C whitespace), then i distance cells
// (empty-field skipping; a cell before the last terminates only on
// `sep`, the last also on newline), then skip-to-newline tolerance for
// full-matrix rows.
//
// Outputs:
//   flat      — n*(n-1)/2 doubles, row-major lower-triangular
//   name_offs — 2n int64: (start, stop) byte spans of each rstripped name
//   raw_lens  — n int64: raw chars consumed by each name incl. terminator
//   *pos      — advanced past the parsed body
//
// Returns 0 on success; negative error codes (caller falls back to the
// Python parser, which reproduces the reference's exact error message):
//   -1 unexpected EOF in a name      -2 unexpected EOF in a distance
//   -3 malformed distance token      -4 missing newline mid-matrix
// ---------------------------------------------------------------------------
int64_t phy_body(const uint8_t *data, int64_t len, int64_t *pos,
                 int64_t n, uint8_t sep, double *flat,
                 int64_t *name_offs, int64_t *raw_lens) {
    int64_t p = *pos;
    int64_t cell = 0;
    for (int64_t i = 0; i < n; ++i) {
        // --- name
        int64_t start = p;
        uint8_t c = 0;
        for (;;) {
            if (p >= len) return -1;
            c = data[p++];
            if (c == sep || c == '\n') break;
        }
        raw_lens[i] = p - start;
        // the terminator joins the name (loadPhy copies it before the
        // isspace chomp, phy.c:409-435): a '\n' or tab chomps away, a
        // non-whitespace separator stays — matching C and Python
        int64_t stop = p;
        while (stop > start) {
            uint8_t b = data[stop - 1];
            if (b == ' ' || b == '\t' || b == '\n' || b == '\r' ||
                b == '\v' || b == '\f') {
                --stop;
            } else {
                break;
            }
        }
        name_offs[2 * i] = start;
        name_offs[2 * i + 1] = stop;

        // --- i distance cells
        for (int64_t j = 0; j < i; ++j) {
            uint8_t stopc = (j != i - 1) ? sep : '\n';
            int64_t tstart, tlen = 0;
            do {
                tstart = p;
                for (;;) {
                    if (p >= len) return -2;
                    c = data[p++];
                    if (c == stopc || c == sep) break;
                }
                tlen = p - 1 - tstart;
            } while (tlen == 0);
            // Parse in place: the caller passes a NUL-terminated buffer
            // (CPython bytes), and strtod stops at the first invalid
            // char, so it never reads past the terminating sep/newline
            // meaningfully; we then require it to have consumed the
            // token up to optional trailing whitespace (Python float()
            // strictness).  Anything odd -> error -> Python fallback.
            const char *src = (const char *)data + tstart;
            const char *tend = src + tlen;
            double fastval;
            if (parse_short_decimal(src, tend, &fastval)) {
                flat[cell++] = fastval;
                continue;
            }
            char *end = nullptr;
            double val = strtod(src, &end);
            bool ok = end != src && end <= tend;
            if (ok) {
                for (const char *q = end; q < tend; ++q) {
                    if (!isspace((unsigned char)*q)) { ok = false; break; }
                }
                // reject strtod-isms Python float() handles differently
                // (hex floats) so the fallback path decides them
                for (const char *q = src; ok && q + 1 < end; ++q) {
                    if (*q == '0' && (q[1] == 'x' || q[1] == 'X'))
                        ok = false;
                }
            }
            if (!ok) return -3;
            flat[cell++] = val;
        }

        // --- skip remainder of the line (full-matrix tolerance)
        while (c != '\n') {
            if (p >= len) {
                if (i != n - 1) return -4;
                break;
            }
            c = data[p++];
        }
    }
    *pos = p;
    return 0;
}

// ---------------------------------------------------------------------------
// printphy cell formatter (phy.c:113-119): each value prints as "\t%d"
// when it equals its integer cast, else "\t%.*f".  Matches the Python
// formatter (int64 range check) byte-for-byte.
// Returns bytes written, or -1 if `cap` could be exceeded.
// ---------------------------------------------------------------------------
int64_t fmt_cells(const double *vals, int64_t count, int32_t precision,
                  uint8_t *out, int64_t cap) {
    int64_t w = 0;
    for (int64_t k = 0; k < count; ++k) {
        double d = vals[k];
        // non-finite cells go back to the Python path, which raises
        // the same OverflowError/ValueError either way
        if (!std::isfinite(d)) return -2;
        if (w + 32 + precision + 320 > cap) return -1;
        char *dst = (char *)out + w;
        // Python: d == int(d) and abs(d) < 2**63 -> "\t%d" % int(d)
        if (d > -9223372036854775808.0 && d < 9223372036854775808.0 &&
            d == (double)(int64_t)d) {
            w += snprintf(dst, (size_t)(cap - w), "\t%lld",
                          (long long)(int64_t)d);
        } else {
            w += snprintf(dst, (size_t)(cap - w), "\t%.*f", precision, d);
        }
    }
    return w;
}

// ---------------------------------------------------------------------------
// KMA .mat template row parser (matparse.c:45-198 FileBuffGetRow +
// FileBuffLoadMat:213-317).  Parses consecutive count rows
// "ref\tA\tC\tG\tT\tN\t-" until the next '#' header or EOF.
//
// Outputs per row: refs[i] = reference base byte; counts[i*6..] in
// [A, C, G, T, -, N] order (file order A C G T N -, with N moved last,
// matparse.c:251-258); totals[i] = sum of all six.
// Counts saturate at uint16 like the reference's `short unsigned`
// fields would wrap — the reference stores into `short unsigned` via
// strtol truncation; we replicate plain uint16 truncation.
// Returns #rows parsed (>= 0) and advances *pos; -1 on malformed row.
// ---------------------------------------------------------------------------
int64_t mat_rows(const uint8_t *data, int64_t len, int64_t *pos,
                 uint8_t *refs, uint16_t *counts, int64_t *totals,
                 int64_t max_rows) {
    int64_t p = *pos;
    int64_t nrow = 0;
    while (p < len && nrow < max_rows) {
        if (data[p] == '#' || data[p] == '\n') break;  // end of entry
        // ref base = first field's first byte; empty field -> '-'
        if (data[p] == '\t') {
            refs[nrow] = '-';
        } else {
            refs[nrow] = data[p];
            // skip rest of the ref field
            while (p < len && data[p] != '\t' && data[p] != '\n') ++p;
        }
        // exactly fields 1..6 count, positionally (Python parts[1:7]);
        // an empty field is an error (int(b'') raises in the fallback)
        int64_t vals[6];
        int nv = 0;
        int64_t total = 0;
        while (nv < 6) {
            if (p >= len || data[p] != '\t') return -1;
            ++p;  // consume the field separator
            bool neg = false;
            if (p < len && data[p] == '-') {
                neg = true;
                ++p;
            }
            if (p >= len || data[p] < '0' || data[p] > '9') return -1;
            int64_t v = 0;
            while (p < len && data[p] >= '0' && data[p] <= '9') {
                v = 10 * v + (data[p++] - '0');
            }
            if (p < len && data[p] != '\t' && data[p] != '\n') return -1;
            if (neg) v = -v;
            vals[nv++] = v;
            total += v;
        }
        // skip any extra columns
        while (p < len && data[p] != '\n') ++p;
        if (p < len) ++p;  // newline
        if (nv < 6) return -1;
        // file order: A C G T N - ; stored order: A C G T - N
        counts[nrow * 6 + 0] = (uint16_t)vals[0];
        counts[nrow * 6 + 1] = (uint16_t)vals[1];
        counts[nrow * 6 + 2] = (uint16_t)vals[2];
        counts[nrow * 6 + 3] = (uint16_t)vals[3];
        counts[nrow * 6 + 4] = (uint16_t)vals[5];
        counts[nrow * 6 + 5] = (uint16_t)vals[4];
        totals[nrow] = total;
        ++nrow;
    }
    *pos = p;
    return nrow;
}

// Count rows of the next template without storing (sizing pass); stops
// at '#', a blank line, or EOF — same entry semantics as mat_rows.
int64_t mat_count_rows(const uint8_t *data, int64_t len, int64_t pos) {
    int64_t nrow = 0;
    while (pos < len) {
        if (data[pos] == '#' || data[pos] == '\n') break;
        const uint8_t *nl = (const uint8_t *)memchr(data + pos, '\n',
                                                    (size_t)(len - pos));
        pos = nl ? (int64_t)(nl - data) + 1 : len;
        ++nrow;
    }
    return nrow;
}

// ---------------------------------------------------------------------------
// fasta 2-bit packing (qseq2nibble, qseqs.c:60-88) with translation
// table (get2BitTable, fsacmp.c:32-91): raw fasta body bytes ->
// u64-packed codes, 32 bases/word, first base highest bit pair; code 4
// (unknown) packs as 0 and counts toward *ns.  Codes >= 32 are skipped
// (newlines etc).  Returns the number of bases packed.
// ---------------------------------------------------------------------------
int64_t fasta_pack(const uint8_t *raw, int64_t len, const uint8_t *table,
                   uint64_t *words, int64_t *ns) {
    int64_t nbase = 0;
    int64_t nn = 0;
    uint64_t acc = 0;
    int shift = 62;
    int64_t w = 0;
    for (int64_t k = 0; k < len; ++k) {
        uint8_t code = table[raw[k]];
        if (code >= 32) continue;
        if (code == 4) {
            ++nn;
            code = 0;
        }
        acc |= (uint64_t)code << shift;
        shift -= 2;
        ++nbase;
        if (shift < 0) {
            words[w++] = acc;
            acc = 0;
            shift = 62;
        }
    }
    if (shift != 62) words[w++] = acc;
    *ns = nn;
    return nbase;
}

// ---------------------------------------------------------------------------
// Streamed-engine host init (the reference's initHNJ / initQ analog,
// dnj.c:121-180 — row sums + per-row Q/P seed in exact int32 u-units).
//
// Single sequential pass over the (n, n) u8 host matrix (RAM or
// memmap): row r's full sum finalizes sD2[r] BEFORE its Q/P scan runs,
// and that scan only reads sD2[c] for c < r, already final — so one
// 45 GB read at n≈213k instead of the two-pass numpy formulation
// (measured 4859 s in Python; the matrix read is the floor here).
//
// Semantics are the bit-exact twin of streamed_engine._host_init:
//   sD2[r] = 2 * sum_{c<m, c!=r} D[r][c]          (int32 wraparound)
//   Q[r]   = min_{c<r} (co0*D[r][c] - sD2[r] - sD2[c]),  co0=2(m-2)
//   P[r]   = serial tie rule: reset on strictly smaller q; among
//            equal-q candidates keep the LAST c whose D is <= the
//            running D-min (numpy prefmin formulation).
// Rows r >= m: sD2=0, Q=INT32_MAX, P=0.  Returns the seed row (max
// r >= 1 with Q[r] == min, 0 when m <= 1).  All q arithmetic runs in
// uint32 and is bitcast to int32 so overflow wraps exactly as numpy.
int64_t init_hnj_u8(const uint8_t *D, int64_t n, int64_t m,
                    int32_t *sD2, int32_t *Q, int32_t *P) {
    const int32_t big = INT32_MAX;
    const uint32_t co0 = (uint32_t)(2 * (m - 2));
    for (int64_t r = 0; r < n; ++r) {
        sD2[r] = 0;
        Q[r] = big;
        P[r] = 0;
    }
    const int64_t CH = 4096;  // chunk: vector min, scalar ties
    for (int64_t r = 0; r < m; ++r) {
        const uint8_t *row = D + r * n;
        uint32_t acc = 0;
        for (int64_t c = 0; c < m; ++c) acc += row[c];
        acc -= row[r];
        sD2[r] = (int32_t)(2u * acc);
        if (r < 1) continue;
        const uint32_t sr = (uint32_t)sD2[r];
        int32_t qmin = big;
        uint8_t pd = 255;
        int64_t pc = 0;
        bool have = false;
        for (int64_t c0 = 0; c0 < r; c0 += CH) {
            const int64_t c1 = (c0 + CH < r) ? c0 + CH : r;
            int32_t cmin = big;
            for (int64_t c = c0; c < c1; ++c) {
                const int32_t q = (int32_t)(co0 * row[c] - sr
                                            - (uint32_t)sD2[c]);
                if (q < cmin) cmin = q;
            }
            if (cmin > qmin) continue;  // no candidate in this chunk
            for (int64_t c = c0; c < c1; ++c) {
                const int32_t q = (int32_t)(co0 * row[c] - sr
                                            - (uint32_t)sD2[c]);
                if (q < qmin || (q == qmin && !have)) {
                    qmin = q;
                    pd = row[c];
                    pc = c;
                    have = true;
                } else if (q == qmin && row[c] <= pd) {
                    pd = row[c];
                    pc = c;
                }
            }
        }
        Q[r] = qmin;
        P[r] = (int32_t)pc;
    }
    if (m <= 1) return 0;
    int32_t mn0 = big;
    int64_t seed = -1;
    for (int64_t r = 1; r < m; ++r) {
        if (Q[r] < mn0) {
            mn0 = Q[r];
            seed = r;
        } else if (Q[r] == mn0) {
            seed = r;  // max index among ties
        }
    }
    return seed < 0 ? 0 : seed;
}

// version / health probe
int32_t ccphylo_native_abi(void) { return 1; }

}  // extern "C"
