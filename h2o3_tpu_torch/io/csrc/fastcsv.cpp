// fastcsv — the native CSV tokenizer of the port (h2o3_tpu_torch/io).
//
// A copy of the JAX package's native/fastcsv.cpp, built by the port itself
// at first use (h2o3_tpu_torch/ops/_build.py `load_host`):
//
//     g++ -O3 -fPIC -std=c++17 -shared -o libfastcsv-<hash>.so fastcsv.cpp
//
// It tokenizes every byte as that engine does, with two changes:
//   * a doubled quote inside a quoted field is one quote ("q""r" is q"r,
//     as RFC 4180 and Python's csv module read it; the reference engine
//     keeps q""r);
//   * a dictionary export (`fastcsv_dict_*`): each column's string cells
//     as their rows, one int32 code a cell and the distinct tokens in
//     first-seen order, so the caller builds categorical levels from the
//     distinct tokens alone instead of one Python string a cell.
//
// What follows is the reference engine's own description.
//
// Reference: the per-byte CSV tokenizer hot loop in H2O-3's
// water/parser/CsvParser.java (parseChunk) — the reference parses file chunks
// distributed across JVM nodes. Here the parser is the per-host tokenize
// stage of the distributed ingest pipeline (io/dparse.py):
//   * one sequential pass over the buffer, quote-aware, with a 256-entry
//     dispatch table so runs of ordinary bytes scan in a tight inner loop;
//   * numeric cells parsed with an allocation-free exact fast path (the
//     Clinger fast path: mantissa <= 2^53 and |exp10| <= 22 make one
//     multiply/divide correctly rounded, so the result is bit-identical
//     to strtod) into column-major double arrays; odd tokens (hex floats,
//     inf spellings, >19 digits) fall back to strtod on a stack buffer;
//   * non-numeric cells recorded per column in a side string table
//     (row index + bytes), exported either cell-at-a-time (legacy ABI)
//     or as bulk rows/lens/bytes planes;
//   * byte-range entry points implement the chunk contract (a range at
//     start > 0 begins after its first newline and runs through the line
//     straddling its end), and a buffer entry point parses bytes the
//     caller staged (streaming-decompressed gzip/zip, HTTP range reads);
//   * exported via a plain C ABI consumed with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <mutex>
#include <new>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#ifdef __SSE2__
#include <emmintrin.h>
#endif

namespace {

// ---- thread-local slab arena for column plane growth ---------------------
// The reserve(est) heuristic in finish_row kills the log2(n) growth
// reallocations, but each chunk parse still pays ONE giant malloc per
// column plane — and on Linux a fresh multi-MB malloc is mmap-backed, so
// the first write to every 4 KB page takes a soft page fault. Across a
// parse pool thread's lifetime that is the same pages faulted in again
// for every chunk. This arena keeps freed blocks on a per-thread
// freelist (power-of-two size classes, 4 KB … 32 MB), so chunk N+1's
// planes land in chunk N's already-faulted memory: the steady-state cost
// of a column plane drops from mmap + N page faults to a freelist pop.
//
// Cross-thread safety: a ParseResult is routinely freed on a DIFFERENT
// thread than the one that parsed it (Python GC / pool handoff), so each
// block carries its owning arena in a 16-byte header and frees push back
// to the OWNER's mutex-protected freelist. Arenas are heap-allocated and
// intentionally never destroyed: a block freed after its parse thread
// exited must still find a live owner (the leak is bounded by the thread
// count, and pool threads are reused).
constexpr int kArenaClasses = 14;                 // 4 KB << 0 … 32 MB
constexpr size_t kArenaMinBytes = 4096;
constexpr size_t kArenaMaxBytes = kArenaMinBytes << (kArenaClasses - 1);
constexpr size_t kArenaHoldCap = 256u << 20;      // freelist cap per thread

struct Arena {
    std::mutex mu;
    std::vector<void*> free_lists[kArenaClasses];
    size_t held = 0;                              // bytes parked in lists
};

struct ArenaHeader {                              // 16 bytes: user data
    Arena* owner;                                 // stays 16-aligned
    size_t bytes;                                 // block size incl. header
};

Arena* my_arena() {
    static thread_local Arena* a = new Arena();
    return a;
}

int arena_class_for(size_t want) {
    size_t sz = kArenaMinBytes;
    int cls = 0;
    while (sz < want) { sz <<= 1; ++cls; }
    return cls;
}

void* arena_alloc(size_t n) {
    size_t want = n + sizeof(ArenaHeader);
    if (want > kArenaMaxBytes) {                  // outsize: plain malloc
        void* raw = malloc(want);
        if (!raw) throw std::bad_alloc();
        auto* h = static_cast<ArenaHeader*>(raw);
        h->owner = nullptr;
        h->bytes = want;
        return h + 1;
    }
    int cls = arena_class_for(want);
    size_t block = kArenaMinBytes << cls;
    Arena* a = my_arena();
    void* raw = nullptr;
    {
        std::lock_guard<std::mutex> g(a->mu);
        auto& fl = a->free_lists[cls];
        if (!fl.empty()) {
            raw = fl.back();
            fl.pop_back();
            a->held -= block;
        }
    }
    if (!raw) {
        raw = malloc(block);
        if (!raw) throw std::bad_alloc();
    }
    auto* h = static_cast<ArenaHeader*>(raw);
    h->owner = a;
    h->bytes = block;
    return h + 1;
}

void arena_free(void* p) {
    if (!p) return;
    auto* h = static_cast<ArenaHeader*>(p) - 1;
    Arena* a = h->owner;
    if (!a) { free(h); return; }
    size_t block = h->bytes;
    int cls = arena_class_for(block);
    {
        std::lock_guard<std::mutex> g(a->mu);
        if (a->held + block <= kArenaHoldCap) {
            a->free_lists[cls].push_back(h);
            a->held += block;
            return;
        }
    }
    free(h);
}

template <class T>
struct ArenaAlloc {
    using value_type = T;
    ArenaAlloc() = default;
    template <class U> ArenaAlloc(const ArenaAlloc<U>&) {}
    T* allocate(size_t n) {
        return static_cast<T*>(arena_alloc(n * sizeof(T)));
    }
    void deallocate(T* p, size_t) { arena_free(p); }
    template <class U> bool operator==(const ArenaAlloc<U>&) const {
        return true;
    }
    template <class U> bool operator!=(const ArenaAlloc<U>&) const {
        return false;
    }
};

struct StrCell {
    int64_t row;
    std::string val;
};

struct Column {
    // the hot, plane-sized vectors grow through the arena; data() still
    // hands contiguous T* across the C ABI, valid until fastcsv_free
    std::vector<double, ArenaAlloc<double>> num;   // numeric value or NaN
    std::vector<StrCell> strs;     // cells that failed numeric parse
    int64_t na_count = 0;
    // bulk string-table export, built lazily on first request
    std::vector<int64_t, ArenaAlloc<int64_t>> bulk_rows;
    std::vector<int32_t, ArenaAlloc<int32_t>> bulk_lens;
    std::string bulk_bytes;
    bool bulk_built = false;
    // dictionary export, built lazily on first request: one code a string
    // cell (in strs order) and the distinct tokens in first-seen order
    std::vector<int64_t> dict_rows;
    std::vector<int32_t> dict_codes;
    std::vector<int32_t> dict_lens;
    std::string dict_bytes;
    bool dict_built = false;
};

struct ParseResult {
    std::vector<Column> cols;
    int64_t nrows = 0;
    std::string error;
};

bool is_na_token(const char* s, size_t n) {
    if (n == 0) return true;
    // length-bucketed: the old strlen-per-candidate scan ran per cell
    switch (n) {
        case 1: return s[0] == '?';
        case 2: return memcmp(s, "NA", 2) == 0 || memcmp(s, "na", 2) == 0;
        case 3: return memcmp(s, "N/A", 3) == 0 || memcmp(s, "NaN", 3) == 0
                    || memcmp(s, "nan", 3) == 0;
        case 4: return memcmp(s, "null", 4) == 0 || memcmp(s, "NULL", 4) == 0
                    || memcmp(s, "None", 4) == 0;
        default: return false;
    }
}

// Exact fast double parse (the Clinger fast path). Returns false for any
// token it cannot convert with a guaranteed-correctly-rounded result —
// the caller falls back to strtod, so accepting is ALWAYS bit-identical
// to the old per-cell strtod.
const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
const uint64_t kPow10i[9] = {1ULL, 10ULL, 100ULL, 1000ULL, 10000ULL,
                             100000ULL, 1000000ULL, 10000000ULL,
                             100000000ULL};

inline const char* digit_run(const char* p, const char* end) {
    while (p < end && (uint8_t)(*p - '0') <= 9) ++p;
    return p;
}

// accumulate a known-all-digits run [p, q) into mant (no per-digit checks:
// the caller bounds total digits at 19, so overflow is impossible)
inline uint64_t accum_digits(uint64_t mant, const char* p, const char* q) {
    for (; p < q; ++p) mant = mant * 10 + (uint8_t)(*p - '0');
    return mant;
}

// SWAR: 8 ASCII digits (first char most significant, loaded little-endian)
// to their integer value in ~4 cycles — the serial mul-add chain in
// accum_digits is latency-bound at ~4 cycles PER DIGIT and dominated the
// whole ingest path.
inline uint32_t parse8(uint64_t v) {
    v -= 0x3030303030303030ULL;
    v = v * 10 + (v >> 8);
    v = ((v & 0x000000FF000000FFULL) * 0x000F424000000064ULL
         + ((v >> 16) & 0x000000FF000000FFULL) * 0x0000271000000001ULL)
        >> 32;
    return (uint32_t)v;
}

// value of the known-all-digits run [p, q) of length 1..8, end-aligned:
// load the 8 bytes ending at q and front-fill the lead with '0'. `base`
// guards the load (bytes before the run exist everywhere but at the very
// head of the parse buffer).
inline uint64_t run_value(const char* p, const char* q, const char* base) {
    long len = q - p;
    if (len <= 0) return 0;
    if (len <= 8 && q - 8 >= base) {
        uint64_t raw;
        memcpy(&raw, q - 8, 8);
        if (len < 8) {
            uint64_t keep = ~0ULL << ((8 - len) * 8);
            raw = (raw & keep) | (0x3030303030303030ULL & ~keep);
        }
        return parse8(raw);
    }
    return accum_digits(0, p, q);
}


inline bool fast_double(const char* s, size_t len, const char* base,
                        double* out) {
    const char* p = s;
    const char* end = s + len;
    if (p == end) return false;
    bool neg = false;
    if (*p == '-') { neg = true; ++p; }
    else if (*p == '+') { ++p; }
    const char* q1 = digit_run(p, end);          // integer digits
    const char* f0 = q1;
    const char* q2 = q1;
    if (q1 < end && *q1 == '.') {
        f0 = q1 + 1;
        q2 = digit_run(f0, end);                 // fraction digits
    }
    long l1 = q1 - p, l2 = q2 - f0;
    long ndig = l1 + l2;
    if (ndig == 0 || ndig > 19) return false;    // empty / may overflow
    uint64_t mant;
    if (l1 <= 8 && l2 <= 8) {
        mant = run_value(p, q1, base) * (uint64_t)kPow10i[l2]
             + run_value(f0, q2, base);
    } else {
        mant = accum_digits(accum_digits(0, p, q1), f0, q2);
    }
    int e10 = (int)-l2;
    p = q2;
    if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        bool eneg = false;
        if (p < end && (*p == '-' || *p == '+')) { eneg = (*p == '-'); ++p; }
        const char* qe = digit_run(p, end);
        if (qe == p || qe - p > 3) return false;
        int ev = (int)accum_digits(0, p, qe);
        e10 += eneg ? -ev : ev;
        p = qe;
    }
    if (p != end) return false;                  // trailing junk: fallback
    if (mant > (1ULL << 53)) return false;       // not exact in a double
    if (e10 < -22 || e10 > 22) return false;     // 10^|e| not exact
    double v = (e10 >= 0) ? (double)mant * kPow10[e10]
                          : (double)mant / kPow10[-e10];
    *out = neg ? -v : v;
    return true;
}

inline void put_token(Column& c, const char* s, size_t len,
                      const char* base);

inline void put_cell(ParseResult* r, size_t col, int64_t row, const char* s,
                     size_t len, const char* base) {
    if (__builtin_expect(r->cols.size() <= col, 0)) r->cols.resize(col + 1);
    Column& c = r->cols[col];
    while (__builtin_expect((int64_t)c.num.size() < row, 0))
        c.num.push_back(NAN);  // ragged pad
    // trim whitespace and symmetric quotes
    while (len && (s[0] == ' ' || s[0] == '\t')) { s++; len--; }
    while (len && (s[len-1] == ' ' || s[len-1] == '\t' || s[len-1] == '\r'))
        len--;
    if (len >= 2 && s[0] == '"' && s[len-1] == '"') {
        s++;
        len -= 2;
        if (memchr(s, '"', len)) {
            // RFC 4180: inside a quoted field a doubled quote is one quote
            std::string un;
            un.reserve(len);
            for (size_t i = 0; i < len; ++i) {
                un.push_back(s[i]);
                if (s[i] == '"' && i + 1 < len && s[i + 1] == '"') ++i;
            }
            put_token(c, un.data(), un.size(), un.data());
            return;
        }
    }
    put_token(c, s, len, base);
}

// One trimmed, unquoted token into its column: a number, an NA or a
// string cell.
inline void put_token(Column& c, const char* s, size_t len,
                      const char* base) {
    double v;
    if (fast_double(s, len, base, &v)) {         // the hot path: no alloc
        c.num.push_back(v);
        return;
    }
    if (is_na_token(s, len)) {
        c.num.push_back(NAN);
        c.na_count++;
        return;
    }
    char sbuf[64];
    char* end = nullptr;
    if (len < sizeof(sbuf)) {                    // strtod needs NUL-term
        memcpy(sbuf, s, len);
        sbuf[len] = '\0';
        v = strtod(sbuf, &end);
        if (end && *end == '\0' && end != sbuf) {
            c.num.push_back(v);
            return;
        }
        c.num.push_back(NAN);
        c.strs.push_back({(int64_t)c.num.size() - 1, std::string(s, len)});
        return;
    }
    std::string tmp(s, len);
    v = strtod(tmp.c_str(), &end);
    if (end && *end == '\0' && end != tmp.c_str()) {
        c.num.push_back(v);
    } else {
        c.num.push_back(NAN);
        c.strs.push_back({(int64_t)c.num.size() - 1, std::move(tmp)});
    }
}

// advance to the first structural byte (sep / '\n' / '"' / '\r') — 16
// bytes per compare on SSE2, table-scan tail/fallback otherwise: the
// byte-at-a-time dispatch loop was ~2ns/byte, a third of the whole parse
inline const char* scan_plain(const char* p, const char* end, char sep,
                              const bool* special) {
#ifdef __SSE2__
    const __m128i vsep = _mm_set1_epi8(sep);
    const __m128i vnl = _mm_set1_epi8('\n');
    const __m128i vq = _mm_set1_epi8('"');
    const __m128i vcr = _mm_set1_epi8('\r');
    while (p + 16 <= end) {
        __m128i x = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
        __m128i m = _mm_or_si128(
            _mm_or_si128(_mm_cmpeq_epi8(x, vsep), _mm_cmpeq_epi8(x, vnl)),
            _mm_or_si128(_mm_cmpeq_epi8(x, vq), _mm_cmpeq_epi8(x, vcr)));
        int bits = _mm_movemask_epi8(m);
        if (bits) return p + __builtin_ctz((unsigned)bits);
        p += 16;
    }
#endif
    while (p < end && !special[(uint8_t)*p]) ++p;
    return p;
}

// The numeric fast loop: starting AT a field boundary, parse consecutive
// bare numeric fields in place (no scan-then-reparse, no put_cell call)
// until something non-trivial appears — quotes, spaces, NA/string
// tokens, mantissas past 2^53 — then return for the general machinery
// to take that field. Typical ingest is overwhelmingly plain numbers,
// so this loop IS the tokenizer for numeric CSV; noinline keeps its
// register allocation clear of the general loop's lambdas and SSE
// constants (inlining it measurably halves throughput).
__attribute__((noinline))
const char* fast_fields(ParseResult* r, const char* p, const char* endp,
                        char sep, const char* base, size_t& col_io,
                        int64_t& row_io, bool& rhd_io,
                        const char*& row_start_io) {
    size_t col = col_io;
    int64_t row = row_io;
    bool rhd = rhd_io;
    const char* row_start = row_start_io;
    while (p < endp) {
        const char* pp = p;
        bool neg = false;
        if (*pp == '-' || *pp == '+') { neg = (*pp == '-'); ++pp; }
        // digit runs walk forward byte-wise; each run's VALUE then comes
        // from one 8-byte load ending at the run (end-aligned, lead
        // front-filled with '0' for parse8). Benchmarked faster here
        // than a fused prefix-classifier: the runs are short and the
        // branchy walk predicts, while ctz+variable-shift chains stall.
        const char* q1 = digit_run(pp, endp);
        const char* f0 = q1;
        const char* q2 = q1;
        if (q1 < endp && *q1 == '.') {
            f0 = q1 + 1;
            q2 = digit_run(f0, endp);
        }
        long l1 = q1 - pp, l2 = q2 - f0;
        long ndig = l1 + l2;
        if (l1 > 8 || l2 > 8) break;       // long runs: general path
        uint64_t ipart, fpart;
        if (__builtin_expect(pp - base >= 8, 1)) {
            // in the body of the buffer both end-aligned loads are safe
            uint64_t raw, keep;
            memcpy(&raw, q1 - 8, 8);
            keep = l1 ? ~0ULL << ((8 - l1) * 8) : 0;   // l==0: all-'0'
            raw = (raw & keep) | (0x3030303030303030ULL & ~keep);
            ipart = parse8(raw);
            memcpy(&raw, q2 - 8, 8);
            keep = l2 ? ~0ULL << ((8 - l2) * 8) : 0;
            raw = (raw & keep) | (0x3030303030303030ULL & ~keep);
            fpart = parse8(raw);
        } else {                           // buffer head: guarded
            ipart = run_value(pp, q1, base);
            fpart = run_value(f0, q2, base);
        }
        const char* after = q2;
        int eexp = 0;
        if (after < endp && (*after == 'e' || *after == 'E') && ndig) {
            const char* px = after + 1;
            bool eneg = false;
            if (px < endp && (*px == '-' || *px == '+')) {
                eneg = (*px == '-');
                ++px;
            }
            const char* qe = digit_run(px, endp);
            if (qe != px && qe - px <= 3) {
                eexp = (int)accum_digits(0, px, qe);
                if (eneg) eexp = -eexp;
                after = qe;
            } else {
                ndig = 0;                  // junk exponent: general path
            }
        }
        int e10 = eexp - (int)l2;
        // the field must END at a structural byte ('\r' only as part of
        // a final "\r\n" / "\r<EOF>")
        bool clean_end =
            after == endp || *after == sep || *after == '\n'
            || (*after == '\r'
                && (after + 1 == endp || after[1] == '\n'));
        if (!(ndig > 0 && clean_end && e10 >= -22 && e10 <= 22))
            break;
        uint64_t mant = ipart * kPow10i[l2] + fpart;
        if (mant > (1ULL << 53)) break;
        double v = (e10 >= 0) ? (double)mant * kPow10[e10]
                              : (double)mant / kPow10[-e10];
        if (neg) v = -v;
        if (__builtin_expect(r->cols.size() <= col, 0))
            r->cols.resize(col + 1);
        Column& c = r->cols[col];
        while (__builtin_expect((int64_t)c.num.size() < row, 0))
            c.num.push_back(NAN);
        c.num.push_back(v);
        col++;
        rhd = true;
        if (after < endp && *after == sep) {
            p = after + 1;
            continue;
        }
        // row end (newline / CRLF / EOF): pad short rows, advance
        for (size_t c2 = 0; c2 < r->cols.size(); ++c2) {
            Column& cc = r->cols[c2];
            while ((int64_t)cc.num.size() <= row) {
                cc.num.push_back(NAN);
                cc.na_count++;
            }
        }
        if (row == 0) {
            size_t row_bytes = (size_t)(after - row_start) + 1;
            if (row_bytes < 2) row_bytes = 2;
            size_t est = (size_t)(endp - row_start) / row_bytes + 8;
            for (auto& cc : r->cols) cc.num.reserve(est);
        }
        if (after < endp && *after == '\r') ++after;
        row++;
        col = 0;
        rhd = false;
        row_start = after + 1;
        p = after + 1;                     // past '\n' (or EOF)
    }
    col_io = col;
    row_io = row;
    rhd_io = rhd;
    row_start_io = row_start;
    return p;
}

// Parse the byte buffer [p, endp) into r (quote-aware, sequential).
void parse_buffer(ParseResult* r, const char* p, const char* endp,
                  char sep, int skip_header) {
    bool in_quote = false;
    const char* const base = p;     // SWAR load guard (run_value)
    const char* field_start = p;
    const char* row_start = p;
    size_t col = 0;
    int64_t row = skip_header ? -1 : 0;
    bool row_has_data = false;

    // 256-entry dispatch: only these bytes break the tight scan loop
    bool special[256] = {false};
    special[(uint8_t)sep] = true;
    special[(uint8_t)'\n'] = true;
    special[(uint8_t)'"'] = true;
    special[(uint8_t)'\r'] = true;

    auto end_field = [&](const char* fe) {
        if (row >= 0)
            put_cell(r, col, row, field_start, fe - field_start, base);
        col++;
    };
    // the non-cell half of finishing a row: pad short rows, advance
    auto finish_row = [&](const char* fe) {
        if (row >= 0) {
            for (size_t c2 = 0; c2 < r->cols.size(); ++c2) {
                Column& cc = r->cols[c2];
                while ((int64_t)cc.num.size() <= row) {
                    cc.num.push_back(NAN);
                    cc.na_count++;
                }
            }
            if (row == 0) {
                // first data row done: reserve every column to the
                // row-count estimate, killing the ~log2(n) growth
                // reallocations that memcpy the whole plane each time
                size_t row_bytes = (size_t)(fe - row_start) + 1;
                if (row_bytes < 2) row_bytes = 2;
                size_t est = (size_t)(endp - row_start) / row_bytes + 8;
                for (auto& cc : r->cols) cc.num.reserve(est);
            }
        }
        row++;
        col = 0;
        row_has_data = false;
        row_start = fe + 1;
    };
    auto end_row = [&](const char* fe) {
        if (row_has_data || fe != field_start) {
            end_field(fe);
            finish_row(fe);
        } else {
            col = 0;
            row_has_data = false;
            row_start = fe + 1;
        }
    };

    while (p < endp) {
        if (!in_quote && row >= 0 && p == field_start) {
            p = fast_fields(r, p, endp, sep, base, col, row,
                            row_has_data, row_start);
            field_start = p;
            // fully consumed: fast_fields finished its last row itself
            // (p lands past endp when the final field ran to EOF)
            if (p >= endp)
                break;
        }
        const char* q = scan_plain(p, endp, sep, special);
        if (q != p) {
            row_has_data = true;
            p = q;
            if (p >= endp) break;
        }
        char ch = *p;
        if (ch == '"') {
            in_quote = !in_quote;
            row_has_data = true;
            ++p;
            if (in_quote && p < endp) {
                // inside quotes every byte but '"' is field data: jump
                const char* e = (const char*)memchr(p, '"', endp - p);
                p = e ? e : endp;
            }
        } else if (!in_quote && ch == sep) {
            end_field(p);
            field_start = p + 1;
            row_has_data = true;
            ++p;
        } else if (!in_quote && ch == '\n') {
            end_row(p);
            field_start = p + 1;
            ++p;
        } else {
            if (ch != '\r') row_has_data = true;
            ++p;
        }
    }
    if (field_start < endp || col > 0) end_row(endp);
    r->nrows = row < 0 ? 0 : row;
    // equalize column lengths
    for (auto& c : r->cols) {
        while ((int64_t)c.num.size() < r->nrows) {
            c.num.push_back(NAN);
            c.na_count++;
        }
    }
}

void build_bulk(Column& c) {
    if (c.bulk_built) return;
    c.bulk_rows.reserve(c.strs.size());
    c.bulk_lens.reserve(c.strs.size());
    size_t total = 0;
    for (const auto& sc : c.strs) total += sc.val.size();
    c.bulk_bytes.reserve(total);
    for (const auto& sc : c.strs) {
        c.bulk_rows.push_back(sc.row);
        c.bulk_lens.push_back((int32_t)sc.val.size());
        c.bulk_bytes.append(sc.val);
    }
    c.bulk_built = true;
}

void build_dict(Column& c) {
    if (c.dict_built) return;
    std::unordered_map<std::string_view, int32_t> ids;
    ids.reserve(64);
    c.dict_rows.reserve(c.strs.size());
    c.dict_codes.reserve(c.strs.size());
    for (const auto& sc : c.strs) {
        std::string_view key(sc.val);
        auto it = ids.find(key);
        int32_t id;
        if (it == ids.end()) {
            id = (int32_t)c.dict_lens.size();
            ids.emplace(key, id);
            c.dict_lens.push_back((int32_t)sc.val.size());
            c.dict_bytes.append(sc.val);
        } else {
            id = it->second;
        }
        c.dict_rows.push_back(sc.row);
        c.dict_codes.push_back(id);
    }
    c.dict_built = true;
}

}  // namespace

extern "C" {

// Parse a byte range of a CSV file — the unit of the distributed 2-phase
// parse (water/parser/FVecParseReader chunk semantics): a chunk at
// start > 0 skips forward past the first '\n' (the previous chunk owns
// that partial line) and parses THROUGH the first '\n' at/after `end`,
// so every line is parsed exactly once across adjacent ranges.
// Caveat shared with the reference's chunked reader: a quoted field
// containing '\n' must not straddle a range boundary (range boundaries
// are caller-aligned to multi-MB, making this astronomically unlikely;
// the single-range path has no such constraint).
void* fastcsv_parse_range(const char* path, char sep, long start, long end,
                          int skip_header) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    if (end < 0 || end > size) end = size;
    if (start < 0) start = 0;
    // extend end through the line straddling it
    long ext = end;
    if (ext < size) {
        fseek(f, ext, SEEK_SET);
        int ch;
        while (ext < size && (ch = fgetc(f)) != EOF) {
            ext++;
            if (ch == '\n') break;
        }
    }
    fseek(f, start, SEEK_SET);
    std::vector<char> buf(ext - start);
    if (ext > start &&
        fread(buf.data(), 1, ext - start, f) != (size_t)(ext - start)) {
        fclose(f);
        return nullptr;
    }
    fclose(f);
    const char* p = buf.data();
    const char* endp = p + buf.size();
    if (start > 0) {  // skip the partial first line (previous chunk's)
        while (p < endp && *p != '\n') p++;
        if (p < endp) p++;
    }
    auto* r = new ParseResult();
    parse_buffer(r, p, endp, sep, start == 0 ? skip_header : 0);
    return r;
}

// Parse a whole CSV file. Returns an opaque handle (nullptr on error).
void* fastcsv_parse(const char* path, char sep, int skip_header) {
    return fastcsv_parse_range(path, sep, 0, -1, skip_header);
}

// Parse caller-staged bytes (a streaming-decompressed gzip/zip window, an
// HTTP range read). The caller owns the chunk contract: `buf` must hold
// whole lines (io/dparse aligns windows on newline boundaries before
// handing them over). `skip_partial_first` applies the start>0 half of
// the range contract to a buffer whose head may be a partial line.
void* fastcsv_parse_bytes(const char* buf, long len, char sep,
                          int skip_header, int skip_partial_first) {
    const char* p = buf;
    const char* endp = buf + (len < 0 ? 0 : len);
    if (skip_partial_first) {
        while (p < endp && *p != '\n') p++;
        if (p < endp) p++;
    }
    auto* r = new ParseResult();
    parse_buffer(r, p, endp, sep, skip_partial_first ? 0 : skip_header);
    return r;
}

int64_t fastcsv_nrows(void* h) { return ((ParseResult*)h)->nrows; }
int64_t fastcsv_ncols(void* h) { return (int64_t)((ParseResult*)h)->cols.size(); }

const double* fastcsv_col_data(void* h, int64_t j) {
    return ((ParseResult*)h)->cols[j].num.data();
}

int64_t fastcsv_col_nstr(void* h, int64_t j) {
    return (int64_t)((ParseResult*)h)->cols[j].strs.size();
}

int64_t fastcsv_col_na(void* h, int64_t j) {
    return ((ParseResult*)h)->cols[j].na_count;
}

int64_t fastcsv_str_row(void* h, int64_t j, int64_t i) {
    return ((ParseResult*)h)->cols[j].strs[i].row;
}

const char* fastcsv_str_val(void* h, int64_t j, int64_t i) {
    return ((ParseResult*)h)->cols[j].strs[i].val.c_str();
}

// Bulk string-table export: three parallel planes (row indices, byte
// lengths, concatenated UTF-8 bytes) so the Python layer rebuilds a
// categorical column's side table with three numpy views instead of two
// ctypes calls per cell. Pointers stay valid until fastcsv_free.
const int64_t* fastcsv_str_rows_ptr(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_bulk(c);
    return c.bulk_rows.data();
}

const int32_t* fastcsv_str_lens_ptr(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_bulk(c);
    return c.bulk_lens.data();
}

const char* fastcsv_str_bytes_ptr(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_bulk(c);
    return c.bulk_bytes.data();
}

int64_t fastcsv_str_bytes_len(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_bulk(c);
    return (int64_t)c.bulk_bytes.size();
}

// Dictionary export of column j's string cells: their rows and one code
// a cell (both fastcsv_col_nstr long), and the fastcsv_dict_nlevels
// distinct tokens in first-seen order as lengths and concatenated bytes.
// Pointers stay valid until fastcsv_free.
int64_t fastcsv_dict_nlevels(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_dict(c);
    return (int64_t)c.dict_lens.size();
}

const int64_t* fastcsv_dict_rows_ptr(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_dict(c);
    return c.dict_rows.data();
}

const int32_t* fastcsv_dict_codes_ptr(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_dict(c);
    return c.dict_codes.data();
}

const int32_t* fastcsv_dict_lens_ptr(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_dict(c);
    return c.dict_lens.data();
}

const char* fastcsv_dict_bytes_ptr(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_dict(c);
    return c.dict_bytes.data();
}

int64_t fastcsv_dict_bytes_len(void* h, int64_t j) {
    Column& c = ((ParseResult*)h)->cols[j];
    build_dict(c);
    return (int64_t)c.dict_bytes.size();
}

void fastcsv_free(void* h) { delete (ParseResult*)h; }

}  // extern "C"
