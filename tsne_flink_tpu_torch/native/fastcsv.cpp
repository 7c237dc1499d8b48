// Native COO CSV reader/writer for the ingest/output path (a copy of the
// JAX package's native/fastcsv.cpp; the two must stay byte-identical in what
// they read and write).
//
// The reference delegates ingest to Flink's CSV source (Tsne.scala:138-159,
// readCsvFile) — a JVM-native, parallel parser.  The host-side equivalent
// is this small C++ library: memory-mapped input, std::from_chars float
// parsing (GCC 12), one pass, no per-line Python objects.
//
// Exposed via ctypes; utils/native.py builds it with g++ at first use and
// raises when the build fails.

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
    Mapped m;
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    m.data = static_cast<const char*>(p);
    m.size = st.st_size;
    madvise(p, st.st_size, MADV_SEQUENTIAL);
    return m;
}

void unmap(Mapped& m) {
    if (m.data) munmap(const_cast<char*>(m.data), m.size);
    if (m.fd >= 0) close(m.fd);
    m.data = nullptr;
    m.fd = -1;
}

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

// parse one double at p; returns next position or nullptr on failure
inline const char* parse_f64(const char* p, const char* end, double* out) {
    p = skip_ws(p, end);
    if (p < end && *p == '+') ++p;  // from_chars rejects the (numpy-legal) '+'
    auto [next, ec] = std::from_chars(p, end, *out);
    if (ec != std::errc()) return nullptr;
    return next;
}

}  // namespace

extern "C" {

// Count data lines (non-empty lines) — used to size the numpy output arrays.
long long coo_count_rows(const char* path) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    long long rows = 0;
    const char* p = m.data;
    const char* end = m.data + m.size;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        for (const char* q = p; q < line_end; ++q) {
            if (*q != ' ' && *q != '\t' && *q != '\r') {
                ++rows;
                break;
            }
        }
        if (!nl) break;
        p = nl + 1;
    }
    unmap(m);
    return rows;
}

// Parse `cols`-column comma/space-separated numeric CSV into out[row*cols+c].
// Returns the number of rows parsed, or -(1+line_number) on a malformed line.
long long coo_parse(const char* path, double* out, long long max_rows,
                    int cols) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    const char* p = m.data;
    const char* end = m.data + m.size;
    long long row = 0;
    long long line = 0;
    while (p < end && row < max_rows) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        ++line;
        const char* q = skip_ws(p, line_end);
        if (q < line_end) {  // non-empty line
            double* dst = out + row * cols;
            for (int c = 0; c < cols; ++c) {
                q = parse_f64(q, line_end, dst + c);
                if (!q) {
                    unmap(m);
                    return -(1 + line);
                }
                q = skip_ws(q, line_end);
                if (c + 1 < cols) {
                    if (q < line_end && *q == ',') {
                        ++q;
                    } else if (q >= line_end) {
                        unmap(m);
                        return -(1 + line);
                    }
                }
            }
            if (q < line_end) {  // trailing junk / extra fields: malformed
                unmap(m);
                return -(1 + line);
            }
            ++row;
        }
        if (!nl) break;
        p = nl + 1;
    }
    unmap(m);
    return row;
}

// Write embedding rows "id,y0,...,y{m-1}\n" with shortest round-trip floats.
long long write_embedding(const char* path, const long long* ids,
                          const double* y, long long n, int m) {
    FILE* f = fopen(path, "w");
    if (!f) return -1;
    const size_t BUF = 1 << 20;
    char* buf = new char[BUF];
    size_t used = 0;
    bool io_error = false;
    for (long long i = 0; i < n; ++i) {
        if (used + 32 * (m + 1) > BUF) {
            if (fwrite(buf, 1, used, f) != used) io_error = true;
            used = 0;
        }
        used += snprintf(buf + used, BUF - used, "%lld",
                         static_cast<long long>(ids[i]));
        for (int c = 0; c < m; ++c) {
            buf[used++] = ',';
            // %.17g round-trips doubles; trim via shortest-of-two attempts
            char tmp[40];
            int len = snprintf(tmp, sizeof tmp, "%.15g", y[i * m + c]);
            double back;
            auto [ptr, ec] = std::from_chars(tmp, tmp + len, back);
            (void)ptr;
            if (ec != std::errc() || back != y[i * m + c])
                len = snprintf(tmp, sizeof tmp, "%.17g", y[i * m + c]);
            memcpy(buf + used, tmp, len);
            used += len;
        }
        buf[used++] = '\n';
    }
    if (fwrite(buf, 1, used, f) != used) io_error = true;
    delete[] buf;
    if (fflush(f) != 0) io_error = true;
    if (fclose(f) != 0 || io_error) return -1;
    return n;
}

}  // extern "C"
