// Native COO CSV reader/writer for the ingest/output path (from the JAX
// package's native/fastcsv.cpp, whose parse is one pass on one thread; the
// two must stay byte-identical in what they read and write).
//
// The reference delegates ingest to Flink's CSV source (Tsne.scala:138-159,
// readCsvFile) — a JVM-native, parallel parser.  The host-side equivalent
// is this small C++ library: memory-mapped input, std::from_chars float
// parsing (GCC 12), the file cut into slices of whole lines parsed on
// threads at once, no per-line Python objects.
//
// Exposed via ctypes; utils/native.py builds it with g++ at first use and
// raises when the build fails.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <thread>
#include <vector>

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

// One slice of the file: whole lines, [begin, end).
struct Slice {
    const char* begin;
    const char* end;
};

// `parts` slices of m, each starting at a line's start (the last may be
// empty when the file has fewer lines than parts).
std::vector<Slice> split_lines(const Mapped& m, int parts) {
    std::vector<Slice> out(parts);
    const char* end = m.data + m.size;
    const char* at = m.data;
    for (int t = 0; t < parts; ++t) {
        const char* stop = end;
        if (t + 1 < parts) {
            stop = m.data + m.size / parts * (t + 1);
            if (stop < at) stop = at;
            const char* nl = static_cast<const char*>(
                memchr(stop, '\n', end - stop));
            stop = nl ? nl + 1 : end;
        }
        out[t] = {at, stop};
        at = stop;
    }
    return out;
}

// Lines started and non-empty lines in [p, end).
void count_lines(const char* p, const char* end, long long* lines,
                 long long* rows) {
    long long nl_count = 0, nonempty = 0;
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        const char* line_end = nl ? nl : end;
        ++nl_count;
        for (const char* q = p; q < line_end; ++q) {
            if (*q != ' ' && *q != '\t' && *q != '\r') {
                ++nonempty;
                break;
            }
        }
        if (!nl) break;
        p = nl + 1;
    }
    *lines = nl_count;
    *rows = nonempty;
}

// Parse at most max_rows non-empty lines of [p, end) into out.  Returns the
// rows parsed, or -(1 + line) for the slice's first malformed line (1-based
// within the slice).
long long parse_lines(const char* p, const char* end, double* out,
                      long long max_rows, int cols) {
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
                if (!q) return -(1 + line);
                q = skip_ws(q, line_end);
                if (c + 1 < cols) {
                    if (q < line_end && *q == ',') {
                        ++q;
                    } else if (q >= line_end) {
                        return -(1 + line);
                    }
                }
            }
            if (q < line_end) return -(1 + line);  // trailing junk
            ++row;
        }
        if (!nl) break;
        p = nl + 1;
    }
    return row;
}

// fn(t) for t in [0, parts), on a thread each past the first.
template <typename Fn>
void on_threads(int parts, Fn fn) {
    std::vector<std::thread> pool;
    for (int t = 1; t < parts; ++t) pool.emplace_back(fn, t);
    fn(0);
    for (auto& th : pool) th.join();
}

// [b_t, b_{t+1}) slices of a COO's entries, each starting where a point's
// run of entries starts, so that no point's row is written by two threads.
std::vector<long long> run_slices(const double* coo, long long rows,
                                  int parts) {
    std::vector<long long> b(parts + 1, rows);
    b[0] = 0;
    for (int t = 1; t < parts; ++t) {
        long long at = rows / parts * t;
        if (at < b[t - 1]) at = b[t - 1];
        while (at > 0 && at < rows && coo[at * 3] == coo[(at - 1) * 3]) ++at;
        b[t] = at;
    }
    return b;
}

// Point runs started in [lo, hi), or -1 when an entry is not a point id
// and feature id that are integers (ids in [0, 2^53), features in [0, dim))
// or a point id is below the one before it.
long long count_runs(const double* coo, long long lo, long long hi,
                     int dim) {
    long long starts = 0;
    for (long long i = lo; i < hi; ++i) {
        double p = coo[i * 3], f = coo[i * 3 + 1];
        if (!(p >= 0.0 && p < 9007199254740992.0 && p == std::floor(p)))
            return -1;
        if (!(f >= 0.0 && f < dim && f == std::floor(f))) return -1;
        if (i == 0 || p != coo[(i - 1) * 3]) {
            if (i > 0 && p < coo[(i - 1) * 3]) return -1;
            ++starts;
        }
    }
    return starts;
}

}  // namespace

extern "C" {

// Count data lines (non-empty lines) — used to size the numpy output arrays.
// The file is cut into `threads` slices of whole lines, counted at once.
long long coo_count_rows(const char* path, int threads) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    if (threads < 1) threads = 1;
    std::vector<Slice> slices = split_lines(m, threads);
    std::vector<long long> lines(threads), rows(threads);
    on_threads(threads, [&](int t) {
        count_lines(slices[t].begin, slices[t].end, &lines[t], &rows[t]);
    });
    unmap(m);
    long long total = 0;
    for (long long r : rows) total += r;
    return total;
}

// Parse `cols`-column comma/space-separated numeric CSV into out[row*cols+c].
// Returns the number of rows parsed, or -(1+line_number) on a malformed line.
// The file is cut into `threads` slices of whole lines: each slice's rows
// and lines are counted, then each slice is parsed into its own rows; the
// result is the one-pass parse's (its first malformed line within max_rows,
// else min(rows, max_rows)).
long long coo_parse(const char* path, double* out, long long max_rows,
                    int cols, int threads) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    if (threads < 1) threads = 1;
    std::vector<Slice> slices = split_lines(m, threads);
    std::vector<long long> lines(threads), rows(threads), got(threads);
    if (threads > 1) {
        on_threads(threads, [&](int t) {
            count_lines(slices[t].begin, slices[t].end, &lines[t], &rows[t]);
        });
    }
    std::vector<long long> row0(threads, 0), line0(threads, 0);
    for (int t = 1; t < threads; ++t) {
        row0[t] = row0[t - 1] + rows[t - 1];
        line0[t] = line0[t - 1] + lines[t - 1];
    }
    on_threads(threads, [&](int t) {
        long long room = max_rows - row0[t];
        got[t] = room > 0 ? parse_lines(slices[t].begin, slices[t].end,
                                        out + row0[t] * cols, room, cols)
                          : 0;
    });
    unmap(m);
    long long total = 0;
    for (int t = 0; t < threads; ++t) {
        if (got[t] < 0) return got[t] - line0[t];
        total += got[t];
    }
    return total < max_rows ? total : max_rows;
}

// Distinct point ids of a parsed COO ([rows, 3] point, feature, value)
// whose point ids never decrease and whose ids and features are integers
// (features below dim), counted on `threads` slices at once; -1 for any
// other COO (the caller assembles that one itself).
long long coo_points(const double* coo, long long rows, int dim,
                     int threads) {
    if (threads < 1) threads = 1;
    std::vector<long long> b = run_slices(coo, rows, threads);
    std::vector<long long> starts(threads);
    on_threads(threads, [&](int t) {
        starts[t] = count_runs(coo, b[t], b[t + 1], dim);
    });
    long long total = 0;
    for (long long c : starts) {
        if (c < 0) return -1;
        total += c;
    }
    return total;
}

// The dense rows of a COO that coo_points counted: ids[r] is the r-th
// distinct point id, x[r * dim + f] the value of its feature f (a feature
// given twice keeps its last value); x holds zeros on entry.
void coo_dense(const double* coo, long long rows, int dim, int threads,
               long long* ids, double* x) {
    if (threads < 1) threads = 1;
    std::vector<long long> b = run_slices(coo, rows, threads);
    std::vector<long long> row0(threads + 1, 0);
    on_threads(threads, [&](int t) {
        row0[t + 1] = count_runs(coo, b[t], b[t + 1], dim);
    });
    for (int t = 0; t < threads; ++t) row0[t + 1] += row0[t];
    on_threads(threads, [&](int t) {
        long long r = row0[t] - 1;
        for (long long i = b[t]; i < b[t + 1]; ++i) {
            double p = coo[i * 3];
            if (i == 0 || p != coo[(i - 1) * 3]) ids[++r] =
                static_cast<long long>(p);
            x[r * dim + static_cast<long long>(coo[i * 3 + 1])] =
                coo[i * 3 + 2];
        }
    });
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
