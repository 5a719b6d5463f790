// Native host-side text codecs for the hot I/O paths.
//
// The reference implements its entire I/O layer in C++ (libStatGen's VCF
// classes plus src/format_{hap,plink,vcf}.cpp); this library is this
// package's equivalent: the O(n*m) text<->matrix conversions run here at
// memory speed while Python keeps the (cheap) per-file orchestration.
//
// Exposed via a C ABI for ctypes (no pybind11 in the image).
//
//   hap_parse     .hap text -> (m, 2n) uint8 alleles (caller transposes)
//   hap_format    (m, 2n) alleles -> .hap text ("0 1 ... \n" per SNP row)
//   vcf_count     count data records + samples in a VCF buffer
//   vcf_parse_gt  VCF buffer -> per-record fixed-column offsets + GT matrix
//   gt_format     (n, m) pair matrix -> "\t a|b" GT tails per record
//   ped_format    (n, m, 2) allele letters -> PED genotype tail per individual
//
// All functions return 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Parse a .hap buffer: rows of "c c c ... c\n" where alleles sit at even
// character offsets (strict positional parse, format_hap.cpp:95-106).
// out must hold nrows*ncols bytes (SNP-major). Returns 0, or -(line+1) on a
// character that is not '0'/'1'.
int64_t hap_parse(const char* buf, int64_t len, int64_t nrows, int64_t ncols,
                  uint8_t* out) {
    int64_t row = 0;
    int64_t i = 0;
    while (i < len && row < nrows) {
        // parse one line
        uint8_t* dst = out + row * ncols;
        int64_t col = 0;
        while (col < ncols) {
            char c = buf[i];
            if (c != '0' && c != '1') return -(row + 1);
            dst[col++] = (uint8_t)(c - '0');
            i += 2;  // skip the separator
        }
        // skip to end of line
        while (i < len && buf[i] != '\n') i++;
        i++;
        row++;
    }
    return row == nrows ? 0 : -(row + 1);
}

// Format a SNP-major (nrows, ncols) 0/1 matrix as .hap text: every allele
// followed by a space, newline-terminated rows (format_hap.cpp:17-25).
// out must hold nrows*(2*ncols+1) bytes. Returns bytes written.
int64_t hap_format(const uint8_t* mat, int64_t nrows, int64_t ncols,
                   char* out) {
    char* p = out;
    for (int64_t r = 0; r < nrows; ++r) {
        const uint8_t* src = mat + r * ncols;
        for (int64_t c = 0; c < ncols; ++c) {
            *p++ = (char)('0' + src[c]);
            *p++ = ' ';
        }
        p[-1] = ' ';  // reference writes trailing space then newline
        *p++ = '\n';
    }
    return (int64_t)(p - out);
}

// First pass over a VCF buffer: counts usable biallelic data records and
// samples. A record is counted if it has >= 10 tab-separated fields and its
// ALT has no ','. Multi-allelic records are skipped, filter status is NOT
// enforced (format_vcf.cpp:114-121,172-178).
int64_t vcf_count(const char* buf, int64_t len, int64_t* n_records,
                  int64_t* n_samples) {
    int64_t records = 0, samples = -1;
    int64_t i = 0;
    while (i < len) {
        int64_t line_start = i;
        while (i < len && buf[i] != '\n') i++;
        int64_t line_end = i;
        i++;
        if (line_end - line_start < 1) continue;
        if (buf[line_start] == '#') {
            if (line_end - line_start >= 6 &&
                memcmp(buf + line_start, "#CHROM", 6) == 0) {
                int64_t tabs = 0;
                for (int64_t j = line_start; j < line_end; ++j)
                    if (buf[j] == '\t') tabs++;
                samples = tabs - 8;
            }
            continue;
        }
        // count tabs; find ALT (field 5)
        int64_t tabs = 0;
        bool multiallelic = false;
        int64_t field = 0;
        for (int64_t j = line_start; j < line_end; ++j) {
            if (buf[j] == '\t') {
                tabs++;
                field++;
            } else if (field == 4 && buf[j] == ',') {
                multiallelic = true;
            }
        }
        if (tabs >= 9 && !multiallelic) records++;
    }
    *n_records = records;
    *n_samples = samples;
    return 0;
}

// Second pass: fill GT matrix (2*n_samples, n_records) hap-major and record
// the byte offset/length of each kept record's first 9 columns (for Python
// to slice CHROM..FORMAT without re-scanning). gt is indexed
// gt[h * n_records + rec]. Unknown '.' alleles become 0 (format_vcf semantics:
// anything not '0' maps by digit; we map '.'->0 like the Python codec).
int64_t vcf_parse_gt(const char* buf, int64_t len, int64_t n_records,
                     int64_t n_samples, uint8_t* gt, int64_t* rec_off,
                     int64_t* rec_len) {
    int64_t rec = 0;
    int64_t i = 0;
    while (i < len && rec < n_records) {
        int64_t line_start = i;
        while (i < len && buf[i] != '\n') i++;
        int64_t line_end = i;
        i++;
        if (line_end - line_start < 1 || buf[line_start] == '#') continue;
        // locate field boundaries
        int64_t field = 0;
        bool multiallelic = false;
        int64_t fixed_end = line_end;  // end of field 8 (FORMAT)
        int64_t tabs = 0;
        for (int64_t j = line_start; j < line_end; ++j) {
            if (buf[j] == '\t') {
                tabs++;
                field++;
                if (field == 9) fixed_end = j;
            } else if (field == 4 && buf[j] == ',') {
                multiallelic = true;
            }
        }
        if (tabs < 9 || multiallelic) continue;
        rec_off[rec] = line_start;
        rec_len[rec] = fixed_end - line_start;
        // parse GT cells after fixed_end
        int64_t j = fixed_end + 1;
        for (int64_t s = 0; s < n_samples; ++s) {
            // cell runs to next tab or line end; GT is the part before ':'
            char a = buf[j];
            uint8_t va = (a >= '1' && a <= '9') ? 1 : 0;
            // advance past first allele (may be multi-digit)
            while (j < line_end && buf[j] != '|' && buf[j] != '/' &&
                   buf[j] != '\t')
                j++;
            uint8_t vb = 0;
            if (j < line_end && (buf[j] == '|' || buf[j] == '/')) {
                j++;
                char b = buf[j];
                vb = (b >= '1' && b <= '9') ? 1 : 0;
            }
            gt[(2 * s) * n_records + rec] = va;
            gt[(2 * s + 1) * n_records + rec] = vb;
            // advance to next cell
            while (j < line_end && buf[j] != '\t') j++;
            j++;
        }
        rec++;
    }
    return rec == n_records ? 0 : -(rec + 1);
}

// Format GT tails: for record j write "\ta|b" for every sample into out.
// hapA/hapB are (n_samples, n_records) row-major. Each record tail is
// 4*n_samples bytes followed by '\n'. Returns bytes written.
int64_t gt_format(const uint8_t* hapA, const uint8_t* hapB,
                  int64_t n_samples, int64_t n_records, char* out) {
    char* p = out;
    for (int64_t j = 0; j < n_records; ++j) {
        for (int64_t s = 0; s < n_samples; ++s) {
            *p++ = '\t';
            *p++ = (char)('0' + hapA[s * n_records + j]);
            *p++ = '|';
            *p++ = (char)('0' + hapB[s * n_records + j]);
        }
        *p++ = '\n';
    }
    return (int64_t)(p - out);
}

// Format the per-individual info table body
// (`Population::ras_save_human_info`, Population.cpp:510-568): per row,
// k_int integer columns (IDs + sex) then k_val float columns rendered %g
// (matching Python's f"{x:g}"), space separated, newline terminated.
// ids is (n, k_int) int64 row-major, vals is (n, k_val) double row-major.
// Returns bytes written, or -1 if out (capacity cap) would overflow.
int64_t info_format(const int64_t* ids, int64_t n, int64_t k_int,
                    const double* vals, int64_t k_val, char* out,
                    int64_t cap) {
    char* p = out;
    const char* end = out + cap;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* idr = ids + i * k_int;
        const double* vr = vals + i * k_val;
        for (int64_t j = 0; j < k_int; ++j) {
            if (end - p < 32) return -1;
            int w = snprintf(p, 32, j ? " %lld" : "%lld", (long long)idr[j]);
            if (w < 0) return -1;
            p += w;
        }
        for (int64_t j = 0; j < k_val; ++j) {
            if (end - p < 40) return -1;
            int w = snprintf(p, 40, " %g", vr[j]);
            if (w < 0) return -1;
            p += w;
        }
        if (p >= end) return -1;
        *p++ = '\n';
    }
    return (int64_t)(p - out);
}

// Multi-threaded info_format: rows are split into `threads` contiguous
// chunks, each formatted into a private region of `out` sized by the same
// per-row capacity bound the Python wrapper uses; chunks are then compacted
// in place. Row content is identical to info_format (formatting is
// row-local). Returns bytes written or -1 on overflow.
int64_t info_format_mt(const int64_t* ids, int64_t n, int64_t k_int,
                       const double* vals, int64_t k_val, char* out,
                       int64_t cap, int64_t threads) {
    if (threads < 2 || n < 4096)
        return info_format(ids, n, k_int, vals, k_val, out, cap);
    if (threads > 32) threads = 32;
    int64_t per_row = k_int * 22 + k_val * 16 + 2;  // wrapper's bound
    if (per_row * n + 64 > cap)
        return info_format(ids, n, k_int, vals, k_val, out, cap);
    int64_t chunk = (n + threads - 1) / threads;
    std::vector<int64_t> written((size_t)threads, 0);
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < threads; ++t) {
        pool.emplace_back([&, t]() {
            int64_t lo = t * chunk;
            int64_t hi = lo + chunk < n ? lo + chunk : n;
            if (lo >= hi) return;
            written[(size_t)t] = info_format(
                ids + lo * k_int, hi - lo, k_int, vals + lo * k_val, k_val,
                out + lo * per_row, (hi - lo) * per_row + 64);
        });
    }
    for (auto& th : pool) th.join();
    // compact: move each chunk down to the end of the previous one
    int64_t total = written[0];
    if (total < 0) return -1;
    for (int64_t t = 1; t < threads; ++t) {
        int64_t w = written[(size_t)t];
        if (w < 0) return -1;
        if (w == 0) continue;
        memmove(out + total, out + t * chunk * per_row, (size_t)w);
        total += w;
    }
    return total;
}

// Format the genotype tail of one PED row: " A A G G ..." for m SNPs with
// allele letters. letters is (m, 2) of single chars; out needs 4*m bytes.
int64_t ped_format(const char* letters, int64_t m, char* out) {
    char* p = out;
    for (int64_t j = 0; j < m; ++j) {
        *p++ = ' ';
        *p++ = letters[2 * j];
        *p++ = ' ';
        *p++ = letters[2 * j + 1];
    }
    return (int64_t)(p - out);
}

}  // extern "C"
