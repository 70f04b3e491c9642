// Fast host-side record decoding: CSV → float32 matrix, IDX (MNIST) readers.
//
// TPU-native equivalent of the DataVec native record readers the reference
// consumes as an external Maven dep (SURVEY.md §2.8 item 3: RecordReaders
// feeding RecordReaderDataSetIterator). The host CPU must decode and stage
// batches fast enough to keep the TPU fed; Python-level parsing becomes the
// bottleneck at high samples/sec, so the inner parse loops live here.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parses delimiter-separated numeric text into out (row-major float32).
// Rows are '\n'-separated; empty rows skipped. Returns total values written,
// or -1 if out/max_vals is exceeded. n_rows/n_cols receive the matrix shape
// (n_cols = columns of the first non-empty row).
int64_t dl4j_csv_parse(const char* buf, int64_t len, char delim, float* out,
                       int64_t max_vals, int64_t* n_rows, int64_t* n_cols) {
    int64_t written = 0, rows = 0, cols = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        // Find end of line.
        const char* eol = p;
        while (eol < end && *eol != '\n') ++eol;
        if (eol > p && eol[-1] == '\r') {
            // Trim CR of CRLF by treating it as line end below.
        }
        const char* line_end = (eol > p && eol[-1] == '\r') ? eol - 1 : eol;
        bool blank = true;
        for (const char* q = p; q < line_end; ++q) {
            if (*q != ' ' && *q != '\t') { blank = false; break; }
        }
        if (!blank) {
            // Exactly one delimiter per field separator: a row with k
            // delimiters has k+1 fields; empty or non-numeric fields
            // parse as 0.0 (matches the Python fallback).
            int64_t row_cols = 0;
            const char* field = p;
            for (const char* q = p; q <= line_end; ++q) {
                if (q == line_end || *q == delim) {
                    float v = 0.0f;
                    if (q > field) {
                        char* next = nullptr;
                        double d = strtod(field, &next);
                        if (next != field && next <= q) {
                            v = static_cast<float>(d);
                        }
                    }
                    if (written >= max_vals) return -1;
                    out[written++] = v;
                    ++row_cols;
                    field = q + 1;
                }
            }
            if (rows == 0) cols = row_cols;
            ++rows;
        }
        p = eol + 1;
    }
    *n_rows = rows;
    *n_cols = cols;
    return written;
}

// IDX (MNIST ubyte) header parse. Returns data offset in bytes, or -1 on a
// malformed header. dims must hold up to 8 entries.
int64_t dl4j_idx_header(const uint8_t* buf, int64_t len, int32_t* dtype,
                        int32_t* ndim, int64_t* dims) {
    if (len < 4 || buf[0] != 0 || buf[1] != 0) return -1;
    *dtype = buf[2];
    int32_t nd = buf[3];
    if (nd <= 0 || nd > 8) return -1;
    if (len < 4 + 4 * nd) return -1;
    for (int32_t d = 0; d < nd; ++d) {
        const uint8_t* q = buf + 4 + 4 * d;
        dims[d] = ((int64_t)q[0] << 24) | ((int64_t)q[1] << 16) |
                  ((int64_t)q[2] << 8) | (int64_t)q[3];
    }
    *ndim = nd;
    return 4 + 4 * nd;
}

// uint8 → float32 with scale (e.g. 1/255 pixel normalisation).
void dl4j_u8_to_f32(const uint8_t* in, int64_t n, float scale, float* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * scale;
}

// One-hot encode int labels into a zeroed [n, k] float32 matrix.
void dl4j_one_hot(const int32_t* labels, int64_t n, int32_t k, float* out) {
    memset(out, 0, sizeof(float) * (size_t)(n * k));
    for (int64_t i = 0; i < n; ++i) {
        int32_t c = labels[i];
        if (c >= 0 && c < k) out[i * k + c] = 1.0f;
    }
}

}  // extern "C"
