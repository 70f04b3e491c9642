// Threshold gradient compression codec (Strom-style 1-bit with residual).
//
// TPU-native equivalent of the reference's native threshold-encoding ops
// consumed by EncodingHandler
// (deeplearning4j-nn/.../optimize/solvers/accumulation/EncodingHandler.java:65
//  calls Nd4j.getExecutioner().thresholdEncode(...), implemented in libnd4j).
// On TPU, intra-slice gradient exchange rides ICI via XLA psum and needs no
// compression; this codec is for the DCN-side exchange between hosts
// (parameter-server-style async updates, SURVEY.md §5 "Distributed
// communication backend"), where bandwidth is scarce.
//
// Encoding: for every |g[i]| >= t, emit index i and a sign bit; subtract
// sign*t from g in place, so g retains the residual for later rounds.

#include <cstdint>
#include <cstring>

extern "C" {

// Returns number of encoded elements (clipped at max_out). grad is modified
// in place to hold the residual.
int64_t dl4j_threshold_encode(float* grad, int64_t n, float threshold,
                              int32_t* idx_out, uint8_t* sign_out,
                              int64_t max_out) {
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        float g = grad[i];
        if (g >= threshold) {
            if (m >= max_out) return m;
            idx_out[m] = static_cast<int32_t>(i);
            sign_out[m] = 1;
            grad[i] = g - threshold;
            ++m;
        } else if (g <= -threshold) {
            if (m >= max_out) return m;
            idx_out[m] = static_cast<int32_t>(i);
            sign_out[m] = 0;
            grad[i] = g + threshold;
            ++m;
        }
    }
    return m;
}

// Applies a sparse encoded update into target: target[idx] += (+t | -t).
void dl4j_threshold_decode(float* target, int64_t n, float threshold,
                           const int32_t* idx, const uint8_t* signs,
                           int64_t m) {
    for (int64_t j = 0; j < m; ++j) {
        int32_t i = idx[j];
        if (i < 0 || i >= n) continue;
        target[i] += signs[j] ? threshold : -threshold;
    }
}

// Bit-packs sign+index into one int32 stream (sign in the top bit) for wire
// transport; returns bytes written into out (must hold 4*m bytes).
int64_t dl4j_threshold_pack(const int32_t* idx, const uint8_t* signs,
                            int64_t m, int32_t* out) {
    for (int64_t j = 0; j < m; ++j) {
        out[j] = (idx[j] & 0x7fffffff) | (signs[j] ? (int32_t)0x80000000 : 0);
    }
    return m * 4;
}

void dl4j_threshold_unpack(const int32_t* packed, int64_t m, int32_t* idx,
                           uint8_t* signs) {
    for (int64_t j = 0; j < m; ++j) {
        int32_t v = packed[j];
        idx[j] = v & 0x7fffffff;
        signs[j] = (v & (int32_t)0x80000000) ? 1 : 0;
    }
}

}  // extern "C"
