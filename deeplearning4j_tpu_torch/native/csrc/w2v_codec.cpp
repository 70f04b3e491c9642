// Google word2vec binary-format body parser.
//
// Reference seam: WordVectorSerializer.loadGoogleModel(binary=true)
// (deeplearning4j-nlp/.../loader/WordVectorSerializer.java) — the
// reference reads GB-scale pretrained embedding files through a buffered
// JVM stream; here the host-side hot path is one C++ scan over the
// mapped bytes with bulk memcpy of the vectors (floats are stored
// little-endian; this parser assumes a little-endian host, which the
// ctypes binding asserts).

#include <cstdint>
#include <cstring>

extern "C" {

// Parse n_words records of [word bytes] ' ' [dim x f32] [optional '\n']
// from buf/len (the file body after the "V D\n" header).
//   vecs:          out, n_words * dim floats
//   words:         out, concatenated word bytes (caller-sized words_cap)
//   word_offsets:  out, n_words + 1 prefix offsets into words
// Returns bytes consumed, or -1 on truncated/malformed input or word
// buffer overflow.
int64_t dl4j_w2v_parse(const uint8_t* buf, int64_t len, int64_t n_words,
                       int64_t dim, float* vecs, uint8_t* words,
                       int64_t words_cap, int64_t* word_offsets) {
    int64_t p = 0, w = 0;
    const int64_t vec_bytes = dim * 4;
    for (int64_t i = 0; i < n_words; ++i) {
        while (p < len && (buf[p] == '\n' || buf[p] == '\r')) ++p;
        word_offsets[i] = w;
        const int64_t start = p;
        while (p < len && buf[p] != ' ') ++p;
        if (p >= len) return -1;                 // no space -> truncated
        const int64_t wl = p - start;
        if (wl == 0 || w + wl > words_cap) return -1;
        std::memcpy(words + w, buf + start, wl);
        w += wl;
        ++p;                                     // the separating space
        if (p + vec_bytes > len) return -1;      // truncated vector
        std::memcpy(vecs + static_cast<size_t>(i) * dim, buf + p,
                    vec_bytes);
        p += vec_bytes;
    }
    word_offsets[n_words] = w;
    return p;
}

}  // extern "C"
