// Native hot path for text feature hashing.
//
// The embedding front-end hashes character n-grams (FNV-1a) of lowercased
// UTF-8 bytes into a bucket-count vector; this is the only host-side hot
// loop on the ingest/rerank paths (everything after it is a matmul).  The
// Python/numpy implementation in models/text_embedder.py is the reference
// semantics; this translation unit must match it bit-for-bit and is loaded
// via ctypes with a transparent fallback when no compiler is available.
//
// Build: g++ -O3 -shared -fPIC ngram_hash.cc -o libngram_hash.so

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// counts must be zero-initialised, length n_buckets.
// ns: the n-gram sizes (e.g. {2,3,4}).
// Applies log1p at the end (sublinear tf), matching the Python path.
void ngram_counts(const unsigned char* text, int64_t len,
                  const int64_t* ns, int32_t n_ns,
                  int64_t n_buckets, float* counts) {
    if (len <= 0 || n_buckets <= 0) return;
    const uint64_t FNV_OFFSET = 14695981039346656037ULL;
    const uint64_t FNV_PRIME = 1099511628211ULL;
    for (int32_t k = 0; k < n_ns; ++k) {
        const int64_t n = ns[k];
        if (n <= 0 || len < n) continue;
        for (int64_t i = 0; i + n <= len; ++i) {
            uint64_t h = FNV_OFFSET;
            for (int64_t j = 0; j < n; ++j) {
                h = (h ^ (uint64_t)text[i + j]) * FNV_PRIME;
            }
            counts[h % (uint64_t)n_buckets] += 1.0f;
        }
    }
    for (int64_t b = 0; b < n_buckets; ++b) {
        counts[b] = log1pf(counts[b]);
    }
}

// Batched variant: texts concatenated, offsets[i]..offsets[i+1] per text,
// writes rows of a [n_texts, n_buckets] matrix.
void ngram_counts_batch(const unsigned char* blob, const int64_t* offsets,
                        int32_t n_texts, const int64_t* ns, int32_t n_ns,
                        int64_t n_buckets, float* out) {
    for (int32_t t = 0; t < n_texts; ++t) {
        const unsigned char* text = blob + offsets[t];
        int64_t len = offsets[t + 1] - offsets[t];
        float* row = out + (int64_t)t * n_buckets;
        memset(row, 0, sizeof(float) * (size_t)n_buckets);
        ngram_counts(text, len, ns, n_ns, n_buckets, row);
    }
}

}  // extern "C"
