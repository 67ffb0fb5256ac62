// Native BM25 index builder: tokenization + df/tf statistics + slot-padded
// term-weight layout, and the pruned search's host aux structures (term ->
// tile lists, Bloom tile filters), exposed through a C ABI for ctypes.
//
// The port's copy of the JAX package's native/bm25_native.cpp, with the same
// C ABI and the same outputs. It is compiled by g++ on first use into
// autorag_research_tpu_torch/_build/ (autorag_research_tpu_torch/native.py).
// Corpus tokenization and BM25 weight precomputation are the host-side hot
// path of a sparse index build, so they run here in a single pass over the
// text with hash tables; the slot arrays then go to the GPU kernels
// (autorag_research_tpu_torch/ops/sparse.py).
//
// Tokenization matches the Python "simple" tokenizer for ASCII text
// ([a-z0-9]+ after lowercasing). Non-ASCII bytes pass through untouched (no
// Unicode case/word-class tables here), which would NOT match Python's
// str.lower()/\w semantics on accented letters or Unicode punctuation, so
// the index selects this builder only for pure-ASCII corpora (see
// autorag_research_tpu_torch/index/sparse.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Doc {
    std::vector<std::pair<int32_t, int32_t>> tf;  // (term_id, count), insertion order
    int64_t length = 0;
};

struct Bm25Index {
    std::unordered_map<std::string, int32_t> vocab;
    std::vector<std::string> terms;   // id -> term
    std::vector<int64_t> doc_freq;
    std::vector<Doc> docs;
    double k1 = 1.2;
    double b = 0.75;
    double avgdl = 0.0;
    int32_t max_slots = 0;

    // materialized slot arrays
    std::vector<int32_t> slot_ids;
    std::vector<float> slot_weights;
};

inline bool is_ascii_alnum(unsigned char c) {
    return (c >= '0' && c <= '9') || (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}

void tokenize_doc(const char* text, size_t len, Bm25Index& index, Doc& doc,
                  std::unordered_map<int32_t, int32_t>& tf_scratch) {
    tf_scratch.clear();
    std::string token;
    size_t i = 0;
    auto flush = [&]() {
        if (token.empty()) return;
        auto it = index.vocab.find(token);
        int32_t id;
        if (it == index.vocab.end()) {
            id = static_cast<int32_t>(index.terms.size());
            index.vocab.emplace(token, id);
            index.terms.push_back(token);
            index.doc_freq.push_back(0);
        } else {
            id = it->second;
        }
        ++tf_scratch[id];
        ++doc.length;
        token.clear();
    };
    while (i < len) {
        unsigned char c = static_cast<unsigned char>(text[i]);
        if (c < 0x80) {
            if (is_ascii_alnum(c)) {
                token.push_back(static_cast<char>(c >= 'A' && c <= 'Z' ? c + 32 : c));
            } else {
                flush();
            }
            ++i;
        } else {
            // multibyte UTF-8: copy the whole sequence as letter chars
            size_t n = 1;
            if ((c & 0xE0) == 0xC0) n = 2;
            else if ((c & 0xF0) == 0xE0) n = 3;
            else if ((c & 0xF8) == 0xF0) n = 4;
            for (size_t j = 0; j < n && i + j < len; ++j) token.push_back(text[i + j]);
            i += n;
        }
    }
    flush();
    doc.tf.reserve(tf_scratch.size());
    for (auto& kv : tf_scratch) doc.tf.emplace_back(kv.first, kv.second);
    for (auto& kv : doc.tf) ++index.doc_freq[kv.first];
}

void materialize(Bm25Index& index) {
    const size_t n = index.docs.size();
    int64_t total_len = 0;
    size_t slots = 1;
    for (auto& d : index.docs) {
        total_len += d.length;
        if (d.tf.size() > slots) slots = d.tf.size();
    }
    index.avgdl = n ? static_cast<double>(total_len) / n : 0.0;
    index.max_slots = static_cast<int32_t>(slots);
    index.slot_ids.assign(n * slots, -1);
    index.slot_weights.assign(n * slots, 0.0f);
    const double k1 = index.k1, b = index.b;
    for (size_t i = 0; i < n; ++i) {
        const Doc& d = index.docs[i];
        const double norm =
            k1 * (1.0 - b + (index.avgdl > 0 ? b * d.length / index.avgdl : 0.0));
        size_t base = i * slots;
        for (size_t s = 0; s < d.tf.size(); ++s) {
            const double cnt = d.tf[s].second;
            index.slot_ids[base + s] = d.tf[s].first;
            index.slot_weights[base + s] =
                static_cast<float>(cnt * (k1 + 1.0) / (cnt + norm));
        }
    }
}

}  // namespace

extern "C" {

void* bm25_create(double k1, double b) {
    auto* index = new Bm25Index();
    index->k1 = k1;
    index->b = b;
    return index;
}

void bm25_add_docs(void* handle, const char** texts, const int64_t* lengths, int64_t n_docs) {
    auto* index = static_cast<Bm25Index*>(handle);
    std::unordered_map<int32_t, int32_t> scratch;
    index->docs.reserve(index->docs.size() + n_docs);
    for (int64_t i = 0; i < n_docs; ++i) {
        index->docs.emplace_back();
        tokenize_doc(texts[i], static_cast<size_t>(lengths[i]), *index,
                     index->docs.back(), scratch);
    }
}

void bm25_finalize(void* handle) { materialize(*static_cast<Bm25Index*>(handle)); }

int64_t bm25_n_docs(void* handle) { return static_cast<Bm25Index*>(handle)->docs.size(); }
int64_t bm25_n_terms(void* handle) { return static_cast<Bm25Index*>(handle)->terms.size(); }
int32_t bm25_slots(void* handle) { return static_cast<Bm25Index*>(handle)->max_slots; }
double bm25_avgdl(void* handle) { return static_cast<Bm25Index*>(handle)->avgdl; }

void bm25_copy_slot_ids(void* handle, int32_t* out) {
    auto* index = static_cast<Bm25Index*>(handle);
    std::memcpy(out, index->slot_ids.data(), index->slot_ids.size() * sizeof(int32_t));
}

void bm25_copy_slot_weights(void* handle, float* out) {
    auto* index = static_cast<Bm25Index*>(handle);
    std::memcpy(out, index->slot_weights.data(), index->slot_weights.size() * sizeof(float));
}

void bm25_copy_doc_freq(void* handle, int64_t* out) {
    auto* index = static_cast<Bm25Index*>(handle);
    std::memcpy(out, index->doc_freq.data(), index->doc_freq.size() * sizeof(int64_t));
}

void bm25_copy_doc_lengths(void* handle, int64_t* out) {
    auto* index = static_cast<Bm25Index*>(handle);
    for (size_t i = 0; i < index->docs.size(); ++i) out[i] = index->docs[i].length;
}

// vocab exported as one newline-joined blob (single copy instead of per-term calls)
int64_t bm25_vocab_blob_size(void* handle) {
    auto* index = static_cast<Bm25Index*>(handle);
    int64_t total = 0;
    for (auto& t : index->terms) total += static_cast<int64_t>(t.size()) + 1;
    return total;
}

void bm25_copy_vocab_blob(void* handle, char* out) {
    auto* index = static_cast<Bm25Index*>(handle);
    for (auto& t : index->terms) {
        std::memcpy(out, t.data(), t.size());
        out += t.size();
        *out++ = '\n';
    }
}

void bm25_destroy(void* handle) { delete static_cast<Bm25Index*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Pruned-search index-aux builders (probe kernel + Bloom tile-skip).
//
// The plain builders (ops/sparse.py build_term_tile_lists_plain /
// build_tile_bitmaps_plain) are vectorized numpy but sort-bound. Here
// presence is marked straight into a (term, tile) bitmap (no sort), and Bloom
// probe bits are OR-ed directly (idempotent, no dedupe pass). Threaded over
// doc ranges with relaxed atomic ORs; OR is order-free, so the output does
// not depend on the thread count.

#include <algorithm>
#include <thread>

namespace {

inline void atomic_or_u64(uint64_t* addr, uint64_t bits) {
    __atomic_or_fetch(addr, bits, __ATOMIC_RELAXED);
}

inline void atomic_or_u32(uint32_t* addr, uint32_t bits) {
    __atomic_or_fetch(addr, bits, __ATOMIC_RELAXED);
}

inline int aux_threads(int64_t n_docs) {
    unsigned hw = std::thread::hardware_concurrency();
    int t = hw ? static_cast<int>(hw) : 4;
    int64_t per = 64 * 1024;  // don't spin threads for small corpora
    if (n_docs / per < t) t = static_cast<int>(n_docs / per) + 1;
    return t < 1 ? 1 : t;
}

template <typename Fn>
void parallel_docs(int64_t n_docs, Fn&& fn) {
    int t = aux_threads(n_docs);
    if (t == 1) {
        fn(0, n_docs);
        return;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (n_docs + t - 1) / t;
    for (int i = 0; i < t; ++i) {
        int64_t lo = i * chunk, hi = std::min<int64_t>(n_docs, lo + chunk);
        if (lo >= hi) break;
        pool.emplace_back([&fn, lo, hi] { fn(lo, hi); });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Mark (term, tile) presence. bitmap layout: per-term word-aligned rows of
// words_per_term = ceil(n_tiles/64) uint64 words, caller-zeroed,
// vocab * words_per_term words total.
void aux_mark_term_tiles(const int32_t* doc_ids, int64_t n_docs, int32_t slots,
                         int32_t block_n, int64_t words_per_term,
                         uint64_t* bitmap) {
    parallel_docs(n_docs, [=](int64_t lo, int64_t hi) {
        for (int64_t d = lo; d < hi; ++d) {
            const int64_t tile = d / block_n;
            const uint64_t bit = uint64_t(1) << (tile & 63);
            const int64_t word = tile >> 6;
            const int32_t* row = doc_ids + d * slots;
            for (int32_t s = 0; s < slots; ++s) {
                const int32_t t = row[s];
                if (t < 0) continue;
                atomic_or_u64(bitmap + int64_t(t) * words_per_term + word, bit);
            }
        }
    });
}

// indptr[v+1] = number of tiles containing term v (prefix-summed by caller or
// here: we emit exclusive prefix sums directly).
void aux_term_tiles_indptr(const uint64_t* bitmap, int64_t vocab,
                           int64_t words_per_term, int64_t* indptr) {
    indptr[0] = 0;
    for (int64_t v = 0; v < vocab; ++v) {
        const uint64_t* row = bitmap + v * words_per_term;
        int64_t c = 0;
        for (int64_t w = 0; w < words_per_term; ++w) c += __builtin_popcountll(row[w]);
        indptr[v + 1] = indptr[v] + c;
    }
}

// Extract sorted tile ids per term into tiles[nnz] (CSR payload for indptr).
void aux_term_tiles_extract(const uint64_t* bitmap, int64_t vocab,
                            int64_t words_per_term, const int64_t* indptr,
                            int32_t* tiles) {
    for (int64_t v = 0; v < vocab; ++v) {
        const uint64_t* row = bitmap + v * words_per_term;
        int64_t out = indptr[v];
        for (int64_t w = 0; w < words_per_term; ++w) {
            uint64_t bits = row[w];
            while (bits) {
                const int b = __builtin_ctzll(bits);
                tiles[out++] = static_cast<int32_t>(w * 64 + b);
                bits &= bits - 1;
            }
        }
    }
}

// Per-tile 4-probe Bloom filters (query-side probe in ops/sparse.py uses the
// same multiplicative hashes; 32*n_words must be a power of two).
void aux_bloom_bitmaps(const int32_t* doc_ids, int64_t n_docs, int32_t slots,
                       int32_t block_n, int64_t n_words, uint32_t* out) {
    const uint64_t space = uint64_t(32) * n_words;
    const uint64_t mask = space - 1;
    static const uint64_t MULTS[4] = {0x9E3779B1ull, 0x85EBCA77ull,
                                      0xC2B2AE3Dull, 0x27D4EB2Full};
    parallel_docs(n_docs, [=](int64_t lo, int64_t hi) {
        for (int64_t d = lo; d < hi; ++d) {
            uint32_t* base = out + (d / block_n) * n_words;
            const int32_t* row = doc_ids + d * slots;
            for (int32_t s = 0; s < slots; ++s) {
                const int32_t t = row[s];
                if (t < 0) continue;
                for (int m = 0; m < 4; ++m) {
                    const uint64_t pos = (uint64_t(uint32_t(t)) * MULTS[m]) & mask;
                    atomic_or_u32(base + (pos >> 5), uint32_t(1) << (pos & 31));
                }
            }
        }
    });
}

}  // extern "C"
