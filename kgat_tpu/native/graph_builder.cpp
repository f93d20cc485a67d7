// Native host-side graph tooling for kgat_tpu.
//
// Counterpart of DGL's C++ graph-index layer (SURVEY.md §2.2:
// `src/graph/unit_graph.cc` COO/CSR storage + format conversion — the
// reference stack's native components; locations reconstructed, the
// reference mount was empty). Here the *device* side of the graph is a
// pytree of arrays (kgat_tpu/graph.py) consumed by XLA/Pallas, so the
// native layer's job is the host side: parsing multi-GB dataset text files
// and building the sorted/CSR/aligned edge layouts fast. Everything here
// has a pure-numpy fallback with identical output (kgat_tpu/graph.py,
// kgat_tpu/data.py); this library is the production fast path.
//
// C ABI only (consumed via ctypes; pybind11 is not available in the build
// image). All buffers are caller-allocated numpy arrays.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Dataset parsing: "uid iid iid ..." lines -> (u, i) pairs.
// Pass 1: kgat_count_pairs returns the pair count (-1 on IO error).
// Pass 2: kgat_parse_pairs fills caller buffers, returns pairs written.
// ---------------------------------------------------------------------------

static bool read_file(const char* path, std::vector<char>& buf) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    buf.resize(static_cast<size_t>(sz) + 1);
    size_t rd = std::fread(buf.data(), 1, static_cast<size_t>(sz), f);
    std::fclose(f);
    if (rd != static_cast<size_t>(sz)) return false;
    buf[rd] = '\0';
    return true;
}

// Parses the file once; if out_u/out_i are null just counts.
static int64_t parse_pairs_impl(const char* path, int64_t* out_u,
                                int64_t* out_i, int64_t cap) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    const char* p = buf.data();
    const char* end = p + buf.size() - 1;
    int64_t n = 0;
    while (p < end) {
        // parse one line: first token = uid, rest = item ids
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        char* next = nullptr;
        long long uid = std::strtoll(p, &next, 10);
        if (next == p) { while (p < end && *p != '\n') ++p; continue; }
        p = next;
        bool first = true;
        while (p < end && *p != '\n') {
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
            if (p >= end || *p == '\n') break;
            long long item = std::strtoll(p, &next, 10);
            if (next == p) break;
            p = next;
            (void)first;
            if (out_u) {
                if (n >= cap) return -2;  // caller buffer too small
                out_u[n] = uid;
                out_i[n] = item;
            }
            ++n;
        }
    }
    return n;
}

int64_t kgat_count_pairs(const char* path) {
    return parse_pairs_impl(path, nullptr, nullptr, 0);
}

int64_t kgat_parse_pairs(const char* path, int64_t* out_u, int64_t* out_i,
                         int64_t cap) {
    return parse_pairs_impl(path, out_u, out_i, cap);
}

// ---------------------------------------------------------------------------
// Triple file parsing: "h r t" per line -> three columns.
// ---------------------------------------------------------------------------

int64_t kgat_parse_triples(const char* path, int64_t* out, int64_t cap3) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    const char* p = buf.data();
    const char* end = p + buf.size() - 1;
    int64_t n = 0;
    while (p < end) {
        char* next = nullptr;
        long long v[3];
        int got = 0;
        for (; got < 3; ++got) {
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r'
                               || *p == '\n')) ++p;
            if (p >= end) break;
            v[got] = std::strtoll(p, &next, 10);
            if (next == p) { ++p; break; }
            p = next;
        }
        if (got == 3) {
            if (out) {
                if (n >= cap3) return -2;
                out[n * 3 + 0] = v[0];
                out[n * 3 + 1] = v[1];
                out[n * 3 + 2] = v[2];
            }
            ++n;
        }
    }
    return n;
}

int64_t kgat_count_triples(const char* path) {
    std::vector<char> buf;
    if (!read_file(path, buf)) return -1;
    // Upper bound: whitespace-separated token count / 3.
    int64_t tokens = 0;
    bool in_tok = false;
    for (char c : buf) {
        bool ws = (c == ' ' || c == '\t' || c == '\r' || c == '\n'
                   || c == '\0');
        if (!ws && !in_tok) { ++tokens; in_tok = true; }
        if (ws) in_tok = false;
    }
    return tokens / 3;
}

// ---------------------------------------------------------------------------
// Graph indexing: stable counting sort + CSR offsets (DGL coo2csr analog).
// ---------------------------------------------------------------------------

// Stable counting sort of edge ids by int32 key; writes the permutation.
void kgat_sort_perm(const int32_t* keys, int64_t n, int32_t n_keys,
                    int64_t* perm) {
    std::vector<int64_t> count(static_cast<size_t>(n_keys) + 1, 0);
    for (int64_t e = 0; e < n; ++e) count[keys[e] + 1]++;
    for (int32_t k = 0; k < n_keys; ++k) count[k + 1] += count[k];
    for (int64_t e = 0; e < n; ++e) perm[count[keys[e]]++] = e;
}

// CSR offsets over sorted keys: offsets[k] = first index with key >= k.
void kgat_csr_offsets(const int32_t* sorted_keys, int64_t n,
                      int32_t n_segments, int64_t* offsets) {
    int64_t pos = 0;
    for (int32_t k = 0; k <= n_segments; ++k) {
        while (pos < n && sorted_keys[pos] < k) ++pos;
        offsets[k] = pos;
    }
}

// ---------------------------------------------------------------------------
// Block-aligned layout fill (the O(E) part of graph.py _build_aligned_layout,
// DGL format-conversion analog): given the seg-sorted edge order, emit the
// chunk-padded gather/node/seg arrays, per-row [lo, hi) bounds, and the
// per-chunk block ids, in one pass each.
//
// Inputs:
//   order (n_e)     seg-sorted (optionally two-key-sorted) canonical ids
//   seg / other (n_e)  per CANONICAL edge
//   n_nodes, B (=128), align (chunk edges), dead_slot, n_blocks
//   blk_start (n_blocks+1)  aligned start offset of each block (precomputed
//                           from the per-block counts by the caller)
//   ro (n_nodes+1)  CSR offsets of seg over the sorted order
//   e_al            total aligned positions (>= blk_start[n_blocks] when
//                   force_chunks pads the tail)
// Outputs: gather/node/seg_al (e_al) int32; bounds (n_blocks*B*8) int32;
//          chunk_block (e_al/align) int32.
void kgat_aligned_fill(const int64_t* order, const int64_t* seg,
                       const int64_t* other, int64_t n_e,
                       const int64_t* ro, const int64_t* blk_start,
                       int64_t n_blocks, int64_t n_nodes, int64_t B,
                       int64_t align, int64_t dead_slot, int64_t e_al,
                       int32_t* gather, int32_t* node, int32_t* seg_al,
                       int32_t* bounds, int32_t* chunk_block) {
    const int64_t dead32 = dead_slot;
    // gather: per block, the block's run of sorted canonical ids then dead
    // padding up to the aligned block extent; trailing forced chunks dead.
    for (int64_t b = 0; b < n_blocks; ++b) {
        int64_t s = blk_start[b];
        int64_t lo = ro[b * B < n_nodes ? b * B : n_nodes];
        int64_t hi = ro[(b + 1) * B < n_nodes ? (b + 1) * B : n_nodes];
        int64_t c = hi - lo;
        for (int64_t k = 0; k < c; ++k)
            gather[s + k] = static_cast<int32_t>(order[lo + k]);
        for (int64_t k = s + c; k < blk_start[b + 1]; ++k)
            gather[k] = static_cast<int32_t>(dead32);
    }
    for (int64_t k = blk_start[n_blocks]; k < e_al; ++k)
        gather[k] = static_cast<int32_t>(dead32);
    // node/seg in aligned coordinates (dead positions -> 0).
    for (int64_t k = 0; k < e_al; ++k) {
        int64_t g = gather[k];
        bool real = g < n_e;
        node[k] = real ? static_cast<int32_t>(other[g]) : 0;
        seg_al[k] = real ? static_cast<int32_t>(seg[g]) : 0;
    }
    // Per-row aligned [lo, hi) bounds, lane-minor 8-wide.
    for (int64_t b = 0; b < n_blocks; ++b) {
        int64_t blk_lo = ro[b * B < n_nodes ? b * B : n_nodes];
        for (int64_t rrow = 0; rrow < B; ++rrow) {
            int64_t row = b * B + rrow;
            int32_t* cell = bounds + (b * B + rrow) * 8;
            if (row < n_nodes) {
                int64_t lo = blk_start[b] + (ro[row] - blk_lo);
                int64_t hi = lo + (ro[row + 1] - ro[row]);
                cell[0] = static_cast<int32_t>(lo);
                cell[1] = static_cast<int32_t>(hi);
            } else {
                cell[0] = 0;
                cell[1] = 0;
            }
            for (int k = 2; k < 8; ++k) cell[k] = 0;
        }
    }
    // Chunk -> block map; forced trailing chunks point at the last block.
    int64_t n_chunks = e_al / align;
    int64_t cpos = 0;
    int32_t last_blk = 0;
    for (int64_t b = 0; b < n_blocks; ++b) {
        int64_t nc = (blk_start[b + 1] - blk_start[b]) / align;
        for (int64_t k = 0; k < nc; ++k) chunk_block[cpos++] = (int32_t)b;
        if (nc > 0) last_blk = static_cast<int32_t>(b);
    }
    for (; cpos < n_chunks; ++cpos) chunk_block[cpos] = last_blk;
}

}  // extern "C"
