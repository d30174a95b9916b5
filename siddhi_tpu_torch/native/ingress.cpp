// Native batching ingress: raw transport bytes -> lane-routed SoA columns.
//
// The port's copy of the JAX package's C++ loader, with the same C ABI
// (sp_create ... sp_emit_lane_wide): a C++ parser consumes raw CSV lines,
// encodes strings through one shared dictionary, hashes the partition key to
// a lane (crc32, bit-identical to siddhi_tpu_torch/gpu/partition.py::_hash_key)
// and appends into per-lane fixed-capacity columnar staging buffers that
// emit() copies into numpy arrays padded to the lane batch. Its callers are
// gpu/partition.py (enable_native_ingress, ingest_csv, emit_native_feed) and
// core/columns.py (CsvColumnParser); native/__init__.py binds it.
//
// C ABI only (loaded via ctypes; built with g++ at first use).
//
// Column type chars: 'f' float32, 'd' float64, 'i' int32, 'l' int64,
//                    'b' bool(uint8), 's' string -> int32 dict code.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// zlib-compatible CRC-32 (IEEE), table-based; must match Python zlib.crc32.
struct Crc32 {
    uint32_t table[256];
    Crc32() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++)
                c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
            table[i] = c;
        }
    }
    uint32_t operator()(const char* buf, size_t len) const {
        uint32_t c = 0xFFFFFFFFu;
        for (size_t i = 0; i < len; i++)
            c = table[(c ^ (uint8_t)buf[i]) & 0xFF] ^ (c >> 8);
        return c ^ 0xFFFFFFFFu;
    }
};
const Crc32 kCrc;

struct Dict {
    std::unordered_map<std::string, int32_t> codes;
    std::vector<std::string> values;  // code -> string; code 0 = None
    Dict() { values.push_back(std::string()); }
    int32_t encode(const char* s, size_t len) {
        std::string key(s, len);
        auto it = codes.find(key);
        if (it != codes.end()) return it->second;
        int32_t c = (int32_t)values.size();
        values.push_back(key);
        codes.emplace(std::move(key), c);
        return c;
    }
};

union Cell {
    float f;
    double d;
    int32_t i;
    int64_t l;
    uint8_t b;
    int32_t s;
};

struct Lane {
    // column-major staging: cols[c][row]
    std::vector<std::vector<Cell>> cols;
    std::vector<int64_t> ts;
    std::vector<int32_t> tag;
    int64_t n = 0;
};

struct Ingress {
    std::vector<char> types;   // per payload column
    int key_col;               // payload column index used for lane routing (-1: lane 0)
    int n_lanes;
    int64_t capacity;          // per-lane staging capacity
    Dict dict;                 // shared across all string columns
    std::vector<Lane> lanes;
    int64_t parse_errors = 0;

    Ingress(const char* t, int ncols, int key, int lanes_, int64_t cap)
        : types(t, t + ncols), key_col(key), n_lanes(lanes_), capacity(cap) {
        lanes.resize(n_lanes);
        for (auto& ln : lanes) {
            ln.cols.resize(ncols);
            for (auto& c : ln.cols) c.reserve((size_t)cap);
            ln.ts.reserve((size_t)cap);
            ln.tag.reserve((size_t)cap);
        }
    }
};

inline bool parse_bool(const char* s, size_t len) {
    return (len == 4 && strncasecmp(s, "true", 4) == 0) ||
           (len == 1 && s[0] == '1');
}

}  // namespace

extern "C" {

void* sp_create(const char* types, int ncols, int key_col, int n_lanes,
                int64_t capacity) {
    if (ncols <= 0 || ncols > 64 || n_lanes <= 0 || capacity <= 0) return nullptr;
    return new Ingress(types, ncols, key_col, n_lanes, capacity);
}

void sp_destroy(void* h) { delete (Ingress*)h; }

int32_t sp_encode(void* h, const char* s, int64_t len) {
    return ((Ingress*)h)->dict.encode(s, (size_t)len);
}

int64_t sp_dict_size(void* h) { return (int64_t)((Ingress*)h)->dict.values.size(); }

// Copy dict string for `code` into out (cap bytes incl. NUL); returns length or -1.
int64_t sp_dict_get(void* h, int32_t code, char* out, int64_t cap) {
    Ingress* g = (Ingress*)h;
    if (code < 0 || (size_t)code >= g->dict.values.size()) return -1;
    const std::string& v = g->dict.values[code];
    if ((int64_t)v.size() + 1 > cap) return -1;
    memcpy(out, v.data(), v.size());
    out[v.size()] = 0;
    return (int64_t)v.size();
}

int32_t sp_lane_of(void* h, const char* key, int64_t len) {
    Ingress* g = (Ingress*)h;
    return (int32_t)((kCrc(key, (size_t)len) & 0x7FFFFFFFu) % (uint32_t)g->n_lanes);
}

int64_t sp_lane_len(void* h, int32_t lane) { return ((Ingress*)h)->lanes[lane].n; }

int64_t sp_parse_errors(void* h) { return ((Ingress*)h)->parse_errors; }

// Parse CSV lines from buf[0..len). Fields = payload columns in schema order;
// if ts_last != 0, one extra trailing field holds the int64 event timestamp,
// else timestamps are base_ts + row_counter (row_counter starts at *row_seq and
// is advanced). tag is stored per row (merged multi-stream batches).
//
// Stops early when the destination lane of a row is full. Returns the number of
// BYTES consumed (caller resumes after emitting lanes). Malformed lines are
// counted in parse_errors and skipped. A trailing partial line (no '\n' and
// buf doesn't end the message: caller handles framing) is consumed only if
// final != 0.
int64_t sp_ingest_csv(void* h, const char* buf, int64_t len, int64_t base_ts,
                      int ts_last, int32_t tag, int final_, int64_t* row_seq) {
    Ingress* g = (Ingress*)h;
    const int ncols = (int)g->types.size();
    int64_t pos = 0;
    std::vector<std::pair<const char*, size_t>> fields;
    fields.reserve(ncols + 1);

    while (pos < len) {
        // find end of line
        const char* nl = (const char*)memchr(buf + pos, '\n', (size_t)(len - pos));
        int64_t line_end = nl ? (nl - buf) : len;
        if (!nl && !final_) break;  // partial tail; wait for more bytes
        const char* line = buf + pos;
        size_t llen = (size_t)(line_end - pos);
        int64_t next_pos = nl ? line_end + 1 : len;
        // strip \r
        if (llen > 0 && line[llen - 1] == '\r') llen--;
        if (llen == 0) { pos = next_pos; continue; }

        // split fields
        fields.clear();
        size_t start = 0;
        for (size_t i = 0; i <= llen; i++) {
            if (i == llen || line[i] == ',') {
                fields.emplace_back(line + start, i - start);
                start = i + 1;
            }
        }
        int expected = ncols + (ts_last ? 1 : 0);
        if ((int)fields.size() != expected) {
            g->parse_errors++;
            pos = next_pos;
            continue;
        }

        // route to lane
        int32_t lane_idx = 0;
        if (g->key_col >= 0) {
            auto& kf = fields[g->key_col];
            lane_idx = (int32_t)((kCrc(kf.first, kf.second) & 0x7FFFFFFFu) %
                                 (uint32_t)g->n_lanes);
        }
        Lane& lane = g->lanes[lane_idx];
        if (lane.n >= g->capacity) return pos;  // lane full: caller drains

        // parse payload cells
        bool ok = true;
        Cell row[64];
        char tmp[64];
        for (int c = 0; c < ncols && ok; c++) {
            const char* f = fields[c].first;
            size_t flen = fields[c].second;
            char t = g->types[c];
            if (t == 's') {  // empty field -> None (code 0)
                row[c].s = flen ? g->dict.encode(f, flen) : 0;
                continue;
            }
            if (flen == 0) {  // empty field -> 0/None
                memset(&row[c], 0, sizeof(Cell));
                continue;
            }
            if (flen >= sizeof(tmp)) { ok = false; continue; }
            memcpy(tmp, f, flen);
            tmp[flen] = 0;
            char* end = nullptr;
            switch (t) {
                case 'd': row[c].d = strtod(tmp, &end); break;
                case 'f': row[c].f = strtof(tmp, &end); break;
                case 'l': row[c].l = strtoll(tmp, &end, 10); break;
                case 'i': row[c].i = (int32_t)strtoll(tmp, &end, 10); break;
                case 'b': row[c].b = parse_bool(tmp, flen) ? 1 : 0; end = tmp + flen; break;
                default: ok = false; continue;
            }
            if (end != tmp + flen) ok = false;
        }
        int64_t ts = 0;
        if (ts_last) {
            auto& tf = fields[ncols];
            if (tf.second == 0 || tf.second >= sizeof(tmp)) ok = false;
            else {
                memcpy(tmp, tf.first, tf.second);
                tmp[tf.second] = 0;
                char* end = nullptr;
                ts = strtoll(tmp, &end, 10);
                if (end != tmp + tf.second) ok = false;
            }
        } else {
            ts = base_ts + (*row_seq);
        }
        if (!ok) {
            g->parse_errors++;
            pos = next_pos;
            continue;
        }

        for (int c = 0; c < ncols; c++) lane.cols[c].push_back(row[c]);
        lane.ts.push_back(ts);
        lane.tag.push_back(tag);
        lane.n++;
        (*row_seq)++;
        pos = next_pos;
    }
    return pos;
}

// Copy lane `lane` into caller-provided buffers (numpy arrays of the schema
// dtypes, each of length >= capacity), padded; resets the lane. Returns row
// count. col_ptrs[c] points at the destination array for payload column c.
// `wide` != 0 emits 'd' columns as full float64 (the host/columnar tier's
// f64 policy — interpreter-exact edge parity); wide == 0 narrows 'd' to
// float32 (the device dtype policy, gpu/dtypes.py — packing f64 for the
// device would only add a second conversion copy on the Python side).
static int64_t emit_lane_impl(Ingress* g, int32_t lane_idx, void** col_ptrs,
                              int64_t* ts_out, int32_t* tag_out,
                              uint8_t* valid_out, int wide) {
    Lane& lane = g->lanes[lane_idx];
    const int64_t n = lane.n;
    const int ncols = (int)g->types.size();
    for (int c = 0; c < ncols; c++) {
        char t = g->types[c];
        const std::vector<Cell>& src = lane.cols[c];
        switch (t) {
            case 'd':
                if (wide) { double* p = (double*)col_ptrs[c];
                    for (int64_t i = 0; i < n; i++) p[i] = src[i].d; }
                else { float* p = (float*)col_ptrs[c];
                    for (int64_t i = 0; i < n; i++) p[i] = (float)src[i].d; }
                break;
            case 'f': { float* p = (float*)col_ptrs[c];
                for (int64_t i = 0; i < n; i++) p[i] = src[i].f; break; }
            case 'l': { int64_t* p = (int64_t*)col_ptrs[c];
                for (int64_t i = 0; i < n; i++) p[i] = src[i].l; break; }
            case 'i': case 's': { int32_t* p = (int32_t*)col_ptrs[c];
                for (int64_t i = 0; i < n; i++) p[i] = src[i].i; break; }
            case 'b': { uint8_t* p = (uint8_t*)col_ptrs[c];
                for (int64_t i = 0; i < n; i++) p[i] = src[i].b; break; }
        }
    }
    if (ts_out) memcpy(ts_out, lane.ts.data(), (size_t)n * sizeof(int64_t));
    if (tag_out) memcpy(tag_out, lane.tag.data(), (size_t)n * sizeof(int32_t));
    if (valid_out) {
        memset(valid_out, 0, (size_t)g->capacity);
        memset(valid_out, 1, (size_t)n);
    }
    for (auto& c : lane.cols) c.clear();
    lane.ts.clear();
    lane.tag.clear();
    lane.n = 0;
    return n;
}

int64_t sp_emit_lane(void* h, int32_t lane_idx, void** col_ptrs, int64_t* ts_out,
                     int32_t* tag_out, uint8_t* valid_out) {
    return emit_lane_impl((Ingress*)h, lane_idx, col_ptrs, ts_out, tag_out,
                          valid_out, 0);
}

// Wide emit for the host/columnar edge: 'd' columns keep float64.
int64_t sp_emit_lane_wide(void* h, int32_t lane_idx, void** col_ptrs,
                          int64_t* ts_out, int32_t* tag_out,
                          uint8_t* valid_out) {
    return emit_lane_impl((Ingress*)h, lane_idx, col_ptrs, ts_out, tag_out,
                          valid_out, 1);
}

}  // extern "C"
