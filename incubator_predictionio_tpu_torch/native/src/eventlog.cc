// Append-only event log — the native event-store engine.
//
// Plays the role the HBase driver plays in the reference
// (data/.../storage/hbase/: hashed row keys + column-family scans feeding the
// event DAO): a high-throughput, file-backed event store with header-level
// predicate pushdown. The design is TPU-serving-native instead of a
// translation: one framed append-only log per (app, channel), a 48-byte
// fixed header per record carrying the event time and FNV-1a hashes of the
// filterable fields, and an in-memory index built on open so time-range /
// entity / event-name scans never parse JSON. The Python DAO
// (data/storage/cpplog.py) keeps payloads as JSON and does the final
// exact-match check on the (rare) hash candidates.
//
// Concurrency: one process owns a log file at a time (like the localfs
// model store); within the process all calls are serialized by a mutex.
// Deletes are tombstone records so the file stays append-only.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <deque>
#include <functional>
#include <iterator>
#include <mutex>
#include <string>
#include <sched.h>
#include <string_view>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

struct __attribute__((packed)) RecHeader {
  int64_t time_ms;
  uint64_t etype_hash;  // entity type
  uint64_t eid_hash;    // entity id
  uint64_t name_hash;   // event name
  uint64_t id_hash;     // event id
  uint32_t payload_len;
  uint32_t flags;       // bit0 = tombstone (payload = 8-byte target index)
                        // bit1 = payload starts with a binary sidecar block
};

// flags bit1: the payload is [sidecar block][JSON] instead of bare JSON.
// The sidecar carries the scan-relevant fields in binary so the columnar
// training scan never parses JSON. Layout (little-endian, packed):
//   u32 block_len (including this field)
//   u8  n_numeric_props
//   u16 etype_len, name_len, eid_len, tetype_len (0xFFFF = no target),
//       teid_len
//   bytes: etype, name, eid, tetype, teid
//   per prop: u8 key_len, key bytes, f64 value
static constexpr uint32_t kTombstone = 1;
static constexpr uint32_t kSidecar = 2;
//: record stores ONLY the sidecar (plus a trailing 32-char event id inside
//: the sidecar block); the JSON document is rendered on read. Interaction
//: bulk imports write this flavor — it cuts bytes/record ~3x, which is the
//: whole game on a disk-bound 20M-event seed, and the columnar scan never
//: wanted the JSON anyway.
static constexpr uint32_t kCompact = 4;
static constexpr uint16_t kNoTarget = 0xFFFF;

static_assert(sizeof(RecHeader) == 48, "header layout is the disk format");

struct Entry {
  int64_t time_ms;
  uint64_t etype_hash, eid_hash, name_hash, id_hash;
  uint64_t offset;      // of payload
  uint32_t payload_len;
  uint32_t flags;
  bool dead;
};

struct EventLog {
  FILE* f = nullptr;
  std::vector<Entry> entries;
  std::vector<int64_t> sorted;  // indices ordered by (time_ms, idx)
  bool sorted_dirty = true;
  int64_t last_time = INT64_MIN; // fast-path: appends already in order
  // id_hash → entry index, built LAZILY on the first find_id (explicit-id
  // upserts/re-imports); plain ingest never pays its memory. A sorted flat
  // vector (16 B/record — a node-based hash map would cost ~4×) plus a
  // logarithmic tail: a ≤4096-entry unsorted buffer and carry-merged
  // sorted runs of geometrically increasing size (Bentley–Saxe), so an
  // interleaved lookup+append re-import pays O(log) amortized per append
  // and O(log² N) per lookup instead of a linear tail walk or an O(N)
  // merge every fixed-size flush. Tombstoned entries are filtered at
  // query time, so marking dead needs no upkeep.
  std::vector<std::pair<uint64_t, int64_t>> id_sorted;
  std::vector<std::pair<uint64_t, int64_t>> id_buf;
  std::vector<std::vector<std::pair<uint64_t, int64_t>>> id_runs;
  size_t id_tail_total = 0;  // id_buf + all id_runs
  bool id_index_built = false;
  // entries with dead==true (tombstone markers + their targets). The
  // Python training-projection cache (cpplog.py) stores this at write
  // time: any change means a cached row may have died, invalidating the
  // projection without walking the log.
  int64_t dead_count = 0;
  std::mutex mu;
};

static void flush_id_buf(EventLog* log) {
  if (log->id_buf.empty()) return;
  std::sort(log->id_buf.begin(), log->id_buf.end());
  std::vector<std::pair<uint64_t, int64_t>> run = std::move(log->id_buf);
  log->id_buf.clear();
  // carry-merge: absorb every trailing run no larger than the incoming
  // one, so run sizes stay geometric (largest first) and each entry is
  // re-merged only O(log) times on its way toward id_sorted
  while (!log->id_runs.empty() && log->id_runs.back().size() <= run.size()) {
    std::vector<std::pair<uint64_t, int64_t>> merged;
    merged.reserve(run.size() + log->id_runs.back().size());
    std::merge(run.begin(), run.end(), log->id_runs.back().begin(),
               log->id_runs.back().end(), std::back_inserter(merged));
    run = std::move(merged);
    log->id_runs.pop_back();
  }
  log->id_runs.push_back(std::move(run));
}

static void merge_id_tail_into_main(EventLog* log) {
  flush_id_buf(log);
  for (auto& run : log->id_runs) {
    const size_t mid = log->id_sorted.size();
    log->id_sorted.insert(log->id_sorted.end(), run.begin(), run.end());
    std::inplace_merge(log->id_sorted.begin(),
                       log->id_sorted.begin() + mid, log->id_sorted.end());
  }
  log->id_runs.clear();
  log->id_tail_total = 0;
}

static void index_new_entry(EventLog* log, int64_t idx) {
  if (!log->id_index_built || log->entries[idx].dead) return;
  log->id_buf.emplace_back(log->entries[idx].id_hash, idx);
  ++log->id_tail_total;
  if (log->id_buf.size() >= 4096) flush_id_buf(log);
  // geometric schedule into the main run: amortized O(1) of main-merge
  // work per append, while lookups stay logarithmic via the runs
  if (log->id_tail_total > 4096 &&
      log->id_tail_total > log->id_sorted.size() / 8)
    merge_id_tail_into_main(log);
}

static void resort(EventLog* log) {
  if (!log->sorted_dirty) return;
  log->sorted.resize(log->entries.size());
  for (size_t i = 0; i < log->sorted.size(); ++i) log->sorted[i] = (int64_t)i;
  std::stable_sort(log->sorted.begin(), log->sorted.end(),
                   [&](int64_t a, int64_t b) {
                     return log->entries[a].time_ms < log->entries[b].time_ms;
                   });
  log->sorted_dirty = false;
}

void* pio_evlog_open(const char* path) {
  FILE* f = fopen(path, "a+b");
  if (!f) return nullptr;
  auto* log = new EventLog();
  log->f = f;
  // Build the index: one sequential header scan. A crash mid-append (the
  // in-process ftruncate recovery only covers fwrite failures) can leave a
  // torn tail record whose header or payload extends past EOF; indexing it
  // would make later appends start inside its claimed payload range and
  // misframe every subsequent record. Validate each record's extent
  // against the file size and truncate away a torn tail.
  fseeko(f, 0, SEEK_END);
  const off_t file_size = ftello(f);
  fseeko(f, 0, SEEK_SET);
  RecHeader h;
  off_t rec_start = 0;
  bool torn_tail = false;   // extent past EOF — safe to truncate
  bool read_error = false;  // transient I/O failure — must NOT truncate
  while (rec_start + (off_t)sizeof(h) <= file_size) {
    if (fread(&h, sizeof(h), 1, f) != 1) {
      // a full header should fit here; a short read is an I/O problem
      // (or the file shrank underneath us), not a torn tail
      read_error = true;
      break;
    }
    uint64_t off = (uint64_t)rec_start + sizeof(h);
    const off_t rec_end = (off_t)(off + h.payload_len);
    if (rec_end > file_size) {  // torn tail: payload past EOF
      torn_tail = true;
      break;
    }
    if (h.flags & 1) {  // tombstone
      int64_t target = -1;
      if (h.payload_len == 8 && fread(&target, 8, 1, f) == 1 &&
          target >= 0 && (size_t)target < log->entries.size()) {
        if (!log->entries[target].dead) ++log->dead_count;
        log->entries[target].dead = true;
      } else {
        fseeko(f, rec_end, SEEK_SET);
      }
      ++log->dead_count;  // the marker entry itself
      log->entries.push_back({0, 0, 0, 0, 0, off, h.payload_len, h.flags,
                              true});
    } else {
      log->last_time = std::max(log->last_time, h.time_ms);
      log->entries.push_back({h.time_ms, h.etype_hash, h.eid_hash,
                              h.name_hash, h.id_hash, off, h.payload_len,
                              h.flags, false});
      fseeko(f, rec_end, SEEK_SET);
    }
    rec_start = rec_end;
  }
  // Truncate ONLY a genuine torn tail (payload extent past EOF, or a
  // partial header at EOF). A mid-file fread error must leave the file
  // untouched — truncating there would destroy valid later records.
  if (!read_error && rec_start < file_size &&
      (torn_tail || rec_start + (off_t)sizeof(h) > file_size)) {
    (void)!ftruncate(fileno(f), rec_start);
  }
  log->sorted_dirty = true;
  fseeko(f, 0, SEEK_END);
  return log;
}

// Flush buffered appends to the OS and the disk (fdatasync). The hot ingest
// path only fflush()es — torn tails are recovered at open — so durability
// is opt-in: the Python DAO calls this on close and on demand.
int64_t pio_evlog_sync(void* handle) {
  auto* log = (EventLog*)handle;
  if (!log || !log->f) return -1;
  std::lock_guard<std::mutex> g(log->mu);
  if (fflush(log->f) != 0) return -1;
#if defined(__APPLE__)
  return fsync(fileno(log->f)) == 0 ? 0 : -1;
#else
  return fdatasync(fileno(log->f)) == 0 ? 0 : -1;
#endif
}

void pio_evlog_close(void* handle) {
  auto* log = (EventLog*)handle;
  if (!log) return;
  if (log->f) fclose(log->f);
  delete log;
}

int64_t pio_evlog_append(void* handle, int64_t time_ms, uint64_t etype_hash,
                         uint64_t eid_hash, uint64_t name_hash,
                         uint64_t id_hash, const uint8_t* payload,
                         uint32_t len) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  RecHeader h{time_ms, etype_hash, eid_hash, name_hash, id_hash, len, 0};
  fseeko(log->f, 0, SEEK_END);
  off_t rec_start = ftello(log->f);
  uint64_t off = (uint64_t)rec_start + sizeof(h);
  if (fwrite(&h, sizeof(h), 1, log->f) != 1 ||
      (len && fwrite(payload, 1, len, log->f) != len)) {
    // never leave a partial record: it would misframe every later record
    // on the reopen scan
    fflush(log->f);
    (void)!ftruncate(fileno(log->f), rec_start);
    clearerr(log->f);
    fseeko(log->f, 0, SEEK_END);
    return -1;
  }
  fflush(log->f);
  log->entries.push_back(
      {time_ms, etype_hash, eid_hash, name_hash, id_hash, off, len, 0,
       false});
  index_new_entry(log, (int64_t)log->entries.size() - 1);
  if (time_ms >= log->last_time && !log->sorted_dirty) {
    log->sorted.push_back((int64_t)log->entries.size() - 1);  // stays sorted
  } else {
    log->sorted_dirty = true;
  }
  log->last_time = std::max(log->last_time, time_ms);
  return (int64_t)log->entries.size() - 1;
}

int64_t pio_evlog_tombstone(void* handle, int64_t index) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  if (index < 0 || (size_t)index >= log->entries.size()) return -1;
  if (log->entries[index].dead) return -1;
  RecHeader h{0, 0, 0, 0, 0, 8, 1};
  fseeko(log->f, 0, SEEK_END);
  off_t rec_start = ftello(log->f);
  uint64_t off = (uint64_t)rec_start + sizeof(h);
  if (fwrite(&h, sizeof(h), 1, log->f) != 1 ||
      fwrite(&index, 8, 1, log->f) != 1) {
    fflush(log->f);
    (void)!ftruncate(fileno(log->f), rec_start);
    clearerr(log->f);
    fseeko(log->f, 0, SEEK_END);
    return -1;
  }
  fflush(log->f);
  log->entries[index].dead = true;
  log->entries.push_back({0, 0, 0, 0, 0, off, 8, kTombstone, true});
  log->dead_count += 2;  // the target + the marker entry
  log->sorted_dirty = true;
  return 0;
}

// Raw entry count (live + dead + tombstone markers) — the projection
// cache's high-water mark: entries at index >= a stored count are exactly
// the records appended after the cache was written.
int64_t pio_evlog_entry_count(void* handle) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  return (int64_t)log->entries.size();
}

int64_t pio_evlog_dead_count(void* handle) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  return log->dead_count;
}

int64_t pio_evlog_count(void* handle) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  int64_t n = 0;
  for (auto& e : log->entries)
    if (!e.dead) ++n;
  return n;
}

// Header-level scan. 0 hash = "no filter" (the Python side maps real hashes
// of 0 to 1). Returns the number of record indices written to `out`,
// time-ordered (ties by append order), reversed/limit applied like
// LEvents.futureFind (reference data/.../storage/LEvents.scala:167-182).
int64_t pio_evlog_query(void* handle, int64_t start_ms, int64_t until_ms,
                        uint64_t etype_hash, uint64_t eid_hash,
                        const uint64_t* name_hashes, int32_t n_names,
                        int32_t reversed, int64_t limit, int64_t* out,
                        int64_t cap) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  resort(log);
  int64_t n = 0;
  int64_t total = (int64_t)log->sorted.size();
  for (int64_t step = 0; step < total; ++step) {
    int64_t idx = log->sorted[reversed ? total - 1 - step : step];
    const Entry& e = log->entries[idx];
    if (e.dead) continue;
    if (e.time_ms < start_ms || e.time_ms >= until_ms) continue;
    if (etype_hash && e.etype_hash != etype_hash) continue;
    if (eid_hash && e.eid_hash != eid_hash) continue;
    if (n_names > 0) {
      bool hit = false;
      for (int32_t i = 0; i < n_names; ++i)
        if (e.name_hash == name_hashes[i]) { hit = true; break; }
      if (!hit) continue;
    }
    if (n >= cap) break;
    out[n++] = idx;
    if (limit >= 0 && n >= limit) break;
  }
  return n;
}

int64_t pio_evlog_find_id(void* handle, uint64_t id_hash, int64_t* out,
                          int64_t cap) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  if (!log->id_index_built) {
    // one linear pass + sort on the FIRST lookup; afterwards appends keep
    // the index current. An M-event explicit-id re-import into an N-record
    // log costs O(N log N) for this build, O(log) amortized per append
    // (carry-merged runs), and O(log² N) + a ≤4096 linear buffer walk per
    // lookup — far below the O(M·N) of a per-event scan
    log->id_sorted.reserve(log->entries.size());
    for (size_t i = 0; i < log->entries.size(); ++i)
      if (!log->entries[i].dead)
        log->id_sorted.emplace_back(log->entries[i].id_hash, (int64_t)i);
    std::sort(log->id_sorted.begin(), log->id_sorted.end());
    log->id_index_built = true;
  }
  int64_t n = 0;
  const auto probe = std::make_pair(id_hash, INT64_MIN);
  auto lo = std::lower_bound(
      log->id_sorted.begin(), log->id_sorted.end(), probe);
  for (; lo != log->id_sorted.end() && lo->first == id_hash && n < cap; ++lo)
    if (!log->entries[lo->second].dead) out[n++] = lo->second;
  for (const auto& run : log->id_runs) {
    auto it = std::lower_bound(run.begin(), run.end(), probe);
    for (; it != run.end() && it->first == id_hash && n < cap; ++it)
      if (!log->entries[it->second].dead) out[n++] = it->second;
  }
  for (const auto& kv : log->id_buf)
    if (n < cap && kv.first == id_hash && !log->entries[kv.second].dead)
      out[n++] = kv.second;
  return n;
}

// ---------------------------------------------------------------------------
// Columnar interaction scan — the training-ingest fast path.
//
// Plays the role of the reference's parallel HBase read
// (hbase/HBPEvents.scala:63-88 newAPIHadoopRDD): streams matching events
// straight into int32 COO arrays + interned id tables without ever
// materializing per-event objects in Python. The JSON payloads are written
// by this framework's own DAO (compact json.dumps), so a small
// depth-tracking scanner suffices; all header-hash candidates are
// re-checked with exact string compares, so hash collisions cannot corrupt
// the output.
// ---------------------------------------------------------------------------

static uint64_t fnv1a64(const char* s, size_t n) {
  uint64_t h = 0xCBF29CE484222325ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= (uint8_t)s[i];
    h *= 0x100000001B3ull;
  }
  return h ? h : 1;  // 0 is the "no filter" sentinel (native/__init__.py)
}

// Scan a compact JSON object for a top-level key; returns the byte position
// of the first character of its value, or npos. Tracks string/escape state
// and brace depth so key text inside nested values never matches.
static size_t json_toplevel_value(const std::string& s, const char* key) {
  const std::string pat = std::string("\"") + key + "\"";
  int depth = 0;
  bool in_str = false;
  for (size_t i = 0; i < s.size(); ++i) {
    char c = s[i];
    if (in_str) {
      if (c == '\\') { ++i; continue; }
      if (c == '"') in_str = false;
      continue;
    }
    if (c == '{' || c == '[') { ++depth; continue; }
    if (c == '}' || c == ']') { --depth; continue; }
    if (c == '"') {
      if (depth == 1 && s.compare(i, pat.size(), pat) == 0) {
        size_t j = i + pat.size();
        while (j < s.size() && (s[j] == ' ' || s[j] == '\t')) ++j;
        if (j < s.size() && s[j] == ':') {
          ++j;
          while (j < s.size() && (s[j] == ' ' || s[j] == '\t')) ++j;
          return j;
        }
      }
      in_str = true;
    }
  }
  return std::string::npos;
}

// Decode the JSON string whose opening quote is at s[pos]; false when the
// value there is not a string. Handles \", \\, \/, \b, \f, \n, \r, \t and
// \uXXXX (incl. surrogate pairs) — json.dumps default ensure_ascii=True
// escapes all non-ASCII ids this way.
static bool json_decode_string(const std::string& s, size_t pos,
                               std::string* out) {
  if (pos == std::string::npos || pos >= s.size() || s[pos] != '"')
    return false;
  out->clear();
  for (size_t i = pos + 1; i < s.size(); ++i) {
    char c = s[i];
    if (c == '"') return true;
    if (c != '\\') { out->push_back(c); continue; }
    if (++i >= s.size()) return false;
    char e = s[i];
    switch (e) {
      case '"': out->push_back('"'); break;
      case '\\': out->push_back('\\'); break;
      case '/': out->push_back('/'); break;
      case 'b': out->push_back('\b'); break;
      case 'f': out->push_back('\f'); break;
      case 'n': out->push_back('\n'); break;
      case 'r': out->push_back('\r'); break;
      case 't': out->push_back('\t'); break;
      case 'u': {
        if (i + 4 >= s.size()) return false;
        auto hex4 = [&](size_t p) -> int {
          int v = 0;
          for (int k = 0; k < 4; ++k) {
            char hc = s[p + k];
            v <<= 4;
            if (hc >= '0' && hc <= '9') v |= hc - '0';
            else if (hc >= 'a' && hc <= 'f') v |= hc - 'a' + 10;
            else if (hc >= 'A' && hc <= 'F') v |= hc - 'A' + 10;
            else return -1;
          }
          return v;
        };
        int cp = hex4(i + 1);
        if (cp < 0) return false;
        i += 4;
        if (cp >= 0xD800 && cp <= 0xDBFF && i + 6 < s.size() &&
            s[i + 1] == '\\' && s[i + 2] == 'u') {
          int lo = hex4(i + 3);
          if (lo >= 0xDC00 && lo <= 0xDFFF) {
            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            i += 6;
          }
        }
        // utf-8 encode
        if (cp < 0x80) out->push_back((char)cp);
        else if (cp < 0x800) {
          out->push_back((char)(0xC0 | (cp >> 6)));
          out->push_back((char)(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
          out->push_back((char)(0xE0 | (cp >> 12)));
          out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
          out->push_back((char)(0x80 | (cp & 0x3F)));
        } else {
          out->push_back((char)(0xF0 | (cp >> 18)));
          out->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
          out->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
          out->push_back((char)(0x80 | (cp & 0x3F)));
        }
        break;
      }
      default: return false;
    }
  }
  return false;  // unterminated
}

// Extract "properties".<key> as a double; false when absent / not numeric.
static bool json_property_number(const std::string& s, const char* key,
                                 double* out) {
  size_t props = json_toplevel_value(s, "properties");
  if (props == std::string::npos || props >= s.size() || s[props] != '{')
    return false;
  // find the matching close brace of the properties object
  int depth = 0;
  bool in_str = false;
  size_t end = props;
  for (size_t i = props; i < s.size(); ++i) {
    char c = s[i];
    if (in_str) {
      if (c == '\\') { ++i; continue; }
      if (c == '"') in_str = false;
      continue;
    }
    if (c == '"') { in_str = true; continue; }
    if (c == '{' || c == '[') ++depth;
    else if (c == '}' || c == ']') {
      if (--depth == 0) { end = i + 1; break; }
    }
  }
  std::string sub = s.substr(props, end - props);
  size_t vpos = json_toplevel_value(sub, key);
  if (vpos == std::string::npos || vpos >= sub.size()) return false;
  char c = sub[vpos];
  if (c != '-' && (c < '0' || c > '9')) return false;  // not a number
  char* endp = nullptr;
  *out = strtod(sub.c_str() + vpos, &endp);
  return endp != sub.c_str() + vpos;
}

struct ScanResult {
  std::vector<int32_t> uidx, iidx;
  std::vector<float> vals;
  std::vector<int64_t> times;        // per-row event time (projection cache)
  std::string ubuf, ibuf;            // concatenated utf-8 id bytes
  std::vector<int64_t> uoff, ioff;   // n_ids + 1 offsets into the buffers
  int64_t lock_ns = 0;               // wall spent holding the log mutex
};

// ---- single-pass payload field extraction (span-based, zero-copy) --------

struct Span {
  size_t pos = 0, len = 0;
  bool esc = false, present = false;
};

struct Fields {
  Span event, etype, eid, tetype, teid, props;
};

// One pass over a compact JSON object, recording the value spans of the six
// keys the scan needs. Strings are kept raw (escape flag only); object
// values record their full balanced extent.
static bool extract_fields(std::string_view s, Fields* f) {
  size_t i = 0;
  const size_t n = s.size();
  int depth = 0;
  while (i < n) {
    char c = s[i];
    if (c == '{' || c == '[') { ++depth; ++i; continue; }
    if (c == '}' || c == ']') { --depth; ++i; continue; }
    if (c != '"') { ++i; continue; }
    if (depth != 1) {  // a string inside a nested value: skip it
      ++i;
      while (i < n && s[i] != '"') i += (s[i] == '\\') ? 2 : 1;
      ++i;
      continue;
    }
    // depth-1 string reached outside a value ⇒ it is a key
    size_t kstart = ++i;
    bool kesc = false;
    while (i < n && s[i] != '"') {
      if (s[i] == '\\') { kesc = true; i += 2; } else ++i;
    }
    if (i >= n) return false;
    std::string_view key = s.substr(kstart, i - kstart);
    ++i;
    while (i < n && (s[i] == ' ' || s[i] == '\t')) ++i;
    if (i >= n || s[i] != ':') return false;
    ++i;
    while (i < n && (s[i] == ' ' || s[i] == '\t')) ++i;
    if (i >= n) return false;
    Span v;
    if (s[i] == '"') {
      size_t vstart = ++i;
      bool vesc = false;
      while (i < n && s[i] != '"') {
        if (s[i] == '\\') { vesc = true; i += 2; } else ++i;
      }
      if (i >= n) return false;
      v = {vstart, i - vstart, vesc, true};
      ++i;
    } else if (s[i] == '{' || s[i] == '[') {
      size_t vstart = i;
      int d2 = 0;
      bool instr = false;
      while (i < n) {
        char c2 = s[i];
        if (instr) {
          if (c2 == '\\') { i += 2; continue; }
          if (c2 == '"') instr = false;
          ++i;
          continue;
        }
        if (c2 == '"') { instr = true; ++i; continue; }
        if (c2 == '{' || c2 == '[') ++d2;
        else if (c2 == '}' || c2 == ']') {
          if (--d2 == 0) { ++i; break; }
        }
        ++i;
      }
      v = {vstart, i - vstart, false, true};
      // the balanced walk above consumed the closing brace, keeping the
      // outer `depth` unchanged — do not let the main loop see it
    } else {
      size_t vstart = i;
      while (i < n && s[i] != ',' && s[i] != '}') ++i;
      v = {vstart, i - vstart, false, true};
    }
    if (!kesc) {
      if (key == "event") f->event = v;
      else if (key == "entityType") f->etype = v;
      else if (key == "entityId") f->eid = v;
      else if (key == "targetEntityType") f->tetype = v;
      else if (key == "targetEntityId") f->teid = v;
      else if (key == "properties") f->props = v;
    }
  }
  return true;
}

// Decode JSON string escapes of a raw (quote-less) span. Mirrors
// json_decode_string (incl. \uXXXX surrogate pairs).
static bool decode_escapes(std::string_view raw, std::string* out) {
  std::string quoted;
  quoted.reserve(raw.size() + 2);
  quoted.push_back('"');
  quoted.append(raw);
  quoted.push_back('"');
  return json_decode_string(quoted, 0, out);
}

// Materialize a span as a string id: direct slice when unescaped.
static bool span_id(std::string_view payload, const Span& v,
                    std::string* out) {
  if (!v.present) return false;
  std::string_view raw = payload.substr(v.pos, v.len);
  if (!v.esc) {
    out->assign(raw);
    return true;
  }
  return decode_escapes(raw, out);
}

static bool span_equals(std::string_view payload, const Span& v,
                        std::string_view want, std::string* scratch) {
  if (!v.present) return false;
  std::string_view raw = payload.substr(v.pos, v.len);
  if (!v.esc) return raw == want;
  if (!decode_escapes(raw, scratch)) return false;
  return *scratch == want;
}

// properties.<key> as a double from the raw props span (an object).
static bool span_property_number(std::string_view props,
                                 std::string_view key, double* out) {
  size_t i = 0;
  const size_t n = props.size();
  int depth = 0;
  while (i < n) {
    char c = props[i];
    if (c == '{' || c == '[') { ++depth; ++i; continue; }
    if (c == '}' || c == ']') { --depth; ++i; continue; }
    if (c != '"') { ++i; continue; }
    if (depth != 1) {
      ++i;
      while (i < n && props[i] != '"') i += (props[i] == '\\') ? 2 : 1;
      ++i;
      continue;
    }
    size_t kstart = ++i;
    bool kesc = false;
    while (i < n && props[i] != '"') {
      if (props[i] == '\\') { kesc = true; i += 2; } else ++i;
    }
    if (i >= n) return false;
    std::string_view k = props.substr(kstart, i - kstart);
    ++i;
    while (i < n && (props[i] == ' ' || props[i] == '\t')) ++i;
    if (i >= n || props[i] != ':') return false;
    ++i;
    while (i < n && (props[i] == ' ' || props[i] == '\t')) ++i;
    if (i >= n) return false;
    if (!kesc && k == key) {
      char c2 = props[i];
      if (c2 != '-' && (c2 < '0' || c2 > '9')) return false;  // not a number
      char buf[64];
      size_t m = 0;
      while (i < n && m < 63 && props[i] != ',' && props[i] != '}' &&
             props[i] != ' ')
        buf[m++] = props[i++];
      buf[m] = 0;
      char* endp = nullptr;
      *out = strtod(buf, &endp);
      return endp != buf;
    }
    // skip this value
    char c2 = props[i];
    if (c2 == '"') {
      ++i;
      while (i < n && props[i] != '"') i += (props[i] == '\\') ? 2 : 1;
      ++i;
    } else if (c2 == '{' || c2 == '[') {
      int d2 = 0;
      bool instr = false;
      while (i < n) {
        char c3 = props[i];
        if (instr) {
          if (c3 == '\\') { i += 2; continue; }
          if (c3 == '"') instr = false;
          ++i;
          continue;
        }
        if (c3 == '"') { instr = true; ++i; continue; }
        if (c3 == '{' || c3 == '[') ++d2;
        else if (c3 == '}' || c3 == ']') {
          if (--d2 == 0) { ++i; break; }
        }
        ++i;
      }
    } else {
      while (i < n && props[i] != ',' && props[i] != '}') ++i;
    }
  }
  return false;
}

// ---- binary sidecar fast path --------------------------------------------

struct SideFields {
  std::string_view etype, name, eid, tetype, teid, props;
  uint8_t n_props = 0;
  bool has_target = false;
};

static bool parse_sidecar(const char* p, size_t plen, SideFields* f) {
  if (plen < 15) return false;
  uint32_t bl;
  memcpy(&bl, p, 4);
  if (bl > plen || bl < 15) return false;
  f->n_props = (uint8_t)p[4];
  uint16_t l[5];
  memcpy(l, p + 5, 10);
  size_t pos = 15;
  auto take = [&](uint16_t len) {
    std::string_view v(p + pos, len);
    pos += len;
    return v;
  };
  if (15 + (size_t)l[0] + l[1] + l[2] > bl) return false;
  f->etype = take(l[0]);
  f->name = take(l[1]);
  f->eid = take(l[2]);
  f->has_target = l[3] != kNoTarget;
  if (f->has_target) {
    if (pos + l[3] + l[4] > bl) return false;
    f->tetype = take(l[3]);
    f->teid = take(l[4]);
  }
  if (pos > bl) return false;
  f->props = std::string_view(p + pos, bl - pos);
  return true;
}

static bool sidecar_prop_value(const SideFields& f, std::string_view key,
                               double* out) {
  std::string_view props = f.props;
  size_t pos = 0;
  for (uint8_t i = 0; i < f.n_props; ++i) {
    if (pos + 1 > props.size()) return false;
    const uint8_t kl = (uint8_t)props[pos];
    ++pos;
    if (pos + kl + 8 > props.size()) return false;
    std::string_view k = props.substr(pos, kl);
    pos += kl;
    if (k == key) {
      memcpy(out, props.data() + pos, 8);
      return true;
    }
    pos += 8;
  }
  return false;
}

// Per-thread partial scan: local interning, merged in submit order. Id keys
// are string_views into the mmapped file (or into `arena` for ids that
// needed JSON unescaping) — no per-record string allocations.
struct LocalScan {
  std::vector<int32_t> uidx, iidx;
  std::vector<float> vals;
  std::vector<int64_t> times;
  std::vector<std::string_view> users, items;  // local idx → id view
  std::unordered_map<std::string_view, int32_t> umap, imap;
  std::deque<std::string> arena;  // stable storage for decoded ids
};

struct ScanFilters {
  int64_t start_ms, until_ms;
  std::string_view entity_type, target_entity_type, value_prop;
  const std::vector<std::string>* names;
  std::vector<uint64_t> name_hs;
  const double* fixed_vals;
  bool have_prop;
  double default_value;
  uint64_t etype_h;
};

// One header-prefiltered entry, copied out of the in-memory index while the
// log mutex is held. The expensive payload work (mmap reads, sidecar/JSON
// parsing, interning) runs on these snapshots OUTSIDE the mutex, so
// concurrent appends — which may reallocate the entries vector — are never
// stalled by a scan and never race a reader.
struct SnapEntry {
  int64_t time_ms;
  uint64_t offset;
  uint32_t payload_len;
  uint16_t flags;
  uint16_t slot;  // matched name-hash slot (exact-checked during the scan)
};

// A span as an interning key: a view into the mmap when unescaped, else a
// decoded copy pinned in the arena.
static bool span_view(std::string_view payload, const Span& v,
                      LocalScan* out, std::string_view* view) {
  if (!v.present) return false;
  std::string_view raw = payload.substr(v.pos, v.len);
  if (!v.esc) {
    *view = raw;
    return true;
  }
  std::string decoded;
  if (!decode_escapes(raw, &decoded)) return false;
  out->arena.push_back(std::move(decoded));
  *view = out->arena.back();
  return true;
}

static void scan_snap(const char* base, const std::vector<SnapEntry>& snap,
                      int64_t lo, int64_t hi, const ScanFilters& flt,
                      LocalScan* out) {
  std::string scratch;
  std::string_view uid, iid;
  const int32_t n_names = (int32_t)flt.names->size();
  for (int64_t k = lo; k < hi; ++k) {
    const SnapEntry& e = snap[k];
    int32_t slot = (int32_t)e.slot;
    double v;
    if (e.flags & kSidecar) {
      // fast path: all fields binary, no JSON touched
      SideFields sf;
      if (!parse_sidecar(base + e.offset, e.payload_len, &sf)) continue;
      if (sf.name != (*flt.names)[slot]) {  // hash collision in name set
        slot = -1;
        for (int32_t i = 0; i < n_names; ++i)
          if (sf.name == (*flt.names)[i]) { slot = i; break; }
        if (slot < 0) continue;
      }
      if (sf.etype != flt.entity_type) continue;
      if (!sf.has_target || sf.tetype != flt.target_entity_type) continue;
      const double fv = flt.fixed_vals[slot];
      if (!std::isnan(fv)) {
        v = fv;
      } else if (flt.have_prop) {
        if (!sidecar_prop_value(sf, flt.value_prop, &v)) continue;
      } else {
        v = flt.default_value;
      }
      uid = sf.eid;
      iid = sf.teid;
    } else {
      // JSON fallback (records written before the sidecar format)
      std::string_view payload(base + e.offset, e.payload_len);
      Fields f;
      if (!extract_fields(payload, &f)) continue;
      // exact rechecks (headers are hash prefilters only)
      if (!span_equals(payload, f.event, (*flt.names)[slot], &scratch)) {
        slot = -1;
        for (int32_t i = 0; i < n_names; ++i)
          if (span_equals(payload, f.event, (*flt.names)[i], &scratch)) {
            slot = i;
            break;
          }
        if (slot < 0) continue;
      }
      if (!span_equals(payload, f.etype, flt.entity_type, &scratch))
        continue;
      if (!span_equals(payload, f.tetype, flt.target_entity_type, &scratch))
        continue;
      const double fv = flt.fixed_vals[slot];
      if (!std::isnan(fv)) {
        v = fv;
      } else if (flt.have_prop) {
        if (!f.props.present ||
            !span_property_number(
                payload.substr(f.props.pos, f.props.len), flt.value_prop,
                &v))
          continue;
      } else {
        v = flt.default_value;
      }
      if (!span_view(payload, f.eid, out, &uid)) continue;
      if (!span_view(payload, f.teid, out, &iid)) continue;
    }
    auto ur = out->umap.emplace(uid, (int32_t)out->users.size());
    if (ur.second) out->users.push_back(uid);
    auto ir = out->imap.emplace(iid, (int32_t)out->items.size());
    if (ir.second) out->items.push_back(iid);
    out->uidx.push_back(ur.first->second);
    out->iidx.push_back(ir.first->second);
    out->vals.push_back((float)v);
    out->times.push_back(e.time_ms);
  }
}

// Columnar scan. `names`/`fixed_vals` are parallel: fixed_vals[i] = NaN
// means "resolve via value_prop / default_value". value_prop may be null
// (every non-fixed event gets default_value).
//
// Locking: the log mutex is held ONLY for the snapshot — fflush, a header
// prefilter pass over the in-memory index (copying the matching entries'
// 24-byte headers out), and the mmap of the flushed extent. The payload
// scan itself runs lock-free on the snapshot + mmap, so concurrent
// appends proceed while a training scan is in flight. The time the mutex
// was held is reported via pio_scan_lock_held_ns.
//
// Entry range: [min_entry_idx, max_entry_idx) in raw entry indices;
// max_entry_idx < 0 means "through the end". A NEGATIVE max_entry_idx
// keeps the historical output order (time-ascending, ties in append
// order, via the sorted index). A bounded range emits rows in ENTRY
// order instead and never builds/resorts the time index — the sharded
// Python caller (data/storage/cpplog.py) restores global time order with
// one stable sort across shards, which reproduces the sequential order
// exactly (stable sort by time over entry order == the sorted index).
//
// n_threads: internal scan threads; <= 0 = auto (one per kMinPerThread
// candidates up to the hardware limit). Sharded Python callers pass 1 so
// parallelism is owned by exactly one layer. Per-thread id tables are
// merged in partition order so the global table keeps first-seen order.
void* pio_evlog_scan_interactions(
    void* handle, int64_t start_ms, int64_t until_ms, int64_t min_entry_idx,
    int64_t max_entry_idx, const char* entity_type,
    const char* target_entity_type, const char** names,
    const double* fixed_vals, int32_t n_names, const char* value_prop,
    double default_value, int32_t n_threads) {
  auto* log = (EventLog*)handle;
  auto* res = new ScanResult();
  // empty name list matches nothing (find() contract); slot is a u16
  if (n_names <= 0 || n_names > 0xFFFF) {
    res->uoff.push_back(0);
    res->ioff.push_back(0);
    return res;
  }

  std::vector<std::string> name_strs(names, names + n_names);
  ScanFilters flt;
  flt.start_ms = start_ms;
  flt.until_ms = until_ms;
  flt.entity_type = entity_type;
  flt.target_entity_type = target_entity_type;
  flt.value_prop = value_prop ? std::string_view(value_prop)
                              : std::string_view();
  flt.names = &name_strs;
  for (auto& s : name_strs) flt.name_hs.push_back(fnv1a64(s.data(), s.size()));
  flt.fixed_vals = fixed_vals;
  flt.have_prop = value_prop != nullptr;
  flt.default_value = default_value;
  flt.etype_h = fnv1a64(entity_type, strlen(entity_type));

  std::vector<SnapEntry> snap;
  char* base = nullptr;
  size_t map_len = 0;
  std::string heap;
  struct timespec lt0, lt1;
  {
    std::lock_guard<std::mutex> g(log->mu);
    // clock starts AFTER acquisition: lock_ns reports time HELD (what a
    // concurrent writer pays per scan), not time spent queueing behind
    // sibling shards' snapshots
    clock_gettime(CLOCK_MONOTONIC, &lt0);
    fflush(log->f);
    const int64_t n_entries = (int64_t)log->entries.size();
    const int64_t lo = std::max<int64_t>(min_entry_idx, 0);
    const int64_t hi = max_entry_idx < 0
                           ? n_entries
                           : std::min(max_entry_idx, n_entries);
    auto prefilter = [&](int64_t idx) {
      const Entry& e = log->entries[idx];
      if (e.dead) return;
      if (e.time_ms < flt.start_ms || e.time_ms >= flt.until_ms) return;
      if (e.etype_hash != flt.etype_h) return;
      int32_t slot = -1;
      for (int32_t i = 0; i < n_names; ++i)
        if (e.name_hash == flt.name_hs[i]) { slot = i; break; }
      if (slot < 0) return;
      snap.push_back({e.time_ms, e.offset, e.payload_len, (uint16_t)e.flags,
                      (uint16_t)slot});
    };
    if (max_entry_idx >= 0) {
      for (int64_t idx = lo; idx < hi; ++idx) prefilter(idx);
    } else {
      resort(log);
      for (int64_t k = 0; k < (int64_t)log->sorted.size(); ++k)
        if (log->sorted[k] >= lo) prefilter(log->sorted[k]);
    }
    // mmap the flushed extent (it covers every snapshotted payload — all
    // were flushed before the snapshot); heap fallback if mmap fails
    struct stat st;
    const int fd = fileno(log->f);
    if (!snap.empty() && fstat(fd, &st) == 0 && st.st_size > 0) {
      map_len = (size_t)st.st_size;
      void* m = mmap(nullptr, map_len, PROT_READ, MAP_SHARED, fd, 0);
      if (m != MAP_FAILED) {
        base = (char*)m;
      } else {
        heap.resize(map_len);
        fseeko(log->f, 0, SEEK_SET);
        if (fread(&heap[0], 1, map_len, log->f) != map_len)
          snap.clear();
        else
          base = &heap[0];
        fseeko(log->f, 0, SEEK_END);
      }
    }
    clock_gettime(CLOCK_MONOTONIC, &lt1);
  }
  res->lock_ns = (lt1.tv_sec - lt0.tv_sec) * 1000000000LL +
                 (lt1.tv_nsec - lt0.tv_nsec);

  const int64_t total = (int64_t)snap.size();
  if (base == nullptr || total == 0) {
    res->uoff.push_back(0);
    res->ioff.push_back(0);
    if (base && map_len && base != heap.data()) munmap(base, map_len);
    return res;
  }

  int nt = n_threads;
  if (nt <= 0) {
    constexpr int64_t kMinPerThread = 200000;
    int hw = (int)std::thread::hardware_concurrency();
    nt = (int)std::min<int64_t>(
        std::max(hw, 1), std::max<int64_t>(1, total / kMinPerThread));
  }
  nt = std::max(1, std::min(nt, 16));

  std::vector<LocalScan> locals(nt);
  if (nt == 1) {
    scan_snap(base, snap, 0, total, flt, &locals[0]);
  } else {
    std::vector<std::thread> pool;
    const int64_t step = (total + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
      int64_t lo = t * step, hi = std::min<int64_t>(total, lo + step);
      pool.emplace_back(scan_snap, base, std::cref(snap), lo, hi,
                        std::cref(flt), &locals[t]);
    }
    for (auto& th : pool) th.join();
  }
  // merge in partition order: global tables keep first-seen order. Views
  // still point into the mapped file / local arenas — the file stays
  // mapped until the merge has materialized the id tables.
  std::unordered_map<std::string_view, int32_t> gu, gi;
  std::vector<std::string_view> user_order, item_order;
  size_t nnz = 0;
  for (auto& L : locals) nnz += L.uidx.size();
  res->uidx.reserve(nnz);
  res->iidx.reserve(nnz);
  res->vals.reserve(nnz);
  res->times.reserve(nnz);
  for (auto& L : locals) {
    std::vector<int32_t> uremap(L.users.size()), iremap(L.items.size());
    for (size_t j = 0; j < L.users.size(); ++j) {
      auto r = gu.emplace(L.users[j], (int32_t)gu.size());
      if (r.second) user_order.push_back(L.users[j]);
      uremap[j] = r.first->second;
    }
    for (size_t j = 0; j < L.items.size(); ++j) {
      auto r = gi.emplace(L.items[j], (int32_t)gi.size());
      if (r.second) item_order.push_back(L.items[j]);
      iremap[j] = r.first->second;
    }
    for (size_t j = 0; j < L.uidx.size(); ++j) {
      res->uidx.push_back(uremap[L.uidx[j]]);
      res->iidx.push_back(iremap[L.iidx[j]]);
      res->vals.push_back(L.vals[j]);
      res->times.push_back(L.times[j]);
    }
  }
  res->uoff.push_back(0);
  for (auto& s : user_order) {
    res->ubuf += s;
    res->uoff.push_back((int64_t)res->ubuf.size());
  }
  res->ioff.push_back(0);
  for (auto& s : item_order) {
    res->ibuf += s;
    res->ioff.push_back((int64_t)res->ibuf.size());
  }
  if (base != heap.data() && map_len) munmap(base, map_len);
  return res;
}

// Bulk append: n records whose per-record byte fields live concatenated in
// `buf` — for record k, offs[7k..7k+7] delimit (entity_type, entity_id,
// event name, event id, target_entity_type, target_entity_id+props_blob?,
// json_payload)... see below. Field layout per record (7 ranges):
//   0 entity_type   1 entity_id   2 event name   3 event id
//   4 target_entity_type   5 target_entity_id   6 props_blob ++ json
// props_blob comes pre-packed ([u8 klen][key][f64 value] per numeric
// property) followed by the JSON document; `meta` per record packs
// (u8 has_target, u8 sidecar_ok, u8 n_props, u8 pad, u32 props_blob_len).
// When sidecar_ok, the record is written as [sidecar][json] with the
// kSidecar flag; otherwise as bare JSON. Hashing and framing happen here;
// one buffered write per batch. Returns n, or -1 with the file truncated
// back to the batch start on a write failure (never a partial batch).
int64_t pio_evlog_append_bulk(void* handle, int64_t n,
                              const int64_t* time_ms, const uint8_t* buf,
                              const int64_t* offs, const uint8_t* meta) {
  auto* log = (EventLog*)handle;
  if (n <= 0) return 0;
  std::lock_guard<std::mutex> g(log->mu);
  fseeko(log->f, 0, SEEK_END);
  const off_t batch_start = ftello(log->f);
  std::string out;
  out.reserve((size_t)(offs[7 * n] - offs[0]) +
              (size_t)n * (sizeof(RecHeader) + 32));
  std::vector<Entry> new_entries;
  new_entries.reserve(n);
  off_t pos = batch_start;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t* o = offs + 7 * k;
    auto flen = [&](int i) { return (size_t)(o[i + 1] - o[i]); };
    auto fptr = [&](int i) { return (const char*)buf + o[i]; };
    auto field_hash = [&](int i) { return fnv1a64(fptr(i), flen(i)); };
    const uint8_t* m = meta + 8 * k;
    const bool has_target = m[0] != 0;
    const bool sidecar_ok = m[1] != 0;
    const uint8_t n_props = m[2];
    uint32_t props_len;
    memcpy(&props_len, m + 4, 4);
    const size_t json_len = flen(6) - props_len;
    const char* json = fptr(6) + props_len;
    uint32_t plen, flags;
    uint32_t side_len = 0;
    if (sidecar_ok) {
      side_len = 4 + 1 + 10 + (uint32_t)(flen(0) + flen(2) + flen(1)) +
                 (has_target ? (uint32_t)(flen(4) + flen(5)) : 0) + props_len;
      plen = side_len + (uint32_t)json_len;
      flags = kSidecar;
    } else {
      plen = (uint32_t)json_len;
      flags = 0;
    }
    RecHeader h{time_ms[k], field_hash(0), field_hash(1), field_hash(2),
                field_hash(3), plen, flags};
    out.append((const char*)&h, sizeof(h));
    if (sidecar_ok) {
      out.append((const char*)&side_len, 4);
      out.push_back((char)n_props);
      uint16_t l[5] = {(uint16_t)flen(0), (uint16_t)flen(2),
                       (uint16_t)flen(1),
                       has_target ? (uint16_t)flen(4) : kNoTarget,
                       has_target ? (uint16_t)flen(5) : (uint16_t)0};
      out.append((const char*)l, 10);
      out.append(fptr(0), flen(0));  // etype
      out.append(fptr(2), flen(2));  // event name
      out.append(fptr(1), flen(1));  // entity id
      if (has_target) {
        out.append(fptr(4), flen(4));
        out.append(fptr(5), flen(5));
      }
      out.append(fptr(6), props_len);
    }
    out.append(json, json_len);
    new_entries.push_back({time_ms[k], h.etype_hash, h.eid_hash, h.name_hash,
                           h.id_hash, (uint64_t)(pos + sizeof(h)), plen,
                           h.flags, false});
    pos += sizeof(h) + plen;
  }
  if (fwrite(out.data(), 1, out.size(), log->f) != out.size()) {
    fflush(log->f);
    (void)!ftruncate(fileno(log->f), batch_start);
    clearerr(log->f);
    fseeko(log->f, 0, SEEK_END);
    return -1;
  }
  fflush(log->f);
  for (auto& e : new_entries) {
    if (e.time_ms >= log->last_time && !log->sorted_dirty) {
      log->sorted.push_back((int64_t)log->entries.size());
    } else {
      log->sorted_dirty = true;
    }
    log->last_time = std::max(log->last_time, e.time_ms);
    log->entries.push_back(e);
    index_new_entry(log, (int64_t)log->entries.size() - 1);
  }
  return n;
}

// ---------------------------------------------------------------------------
// Columnar bulk import — the inverse of the interaction scan.
//
// Renders `n` interaction events (JSON payload + binary sidecar + framed
// header) entirely in C++ from columnar inputs: COO index arrays plus
// arrow-style id tables (byte blob + offsets — the same layout the scan
// emits). This is the high-throughput seeding path for `pio import` and the
// benchmark: no per-event Python objects exist anywhere. Plays the role of
// the reference's bulk write (data/.../storage/PEvents.scala:184
// `write(RDD[Event])` via the HBase TableOutputFormat).
// ---------------------------------------------------------------------------

static void json_escape_append(std::string* out, std::string_view s) {
  for (char c : s) {
    switch (c) {
      case '"': out->append("\\\""); break;
      case '\\': out->append("\\\\"); break;
      case '\b': out->append("\\b"); break;
      case '\f': out->append("\\f"); break;
      case '\n': out->append("\\n"); break;
      case '\r': out->append("\\r"); break;
      case '\t': out->append("\\t"); break;
      default:
        if ((uint8_t)c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", (int)(uint8_t)c);
          out->append(buf);
        } else {
          out->push_back(c);  // raw utf-8 bytes are valid JSON strings
        }
    }
  }
}

static void iso8601_append(std::string* out, int64_t ms) {
  time_t secs = (time_t)(ms >= 0 ? ms / 1000 : (ms - 999) / 1000);
  int milli = (int)(ms - (int64_t)secs * 1000);
  struct tm tmv;
  gmtime_r(&secs, &tmv);
  char buf[40];
  snprintf(buf, sizeof(buf), "%04d-%02d-%02dT%02d:%02d:%02d.%03d+00:00",
           tmv.tm_year + 1900, tmv.tm_mon + 1, tmv.tm_mday, tmv.tm_hour,
           tmv.tm_min, tmv.tm_sec, milli);
  out->append(buf);
}

static uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

static void hex32_append(std::string* out, uint64_t a, uint64_t b) {
  static const char* d = "0123456789abcdef";
  char buf[32];
  for (int i = 15; i >= 0; --i) { buf[i] = d[a & 15]; a >>= 4; }
  for (int i = 31; i >= 16; --i) { buf[i] = d[b & 15]; b >>= 4; }
  out->append(buf, 32);
}

// Render the canonical Event JSON from a compact record's sidecar — byte-
// identical to what append_interactions used to store inline (key order,
// %.9g numbers, iso8601 times), so readers cannot tell a compact record
// from a JSON-carrying one.
static void render_compact_json(const SideFields& f, std::string_view id32,
                                int64_t time_ms, std::string* out) {
  out->append("{\"eventId\":\"");
  out->append(id32);
  out->append("\",\"event\":\"");
  json_escape_append(out, f.name);
  out->append("\",\"entityType\":\"");
  json_escape_append(out, f.etype);
  out->append("\",\"entityId\":\"");
  json_escape_append(out, f.eid);
  if (f.has_target) {
    out->append("\",\"targetEntityType\":\"");
    json_escape_append(out, f.tetype);
    out->append("\",\"targetEntityId\":\"");
    json_escape_append(out, f.teid);
  }
  out->append("\",\"properties\":{");
  // f.props for a compact record also holds the trailing id32; the loop is
  // n_props-bounded so it never reads into it
  std::string_view props = f.props;
  size_t pos = 0;
  for (uint8_t i = 0; i < f.n_props; ++i) {
    if (pos + 1 > props.size()) break;
    const uint8_t kl = (uint8_t)props[pos];
    ++pos;
    if (pos + kl + 8 > props.size()) break;
    if (i) out->push_back(',');
    out->push_back('"');
    json_escape_append(out, props.substr(pos, kl));
    pos += kl;
    out->append("\":");
    double v;
    memcpy(&v, props.data() + pos, 8);
    pos += 8;
    char vbuf[40];
    snprintf(vbuf, sizeof(vbuf), "%.9g", v);
    out->append(vbuf);
  }
  out->append("},\"eventTime\":\"");
  std::string iso;
  iso8601_append(&iso, time_ms);
  out->append(iso);
  out->append("\",\"tags\":[],\"creationTime\":\"");
  out->append(iso);
  out->append("\"}");
}

// Returns n on success; -1 on write failure (file truncated back to the
// batch start — never a partial batch); -2 when an id/field exceeds the
// sidecar length limits (caller falls back to the generic Python path).
int64_t pio_evlog_append_interactions(
    void* handle, int64_t n, const int64_t* time_ms, const int32_t* uidx,
    const int32_t* iidx, const float* vals, const char* ubuf,
    const int64_t* uoffs, int64_t n_users, const char* ibuf,
    const int64_t* ioffs, int64_t n_items, const char* entity_type,
    const char* target_entity_type, const char* event_name,
    const char* value_prop, uint64_t seed) {
  auto* log = (EventLog*)handle;
  if (n <= 0) return 0;
  const std::string_view etype(entity_type), tetype(target_entity_type);
  const std::string_view name(event_name), prop(value_prop);
  if (etype.size() >= kNoTarget || tetype.size() >= kNoTarget ||
      name.size() >= kNoTarget || prop.size() > 255)
    return -2;
  for (int64_t i = 0; i < n_users; ++i)
    if (uoffs[i + 1] - uoffs[i] >= kNoTarget) return -2;
  for (int64_t i = 0; i < n_items; ++i)
    if (ioffs[i + 1] - ioffs[i] >= kNoTarget) return -2;
  for (int64_t k = 0; k < n; ++k)
    if (!std::isfinite((double)vals[k]) || uidx[k] < 0 ||
        uidx[k] >= n_users || iidx[k] < 0 || iidx[k] >= n_items)
      return -2;

  const uint64_t etype_h = fnv1a64(etype.data(), etype.size());
  const uint64_t name_h = fnv1a64(name.data(), name.size());
  // per-user id hashes, computed once
  std::vector<uint64_t> uhash(n_users);
  for (int64_t i = 0; i < n_users; ++i)
    uhash[i] = fnv1a64(ubuf + uoffs[i], (size_t)(uoffs[i + 1] - uoffs[i]));

  // Record size is a function of the two id lengths alone, so a prefix sum
  // over the batch gives every record's exact byte offset — which makes the
  // rendering embarrassingly parallel: T threads fill disjoint slices of
  // one contiguous buffer, then a single fwrite lands the super-batch.
  // Super-batches (~2M events ≈ 270 MB) bound peak memory at import scale.
  const size_t base_rec = sizeof(RecHeader) + 4 + 1 + 10 + etype.size() +
                          name.size() + tetype.size() + 1 + prop.size() + 8 +
                          32;
  // respect the cpuset/affinity mask (containers routinely pin to fewer
  // CPUs than the machine has; hardware_concurrency ignores that and
  // oversubscribing a 1-core mask just adds spawn + context-switch cost)
#if defined(__linux__)
  cpu_set_t cs;
  int nthreads = sched_getaffinity(0, sizeof(cs), &cs) == 0
                     ? CPU_COUNT(&cs)
                     : (int)std::thread::hardware_concurrency();
#else
  int nthreads = (int)std::thread::hardware_concurrency();
#endif
  if (const char* env = getenv("PIO_NATIVE_THREADS")) {
    const int v = atoi(env);
    if (v > 0) nthreads = v;
  }
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 16) nthreads = 16;
  const int64_t kSuper = 2'000'000;
  if (n < 65536) nthreads = 1;  // spawn cost dwarfs tiny batches

  std::lock_guard<std::mutex> g(log->mu);
  fseeko(log->f, 0, SEEK_END);
  const off_t batch_start = ftello(log->f);
  const size_t old_n = log->entries.size();
  const int64_t old_last_time = log->last_time;
  off_t pos = batch_start;
  if (log->entries.capacity() < old_n + (size_t)n) {
    // grow geometrically: an exact reserve() reallocates-and-copies the
    // whole entry index on EVERY small append (O(total) per call — REST
    // ingest decayed from 77k to 6k ev/s as the log grew); doubling
    // amortizes the copy to O(1) per entry
    log->entries.reserve(std::max(old_n + (size_t)n, old_n * 2));
  }
  std::string buf;
  std::vector<size_t> rec_off;
  bool failed = false;
  bool monotone = true;  // batch times in order AND not before the log tail
  int64_t prev_t = log->last_time;
  int64_t max_t = log->last_time;
  for (int64_t s0 = 0; s0 < n && !failed; s0 += kSuper) {
    const int64_t m = std::min(n - s0, kSuper);
    rec_off.assign((size_t)m + 1, 0);
    for (int64_t k = 0; k < m; ++k) {
      const int32_t u = uidx[s0 + k], it = iidx[s0 + k];
      rec_off[k + 1] = rec_off[k] + base_rec +
                       (size_t)(uoffs[u + 1] - uoffs[u]) +
                       (size_t)(ioffs[it + 1] - ioffs[it]);
      const int64_t t = time_ms[s0 + k];
      if (t < prev_t) monotone = false;
      prev_t = t;
      if (t > max_t) max_t = t;
    }
    buf.resize(rec_off[(size_t)m]);
    log->entries.resize(old_n + (size_t)(s0 + m));
    Entry* ents = log->entries.data() + old_n + s0;
    char* out = buf.data();
    const off_t sb_pos = pos;
    auto render = [&, s0, sb_pos, ents, out](int64_t a, int64_t b) {
      std::string idhex;
      for (int64_t k = a; k < b; ++k) {
        const int64_t g_k = s0 + k;
        const int32_t u = uidx[g_k], it = iidx[g_k];
        const std::string_view uid(ubuf + uoffs[u],
                                   (size_t)(uoffs[u + 1] - uoffs[u]));
        const std::string_view iid(ibuf + ioffs[it],
                                   (size_t)(ioffs[it + 1] - ioffs[it]));
        const uint64_t ida = splitmix64(seed ^ (uint64_t)g_k);
        const uint64_t idb =
            splitmix64(seed + 0x9E3779B97F4A7C15ull + (uint64_t)g_k);
        idhex.clear();
        hex32_append(&idhex, ida, idb);
        const uint64_t id_h = fnv1a64(idhex.data(), 32);
        // COMPACT record: sidecar only (with the 32-char event id appended
        // inside the block); pio_evlog_read renders the JSON on demand via
        // render_compact_json
        const uint32_t side_len = (uint32_t)(rec_off[k + 1] - rec_off[k] -
                                             sizeof(RecHeader));
        const uint32_t flags = kSidecar | kCompact;
        char* p = out + rec_off[k];
        RecHeader h{time_ms[g_k], etype_h, uhash[u], name_h, id_h, side_len,
                    flags};
        memcpy(p, &h, sizeof(h));
        p += sizeof(h);
        memcpy(p, &side_len, 4);
        p += 4;
        *p++ = (char)1;  // n_props
        uint16_t l[5] = {(uint16_t)etype.size(), (uint16_t)name.size(),
                         (uint16_t)uid.size(), (uint16_t)tetype.size(),
                         (uint16_t)iid.size()};
        memcpy(p, l, 10);
        p += 10;
        auto put = [&p](std::string_view s) {
          memcpy(p, s.data(), s.size());
          p += s.size();
        };
        put(etype);
        put(name);
        put(uid);
        put(tetype);
        put(iid);
        *p++ = (char)prop.size();
        put(prop);
        const double v64 = (double)vals[g_k];
        memcpy(p, &v64, 8);
        p += 8;
        memcpy(p, idhex.data(), 32);
        ents[k] = {time_ms[g_k], etype_h, uhash[u], name_h, id_h,
                   (uint64_t)(sb_pos + (off_t)rec_off[k] + sizeof(RecHeader)),
                   side_len, flags, false};
      }
    };
    if (nthreads == 1) {
      render(0, m);
    } else {
      std::vector<std::thread> pool;
      pool.reserve((size_t)nthreads);
      const int64_t chunk = (m + nthreads - 1) / nthreads;
      for (int t = 0; t < nthreads; ++t) {
        const int64_t a = t * chunk, b = std::min(m, a + chunk);
        if (a >= b) break;
        pool.emplace_back(render, a, b);
      }
      for (auto& th : pool) th.join();
    }
    if (fwrite(buf.data(), 1, buf.size(), log->f) != buf.size())
      failed = true;
    pos += (off_t)buf.size();
  }
  if (failed) {
    fflush(log->f);
    (void)!ftruncate(fileno(log->f), batch_start);
    clearerr(log->f);
    fseeko(log->f, 0, SEEK_END);
    log->entries.resize(old_n);  // sorted/last_time were never touched
    return -1;
  }
  fflush(log->f);
  if (monotone && !log->sorted_dirty) {
    const size_t old_sorted = log->sorted.size();
    log->sorted.resize(old_sorted + (size_t)n);
    for (int64_t k = 0; k < n; ++k)
      log->sorted[old_sorted + (size_t)k] = (int64_t)(old_n + (size_t)k);
  } else {
    log->sorted_dirty = true;
  }
  log->last_time = std::max(old_last_time, max_t);
  if (log->id_index_built)
    for (int64_t k = 0; k < n; ++k)
      index_new_entry(log, (int64_t)(old_n + (size_t)k));
  return n;
}

// ---------------------------------------------------------------------------
// Record-preserving compaction: copy LIVE records into a fresh log file at
// dst_path in the CURRENT on-disk format. Records that already carry a
// sidecar (incl. compact interaction records) byte-copy unchanged; bare-JSON
// records gain a sidecar built from the span parser — conservatively: a
// record whose relevant fields carry escapes or exceed the sidecar length
// limits stays bare JSON (readers handle both forms). Order: original log
// (append) order, which preserves the cross-backend equal-time tie-break.
// Returns the live-record count, or -1 on I/O failure (dst removed).
// ---------------------------------------------------------------------------

// Pack the NUMERIC top-level entries of a JSON object span as sidecar props
// (u8 klen, key bytes, f64 value). Returns false when the object cannot be
// represented (escaped/oversize keys, >255 numeric props) — caller keeps
// the record bare.
static bool pack_numeric_props(std::string_view obj, std::string* out,
                               uint8_t* n_out) {
  size_t i = 0;
  const size_t n = obj.size();
  int count = 0;
  if (n < 2 || obj[0] != '{') return false;
  i = 1;
  while (i < n) {
    while (i < n && (obj[i] == ' ' || obj[i] == '\t' || obj[i] == ',')) ++i;
    if (i < n && obj[i] == '}') break;
    if (i >= n || obj[i] != '"') return false;
    size_t kstart = ++i;
    bool kesc = false;
    while (i < n && obj[i] != '"') {
      if (obj[i] == '\\') { kesc = true; i += 2; } else ++i;
    }
    if (i >= n) return false;
    std::string_view key = obj.substr(kstart, i - kstart);
    ++i;
    while (i < n && (obj[i] == ' ' || obj[i] == '\t')) ++i;
    if (i >= n || obj[i] != ':') return false;
    ++i;
    while (i < n && (obj[i] == ' ' || obj[i] == '\t')) ++i;
    if (i >= n) return false;
    if (obj[i] == '"') {  // string value: skip
      ++i;
      while (i < n && obj[i] != '"') i += (obj[i] == '\\') ? 2 : 1;
      ++i;
    } else if (obj[i] == '{' || obj[i] == '[') {  // nested: skip balanced
      int d = 0;
      bool instr = false;
      while (i < n) {
        char c = obj[i];
        if (instr) {
          if (c == '\\') { i += 2; continue; }
          if (c == '"') instr = false;
          ++i;
          continue;
        }
        if (c == '"') { instr = true; ++i; continue; }
        if (c == '{' || c == '[') ++d;
        else if (c == '}' || c == ']') {
          if (--d == 0) { ++i; break; }
        }
        ++i;
      }
    } else {  // bare token: numeric, true/false/null
      size_t vstart = i;
      while (i < n && obj[i] != ',' && obj[i] != '}' && obj[i] != ' ' &&
             obj[i] != '\t')
        ++i;
      std::string tok(obj.substr(vstart, i - vstart));
      if (!tok.empty() && tok != "true" && tok != "false" && tok != "null") {
        char* end = nullptr;
        double v = strtod(tok.c_str(), &end);
        if (end == tok.c_str() + tok.size() && std::isfinite(v)) {
          if (kesc || key.size() > 255) return false;
          if (++count > 255) return false;
          out->push_back((char)key.size());
          out->append(key);
          out->append((const char*)&v, 8);
        }
      }
    }
  }
  *n_out = (uint8_t)count;
  return true;
}

int64_t pio_evlog_compact_copy(void* handle, const char* dst_path) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  FILE* dst = fopen(dst_path, "wb");
  if (!dst) return -1;
  fflush(log->f);
  int64_t live = 0;
  bool failed = false;
  std::string payload;
  std::string side;
  for (size_t idx = 0; idx < log->entries.size() && !failed; ++idx) {
    const Entry& e = log->entries[idx];
    if (e.dead || (e.flags & kTombstone)) continue;
    payload.resize(e.payload_len);
    fseeko(log->f, (off_t)e.offset, SEEK_SET);
    if (e.payload_len &&
        fread(payload.data(), 1, e.payload_len, log->f) != e.payload_len) {
      failed = true;
      break;
    }
    RecHeader h{e.time_ms, e.etype_hash, e.eid_hash, e.name_hash, e.id_hash,
                e.payload_len, e.flags};
    if (!(e.flags & kSidecar)) {
      // bare JSON: try the sidecar upgrade
      Fields f;
      side.clear();
      uint8_t n_props = 0;
      std::string props_packed;
      bool ok = extract_fields(payload, &f) && f.event.present &&
                f.etype.present && f.eid.present && !f.event.esc &&
                !f.etype.esc && !f.eid.esc &&
                (!f.tetype.present || !f.tetype.esc) &&
                (!f.teid.present || !f.teid.esc) &&
                f.tetype.present == f.teid.present &&
                f.etype.len < kNoTarget && f.event.len < kNoTarget &&
                f.eid.len < kNoTarget && f.tetype.len < kNoTarget &&
                f.teid.len < kNoTarget;
      if (ok && f.props.present)
        ok = pack_numeric_props(payload.substr(f.props.pos, f.props.len),
                                &props_packed, &n_props);
      if (ok) {
        const bool has_target = f.tetype.present;
        const uint32_t side_len =
            4 + 1 + 10 +
            (uint32_t)(f.etype.len + f.event.len + f.eid.len) +
            (has_target ? (uint32_t)(f.tetype.len + f.teid.len) : 0) +
            (uint32_t)props_packed.size();
        side.append((const char*)&side_len, 4);
        side.push_back((char)n_props);
        uint16_t l[5] = {(uint16_t)f.etype.len, (uint16_t)f.event.len,
                         (uint16_t)f.eid.len,
                         has_target ? (uint16_t)f.tetype.len : kNoTarget,
                         has_target ? (uint16_t)f.teid.len : (uint16_t)0};
        side.append((const char*)l, 10);
        side.append(payload, f.etype.pos, f.etype.len);
        side.append(payload, f.event.pos, f.event.len);
        side.append(payload, f.eid.pos, f.eid.len);
        if (has_target) {
          side.append(payload, f.tetype.pos, f.tetype.len);
          side.append(payload, f.teid.pos, f.teid.len);
        }
        side.append(props_packed);
        h.payload_len = side_len + (uint32_t)payload.size();
        h.flags = kSidecar;
      }
    }
    if (fwrite(&h, sizeof(h), 1, dst) != 1 ||
        (!side.empty() &&
         fwrite(side.data(), 1, side.size(), dst) != side.size()) ||
        (!payload.empty() &&
         fwrite(payload.data(), 1, payload.size(), dst) != payload.size()))
      failed = true;
    side.clear();
    ++live;
  }
  fseeko(log->f, 0, SEEK_END);
  // fdatasync BEFORE the caller renames dst over the original: a rename
  // is durable only if the replacement's blocks are — a crash after an
  // unsynced swap would lose the whole log
#if defined(__APPLE__)
  const bool synced = !failed && fflush(dst) == 0 &&
                      fcntl(fileno(dst), F_FULLFSYNC) != -1;
#else
  const bool synced = !failed && fflush(dst) == 0 &&
                      fdatasync(fileno(dst)) == 0;
#endif
  if (!synced) {
    fclose(dst);
    remove(dst_path);
    return -1;
  }
  fclose(dst);
  return live;
}

int64_t pio_scan_nnz(void* r) { return (int64_t)((ScanResult*)r)->uidx.size(); }

// Nanoseconds the scan held the log mutex (snapshot + mmap only) — the
// bench's lock-held-wall sub-metric; the payload scan runs lock-free.
int64_t pio_scan_lock_held_ns(void* r) { return ((ScanResult*)r)->lock_ns; }

int64_t pio_scan_n_ids(void* r, int32_t which) {
  auto* res = (ScanResult*)r;
  return (int64_t)(which == 0 ? res->uoff.size() : res->ioff.size()) - 1;
}

int64_t pio_scan_ids_bytes(void* r, int32_t which) {
  auto* res = (ScanResult*)r;
  return (int64_t)(which == 0 ? res->ubuf.size() : res->ibuf.size());
}

void pio_scan_fill(void* r, int32_t* u, int32_t* i, float* v) {
  auto* res = (ScanResult*)r;
  memcpy(u, res->uidx.data(), res->uidx.size() * sizeof(int32_t));
  memcpy(i, res->iidx.data(), res->iidx.size() * sizeof(int32_t));
  memcpy(v, res->vals.data(), res->vals.size() * sizeof(float));
}

// Per-row event times, parallel to pio_scan_fill's arrays — consumed by the
// Python training-projection cache (cpplog.py) so any full scan can seed it.
void pio_scan_fill_times(void* r, int64_t* t) {
  auto* res = (ScanResult*)r;
  memcpy(t, res->times.data(), res->times.size() * sizeof(int64_t));
}

void pio_scan_copy_ids(void* r, int32_t which, char* buf, int64_t* offsets) {
  auto* res = (ScanResult*)r;
  const std::string& b = which == 0 ? res->ubuf : res->ibuf;
  const std::vector<int64_t>& o = which == 0 ? res->uoff : res->ioff;
  memcpy(buf, b.data(), b.size());
  memcpy(offsets, o.data(), o.size() * sizeof(int64_t));
}

void pio_scan_free(void* r) { delete (ScanResult*)r; }

// Returns the payload length; copies into buf only when it fits. Dead or
// out-of-range records return -1.
int32_t pio_evlog_read(void* handle, int64_t index, uint8_t* buf,
                       int32_t cap) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  if (index < 0 || (size_t)index >= log->entries.size()) return -1;
  const Entry& e = log->entries[index];
  if (e.dead) return -1;
  uint64_t off = e.offset;
  uint32_t len = e.payload_len;
  if (e.flags & kCompact) {
    // no stored JSON: read the sidecar and render the canonical document
    std::string payload(len, '\0');
    fflush(log->f);
    fseeko(log->f, (off_t)off, SEEK_SET);
    const bool ok = fread(payload.data(), 1, len, log->f) == len;
    fseeko(log->f, 0, SEEK_END);
    SideFields sf;
    if (!ok || !parse_sidecar(payload.data(), len, &sf)) return -1;
    uint32_t bl;
    memcpy(&bl, payload.data(), 4);
    if (bl < 32 || bl > len) return -1;
    const std::string_view id32(payload.data() + bl - 32, 32);
    std::string json;
    render_compact_json(sf, id32, e.time_ms, &json);
    if ((int32_t)json.size() <= cap)
      memcpy(buf, json.data(), json.size());
    return (int32_t)json.size();
  }
  if (e.flags & kSidecar) {
    // skip the binary sidecar block: callers get the JSON document only
    uint32_t bl = 0;
    fflush(log->f);
    fseeko(log->f, (off_t)off, SEEK_SET);
    if (fread(&bl, 4, 1, log->f) != 1 || bl > len) {
      fseeko(log->f, 0, SEEK_END);
      return -1;
    }
    off += bl;
    len -= bl;
  }
  if ((int32_t)len <= cap) {
    fseeko(log->f, (off_t)off, SEEK_SET);
    if (fread(buf, 1, len, log->f) != len) return -1;
    fseeko(log->f, 0, SEEK_END);
  }
  return (int32_t)len;
}

// ---------------------------------------------------------------------------
// Replication frame IO: byte-level log shipping. A follower tails the
// leader's framed byte stream — whole records only, never split — and
// appends them verbatim, so the follower's file is bit-identical to the
// leader's prefix: entry numbering, tombstone target indices, sidecars
// and hashes all carry over with no re-derivation.

int64_t pio_evlog_file_size(void* handle) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  fflush(log->f);
  fseeko(log->f, 0, SEEK_END);
  return (int64_t)ftello(log->f);
}

// Copy whole frames for entries [from_entry, ...] into buf, up to
// max_bytes. Returns bytes copied (0 = already at the tail) and sets
// *out_entries to the frame count. When even the FIRST frame exceeds
// max_bytes, returns -(needed bytes) so the caller can retry with a
// bigger buffer instead of stalling the stream forever.
int64_t pio_evlog_read_frames(void* handle, int64_t from_entry,
                              int64_t max_bytes, uint8_t* buf,
                              int64_t* out_entries) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  *out_entries = 0;
  const int64_t total = (int64_t)log->entries.size();
  if (from_entry < 0 || from_entry > total) return -1;
  if (from_entry == total) return 0;
  const off_t start = (off_t)log->entries[from_entry].offset
                      - (off_t)sizeof(RecHeader);
  int64_t end = start;
  int64_t n = 0;
  for (int64_t i = from_entry; i < total; ++i) {
    const Entry& e = log->entries[i];
    const int64_t frame_end = (int64_t)e.offset + e.payload_len;
    if (frame_end - start > max_bytes) break;
    end = frame_end;
    ++n;
  }
  if (n == 0) {  // first frame alone is larger than the caller's buffer
    const Entry& e = log->entries[from_entry];
    return -((int64_t)e.offset + e.payload_len - start);
  }
  fflush(log->f);
  fseeko(log->f, start, SEEK_SET);
  const size_t want = (size_t)(end - start);
  const bool ok = fread(buf, 1, want, log->f) == want;
  fseeko(log->f, 0, SEEK_END);
  if (!ok) return -1;
  *out_entries = n;
  return (int64_t)want;
}

// Append a validated run of whole frames (as produced by read_frames) and
// index them exactly as the reopen scan would. All-or-nothing: a malformed
// buffer is rejected before any write; a failed write truncates back.
// Returns the new entry count, or -1.
int64_t pio_evlog_append_frames(void* handle, const uint8_t* buf,
                                int64_t nbytes) {
  auto* log = (EventLog*)handle;
  std::lock_guard<std::mutex> g(log->mu);
  // validation pass: every frame extent must land exactly on nbytes
  int64_t pos = 0;
  while (pos < nbytes) {
    if (pos + (int64_t)sizeof(RecHeader) > nbytes) return -1;
    RecHeader h;
    memcpy(&h, buf + pos, sizeof(h));
    pos += (int64_t)sizeof(h) + h.payload_len;
    if (pos > nbytes) return -1;
  }
  if (pos != nbytes) return -1;
  fseeko(log->f, 0, SEEK_END);
  const off_t rec_start = ftello(log->f);
  if (nbytes &&
      fwrite(buf, 1, (size_t)nbytes, log->f) != (size_t)nbytes) {
    fflush(log->f);
    (void)!ftruncate(fileno(log->f), rec_start);
    clearerr(log->f);
    fseeko(log->f, 0, SEEK_END);
    return -1;
  }
  fflush(log->f);
  // index pass: mirrors the pio_evlog_open scan (tombstone targets are
  // indices into the stream the frames came from — identical here by
  // construction, since the follower only ever appends the leader's
  // prefix in order)
  pos = 0;
  uint64_t off_base = (uint64_t)rec_start;
  while (pos < nbytes) {
    RecHeader h;
    memcpy(&h, buf + pos, sizeof(h));
    const uint64_t off = off_base + (uint64_t)pos + sizeof(h);
    if (h.flags & kTombstone) {
      int64_t target = -1;
      if (h.payload_len == 8) {
        memcpy(&target, buf + pos + sizeof(h), 8);
        if (target >= 0 && (size_t)target < log->entries.size() &&
            !log->entries[target].dead) {
          log->entries[target].dead = true;
          ++log->dead_count;
        }
      }
      ++log->dead_count;  // the marker entry itself
      log->entries.push_back({0, 0, 0, 0, 0, off, h.payload_len, h.flags,
                              true});
    } else {
      log->last_time = std::max(log->last_time, h.time_ms);
      log->entries.push_back({h.time_ms, h.etype_hash, h.eid_hash,
                              h.name_hash, h.id_hash, off, h.payload_len,
                              h.flags, false});
      index_new_entry(log, (int64_t)log->entries.size() - 1);
    }
    pos += (int64_t)sizeof(h) + h.payload_len;
  }
  log->sorted_dirty = true;
  return (int64_t)log->entries.size();
}

int64_t pio_evlog_hash_ids(const char* blob, const int64_t* offsets,
                           int64_t n, uint64_t* out) {
  // Batched FNV-1a over an interned id table (blob + offsets, the
  // IdTable layout): one crossing for the whole table instead of a
  // per-id Python hash — the writer-shard spray's hot loop.
  if (!blob || !offsets || !out || n < 0) return -1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t len = offsets[i + 1] - offsets[i];
    if (len < 0) return -1;
    out[i] = fnv1a64(blob + offsets[i], (size_t)len);
  }
  return n;
}

}  // extern "C"
