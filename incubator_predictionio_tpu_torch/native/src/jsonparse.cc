// Native uniform-batch JSON parser — the REST ingest hot path's
// body-bytes → columnar-arrays leg, in C++ so it runs GIL-released.
//
// Scope is a STRICT SUBSET of the Python doc gate
// (data/storage/base.py uniform_interactions_from_docs): anything this
// parser accepts, the Python gate provably accepts with identical output
// (pinned by a randomized differential test); anything unusual — string
// escapes, eventTime, reserved-prefix names, non-f32-exact values,
// numbers near double precision, oversized fields — returns -1 and the
// caller falls back to the Python path, which owns the full semantics.
// The reference's ingest parses every event into a case class on the JVM
// (data/.../api/EventServer.scala + EventJson4sSupport); here the
// machine-generated wire shape never materializes per-event objects in
// either language.
//
// Build: compiled into libpio_native.so next to eventlog.cc (see
// native/__init__.py _SOURCES).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct Cursor {
  const char* p;
  const char* end;
  bool ok = true;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool lit(char c) {
    ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    ok = false;
    return false;
  }
  bool peek(char c) {
    ws();
    return p < end && *p == c;
  }
};

// String without escapes: returns the raw byte span between quotes.
// Rejects backslash (escape semantics stay in Python), control chars,
// and unterminated strings.
bool parse_string(Cursor& c, std::string_view* out) {
  if (!c.lit('"')) return false;
  const char* start = c.p;
  while (c.p < c.end) {
    unsigned char ch = (unsigned char)*c.p;
    if (ch == '"') {
      *out = std::string_view(start, (size_t)(c.p - start));
      ++c.p;
      return true;
    }
    if (ch == '\\' || ch < 0x20) return false;
    ++c.p;
  }
  return false;
}

// Strict JSON number grammar, with conservative precision screens so the
// double arithmetic below provably matches Python's arbitrary-precision
// comparison: <=15 significant digits and |exponent| <= 30.
bool parse_number(Cursor& c, double* out) {
  c.ws();
  const char* start = c.p;
  if (c.p < c.end && *c.p == '-') ++c.p;
  if (c.p >= c.end) return false;
  int int_digits = 0;
  if (*c.p == '0') {
    ++c.p;
    int_digits = 1;
  } else if (*c.p >= '1' && *c.p <= '9') {
    while (c.p < c.end && *c.p >= '0' && *c.p <= '9') {
      ++c.p;
      ++int_digits;
    }
  } else {
    return false;
  }
  int frac_digits = 0;
  if (c.p < c.end && *c.p == '.') {
    ++c.p;
    if (c.p >= c.end || *c.p < '0' || *c.p > '9') return false;
    while (c.p < c.end && *c.p >= '0' && *c.p <= '9') {
      ++c.p;
      ++frac_digits;
    }
  }
  long expv = 0;
  if (c.p < c.end && (*c.p == 'e' || *c.p == 'E')) {
    ++c.p;
    bool neg = false;
    if (c.p < c.end && (*c.p == '+' || *c.p == '-')) {
      neg = (*c.p == '-');
      ++c.p;
    }
    if (c.p >= c.end || *c.p < '0' || *c.p > '9') return false;
    while (c.p < c.end && *c.p >= '0' && *c.p <= '9') {
      expv = expv * 10 + (*c.p - '0');
      if (expv > 1000) return false;
      ++c.p;
    }
    if (neg) expv = -expv;
  }
  if (int_digits + frac_digits > 15) return false;
  if (expv < -30 || expv > 30) return false;
  std::string buf(start, (size_t)(c.p - start));
  char* endp = nullptr;
  double v = strtod(buf.c_str(), &endp);
  if (endp != buf.c_str() + buf.size()) return false;
  *out = v;
  return true;
}

constexpr size_t kMaxField = 200;  // ids and scalar fields, bytes

// Strict UTF-8 validation (rejects overlongs, surrogates, >U+10FFFF) —
// Python's utf-8 decode on the json.loads path rejects the same set, so
// accepting less keeps the strict-subset contract: an undecodable id
// must 400 via the generic path, never persist as raw bytes.
bool valid_utf8(std::string_view s) {
  size_t i = 0;
  const size_t n = s.size();
  while (i < n) {
    unsigned char c = (unsigned char)s[i];
    if (c < 0x80) {
      ++i;
      continue;
    }
    int extra;
    unsigned cp, cp_min;
    if ((c & 0xE0) == 0xC0) {
      extra = 1;
      cp = c & 0x1F;
      cp_min = 0x80;
    } else if ((c & 0xF0) == 0xE0) {
      extra = 2;
      cp = c & 0x0F;
      cp_min = 0x800;
    } else if ((c & 0xF8) == 0xF0) {
      extra = 3;
      cp = c & 0x07;
      cp_min = 0x10000;
    } else {
      return false;
    }
    if (i + (size_t)extra >= n) return false;
    for (int k = 1; k <= extra; ++k) {
      unsigned char cc = (unsigned char)s[i + (size_t)k];
      if ((cc & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (cc & 0x3F);
    }
    if (cp < cp_min || cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF))
      return false;
    i += (size_t)extra + 1;
  }
  return true;
}

bool reserved_prefix(std::string_view s) {
  // conservative superset of the Python reserved screens: anything
  // starting with '$' or 'pio_' falls back (the Python gate knows the
  // builtin whitelists; this parser does not need to)
  return (!s.empty() && s[0] == '$') ||
         (s.size() >= 4 && s.substr(0, 4) == "pio_");
}

struct Intern {
  std::unordered_map<std::string_view, int32_t> map;
  char* blob;
  int64_t cap;
  int64_t used = 0;
  int64_t* offs;  // [max_n + 1]
  int64_t n = 0;

  explicit Intern(char* b, int64_t c, int64_t* o) : blob(b), cap(c), offs(o) {
    offs[0] = 0;
  }
  // returns dense index or -1 on blob overflow
  int32_t put(std::string_view id) {
    auto it = map.find(id);
    if (it != map.end()) return it->second;
    if (used + (int64_t)id.size() > cap) return -1;
    memcpy(blob + used, id.data(), id.size());
    // keys must view the BLOB copy: the request body the string_views
    // point into outlives this call, but interning against the copy is
    // self-contained and keeps the invariant local
    std::string_view stored(blob + used, id.size());
    used += (int64_t)id.size();
    int32_t idx = (int32_t)n;
    offs[++n] = used;
    map.emplace(stored, idx);
    return idx;
  }
};

}  // namespace

extern "C" {

// Parse a strict-subset uniform batch. Returns the doc count n (>= 1)
// when eligible, or -1 for "fall back to the Python path" (not an
// error). Output arrays are caller-allocated: uidx/iidx/vals sized
// max_n; ublob/iblob byte caps with offs arrays sized max_n+1; scalars
// holds etype|name|tetype|vprop concatenated with lengths in
// scalar_lens[4].
int64_t pio_parse_uniform_batch(
    const char* body, int64_t body_len, int64_t max_n,
    int32_t* uidx, int32_t* iidx, float* vals,
    char* ublob, int64_t ublob_cap, int64_t* uoffs, int64_t* n_users_out,
    char* iblob, int64_t iblob_cap, int64_t* ioffs, int64_t* n_items_out,
    char* scalars, int64_t scalars_cap, int64_t* scalar_lens) {
  Cursor c{body, body + body_len};
  if (!c.lit('[')) return -1;
  if (c.peek(']')) return -1;  // empty batch: Python path owns the reply

  std::string_view name, etype, tetype, vprop;
  Intern users(ublob, ublob_cap, uoffs);
  Intern items(iblob, iblob_cap, ioffs);
  int64_t n = 0;

  enum KeyBit {
    kEvent = 1, kEtype = 2, kEid = 4, kTetype = 8, kTid = 16, kProps = 32,
  };

  while (true) {
    if (!c.lit('{')) return -1;
    unsigned seen = 0;
    std::string_view d_name, d_etype, d_eid, d_tetype, d_tid, d_vprop;
    double value = 0.0;
    if (!c.peek('}')) {
      while (true) {
        std::string_view key;
        if (!parse_string(c, &key)) return -1;
        if (!c.lit(':')) return -1;
        unsigned bit;
        std::string_view* dst = nullptr;
        if (key == "event") {
          bit = kEvent;
          dst = &d_name;
        } else if (key == "entityType") {
          bit = kEtype;
          dst = &d_etype;
        } else if (key == "entityId") {
          bit = kEid;
          dst = &d_eid;
        } else if (key == "targetEntityType") {
          bit = kTetype;
          dst = &d_tetype;
        } else if (key == "targetEntityId") {
          bit = kTid;
          dst = &d_tid;
        } else if (key == "properties") {
          bit = kProps;
        } else {
          // unknown key OR eventTime: the Python path owns both (the
          // gate rejects unknowns; eventTime needs tz semantics)
          return -1;
        }
        if (seen & bit) return -1;  // duplicate key: json.loads keeps
        seen |= bit;                // the LAST; we keep neither — fallback
        if (dst != nullptr) {
          if (!parse_string(c, dst)) return -1;
        } else {  // properties: exactly one numeric prop
          if (!c.lit('{')) return -1;
          if (!parse_string(c, &d_vprop)) return -1;
          if (!c.lit(':')) return -1;
          if (!parse_number(c, &value)) return -1;
          if (!c.lit('}')) return -1;
        }
        if (c.peek(',')) {
          c.lit(',');
          continue;
        }
        break;
      }
    }
    if (!c.lit('}')) return -1;
    if (seen != (kEvent | kEtype | kEid | kTetype | kTid | kProps))
      return -1;
    if (d_eid.empty() || d_eid.size() > kMaxField || d_tid.empty() ||
        d_tid.size() > kMaxField)
      return -1;
    if (!valid_utf8(d_eid) || !valid_utf8(d_tid)) return -1;
    // f32-exactness, same predicate as the gate's vectorized screen
    float f = (float)value;
    if ((double)f != value) return -1;

    if (n == 0) {
      name = d_name;
      etype = d_etype;
      tetype = d_tetype;
      vprop = d_vprop;
      if (name.empty() || name.size() > kMaxField || etype.empty() ||
          etype.size() > kMaxField || tetype.empty() ||
          tetype.size() > kMaxField || vprop.empty() ||
          vprop.size() > kMaxField)
        return -1;
      if (reserved_prefix(name) || reserved_prefix(etype) ||
          reserved_prefix(tetype) || reserved_prefix(vprop))
        return -1;
      if (!valid_utf8(name) || !valid_utf8(etype) || !valid_utf8(tetype) ||
          !valid_utf8(vprop))
        return -1;
    } else {
      if (d_name != name || d_etype != etype || d_tetype != tetype ||
          d_vprop != vprop)
        return -1;
    }
    if (n >= max_n) return -1;  // over the wire cap: Python owns the 400
    int32_t u = users.put(d_eid);
    int32_t t = items.put(d_tid);
    if (u < 0 || t < 0) return -1;  // blob overflow
    uidx[n] = u;
    iidx[n] = t;
    vals[n] = f;
    ++n;

    if (c.peek(',')) {
      c.lit(',');
      continue;
    }
    break;
  }
  if (!c.lit(']')) return -1;
  c.ws();
  if (c.p != c.end) return -1;  // trailing bytes: not a pure array

  int64_t total_scalars =
      (int64_t)(etype.size() + name.size() + tetype.size() + vprop.size());
  if (total_scalars > scalars_cap) return -1;
  char* s = scalars;
  memcpy(s, etype.data(), etype.size());
  s += etype.size();
  memcpy(s, name.data(), name.size());
  s += name.size();
  memcpy(s, tetype.data(), tetype.size());
  s += tetype.size();
  memcpy(s, vprop.data(), vprop.size());
  scalar_lens[0] = (int64_t)etype.size();
  scalar_lens[1] = (int64_t)name.size();
  scalar_lens[2] = (int64_t)tetype.size();
  scalar_lens[3] = (int64_t)vprop.size();
  *n_users_out = users.n;
  *n_items_out = items.n;
  return n;
}

}  // extern "C"
