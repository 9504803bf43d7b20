// Degree-bucketed padded-rows builder — the native host-side data loader.
//
// This is the hot host loop between the event store and the device: COO
// interaction triplets → the static-shape padded buckets the ALS sweep
// consumes (ops/sparse.py documents the layout; the reference's analogous
// stage is MLlib's RDD block partitioning inside ALS.train, invoked from
// examples/.../ALSAlgorithm.scala — executor-side JVM code, hence the
// native obligation here). The Python/numpy builder loops over rows in the
// interpreter; at ML-20M scale (~20M triplets, ~165k user rows) that loop
// dominates training-read time, so it moves to C++: counting sort by row +
// one linear fill pass, both O(nnz).
//
// Two-call protocol (caller allocates everything, nothing is malloc'd
// across the boundary):
//   1. pio_csr_plan   → per-bucket segment counts
//   2. pio_csr_fill   → fills caller-allocated per-bucket arrays
// Buckets: bucket b holds segments of width min_width << b; rows longer
// than max_width are split into max_width segments (same rule as
// ops/sparse.py build_padded_rows, including stable within-row order).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// bucket index for a segment of `seg` entries
inline int bucket_of(int64_t seg, int32_t min_width, int32_t n_buckets) {
  int b = 0;
  int64_t w = min_width;
  while (w < seg && b < n_buckets - 1) { w <<= 1; ++b; }
  return b;
}

struct Plan {
  std::vector<int64_t> counts;        // per-row nnz
  std::vector<int64_t> row_start;     // prefix sums into sorted order
  std::vector<int64_t> order;         // counting-sorted triplet indices
};

int build_plan(const int32_t* rows, int64_t nnz, int64_t n_rows, Plan* p) {
  p->counts.assign(n_rows, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t r = rows[i];
    if (r < 0 || r >= n_rows) return -1;
    p->counts[r]++;
  }
  p->row_start.assign(n_rows + 1, 0);
  for (int64_t r = 0; r < n_rows; ++r)
    p->row_start[r + 1] = p->row_start[r] + p->counts[r];
  p->order.resize(nnz);
  std::vector<int64_t> cursor(p->row_start.begin(), p->row_start.end() - 1);
  for (int64_t i = 0; i < nnz; ++i)
    p->order[cursor[rows[i]]++] = i;   // stable: preserves input order
  return 0;
}

}  // namespace

extern "C" {

// Writes the number of segments per bucket into bucket_counts[n_buckets].
int64_t pio_csr_plan(const int32_t* rows, int64_t nnz, int64_t n_rows,
                     int32_t min_width, int32_t max_width, int32_t n_buckets,
                     int64_t* bucket_counts) {
  std::vector<int64_t> counts(n_rows, 0);
  for (int64_t i = 0; i < nnz; ++i) {
    int32_t r = rows[i];
    if (r < 0 || r >= n_rows) return -1;
    counts[r]++;
  }
  for (int32_t b = 0; b < n_buckets; ++b) bucket_counts[b] = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t rem = counts[r];
    while (rem > 0) {
      int64_t seg = std::min<int64_t>(rem, max_width);
      bucket_counts[bucket_of(seg, min_width, n_buckets)]++;
      rem -= seg;
    }
  }
  return 0;
}

// Fills per-bucket arrays. For bucket b (width w = min_width << b) the
// caller passes row_ids[b] (int32[count_b]), out_cols[b]/out_vals[b]/
// out_mask[b] (count_b × w, zero-initialized), and bucket_counts[b] (the
// allocation sizes, normally from pio_csr_plan). Returns the total number
// of segments written, or -1 on bad input — including any bucket whose
// allocation would overflow, so a caller-precomputed plan (the pipelined
// ingest path derives bucket counts from per-shard degree histograms
// accumulated DURING the scan) can never corrupt memory: a mismatch is
// rejected, never written past the allocation. Callers must also check
// the returned segment total against their plan — an over-allocated plan
// fills fewer segments than allocated and the tail rows would be junk.
int64_t pio_csr_fill(const int32_t* rows, const int32_t* cols,
                     const float* vals, int64_t nnz, int64_t n_rows,
                     int32_t min_width, int32_t max_width, int32_t n_buckets,
                     const int64_t* bucket_counts,
                     int32_t* const* out_row_ids, int32_t* const* out_cols,
                     float* const* out_vals, float* const* out_mask) {
  Plan p;
  if (build_plan(rows, nnz, n_rows, &p) != 0) return -1;
  std::vector<int64_t> cursor(n_buckets, 0);
  int64_t segments = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t off = 0, cnt = p.counts[r];
    while (cnt - off > 0) {
      int64_t seg = std::min<int64_t>(cnt - off, max_width);
      int b = bucket_of(seg, min_width, n_buckets);
      int64_t width = (int64_t)min_width << b;
      if (bucket_counts && cursor[b] >= bucket_counts[b]) return -1;
      int64_t slot = cursor[b]++;
      ++segments;
      out_row_ids[b][slot] = (int32_t)r;
      int32_t* oc = out_cols[b] + slot * width;
      float* ov = out_vals[b] + slot * width;
      float* om = out_mask[b] + slot * width;
      for (int64_t j = 0; j < seg; ++j) {
        int64_t k = p.order[p.row_start[r] + off + j];
        oc[j] = cols[k];
        ov[j] = vals[k];
        om[j] = 1.0f;
      }
      off += seg;
    }
  }
  return segments;
}

}  // extern "C"
