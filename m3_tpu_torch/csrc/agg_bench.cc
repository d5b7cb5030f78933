// Single-core host proxy of the reference aggregator's ingest hot loop:
// the port's copy of native/agg_bench.cc (the same source, so the same
// results bit for bit), the measured host baseline under BASELINE configs
// #3 (1M-series counter/gauge rollup) and #4 (timer p50/95/99 quantiles)
// on the machine that runs it.  The Go engine is not built here, so it
// cannot be benchmarked directly; this proxy re-creates the
// reference's per-sample work (src/aggregator/aggregation/counter.go:53,
// gauge.go:53, timer.go:55 + quantile/cm/stream.go:78 AddBatch) under
// conditions deliberately GENEROUS to the baseline:
//
//   * dense slot-indexed struct arrays stand in for the reference's
//     metricMap find-or-create + per-entry mutex (map.go:149,
//     entry.go:264) — a real Go aggregator pays hashing, pointer
//     chasing and lock traffic this proxy does not;
//   * timers append to flat per-ID sample vectors and flush with one
//     sort per ID — cheaper than the CM stream's cursor insert +
//     periodic compress;
//   * everything runs on one core with no scheduler or channel costs.
//
// The measured samples/s is therefore an UPPER BOUND on the single-core
// Go path; device/baseline ratios against it are conservative.
//
// Exposed via ctypes (m3_tpu_torch/native/aggproxy.py).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Counter rollup: per-sample update of (sum, sum_sq, count, max, min).
// Returns a checksum so the work cannot be dead-code eliminated.
// ---------------------------------------------------------------------------

struct CounterCell {
  int64_t sum, sum_sq, count, max, min;
};

int64_t agg_counter_ingest(const uint32_t* ids, const int64_t* values,
                           int64_t n, int64_t capacity, void* cells_raw) {
  auto* cells = static_cast<CounterCell*>(cells_raw);
  for (int64_t i = 0; i < n; ++i) {
    CounterCell& c = cells[ids[i]];
    int64_t v = values[i];
    c.sum += v;
    c.sum_sq += v * v;
    c.count += 1;
    if (v > c.max) c.max = v;
    if (v < c.min) c.min = v;
  }
  int64_t acc = 0;
  for (int64_t s = 0; s < capacity; ++s) acc += cells[s].sum + cells[s].count;
  return acc;
}

void* agg_counter_new(int64_t capacity) {
  auto* cells = new CounterCell[capacity];
  for (int64_t i = 0; i < capacity; ++i) {
    cells[i] = {0, 0, 0, INT64_MIN, INT64_MAX};
  }
  return cells;
}

void agg_counter_free(void* cells) { delete[] static_cast<CounterCell*>(cells); }

// ---------------------------------------------------------------------------
// Gauge rollup: last/sum/sum_sq/count/max/min with timestamped last-wins.
// ---------------------------------------------------------------------------

struct GaugeCell {
  double last, sum, sum_sq, max, min;
  int64_t count, last_t;
};

double agg_gauge_ingest(const uint32_t* ids, const double* values,
                        const int64_t* times, int64_t n, int64_t capacity,
                        void* cells_raw) {
  auto* cells = static_cast<GaugeCell*>(cells_raw);
  for (int64_t i = 0; i < n; ++i) {
    GaugeCell& c = cells[ids[i]];
    double v = values[i];
    if (times[i] > c.last_t) {
      c.last_t = times[i];
      c.last = v;
    }
    c.sum += v;
    c.sum_sq += v * v;
    c.count += 1;
    if (v > c.max) c.max = v;
    if (v < c.min) c.min = v;
  }
  double acc = 0;
  for (int64_t s = 0; s < capacity; ++s) acc += cells[s].sum + cells[s].last;
  return acc;
}

void* agg_gauge_new(int64_t capacity) {
  auto* cells = new GaugeCell[capacity];
  for (int64_t i = 0; i < capacity; ++i) {
    cells[i] = {0.0, 0.0, 0.0, -HUGE_VAL, HUGE_VAL, 0, INT64_MIN};
  }
  return cells;
}

void agg_gauge_free(void* cells) { delete[] static_cast<GaugeCell*>(cells); }

// ---------------------------------------------------------------------------
// Timer quantiles: append samples per ID, flush = sort + rank reads at
// ceil(q*n) (the rank the CM stream approximates within eps:
// reference quantile/cm/stream.go:239-247).
// ---------------------------------------------------------------------------

struct TimerArena {
  std::vector<std::vector<double>> samples;
  std::vector<double> sum;
  std::vector<int64_t> count;
};

void* agg_timer_new(int64_t capacity) {
  auto* a = new TimerArena;
  a->samples.resize(capacity);
  a->sum.assign(capacity, 0.0);
  a->count.assign(capacity, 0);
  return a;
}

void agg_timer_free(void* arena) { delete static_cast<TimerArena*>(arena); }

void agg_timer_ingest(const uint32_t* ids, const double* values, int64_t n,
                      void* arena_raw) {
  auto* a = static_cast<TimerArena*>(arena_raw);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t id = ids[i];
    a->samples[id].push_back(values[i]);
    a->sum[id] += values[i];
    a->count[id] += 1;
  }
}

// Flush all IDs: write (p_q0, p_q1, ..., mean) per ID into out
// (capacity x (nq + 1)), returns total samples flushed.
int64_t agg_timer_flush(void* arena_raw, const double* qs, int64_t nq,
                        double* out) {
  auto* a = static_cast<TimerArena*>(arena_raw);
  int64_t total = 0;
  int64_t capacity = static_cast<int64_t>(a->samples.size());
  for (int64_t id = 0; id < capacity; ++id) {
    auto& v = a->samples[id];
    double* row = out + id * (nq + 1);
    if (v.empty()) {
      for (int64_t q = 0; q <= nq; ++q) row[q] = 0.0;
      continue;
    }
    std::sort(v.begin(), v.end());
    int64_t sz = static_cast<int64_t>(v.size());
    for (int64_t q = 0; q < nq; ++q) {
      int64_t rank = static_cast<int64_t>(std::ceil(qs[q] * sz)) - 1;
      if (rank < 0) rank = 0;
      if (rank >= sz) rank = sz - 1;
      row[q] = v[rank];
    }
    row[nq] = a->sum[id] / static_cast<double>(sz);
    total += sz;
  }
  return total;
}

}  // extern "C"
