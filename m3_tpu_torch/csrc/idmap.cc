// Batched metric-ID -> slot resolver: the aggregator ingest hot path's
// host half.  The role of the reference's metricMap find-or-create
// (src/aggregator/aggregator/map.go:149) and the shard insert queue's
// series creation: every incoming sample resolves its string ID to a
// dense arena slot.  In Python this is a dict lookup per sample
// (~200-500 ns); here it is one hash probe over a packed batch
// (~40-80 ns), called once per ingest batch through ctypes
// (m3_tpu_torch/native/idmap.py).  The port's copy of native/idmap.cc:
// the same hashing, allocation order and rollback, so both packages
// assign the same slots.
//
// Keys are (id bytes, 8-byte aggregation mask) — the same compound key
// the Python MetricMap uses so one metric ID can hold several
// aggregation-key slots.  Slots are dense int32 with a free list;
// capacity is fixed (the device arenas are fixed-size).

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// Heterogeneous (C++20 transparent) lookup: probes hash a borrowed
// (bytes, mask) view with zero allocation; only INSERTS copy the id
// into an owned key.
struct Key {
  std::string id;
  uint64_t mask;
  bool operator==(const Key&) const = default;
};

struct RefKey {
  std::string_view id;
  uint64_t mask;
};

struct KeyHash {
  using is_transparent = void;
  static size_t mix(std::string_view sv, uint64_t mask) {
    size_t h = std::hash<std::string_view>{}(sv);
    return h ^ (std::hash<uint64_t>{}(mask) + 0x9e3779b97f4a7c15ULL +
                (h << 6) + (h >> 2));
  }
  size_t operator()(const Key& k) const { return mix(k.id, k.mask); }
  size_t operator()(const RefKey& k) const { return mix(k.id, k.mask); }
};

struct KeyEq {
  using is_transparent = void;
  bool operator()(const Key& a, const Key& b) const {
    return a.mask == b.mask && a.id == b.id;
  }
  bool operator()(const RefKey& a, const Key& b) const {
    return a.mask == b.mask && a.id == b.id;
  }
  bool operator()(const Key& a, const RefKey& b) const {
    return a.mask == b.mask && a.id == b.id;
  }
};

struct IdMap {
  std::unordered_map<Key, int32_t, KeyHash, KeyEq> slots;
  std::vector<int32_t> free_list;
  int64_t capacity;
  int64_t next = 0;
};

}  // namespace

extern "C" {

void* idmap_new(int64_t capacity) {
  auto* m = new IdMap;
  m->capacity = capacity;
  m->slots.reserve(static_cast<size_t>(capacity < (1 << 20) ? capacity
                                                            : (1 << 20)));
  return m;
}

void idmap_del(void* h) { delete static_cast<IdMap*>(h); }

int64_t idmap_len(void* h) {
  return static_cast<int64_t>(static_cast<IdMap*>(h)->slots.size());
}

// Resolve a packed batch: ids laid out back-to-back in `buf`,
// `offsets[i]..offsets[i+1]` delimiting id i (n+1 entries).  Fills
// out_slots[n].  Newly-allocated entries are reported via
// out_new_idx (their batch positions); returns the count of new
// entries, or -1 when allocation would exceed capacity (no partial
// allocation is rolled back; callers treat -1 as fatal for the batch).
int64_t idmap_resolve_batch(void* h, const uint8_t* buf,
                            const uint64_t* offsets, int64_t n,
                            uint64_t mask, int32_t* out_slots,
                            int64_t* out_new_idx) {
  auto* m = static_cast<IdMap*>(h);
  int64_t n_new = 0;
  for (int64_t i = 0; i < n; ++i) {
    std::string_view sv(reinterpret_cast<const char*>(buf) + offsets[i],
                        offsets[i + 1] - offsets[i]);
    RefKey ref{sv, mask};
    auto it = m->slots.find(ref);
    if (it != m->slots.end()) {
      out_slots[i] = it->second;
      continue;
    }
    int32_t slot;
    if (!m->free_list.empty()) {
      slot = m->free_list.back();
      m->free_list.pop_back();
    } else if (m->next < m->capacity) {
      slot = static_cast<int32_t>(m->next++);
    } else {
      // Roll back this batch's inserts so the caller's state mirror
      // (which never sees this batch's new entries) stays consistent:
      // the erased slots return through the free list.
      for (int64_t k = 0; k < n_new; ++k) {
        int64_t j = out_new_idx[k];
        std::string_view jsv(
            reinterpret_cast<const char*>(buf) + offsets[j],
            offsets[j + 1] - offsets[j]);
        auto jit = m->slots.find(RefKey{jsv, mask});
        if (jit != m->slots.end()) {
          m->free_list.push_back(jit->second);
          m->slots.erase(jit);
        }
      }
      return -1;
    }
    m->slots.emplace(Key{std::string(sv), mask}, slot);
    out_slots[i] = slot;
    out_new_idx[n_new++] = i;
  }
  return n_new;
}

// Release one (id, mask) entry back to the free list.  Returns 1 when
// the key existed.
int32_t idmap_release(void* h, const uint8_t* id, uint64_t len,
                      uint64_t mask) {
  auto* m = static_cast<IdMap*>(h);
  RefKey ref{std::string_view(reinterpret_cast<const char*>(id), len), mask};
  auto it = m->slots.find(ref);
  if (it == m->slots.end()) return 0;
  m->free_list.push_back(it->second);
  m->slots.erase(it);
  return 1;
}

}  // extern "C"
