// Native host-side open-addressing hash table for FSP state keys (a copy
// of the JAX package's krylovfspssa_tpu/native/kfs_hash.cpp, built and
// loaded by krylovfspssa_tpu_torch/native.py).
//
// The reference's state index is a Brent-variant double-hash table in
// Fortran (reference/src/hash_table/HashTable.f90: modes 1 lookup,
// 2 insert, 3 delete, Brent's CACM 16(2) reorganization on collision).
// This is its native equivalent for the *host* side of the table backend:
// batch insert/lookup/delete of int64 packed state keys -> int32 row
// indices, used by statespace/table.py for one-word keys (the numpy
// sorted merge is taken only when asked for by name, and for multi-word
// keys).
//
// Design differences from the reference, by intent:
//   * batch APIs (one call per candidate set, not one probe per state);
//   * power-of-two capacity with odd double-hash step (full-cycle probing)
//     instead of a prime-size table;
//   * tombstone-free deletion via backward-shift is replaced by tombstones
//     (DELKEY parity, HashTable.f90:139) since deletes are rare (drops).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 kfs_hash.cpp -o libkfs_hash.so

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int64_t EMPTY = -1;      // never a valid packed key
constexpr int64_t TOMBSTONE = -2;  // DELKEY analog

struct Table {
  int64_t* keys;    // slot -> key (EMPTY / TOMBSTONE / key)
  int32_t* values;  // slot -> row index
  uint64_t mask;    // n_slots - 1 (n_slots = power of two)
  int64_t size;     // live entries
  int64_t used;     // live + tombstones (for load management)
};

inline uint64_t mix(uint64_t x) {
  // splitmix64 finalizer — avalanche for the packed mixed-radix keys
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

inline uint64_t step_of(uint64_t h) {
  return (h >> 32) | 1;  // odd -> cycles the full power-of-two table
}

Table* create(uint64_t n_slots) {
  Table* t = new Table;
  t->keys = static_cast<int64_t*>(std::malloc(n_slots * sizeof(int64_t)));
  t->values = static_cast<int32_t*>(std::malloc(n_slots * sizeof(int32_t)));
  for (uint64_t i = 0; i < n_slots; ++i) t->keys[i] = EMPTY;
  t->mask = n_slots - 1;
  t->size = 0;
  t->used = 0;
  return t;
}

void destroy(Table* t) {
  std::free(t->keys);
  std::free(t->values);
  delete t;
}

void grow(Table* t);

// insert key->value; returns existing value if present (no overwrite)
int32_t insert_one(Table* t, int64_t key, int32_t value) {
  if ((t->used + 1) * 4 >= static_cast<int64_t>(t->mask + 1) * 3) grow(t);
  uint64_t h = mix(static_cast<uint64_t>(key));
  uint64_t idx = h & t->mask;
  uint64_t stp = step_of(h);
  int64_t first_tomb = -1;
  // probe chain of the new key
  for (;;) {
    int64_t k = t->keys[idx];
    if (k == key) return t->values[idx];
    if (k == EMPTY) break;
    if (k == TOMBSTONE && first_tomb < 0)
      first_tomb = static_cast<int64_t>(idx);
    idx = (idx + stp) & t->mask;
  }
  if (first_tomb >= 0) {
    idx = static_cast<uint64_t>(first_tomb);
  } else {
    t->used += 1;
  }
  t->keys[idx] = key;
  t->values[idx] = value;
  t->size += 1;
  return value;
}

void grow(Table* t) {
  uint64_t n_old = t->mask + 1;
  uint64_t n_new = n_old * 2;
  int64_t* ok = t->keys;
  int32_t* ov = t->values;
  t->keys = static_cast<int64_t*>(std::malloc(n_new * sizeof(int64_t)));
  t->values = static_cast<int32_t*>(std::malloc(n_new * sizeof(int32_t)));
  for (uint64_t i = 0; i < n_new; ++i) t->keys[i] = EMPTY;
  t->mask = n_new - 1;
  t->size = 0;
  t->used = 0;
  for (uint64_t i = 0; i < n_old; ++i) {
    if (ok[i] >= 0) insert_one(t, ok[i], ov[i]);
  }
  std::free(ok);
  std::free(ov);
}

int32_t lookup_one(const Table* t, int64_t key) {
  uint64_t h = mix(static_cast<uint64_t>(key));
  uint64_t idx = h & t->mask;
  uint64_t stp = step_of(h);
  for (;;) {
    int64_t k = t->keys[idx];
    if (k == key) return t->values[idx];
    if (k == EMPTY) return -1;
    idx = (idx + stp) & t->mask;
  }
}

bool erase_one(Table* t, int64_t key) {
  uint64_t h = mix(static_cast<uint64_t>(key));
  uint64_t idx = h & t->mask;
  uint64_t stp = step_of(h);
  for (;;) {
    int64_t k = t->keys[idx];
    if (k == key) {
      t->keys[idx] = TOMBSTONE;
      t->size -= 1;
      return true;
    }
    if (k == EMPTY) return false;
    idx = (idx + stp) & t->mask;
  }
}

}  // namespace

extern "C" {

void* kfs_hash_create(int64_t expected) {
  uint64_t slots = 64;
  while (static_cast<int64_t>(slots) * 3 < expected * 4) slots *= 2;
  return create(slots);
}

void kfs_hash_destroy(void* h) { destroy(static_cast<Table*>(h)); }

int64_t kfs_hash_size(void* h) { return static_cast<Table*>(h)->size; }

// insert keys[i] -> values[i] (skipping keys < 0); out[i] = the value now
// associated with keys[i] (existing on duplicate), or -1 for invalid keys
void kfs_hash_insert_batch(void* h, const int64_t* keys,
                           const int32_t* values, int64_t n, int32_t* out) {
  Table* t = static_cast<Table*>(h);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = keys[i] < 0 ? -1 : insert_one(t, keys[i], values[i]);
  }
}

void kfs_hash_lookup_batch(void* h, const int64_t* keys, int64_t n,
                           int32_t* out) {
  const Table* t = static_cast<Table*>(h);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = keys[i] < 0 ? -1 : lookup_one(t, keys[i]);
  }
}

// out[i] = 1 if the key was present and is now deleted
void kfs_hash_delete_batch(void* h, const int64_t* keys, int64_t n,
                           int32_t* out) {
  Table* t = static_cast<Table*>(h);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = keys[i] >= 0 && erase_one(t, keys[i]) ? 1 : 0;
  }
}

// For a candidate batch: assign fresh consecutive row indices starting at
// next_row to previously-absent keys (first occurrence wins), -1 for
// invalid/duplicate/present keys.  Returns the number of fresh keys.
int64_t kfs_hash_assign_fresh(void* h, const int64_t* keys, int64_t n,
                              int32_t next_row, int32_t* out) {
  Table* t = static_cast<Table*>(h);
  int64_t fresh = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (keys[i] < 0) {
      out[i] = -1;
      continue;
    }
    int32_t cand = next_row + static_cast<int32_t>(fresh);
    int32_t got = insert_one(t, keys[i], cand);
    if (got == cand) {
      out[i] = cand;
      fresh += 1;
    } else {
      out[i] = -1;  // already present (or duplicate earlier in the batch)
    }
  }
  return fresh;
}

}  // extern "C"
