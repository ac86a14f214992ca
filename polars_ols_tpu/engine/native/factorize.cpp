// Native host-side runtime helpers for the least-squares engine.
//
// The reference keeps its host-side group hashing inside polars' Rust
// engine (reference layer L3; SURVEY §1). Our equivalent: an O(N)
// open-addressing hash table that factorizes group keys into dense ids in
// one pass — the host step that precedes every grouped solve and feeds the
// device layout builder. numpy's unique() is sort-based (O(N log N), ~160ms
// at 2M keys); this runs at memory speed.
//
// Exposed via a plain C ABI for ctypes (engine/native.py). No Python.h
// dependency — the library is pure C++ and is loaded with dlopen.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// 64-bit mix (splitmix64 finalizer) — avalanches low-entropy integer keys.
inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

inline uint64_t next_pow2(uint64_t v) {
  v--;
  v |= v >> 1; v |= v >> 2; v |= v >> 4;
  v |= v >> 8; v |= v >> 16; v |= v >> 32;
  return v + 1;
}

}  // namespace

extern "C" {

// Factorize int64 keys into dense group ids in FIRST-SEEN order.
// out[i] = id of keys[i]; returns the number of distinct keys, or -1 on
// allocation failure. Python remaps first-seen -> sorted order to match
// numpy.unique semantics (engine/native.py).
int64_t pols_factorize_i64(const int64_t* keys, int64_t n, int64_t* out) {
  if (n <= 0) return 0;
  uint64_t cap = next_pow2(static_cast<uint64_t>(n) * 2);
  if (cap < 16) cap = 16;
  const uint64_t mask = cap - 1;
  struct Slot { int64_t key; int64_t id; };
  std::vector<Slot> table;
  std::vector<uint8_t> used;
  try {
    table.resize(cap);
    used.assign(cap, 0);
  } catch (...) {
    return -1;
  }
  int64_t n_groups = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = keys[i];
    uint64_t h = mix64(static_cast<uint64_t>(k)) & mask;
    for (;;) {
      if (!used[h]) {
        used[h] = 1;
        table[h].key = k;
        table[h].id = n_groups;
        out[i] = n_groups++;
        break;
      }
      if (table[h].key == k) {
        out[i] = table[h].id;
        break;
      }
      h = (h + 1) & mask;
    }
  }
  return n_groups;
}

// Same, for raw 64-bit key material (e.g. canonicalized f64 bit patterns or
// pre-hashed multi-column keys).
int64_t pols_factorize_u64(const uint64_t* keys, int64_t n, int64_t* out) {
  return pols_factorize_i64(reinterpret_cast<const int64_t*>(keys), n, out);
}

// Combine two id columns into one (row-major pairing) without overflow:
// pair ids through a hash of (a, b). Used for multi-key group_by.
void pols_hash_pair(const int64_t* a, const int64_t* b, int64_t n,
                    uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = mix64(static_cast<uint64_t>(a[i]));
    h = mix64(h ^ static_cast<uint64_t>(b[i]));
    out[i] = h;
  }
}

}  // extern "C"

extern "C" {

// Group layout in two linear passes (counting sort — no argsort, no random
// gathers; numpy's argsort+fancy-index build costs ~45 s at 8M rows on a
// slow-memory host, this runs at memory speed). Outputs:
//   counts[g]  rows per group                      [num_groups]
//   order[p]   row index at sorted position p      [n] (stable by row order)
//   rank[i]    position of row i inside its group  [n]
// Returns 0, or -1 when a gid falls outside [0, num_groups) (caller falls
// back to the numpy path).
int64_t pols_layout_build(const int64_t* gids, int64_t n, int64_t num_groups,
                          int64_t* counts, int64_t* order, int64_t* rank) {
  if (n < 0 || num_groups < 0) return -1;
  std::memset(counts, 0, static_cast<size_t>(num_groups) * sizeof(int64_t));
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = gids[i];
    if (g < 0 || g >= num_groups) return -1;
    ++counts[g];
  }
  std::vector<int64_t> first, cursor;
  try {
    first.resize(static_cast<size_t>(num_groups));
    cursor.resize(static_cast<size_t>(num_groups));
  } catch (...) {
    return -1;
  }
  int64_t acc = 0;
  for (int64_t g = 0; g < num_groups; ++g) {
    first[static_cast<size_t>(g)] = acc;
    cursor[static_cast<size_t>(g)] = acc;
    acc += counts[g];
  }
  // Small inputs (or few groups): direct scatter. The cursor table is
  // cache-resident; only order[pos] writes are random.
  if (n < (1 << 20) || num_groups <= 512) {
    for (int64_t i = 0; i < n; ++i) {
      const int64_t g = gids[i];
      const int64_t pos = cursor[static_cast<size_t>(g)]++;
      order[pos] = i;
      rank[i] = pos - first[static_cast<size_t>(g)];
    }
    return 0;
  }
  // Large inputs: bucket-partitioned scatter. Direct order[pos] writes
  // touch a fresh cache line almost every row when groups interleave
  // (~700 ns/row on slow-memory hosts). Bucket b covers the contiguous
  // group range [b*gpb, (b+1)*gpb), so its slice of `order` is contiguous;
  // partitioning rows by bucket first makes every write stream either
  // sequential (rank, the per-bucket row/gid staging) or confined to an
  // L2-sized region (the final order scatter).
  const int64_t B = 256;
  const int64_t gpb = (num_groups + B - 1) / B;
  std::vector<int64_t> tmp_i, tmp_g, bcur(static_cast<size_t>(B), 0);
  try {
    tmp_i.resize(static_cast<size_t>(n));
    tmp_g.resize(static_cast<size_t>(n));
  } catch (...) {
    return -1;
  }
  // bucket start = first row position of its first group
  for (int64_t b = 0; b < B; ++b) {
    const int64_t g0 = b * gpb;
    bcur[static_cast<size_t>(b)] =
        g0 < num_groups ? first[static_cast<size_t>(g0)] : n;
  }
  std::vector<int64_t> occ(static_cast<size_t>(num_groups), 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = gids[i];
    rank[i] = occ[static_cast<size_t>(g)]++;  // sequential write to rank
    const int64_t at = bcur[static_cast<size_t>(g / gpb)]++;
    tmp_i[static_cast<size_t>(at)] = i;  // sequential per bucket stream
    tmp_g[static_cast<size_t>(at)] = g;
  }
  for (int64_t p = 0; p < n; ++p) {  // sequential reads; L2-local writes
    const int64_t g = tmp_g[static_cast<size_t>(p)];
    order[cursor[static_cast<size_t>(g)]++] = tmp_i[static_cast<size_t>(p)];
  }
  return 0;
}

// Scatter rows into a blocked [S, r_cap] layout in ONE linear pass:
//   blk  = block_first[gids[i]] + rank[i] / r_cap
//   slot = rank[i] % r_cap
//   gather[blk * r_cap + slot] = i;  mask[...] = 1
// Covers both the fully padded layout (block_first[g] = g, r_cap = R) and
// the split-padded moment layout (block_first = cumsum of per-group block
// counts). gather/mask must be pre-zeroed by the caller.
void pols_scatter_blocks(const int64_t* gids, const int64_t* rank,
                         const int64_t* block_first, int64_t r_cap,
                         int64_t n, int64_t* gather, uint8_t* mask) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = rank[i];
    const int64_t at =
        (block_first[gids[i]] + r / r_cap) * r_cap + (r % r_cap);
    gather[at] = i;
    mask[at] = 1;
  }
}

// Inverse of pols_scatter_blocks: per-row flat position inside the blocked
// [S, r_cap] layout (the row-order unpad gather map), emitted as int32 —
// the dtype the device map wants — in ONE pass (the numpy expression
// spends ~3.5 s in six 8M-element temporaries on this host).
void pols_unpad_map(const int64_t* gids, const int64_t* rank,
                    const int64_t* block_first, int64_t r_cap, int64_t n,
                    int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = rank[i];
    out[i] = static_cast<int32_t>(
        (block_first[gids[i]] + r / r_cap) * r_cap + (r % r_cap));
  }
}

}  // extern "C"
