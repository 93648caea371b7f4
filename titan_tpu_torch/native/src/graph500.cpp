// Graph500 host pipeline of the port: R-MAT edge generation and the
// symmetrized, deduplicated, 8-aligned chunked CSR.
//
// Copied from titan_tpu/native/src/titan_native.cpp (tt_rmat_gen,
// tt_sym_chunked_csr and their helpers) and made multi-threaded, with
// output bit-identical to the single-threaded original:
//   * tt_rmat_gen splits the edges into contiguous ranges; each thread
//     jumps the xorshift128+ stream ahead to its range's first draw
//     (the generator is linear over GF(2), so a jump is a 128x128 bit
//     matrix power) and draws exactly what the serial loop would.
//   * tt_sym_chunked_csr scatters half-edges into 256 vertex buckets
//     from per-thread ranges, then sorts, counts and emits the buckets
//     in parallel. Buckets own disjoint vertices, and each bucket is
//     sorted before use, so the insertion order does not matter.
// Unlike the original, the CSR is emitted directly in the transposed
// [8, q_total] layout the device reads (dstT[lane * q_total + col]).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct XorShift128p {
  uint64_t s0, s1;
  explicit XorShift128p(uint64_t seed) {
    // splitmix64 init
    auto next = [&seed]() {
      uint64_t z = (seed += 0x9E3779B97F4A7C15ull);
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
      return z ^ (z >> 31);
    };
    s0 = next();
    s1 = next();
  }
  inline uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  inline double uniform() {  // [0, 1)
    return (next() >> 11) * (1.0 / 9007199254740992.0);
  }
  // Advance the state by `n` calls of next() in O(log n) matrix steps.
  void jump(uint64_t n);
};

// A 128-bit state vector (s0 in lo, s1 in hi) and a GF(2) matrix as its
// 128 columns: column i is the image of unit vector i.
struct V128 {
  uint64_t lo, hi;
};

inline V128 step_linear(V128 v) {  // next()'s state update
  uint64_t x = v.lo, y = v.hi;
  x ^= x << 23;
  return {y, x ^ y ^ (x >> 17) ^ (y >> 26)};
}

inline V128 mat_vec(const std::vector<V128>& m, V128 v) {
  V128 r{0, 0};
  for (int i = 0; i < 128; ++i) {
    uint64_t bit = i < 64 ? (v.lo >> i) & 1 : (v.hi >> (i - 64)) & 1;
    if (bit) {
      r.lo ^= m[i].lo;
      r.hi ^= m[i].hi;
    }
  }
  return r;
}

void XorShift128p::jump(uint64_t n) {
  std::vector<V128> p(128), sq(128);
  for (int i = 0; i < 128; ++i) {
    V128 e{i < 64 ? 1ull << i : 0, i < 64 ? 0 : 1ull << (i - 64)};
    p[i] = step_linear(e);
  }
  V128 v{s0, s1};
  while (n) {
    if (n & 1) v = mat_vec(p, v);
    n >>= 1;
    if (n) {
      for (int i = 0; i < 128; ++i) sq[i] = mat_vec(p, p[i]);
      p.swap(sq);
    }
  }
  s0 = v.lo;
  s1 = v.hi;
}

// Bijective avalanche mix restricted to `bits` bits (murmur-style
// finalizer; every step is invertible mod 2^bits).
inline uint64_t mix_bits(uint64_t v, int bits, uint64_t k1, uint64_t k2) {
  const uint64_t mask = (bits >= 64) ? ~0ull : ((1ull << bits) - 1);
  v &= mask;
  v = (v * (k1 | 1)) & mask;
  v ^= v >> (bits / 2 + 1);
  v = (v * (k2 | 1)) & mask;
  v ^= v >> (bits / 2 + 1);
  return v & mask;
}

int num_threads() {
  unsigned t = std::thread::hardware_concurrency();
  return t == 0 ? 1 : static_cast<int>(t > 64 ? 64 : t);
}

// Runs f(t) for t in [0, T) on T threads (t = 0 on the caller's).
template <class F>
void run_threads(int T, F f) {
  std::vector<std::thread> ts;
  for (int t = 1; t < T; ++t) ts.emplace_back(f, t);
  f(0);
  for (auto& th : ts) th.join();
}

// Runs f(b) for every bucket b in [0, nb), buckets handed out dynamically.
template <class F>
void for_buckets(int T, int nb, F f) {
  std::atomic<int> next{0};
  run_threads(T, [&](int) {
    for (int b = next++; b < nb; b = next++) f(b);
  });
}

}  // namespace

extern "C" {

// R-MAT edge generator: m edges over 2^scale vertices.
void tt_rmat_gen(int64_t m, int scale, uint64_t seed, double a, double b,
                 double c, int32_t* src, int32_t* dst) {
  XorShift128p rng(seed * 0x243F6A8885A308D3ull + 0x13198A2E03707344ull);
  const double ab = a + b, abc = a + b + c;
  const uint64_t k1 = rng.next(), k2 = rng.next();
  const int T = static_cast<int>(std::min<int64_t>(num_threads(),
                                                   std::max<int64_t>(m, 1)));
  run_threads(T, [&](int t) {
    const int64_t i0 = m * t / T, i1 = m * (t + 1) / T;
    XorShift128p r = rng;
    r.jump(static_cast<uint64_t>(i0) * static_cast<uint64_t>(scale));
    for (int64_t i = i0; i < i1; ++i) {
      uint64_t s = 0, d = 0;
      for (int bit = 0; bit < scale; ++bit) {
        double u = r.uniform();
        uint64_t down = (u >= ab);
        uint64_t right = down ? (u >= abc) : (u >= a);
        s |= down << bit;
        d |= right << bit;
      }
      src[i] = static_cast<int32_t>(mix_bits(s, scale, k1, k2));
      dst[i] = static_cast<int32_t>(mix_bits(d, scale, k1, k2));
    }
  });
}

// Symmetrized, deduped, 8-aligned chunked CSR in the transposed layout.
//
// Inputs: directed edges (src[i] -> dst[i]); every edge is inserted in both
// directions, then each vertex's adjacency is sorted and deduplicated
// (self-loops dropped). Outputs:
//   deg_orig[n]  pre-dedup symmetrized degree (Graph500 TEPS accounting)
//   deg[n]       post-dedup degree
//   colstart[n+1] first 8-edge chunk column of each vertex (aligned layout)
//   dstT_out     malloc'd [8 * q_total] int32, lane-major, pad = n+1
// Returns q_total (chunk columns incl. one trailing all-pad sink column),
// or -1 on allocation failure. Caller frees *dstT_out via tt_free.
int64_t tt_sym_chunked_csr(const int32_t* src, const int32_t* dst, int64_t m,
                           int64_t n, int32_t* deg_orig, int32_t* deg,
                           int64_t* colstart, int32_t** dstT_out) {
  const int kB = 256;
  const int64_t vrange = (n + kB - 1) / kB;
  const int T = static_cast<int>(std::min<int64_t>(num_threads(),
                                                   std::max<int64_t>(m, 1)));
  // pass 1: per-thread bucket sizes over contiguous edge ranges
  std::vector<int64_t> cnt(static_cast<size_t>(T) * kB, 0);
  run_threads(T, [&](int t) {
    int64_t* c = cnt.data() + static_cast<size_t>(t) * kB;
    for (int64_t i = m * t / T, e = m * (t + 1) / T; i < e; ++i) {
      ++c[src[i] / vrange];
      ++c[dst[i] / vrange];
    }
  });
  std::vector<int64_t> bstart(kB + 1, 0);
  std::vector<int64_t> head(static_cast<size_t>(T) * kB);
  for (int b = 0; b < kB; ++b) {
    int64_t at = bstart[b];
    for (int t = 0; t < T; ++t) {
      head[static_cast<size_t>(t) * kB + b] = at;
      at += cnt[static_cast<size_t>(t) * kB + b];
    }
    bstart[b + 1] = at;
  }
  // pass 2: scatter packed (v<<32 | w) half-edges into bucket regions
  int64_t* pairs =
      static_cast<int64_t*>(std::malloc(sizeof(int64_t) * 2 * m + 1));
  if (!pairs) return -1;
  run_threads(T, [&](int t) {
    int64_t* h = head.data() + static_cast<size_t>(t) * kB;
    for (int64_t i = m * t / T, e = m * (t + 1) / T; i < e; ++i) {
      uint64_t s = static_cast<uint32_t>(src[i]);
      uint64_t d = static_cast<uint32_t>(dst[i]);
      pairs[h[src[i] / vrange]++] = static_cast<int64_t>((s << 32) | d);
      pairs[h[dst[i] / vrange]++] = static_cast<int64_t>((d << 32) | s);
    }
  });
  // pass 3a: per-bucket sort + dedup degree count (adjacency of each v is
  // a contiguous sorted run of the packed keys)
  std::memset(deg_orig, 0, sizeof(int32_t) * n);
  std::memset(deg, 0, sizeof(int32_t) * n);
  for_buckets(T, kB, [&](int b) {
    int64_t lo = bstart[b], hi = bstart[b + 1];
    std::sort(pairs + lo, pairs + hi);
    int64_t prev = -1;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t p = pairs[i];
      int64_t v = static_cast<int64_t>(static_cast<uint64_t>(p) >> 32);
      int64_t w = p & 0xFFFFFFFFll;
      ++deg_orig[v];
      if (p != prev && v != w) ++deg[v];
      prev = p;
    }
  });
  // colstart prefix over ceil(deg/8)
  colstart[0] = 0;
  for (int64_t v = 0; v < n; ++v)
    colstart[v + 1] = colstart[v] + (deg[v] + 7) / 8;
  const int64_t q = colstart[n] + 1;  // +1 trailing all-pad column
  int32_t* dstT = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * q * 8));
  if (!dstT) {
    std::free(pairs);
    return -1;
  }
  const int32_t pad = static_cast<int32_t>(n + 1);
  // pass 3b: emit unique neighbors with 8-alignment padding, lane-major
  for_buckets(T, kB, [&](int b) {
    int64_t lo = bstart[b], hi = bstart[b + 1];
    int64_t i = lo;
    while (i < hi) {
      int64_t v = static_cast<int64_t>(static_cast<uint64_t>(pairs[i]) >> 32);
      int64_t k = 0;  // slot within v's segment: column colstart[v] + k/8
      int64_t prev = -1;
      while (i < hi &&
             static_cast<int64_t>(static_cast<uint64_t>(pairs[i]) >> 32) == v) {
        int64_t p = pairs[i];
        int64_t w = p & 0xFFFFFFFFll;
        if (p != prev && v != w) {
          dstT[(k & 7) * q + colstart[v] + (k >> 3)] = static_cast<int32_t>(w);
          ++k;
        }
        prev = p;
        ++i;
      }
      for (int64_t end = (colstart[v + 1] - colstart[v]) * 8; k < end; ++k)
        dstT[(k & 7) * q + colstart[v] + (k >> 3)] = pad;
    }
  });
  // the trailing all-pad sink column
  for (int j = 0; j < 8; ++j) dstT[j * q + q - 1] = pad;
  std::free(pairs);
  *dstT_out = dstT;
  return q;
}

void tt_free(void* p) { std::free(p); }

}  // extern "C"
