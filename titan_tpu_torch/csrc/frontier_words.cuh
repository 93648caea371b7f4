// frontier_words.cuh: the vertex-major frontier words that
// frontier_round.cu, batched_exhaust.cu and bfs_fused.cu test parents
// against (the layout is stated in titan_tpu_torch/ops/frontier.py's
// module doc, and `words_at` there is the plain version of word_of).
//
// K jobs' frontiers are ceil(K / 32) planes of nb bytes; a vertex holds
// Kp = min(next_pow2(K), 32) = 2^kp_log bits of each plane, job k of the
// plane at bit k, so one load of a parent's word tests every job of the
// plane. K = 1 is the single-source bitmap.

#pragma once

#include <stdint.h>

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// log2 of Kp for K jobs
inline int word_log2(int K) {
  int kp_log = 0;
  while (kp_log < 5 && (1 << kp_log) < K) ++kp_log;
  return kp_log;
}

// The word of vertex `par` in a plane of nb bytes. Kp >= 8: an aligned
// load of Kp/8 bytes, the word index clamped into [0, nb*8/Kp - 1];
// below that a Kp-bit field of the byte (par*Kp) >> 3, clamped into
// [0, nb-1], at bit (par*Kp) & 7 (Kp = 1: the bit par & 7 of byte
// par >> 3). The clamps keep an out-of-range parent from faulting.
//
// kCoherent picks the load: false reads through the read-only cache
// (__ldg), for kernels whose words stay fixed for the whole launch; true
// reads L2 (__ldcg), for a kernel that rewrites its words between
// grid-wide barriers (bfs_fused.cu), where the read-only cache could
// serve an earlier level's line.
template <bool kCoherent, typename T>
__device__ __forceinline__ T load_word(const T* p) {
  if constexpr (kCoherent) return __ldcg(p);
  else return __ldg(p);
}

template <bool kCoherent>
__device__ __forceinline__ uint32_t word_of_t(
    const uint8_t* __restrict__ plane, int64_t nb, int kp_log,
    int32_t par) {
  if (kp_log >= 3) {
    const int64_t w = clamp64(par, 0, (nb >> (kp_log - 3)) - 1);
    if (kp_log == 3) return load_word<kCoherent>(plane + w);
    if (kp_log == 4)
      return load_word<kCoherent>(
          reinterpret_cast<const unsigned short*>(plane) + w);
    return load_word<kCoherent>(
        reinterpret_cast<const unsigned int*>(plane) + w);
  }
  const int64_t bit = int64_t(par) * (1 << kp_log);
  return (uint32_t(load_word<kCoherent>(plane + clamp64(bit >> 3, 0,
                                                        nb - 1))) >>
          int(bit & 7)) & ((1u << (1 << kp_log)) - 1u);
}

__device__ __forceinline__ uint32_t word_of(const uint8_t* __restrict__ plane,
                                            int64_t nb, int kp_log,
                                            int32_t par) {
  return word_of_t<false>(plane, nb, kp_log, par);
}
