// The word scheme of the strided variants of K1 (csrc/rmsnorm.cu) and K1b
// (csrc/rmsnorm_bwd.cu): a row of any C, at any element alignment, read
// from device memory once, as 16-byte words, into one warp's registers.
//
// A (rows, c) tensor of T whose element 0 lies `ph` elements past a
// 16-byte boundary is seen as a run of 16-byte words from that boundary:
// word k holds elements k E .. k E + E - 1 (E = 16 / sizeof(T)), so row r
// (elements ph + r c .. ph + r c + c - 1) touches words k0 .. k0 + nw - 1,
// its first element at position `off` of word k0.  Lane l of the row's
// G lanes (a warp, or half a warp for short rows in K1) holds the row's
// words l, l + G, ...: at most words_per_lane(c, G) each, every load 16
// bytes, all in flight before the first use.  With an
// odd C rows share the words at their ends; in those two words a lane
// sets the elements that are not its row's (their channel k E + j - off
// is outside 0 .. c - 1) to 0 (row_part).  A word that reaches outside the
// tensor (before element 0, past the last) is read element by element.
// Stores never touch another row's elements (another warp writes that
// row at the same time): a word that lies wholly inside the row is
// written as one 16-byte store, a word the row shares with a neighbour as
// the widest aligned pieces of its row's elements, and every word where
// the output's phase is not the input's element by element.
//
// A warp's lanes read the row's channels E apart, so a table indexed by
// channel (the weight, K1b's dw sums) lies in shared memory padded by one
// float after every E: lane l then reads float (E + 1) l + const, and E + 1
// (9 or 5) is odd, so the 32 lanes hit 32 banks.
#pragma once

#include "common.cuh"

namespace rmsnorm_words {

constexpr int kWordBytes = 16;
constexpr int kRegMaxBytes = 4096;   // a row held in registers, at most
constexpr int kMaxWordsPerLane = 9;  // words_per_lane(c) at kRegMaxBytes

// The words a lane holds for rows of c elements of T at any phase: the
// most words a row can touch, (16 - sizeof(T) + c sizeof(T)) / 16 rounded
// up, over the row's `lanes` lanes (a warp, or half a warp).
template <typename T>
__host__ __device__ constexpr int words_per_lane(int c, int lanes = 32) {
  return ((kWordBytes - (int)sizeof(T) + c * (int)sizeof(T) + kWordBytes -
           1) / kWordBytes + lanes - 1) / lanes;
}
static_assert(words_per_lane<__nv_bfloat16>(kRegMaxBytes / 2) ==
                  kMaxWordsPerLane &&
              words_per_lane<float>(kRegMaxBytes / 4) == kMaxWordsPerLane,
              "a row of kRegMaxBytes takes kMaxWordsPerLane words a lane");

// Channel i's place in a padded shared-memory table (one pad float after
// every E channels); a table of c channels takes padded(c) + 1 floats.
template <typename T>
__host__ __device__ constexpr int padded(int i) {
  return i + i / (kWordBytes / (int)sizeof(T));
}

// The element phase of pointer p: elements between the 16-byte boundary at
// or below p and p.
template <typename T> inline int phase(const void* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) % kWordBytes) / (int)sizeof(T);
}

// The words of one row.
template <typename T> struct Row {
  static constexpr int E = kWordBytes / sizeof(T);
  long long k0;   // the row's first word
  int off;        // its first element's position in word k0
  int nw;         // the words it touches
  __device__ __forceinline__ Row(long long row, int c, int ph) {
    const long long e0 = ph + row * (long long)c;
    k0 = e0 / E;
    off = (int)(e0 - k0 * E);
    nw = (off + c + E - 1) / E;
  }
  // the row's channel of element j of its word k
  __device__ __forceinline__ int ch(int k, int j) const {
    return k * E + j - off;
  }
};

// The bf16 in the low or high half of a 32-bit word, as a float.  The asm
// is volatile so that each use converts anew: otherwise the compiler keeps
// a float copy of every element of the row alive from the reductions to
// the output, where the packed words take half as many registers.
__device__ __forceinline__ float bf16_low(uint32_t u) {
  uint32_t r;
  asm volatile("shl.b32 %0, %1, 16;" : "=r"(r) : "r"(u));
  return __uint_as_float(r);
}

__device__ __forceinline__ float bf16_high(uint32_t u) {
  uint32_t r;
  asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(r) : "r"(u));
  return __uint_as_float(r);
}

// element j of a 16-byte word of T, as float (element 2i of bf16 is the
// low half of 32-bit word i)
template <typename T>
__device__ __forceinline__ float word_elem(const uint4& v, int j) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t u = word(v, j >> 1);
    return (j & 1) ? bf16_high(u) : bf16_low(u);
  } else {
    return __uint_as_float(word(v, j));
  }
}

// v with the elements whose channel ch0 + j lies outside 0 .. c - 1 (a
// neighbour row's, in a word the row shares) set to 0
template <typename T>
__device__ __forceinline__ uint4 row_part(const uint4& v, int ch0, int c) {
  constexpr int E = kWordBytes / sizeof(T);
  uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int ch = ch0 + j;
    if (ch < 0 || ch >= c) {
      if constexpr (sizeof(T) == 2) {
        u[j >> 1] &= (j & 1) ? 0x0000ffffu : 0xffff0000u;
      } else {
        u[j] = 0u;
      }
    }
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// Word kw counted from `base` (the 16-byte boundary ph elements below the
// tensor's element 0; `end`: ph + the tensor's elements), whose element j
// is the row's channel ch0 + j: one 16-byte load where the word lies in
// the tensor, else the row's elements one by one (the others 0).
template <typename T>
__device__ __forceinline__ uint4 load_word(const T* base, long long kw,
                                           int ch0, int c, int ph,
                                           long long end) {
  constexpr int E = kWordBytes / sizeof(T);
  if (kw * E >= ph && kw * E + E <= end)
    return reinterpret_cast<const uint4*>(base)[kw];
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int ch = ch0 + j;
    if (ch >= 0 && ch < c) {
      if constexpr (sizeof(T) == 2) {
        const uint32_t b =
            reinterpret_cast<const unsigned short*>(base)[kw * E + j];
        u[j >> 1] |= b << (16 * (j & 1));
      } else {
        u[j] = reinterpret_cast<const uint32_t*>(base)[kw * E + j];
      }
    }
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// Store the row's elements of word kw (counted from `base`, the output's
// pointer less ph elements; element j is the row's channel ch0 + j).  Where
// the output shares the input's phase (`whole`), base is 16-byte aligned:
// a word inside the row is one 16-byte store, a word the row shares with a
// neighbour its row's elements as the widest aligned 8-, 4- and 2-byte
// stores (one 8-byte store for the 8-byte aligned rows of C % 4 == 0 in
// bf16).  Else the row's elements one by one.
template <typename T>
__device__ __forceinline__ void store_word(T* base, long long kw, int ch0,
                                           int c, bool whole,
                                           const uint4& v) {
  constexpr int E = kWordBytes / sizeof(T);
  const int lo = max(0, -ch0), hi = min(E, c - ch0);
  if (whole && lo == 0 && hi == E) {
    reinterpret_cast<uint4*>(base)[kw] = v;
  } else if (whole) {
    char* b = reinterpret_cast<char*>(base + kw * E);
    const int end = hi * (int)sizeof(T);
    for (int p = lo * (int)sizeof(T); p < end;) {
      const uint32_t u = word(v, p >> 2);
      if ((p & 7) == 0 && p + 8 <= end) {
        *reinterpret_cast<uint2*>(b + p) =
            make_uint2(u, word(v, (p >> 2) + 1));
        p += 8;
      } else if ((p & 3) == 0 && p + 4 <= end) {
        *reinterpret_cast<uint32_t*>(b + p) = u;
        p += 4;
      } else {   // a bf16 alone in its 4 bytes
        *reinterpret_cast<unsigned short*>(b + p) =
            (unsigned short)(u >> (8 * (p & 3)));
        p += 2;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j >= lo && j < hi) {
        if constexpr (sizeof(T) == 2) {
          reinterpret_cast<unsigned short*>(base)[kw * E + j] =
              (unsigned short)(word(v, j >> 1) >> (16 * (j & 1)));
        } else {
          reinterpret_cast<uint32_t*>(base)[kw * E + j] = word(v, j);
        }
      }
    }
  }
}

}  // namespace rmsnorm_words
