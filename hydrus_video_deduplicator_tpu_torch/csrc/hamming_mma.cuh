// Hamming distances of 256-bit frames on the tensor cores: the core shared
// by similarity_segments.cu, similarity_block.cu and exists_mask_sweep.cu.
//
// A warp's binary product mma.sync.m16n8k256.b1.and.popc gives, for 16
// row frames a and 8 column frames b, popc(a & b) + c: one instruction per
// 128 whole-hash pairs. Two of them give the distance exactly, with one
// threshold for the whole launch:
//
//   popc(a & ~b) + popc(~a & b) = popc(a ^ b) = hamming(a, b),
//
// so with c = -(tol + 1) in the first, "hamming <= tol" is "d < 0", the
// sign bit. Padding (decided by the caller from slot ids or counts, never
// from the bits: an all-zero packed frame is a valid hash) is a frame
// whose bits and complement are both all ones: against a real frame its
// "distance" is popc(b) + popc(~b) = 256 > tol (tol < 128), and it never
// matches. So a tile's epilogue is an OR of its accumulators (one 3-input
// LOP3 per two pairs) and a warp vote on the sign bit.
//
// Layouts (the PTX fragments of m16n8k256 .b1): thread (g = lane / 4,
// q = lane % 4) holds, of row frames g and g + 8, the packed words q and
// 4 + q (a0 = row g word q, a1 = row g+8 word q, a2 = row g word 4+q, a3 =
// row g+8 word 4+q) and of column frame g the same two words (b0, b1); the
// accumulators d0, d1 are row g, columns 2q and 2q + 1, and d2, d3 row
// g + 8. The bit order inside a word needs no care: a and b pair bit j of
// word w with bit j of word w. Columns are staged in shared memory as
// words [8][stride] (word-major), stride = frames + 8, so the 32 lanes'
// loads of a fragment fall in 32 different banks.

#pragma once

#include <cstdint>

namespace hmma {

constexpr int kWords = 8;             // 32-bit words of a frame
constexpr unsigned kPad = 0xFFFFFFFFu;  // a padding frame's words and complement

// d = popc(a & b) + c over 16 x 8 frame pairs, 256 bits deep
__device__ __forceinline__ void and_popc(int (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2], int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(c0), "r"(c1),
        "r"(c2), "r"(c3));
}

// 16 row frames of a warp, as this thread's fragment words and their
// complements.
struct Rows {
  unsigned a[4];
  unsigned na[4];
};

// Loads a fragment's rows: lo and hi are the global words of rows g and
// g + 8 (nullptr for padding), q the thread's lane % 4.
__device__ __forceinline__ void load_rows(Rows& r, const unsigned* lo, const unsigned* hi, int q) {
  const unsigned w[4] = {lo ? lo[q] : kPad, hi ? hi[q] : kPad, lo ? lo[4 + q] : kPad,
                         hi ? hi[4 + q] : kPad};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r.a[k] = w[k];
    r.na[k] = (k & 1 ? hi : lo) ? ~w[k] : kPad;
  }
}

// A column fragment (8 frames) from the staged words: b and its complement.
struct Cols {
  unsigned b[2];
  unsigned nb[2];
};

// Stages frame f of a column tile into s_b / s_nb ([8][stride] each):
// its words and their complements, or kPad in both for padding.
__device__ __forceinline__ void stage_col(unsigned* s_b, unsigned* s_nb, int stride, int f,
                                          int word, const unsigned* src) {
  const unsigned w = src ? src[word] : kPad;
  s_b[word * stride + f] = w;
  s_nb[word * stride + f] = src ? ~w : kPad;
}

__device__ __forceinline__ void load_cols(Cols& c, const unsigned* s_b, const unsigned* s_nb,
                                          int stride, int f, int q) {
  c.b[0] = s_b[q * stride + f];
  c.b[1] = s_b[(4 + q) * stride + f];
  c.nb[0] = s_nb[q * stride + f];
  c.nb[1] = s_nb[(4 + q) * stride + f];
}

// d = hamming - (tol + 1) of the 16 x 8 pairs (bias = -(tol + 1)): d < 0
// <=> a match; padding on either side never is.
__device__ __forceinline__ void distance(int (&d)[4], const Rows& r, const Cols& c, int bias) {
  and_popc(d, r.a, c.nb, bias, bias, bias, bias);
  and_popc(d, r.na, c.b, d[0], d[1], d[2], d[3]);
}

// Every live row fragment of this warp (bit r of `live`, uniform in the
// warp) against the staged column fragments c < groups whose bit is set in
// glive, four column fragments a vote. A vote without a match costs the
// products, an OR per accumulator pair and one __any_sync; a vote with one
// computes the four fragments again and calls record(r, row, col) for
// each matching pair: row frame `row` (0-15) of fragment r, column frame
// `col` of the staged tile.
template <int F, class Record>
__device__ __forceinline__ void sweep(const Rows (&rows)[F], unsigned live,
                                      const unsigned* s_b, const unsigned* s_nb, int stride,
                                      unsigned long long glive, int groups, int bias, int lane,
                                      Record record) {
  constexpr int kVote = 4;
  const int g = lane / 4;
  const int q = lane % 4;
  for (int c0 = 0; live && c0 < groups; c0 += kVote) {
    if (((glive >> c0) & ((1ull << kVote) - 1)) == 0ull) continue;  // all padding
    int any = 0;
#pragma unroll
    for (int c = c0; c < c0 + kVote; ++c) {
      Cols cols;
      load_cols(cols, s_b, s_nb, stride, 8 * c + g, q);
#pragma unroll
      for (int r = 0; r < F; ++r) {
        if (!((live >> r) & 1u)) continue;
        int d[4];
        distance(d, rows[r], cols, bias);
        any |= d[0] | d[1] | d[2] | d[3];
      }
    }
    if (!__any_sync(0xffffffffu, any < 0)) continue;
    for (int c = c0; c < c0 + kVote; ++c) {  // the slow path
      Cols cols;
      load_cols(cols, s_b, s_nb, stride, 8 * c + g, q);
#pragma unroll
      for (int r = 0; r < F; ++r) {
        if (!((live >> r) & 1u)) continue;
        int d[4];
        distance(d, rows[r], cols, bias);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (d[k] < 0) record(r, g + 8 * (k >> 1), 8 * c + 2 * q + (k & 1));
        }
      }
    }
  }
}

}  // namespace hmma
