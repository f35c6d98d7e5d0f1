// Chain program of the conv-segment matcher for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's chain is the body of
// coraza_kubernetes_operator_tpu/ops/segment.py::match_segment_block
// (run_bucket, the suffix tier and the per-finals-key AND-any), one jax.jit
// that XLA fuses into a few fusions. Run eagerly in PyTorch the same
// unrolled chain is ~40k small kernels per segment block (~127k per blob
// window); here it is one launch per block, finals columns included.
//
// Contract (ops/segment_chain.py::chain_match_plain is the plain version,
// bit for bit). Positions p < Q = L + 2 index the padded row dpad (a NUL at
// p = 0, the row's L bytes, NULs after; bytes past a row's length are read
// as they are). M_n[p] = out[t, n - off, p] >= 2W is the conv column n's
// match bit at window start p. A bitmap holds one bit per position.
//   bucket unit (one branch signature, left to right), per member j:
//     e = {1} if anchored at the start else [1, Q); per op:
//       seg (n_lead, n_real, column a0 + j): e &= (M << n_lead) & [1, len+1-n_real];
//                                           e <<= n_real
//       gapany [lo, hi]:  e[p] = OR_{d in [lo, hi]} e[p - d]
//       gapcls C [lo, hi]: e[p] = OR_{d in [lo, hi]} e[p - d] and dpad[p-d .. p) in C
//     hit = any(e & {len+1}) if anchored at the end else any(e & [0, len+1]);
//     the single-seg signature tests its window starts directly.
//   suffix unit (one suffix signature, right to left), per member j:
//     s = {len+1} or [0, len+1]; per op, last first:
//       seg:    s = (M << n_lead) & [1, len+1-n_real] & (s >> n_real)
//       gapany: s[p] = OR_{d in [lo, hi]} s[p + d]
//       gapcls: s[p] = OR_{d in [lo, hi]} s[p + d] and dpad[p .. p+d) in C
//   finals column f, suffix column sc, n_lead, n_real, a_start:
//     gj[p] = S_sc[p + n_lead + n_real] and 1 <= p + n_lead and
//             p + n_lead + n_real <= len + 1 (and p + n_lead == 1 if a_start);
//     hit = any(M_f & gj).
// hi = -1 is an unbounded gap; shifts fill with 0 and drop what leaves [0, Q).
// The reference spells a class gap with non-class-count (NCE) tables and
// log-shift min passes; the walk below (a run counter of class bytes and the
// nearest set position) gives the same bits (tests/test_torch_segment_chain.py
// holds both to the JAX package).
//
// What bounds it: the bytes of the conv output at positions p <= len + 1,
// which are all a chain reads, once, at the card's memory rate.
//
// Design. A block owns a tile of rows (ops/segment_chain.py::chain_plan
// sizes it). Per tile, in order, with a block barrier between:
// 1. pack: the tile's conv output is one flat run; threads read it in
//    coalesced 16-byte chunks (4 in flight each, 8 past Q = 192), skipping
//    a chunk wholly past its row's position len + 1, so each conv element
//    a chain reads crosses HBM once. A chunk's 8 elements are held against
//    2W with packed 16-bit compares; a chunk with a match ORs its bits
//    into the zeroed match words, one shared-memory atomicOr per word it
//    touches. The row's class bitmaps (bit p: dpad[p] in C) are packed
//    with __ballot_sync (lane b tests positions 64 w + b and 64 w + 32 +
//    b). Words are laid out [row][word][column], so a warp of items
//    (consecutive members, consecutive columns) reads consecutive words;
// 2. walk: one thread per (row, member) item, items unit by unit (rows,
//    then members), so a warp mostly runs one unit's op list. A unit's
//    bitmap is ceil(Q / 64) words, in registers for Q <= 192 (one kernel
//    per word count), else in the tile's state area [word][thread]. A seg
//    op reads a match word only where the state word is non-zero; gapany is
//    word shifts (log passes; a bit scan when unbounded); gapcls with lo = 0
//    and no bound is a carry flood over the class bitmap, word by word;
//    other gapcls walk the positions with a run counter read from the class
//    bitmap, and skip a whole word where it holds no bit and no earlier bit
//    can still reach.
//    A suffix item leaves its words in the tile's suffix area;
// 3. finals: with the finals tier off, one thread per (row, finals column)
//    ANDs its reach words (the suffix words shifted) with the column's
//    match words; with the tier on, the suffix bits leave as [T, Q, NS]
//    bytes, consecutive threads writing consecutive bytes.
// The tile (match, suffix and class words, and the state area) lives in
// dynamic shared memory; where one row does not fit, the same code runs
// on a per-block slice of a global scratch, one row per tile, the blocks
// walking the rows grid-stride. The wrapper (ops/segment_chain.py::
// chain_plan) owns the tile's layout and passes its areas' offsets.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cstring>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegWords = 3;           // bitmaps of up to 3 words live in registers
constexpr int kNone = INT_MIN / 4;     // "no set position yet"
constexpr int kUnbounded = INT_MAX / 4;

// Unit record (int32 x 8) and op record (int32 x 4), as ops/segment_chain.py lays them out.
enum { U_KIND, U_ASTART, U_AEND, U_NB, U_OP0, U_NOPS, U_OUT, U_SFX, kUnitInts = 8 };
enum { K_BUCKET = 0, K_SINGLE = 1, K_SUFFIX = 2 };
enum { OP_SEG = 0, OP_GAPANY = 1, OP_GAPCLS = 2 };

struct Args {
  const uint16_t* conv;   // [T, ncol, Q] bf16 bits
  const uint8_t* data;    // [T, L]
  const int32_t* lens;    // [T]
  const int32_t* units;   // [U, 8]
  const int32_t* ucum;    // [U + 1] members before each unit
  const int32_t* ops;     // [n_ops, 4]
  const uint64_t* cls;    // [ncls, 4] 256-bit class masks
  const int32_t* fin;     // [NF, 4] per finals column: suffix column, n_lead, n_real, a_start
  uint64_t* scratch;      // per block a tile of one row (global mode), else null
  uint8_t* sfx;           // [T, Q, NS] suffix bits as bytes, or null
  uint8_t* bh;            // [T, ldo] hit columns
  int T, L, Q, nw, ncol, off, U, M, NS, NF, ncls, nbc, ldo, finals, rows, tiles;
  int tile_u64;           // u64 words of a tile (a block's slice of scratch)
  int at_sfx, at_cls, at_state;  // the tile's suffix, class and state areas (u64 words in)
  int at_ints;            // the staged ucum and lengths (bytes into shared memory)
  uint32_t thr_bits;      // 2W as bf16 bits
};

// Per item: its row's tile.
struct Row {
  const uint64_t* words;  // the row's match words [nw][ncol]
  const uint64_t* clsw;   // its class words [nw][ncls]
  int ncol, ncls, Q, nw, off, len1;
};

__device__ __forceinline__ uint64_t range_word(int w, int lo, int hi) {
  // Bits b of word w with lo <= 64 w + b <= hi.
  int b0 = lo - 64 * w, b1 = hi - 64 * w;
  b0 = b0 < 0 ? 0 : b0;
  b1 = b1 > 63 ? 63 : b1;
  if (b0 > b1) return 0ull;
  return (~0ull >> (63 - b1)) & (~0ull << b0);
}

__device__ __forceinline__ uint64_t conv_word(const Row& r, int col, int k) {
  // M_col at positions [64 k, 64 k + 64); col is a global column. Bits past
  // len + 1 are not packed: every reader masks them.
  return k < 0 ? 0ull : r.words[(int64_t)k * r.ncol + col - r.off];
}

template <int NW>
struct RegBits {
  static constexpr int kWords = NW;
  uint64_t v[NW];
  __device__ __forceinline__ uint64_t get(int i) const {
    uint64_t x = 0ull;
#pragma unroll
    for (int k = 0; k < NW; ++k) x = k == i ? v[k] : x;
    return x;
  }
  __device__ __forceinline__ void set(int i, uint64_t x) {
#pragma unroll
    for (int k = 0; k < NW; ++k) v[k] = k == i ? x : v[k];
  }
};

// A bitmap in the tile's state area: word i of this thread at base[i * stride].
struct TileBits {
  static constexpr int kWords = 0;  // runtime word count
  uint64_t* base;
  int stride;
  int nw;
  __device__ __forceinline__ uint64_t get(int i) const {
    return (i >= 0 && i < nw) ? base[(int64_t)i * stride] : 0ull;
  }
  __device__ __forceinline__ void set(int i, uint64_t x) { base[(int64_t)i * stride] = x; }
};

template <class B>
__device__ __forceinline__ int words(const Row& r) {
  return B::kWords ? B::kWords : r.nw;
}

template <class B>
__device__ void fill(B& e, int lo, int hi, const Row& r) {
  hi = hi < r.Q - 1 ? hi : r.Q - 1;
  const int n = words<B>(r);
#pragma unroll
  for (int w = 0; w < n; ++w) e.set(w, range_word(w, lo, hi));
}

template <class B>
__device__ bool any_in(const B& e, int lo, int hi, const Row& r) {
  const int n = words<B>(r);
  uint64_t acc = 0ull;
#pragma unroll
  for (int w = 0; w < n; ++w) acc |= e.get(w) & range_word(w, lo, hi);
  return acc != 0ull;
}

// e[p] = e[p - k] (or e[p] | e[p - k] with keep); bits past Q are dropped.
template <class B>
__device__ void shift_up(B& e, int k, bool keep, const Row& r) {
  if (k <= 0) return;
  const int n = words<B>(r), ws = k >> 6, bs = k & 63;
#pragma unroll
  for (int w = n - 1; w >= 0; --w) {
    const uint64_t hi = e.get(w - ws), lo = e.get(w - ws - 1);
    const uint64_t s = bs ? (hi << bs) | (lo >> (64 - bs)) : hi;
    e.set(w, keep ? e.get(w) | s : s);
  }
  e.set(n - 1, e.get(n - 1) & range_word(n - 1, 0, r.Q - 1));
}

// e[p] = e[p + k] (or e[p] | e[p + k] with keep); zero past Q.
template <class B>
__device__ void shift_down(B& e, int k, bool keep, const Row& r) {
  if (k <= 0) return;
  const int n = words<B>(r), ws = k >> 6, bs = k & 63;
#pragma unroll
  for (int w = 0; w < n; ++w) {
    const uint64_t lo = e.get(w + ws), hi = e.get(w + ws + 1);
    const uint64_t s = bs ? (lo >> bs) | (hi << (64 - bs)) : lo;
    e.set(w, keep ? e.get(w) | s : s);
  }
}

// gapany: up (left to right) e[p] = OR_{d in [lo, hi]} e[p - d]; down e[p + d].
template <class B>
__device__ void spread(B& e, int lo, int hi, bool up, const Row& r) {
  const int n = words<B>(r);
  if (hi < 0) {  // unbounded: the first (up) or last (down) set position decides
    int at = kNone;
#pragma unroll
    for (int w = 0; w < n; ++w) {
      const uint64_t x = e.get(w);
      if (x && up && at == kNone) at = 64 * w + __ffsll((long long)x) - 1;
      if (x && !up) at = 64 * w + 63 - __clzll((long long)x);
    }
    if (at == kNone) return;  // all clear stays clear
    if (up) fill(e, at + lo, r.Q - 1, r);
    else fill(e, 0, at - lo, r);
    return;
  }
  const int width = hi - lo + 1;
  int span = 1;  // e[p] holds the OR over a window of span positions
  while (span * 2 <= width) {
    if (up) shift_up(e, span, true, r);
    else shift_down(e, span, true, r);
    span *= 2;
  }
  if (span < width) {
    if (up) shift_up(e, width - span, true, r);
    else shift_down(e, width - span, true, r);
  }
  if (up) shift_up(e, lo, false, r);
  else shift_down(e, lo, false, r);
}

// The run counter after a word whose `bend` positions were all read: cp's
// bits [0, bend) are the class bits of the word's positions, in the walk's
// order low to high (up) or high to low (down), and `run` counts on if
// every one is set.
__device__ __forceinline__ int run_after_up(uint64_t cp, int bend, int run) {
  const int ones = __clzll((long long)~(cp << (64 - bend)));  // set bits down from bend - 1
  return ones >= bend ? run + bend : ones;
}
__device__ __forceinline__ int run_after_down(uint64_t c, int bend, int run) {
  const int ones = ~c ? __ffsll((long long)~c) - 1 : 64;  // set bits up from 0
  return ones >= bend ? run + bend : ones;
}

// gapcls: as spread, where the d bytes between must all lie in the class.
// After a shift by lo, one walk over the positions keeps the nearest set
// position and the run of class bytes next to p: the gap d fits iff
// d <= hi and d <= run. d - run never falls as the walk goes on, so once a
// position fails it, no later one can take that set position (`dead`):
// a word with no set bit after that is all clear, and only its run moves.
// cw: the class bitmap, word w at cw[w * r.ncls].
template <class B>
__device__ void walk(B& e, int lo, int hi, const uint64_t* cw, bool up, const Row& r) {
  const int hmax = hi < 0 ? kUnbounded : hi;
  const int n = words<B>(r);
  bool dead = true;
  if (up) {
    shift_up(e, lo, false, r);
    int prev = kNone, run = 0;  // run: class bytes ending at p - 1
    uint64_t carry = 0ull;      // class bit of the previous word's last position
#pragma unroll
    for (int w = 0; w < n; ++w) {
      const uint64_t x = e.get(w), c = cw[(int64_t)w * r.ncls];
      const uint64_t cp = (c << 1) | carry;  // bit b: dpad[64 w + b - 1] in C
      carry = c >> 63;
      const int bend = r.Q - 64 * w < 64 ? r.Q - 64 * w : 64;
      uint64_t o = 0ull;
      if (x == 0ull && dead) {
        run = run_after_up(cp, bend, run);
      } else {
        for (int b = 0; b < bend; ++b) {
          const int p = 64 * w + b;
          run = (cp >> b) & 1ull ? run + 1 : 0;
          if ((x >> b) & 1ull) prev = p;
          const int d = lo + p - prev;
          if (prev != kNone && d <= hmax && d <= run) o |= 1ull << b;
        }
        const int d = lo + 64 * w + bend - 1 - prev;
        dead = prev == kNone || d > hmax || d > run;
      }
      e.set(w, o);
    }
  } else {
    shift_down(e, lo, false, r);
    int next = kNone, run = 0;  // run: class bytes starting at p
#pragma unroll
    for (int w = n - 1; w >= 0; --w) {
      const uint64_t x = e.get(w), c = cw[(int64_t)w * r.ncls];  // bit b: dpad[64 w + b] in C
      const int bend = r.Q - 64 * w < 64 ? r.Q - 64 * w : 64;
      uint64_t o = 0ull;
      if (x == 0ull && dead) {
        run = run_after_down(c, bend, run);
      } else {
        for (int b = bend - 1; b >= 0; --b) {
          const int p = 64 * w + b;
          run = (c >> b) & 1ull ? run + 1 : 0;
          if ((x >> b) & 1ull) next = p;
          const int d = lo + next - p;
          if (next != kNone && d <= hmax && d <= run) o |= 1ull << b;
        }
        const int d = lo + next - 64 * w;
        dead = next == kNone || d > hmax || d > run;
      }
      e.set(w, o);
    }
  }
}

// gapcls with lo = 0 and no upper bound, word-parallel: a set bit spreads
// over the run of class bytes next to it. Up, a bit at q reaches q + 1
// when dpad[q] is in C: with gates m (the class word), ((x & m) + m) ^ m
// sets every position a bit's carry runs through, up to the first
// position whose byte is not in C (Hacker's Delight's flood fill; "| x"
// keeps the seeds that the sum cleared), and the carry out of a word enters
// the next one's bit 0. Down, a bit at q + 1 reaches q when dpad[q] is in
// C: the same sum on bit-reversed words, whose gate i is the class bit the
// reversed move from i to i + 1 crosses.
template <class B>
__device__ void flood(B& e, const uint64_t* cw, bool up, const Row& r) {
  const int n = words<B>(r);
  uint64_t k = 0ull;  // the carry: the next word's first position (up) / last (down) is reached
  if (up) {
#pragma unroll
    for (int w = 0; w < n; ++w) {
      const uint64_t x = e.get(w), m = cw[(int64_t)w * r.ncls];
      const uint64_t s1 = (x & m) + m, s2 = s1 + k;
      e.set(w, (s2 ^ m) | x | k);
      k = (uint64_t)((s1 < m) | (s2 < s1));
    }
    e.set(n - 1, e.get(n - 1) & range_word(n - 1, 0, r.Q - 1));
  } else {
#pragma unroll
    for (int w = n - 1; w >= 0; --w) {
      const uint64_t x = __brevll(e.get(w));
      const uint64_t below = w > 0 ? cw[(int64_t)(w - 1) * r.ncls] >> 63 : 0ull;
      const uint64_t m = (__brevll(cw[(int64_t)w * r.ncls]) >> 1) | (below << 63);
      const uint64_t s1 = (x & m) + m, s2 = s1 + k;
      e.set(w, __brevll((s2 ^ m) | x | k));
      k = (uint64_t)((s1 < m) | (s2 < s1));
    }
  }
}

// seg, left to right: e &= (M << nl) & [1, len1 - nr]; e <<= nr.
// Right to left: e = (M << nl) & [1, len1 - nr] & (e >> nr).
template <class B>
__device__ void seg(B& e, int nl, int nr, int col, bool up, const Row& r) {
  if (!up) shift_down(e, nr, false, r);
  const int n = words<B>(r), ws = nl >> 6, bs = nl & 63;
#pragma unroll
  for (int w = 0; w < n; ++w) {
    uint64_t x = e.get(w) & range_word(w, 1, r.len1 - nr);
    if (x) {
      const uint64_t hi = conv_word(r, col, w - ws);
      const uint64_t lo = bs ? conv_word(r, col, w - ws - 1) : 0ull;
      x &= bs ? (hi << bs) | (lo >> (64 - bs)) : hi;
    }
    e.set(w, x);
  }
  if (up) shift_up(e, nr, false, r);
}

// The tile's areas (match, suffix and class words; state) and its rows.
struct Tile {
  uint64_t* words;   // [rows][nw][ncol]
  uint64_t* sfxw;    // [rows][nw][NS]
  uint64_t* clsw;    // [rows][nw][ncls]
  uint64_t* state;   // [nw][kThreads], bitmaps past kRegWords words
  const int32_t* ucum;
  const int32_t* len;
  int t0, rows;      // first row, rows in this tile
};

__device__ __forceinline__ Row row_of(const Args& a, const Tile& tl, int r) {
  Row row;
  row.words = tl.words + (int64_t)r * a.nw * a.ncol;
  row.clsw = tl.clsw + (int64_t)r * a.nw * a.ncls;
  row.ncol = a.ncol;
  row.ncls = a.ncls;
  row.Q = a.Q;
  row.nw = a.nw;
  row.off = a.off;
  row.len1 = tl.len[r] + 1;
  return row;
}

// One item of the tile: row r, member j of unit u.
template <class B>
__device__ void run_item(B& e, const Args& a, const Tile& tl, int g) {
  // The unit: rows * ucum[u] <= g < rows * ucum[u + 1].
  int lo = 0, hi = a.U;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tl.rows * tl.ucum[mid] <= g) lo = mid;
    else hi = mid;
  }
  const int32_t* u = a.units + kUnitInts * lo;
  const int nb = __ldg(u + U_NB), kind = __ldg(u + U_KIND);
  const int local = g - tl.rows * tl.ucum[lo];
  const int rr = local / nb, j = local - rr * nb;
  const Row r = row_of(a, tl, rr);
  uint8_t* hit_out = a.bh + (int64_t)(tl.t0 + rr) * a.ldo + __ldg(u + U_OUT) + j;
  const int a_start = __ldg(u + U_ASTART), a_end = __ldg(u + U_AEND);
  const int op0 = __ldg(u + U_OP0), nops = __ldg(u + U_NOPS);

  if (kind == K_SINGLE) {  // window starts j0 with r = j0 + nl as the real start
    const int32_t* op = a.ops + 4 * op0;
    const int nl = __ldg(op + 1), nr = __ldg(op + 2), col = __ldg(op + 3) + j;
    int jlo = 1 - nl, jhi = r.len1 - nr - nl;
    if (a_start) jhi = jhi < 1 - nl ? jhi : 1 - nl;
    if (a_end) jlo = jlo > r.len1 - nr - nl ? jlo : r.len1 - nr - nl;
    jhi = jhi < r.Q - 1 ? jhi : r.Q - 1;
    bool hit = false;
    for (int w = 0; w < r.nw && !hit; ++w) {
      const uint64_t m = range_word(w, jlo, jhi);
      if (m) hit = (conv_word(r, col, w) & m) != 0ull;
    }
    *hit_out = hit;
    return;
  }

  const bool up = kind == K_BUCKET;
  if (up) fill(e, 1, a_start ? 1 : r.Q - 1, r);
  else fill(e, a_end ? r.len1 : 0, r.len1, r);
  for (int k = 0; k < nops; ++k) {
    const int32_t* op = a.ops + 4 * (op0 + (up ? k : nops - 1 - k));
    const int type = __ldg(op), p1 = __ldg(op + 1), p2 = __ldg(op + 2), p3 = __ldg(op + 3);
    if (type == OP_SEG) seg(e, p1, p2, p3 + j, up, r);
    else if (type == OP_GAPANY) spread(e, p1, p2, up, r);
    else if (p1 == 0 && p2 < 0) flood(e, r.clsw + p3, up, r);
    else walk(e, p1, p2, r.clsw + p3, up, r);
  }
  if (up) {
    *hit_out = any_in(e, a_end ? r.len1 : 0, r.len1, r);
    return;
  }
  uint64_t* dst = tl.sfxw + (int64_t)rr * a.nw * a.NS + __ldg(u + U_SFX) + j;
  const int n = words<B>(r);
#pragma unroll
  for (int w = 0; w < n; ++w) dst[(int64_t)w * a.NS] = e.get(w);
}

// x / d for 0 <= x < 2^53: a double estimate, corrected once.
__device__ __forceinline__ int64_t div_by(int64_t x, int64_t d, double inv) {
  int64_t q = (int64_t)((double)x * inv);
  const int64_t rem = x - q * d;
  q -= rem < 0;
  q += rem >= d;
  return q;
}

// Row, column and position of tile element rel (the tile's rows are one
// flat run of [ncol, Q] blocks), through the reciprocals of Q and ncol.
struct Pos {
  int r, col, p;
};
__device__ __forceinline__ Pos pos_of(int64_t rel, const Args& a, double inv_q, double inv_ncol) {
  const int64_t seg = div_by(rel, (int64_t)a.Q, inv_q);
  Pos o;
  o.r = (int)div_by(seg, (int64_t)a.ncol, inv_ncol);
  o.col = (int)(seg - (int64_t)o.r * a.ncol);
  o.p = (int)(rel - seg * a.Q);
  return o;
}

// The match bits of a chunk of 8 conv elements: m8 bit i is element i,
// the first at row r, column col, position p of the tile. OR them into
// their words: one piece per column the chunk touches (two at most when Q
// >= 8), one or two words per piece.
__device__ void set_bits(const Args& a, const Tile& tl, uint32_t m8, int r, int col, int p) {
  while (m8) {
    const int k = a.Q - p < 8 ? a.Q - p : 8;  // the chunk's elements left in this column
    const uint64_t piece = m8 & ((1u << k) - 1u);
    if (piece) {
      unsigned long long* w = (unsigned long long*)&tl.words[((int64_t)r * a.nw + (p >> 6)) * a.ncol + col];
      const int b = p & 63;
      atomicOr(w, piece << b);
      if (b + k > 64 && (piece >> (64 - b))) atomicOr(w + a.ncol, piece >> (64 - b));
    }
    m8 >>= k;
    p = 0;
    if (++col == a.ncol) col = 0, ++r;
  }
}

// Phase 1: the tile's match words (zeroed before) and class words.
// Match words: the tile's rows are one flat run of the conv output; each
// thread reads 16-byte chunks of 8 elements, kUnroll chunks in flight,
// consecutive threads on consecutive chunks. A chunk wholly past its
// row's position len + 1 is not read. The 8 elements are held against 2W
// two at a time (bf16 bits as int16: the conv output is a non-negative
// integer), and only a chunk with a match goes on to set bits.
// The last chunk may read up to 14 bytes past the conv output, inside the
// same 16-byte-aligned granule of its allocation; those elements are
// masked. Class words: a warp takes (row, word) pairs, reads the 64 bytes
// once and ballots each class.
template <int kUnroll>
__device__ void pack(const Args& a, const Tile& tl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t e0 = (int64_t)tl.t0 * a.ncol * a.Q;
  const int64_t n_el = (int64_t)tl.rows * a.ncol * a.Q;
  const int64_t c_end = (e0 + n_el + 7) >> 3;
  const uint4* src = reinterpret_cast<const uint4*>(a.conv);
  const uint32_t thr2 = a.thr_bits * 0x10001u;
  const double inv_q = 1.0 / a.Q, inv_ncol = 1.0 / a.ncol;
  for (int64_t c = (e0 >> 3) + threadIdx.x; c < c_end; c += (int64_t)kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t cu = c + (int64_t)u * kThreads;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (cu >= c_end) continue;
      const int64_t rel = 8 * cu - e0;
      if (rel > 0) {
        const Pos at = pos_of(rel, a, inv_q, inv_ncol);
        if (at.p + 7 < a.Q && at.p > tl.len[at.r] + 1) continue;  // every element past len + 1
      }
      v[u] = __ldcs(src + cu);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t g[4] = {__vcmpges2(v[u].x, thr2), __vcmpges2(v[u].y, thr2),
                             __vcmpges2(v[u].z, thr2), __vcmpges2(v[u].w, thr2)};
      if (!(g[0] | g[1] | g[2] | g[3])) continue;
      uint32_t m8 = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) m8 |= ((g[q] & 1u) | ((g[q] >> 15) & 2u)) << (2 * q);
      const int64_t rel = 8 * (c + (int64_t)u * kThreads) - e0;
      if (rel < 0) m8 >>= -rel;  // elements before the tile
      const int64_t first = rel < 0 ? 0 : rel;
      if (first + 8 > n_el) m8 &= (1u << (n_el - first)) - 1u;  // and after it
      const Pos at = pos_of(first, a, inv_q, inv_ncol);
      set_bits(a, tl, m8, at.r, at.col, at.p);
    }
  }
  // Class bitmaps: bit p of class c is dpad[p] in C (0 past Q).
  for (int k = warp; k < tl.rows * a.nw; k += kWarps) {
    const int r = k / a.nw, w = k - r * a.nw;
    const uint8_t* bytes = a.data + (int64_t)(tl.t0 + r) * a.L;
    uint32_t b[2];
    bool in_q[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 64 * w + 32 * h + lane;
      b[h] = (p >= 1 && p <= a.L) ? (uint32_t)__ldg(bytes + p - 1) : 0u;
      in_q[h] = p < a.Q;
    }
    uint64_t* dst = tl.clsw + (int64_t)k * a.ncls;  // [r][w][c]
    for (int c = 0; c < a.ncls; ++c) {
      const uint64_t* m = a.cls + 4 * c;
      const uint32_t lo = __ballot_sync(~0u, in_q[0] && ((__ldg(m + (b[0] >> 6)) >> (b[0] & 63)) & 1ull));
      const uint32_t hi = __ballot_sync(~0u, in_q[1] && ((__ldg(m + (b[1] >> 6)) >> (b[1] & 63)) & 1ull));
      if (lane == 0) dst[c] = lo | ((uint64_t)hi << 32);
    }
  }
}

// Phase 3, finals tier off: one thread per (row, finals column).
__device__ void finals_cols(const Args& a, const Tile& tl) {
  const int items = tl.rows * a.NF;
  for (int g = threadIdx.x; g < items; g += kThreads) {
    const int rr = g / a.NF, f = g - rr * a.NF;
    Row r = row_of(a, tl, rr);
    r.off = 0;  // the finals columns come first: conv column f
    const int32_t* d = a.fin + 4 * f;
    const int sc = __ldg(d), nl = __ldg(d + 1), nr = __ldg(d + 2), a_start = __ldg(d + 3);
    int plo = 1 - nl > 0 ? 1 - nl : 0;
    int phi = r.len1 - nr - nl;
    phi = phi < a.Q - 1 - nl - nr ? phi : a.Q - 1 - nl - nr;
    if (a_start) phi = phi < 1 - nl ? phi : 1 - nl;
    const uint64_t* s = tl.sfxw + (int64_t)rr * a.nw * a.NS + sc;  // word w at s[w * NS]
    const int k = nl + nr, ws = k >> 6, bs = k & 63;
    bool hit = false;
    for (int w = 0; w < a.nw && !hit; ++w) {
      const uint64_t m = range_word(w, plo, phi);
      if (!m) continue;
      const uint64_t lo = w + ws < a.nw ? s[(int64_t)(w + ws) * a.NS] : 0ull;
      const uint64_t hi = w + ws + 1 < a.nw ? s[(int64_t)(w + ws + 1) * a.NS] : 0ull;
      const uint64_t gj = m & (bs ? (lo >> bs) | (hi << (64 - bs)) : lo);
      if (gj) hit = (conv_word(r, f, w) & gj) != 0ull;
    }
    a.bh[(int64_t)(tl.t0 + rr) * a.ldo + a.nbc + f] = hit;
  }
}

// Phase 3, finals tier on: the suffix bits as [T, Q, NS] bytes; a warp
// writes one (row, position) at a time, lanes on consecutive columns.
__device__ void suffix_bytes(const Args& a, const Tile& tl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int rp = warp; rp < tl.rows * a.Q; rp += kWarps) {
    const int rr = rp / a.Q, p = rp - rr * a.Q;
    const uint64_t* s = tl.sfxw + ((int64_t)rr * a.nw + (p >> 6)) * a.NS;
    uint8_t* dst = a.sfx + ((int64_t)(tl.t0 + rr) * a.Q + p) * a.NS;
    for (int c = lane; c < a.NS; c += 32) dst[c] = (uint8_t)((s[c] >> (p & 63)) & 1ull);
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads) chain_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool global_tile = a.scratch != nullptr;
  uint64_t* base = global_tile ? a.scratch + (int64_t)blockIdx.x * a.tile_u64 : (uint64_t*)smem;
  int32_t* s_ucum = (int32_t*)(smem + a.at_ints);
  int32_t* s_len = s_ucum + a.U + 1;
  Tile tl;
  tl.words = base;
  tl.sfxw = base + a.at_sfx;
  tl.clsw = base + a.at_cls;
  tl.state = base + a.at_state;
  tl.ucum = s_ucum;
  tl.len = s_len;
  for (int i = threadIdx.x; i <= a.U; i += kThreads) s_ucum[i] = __ldg(a.ucum + i);
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    tl.t0 = tile * a.rows;
    tl.rows = a.T - tl.t0 < a.rows ? a.T - tl.t0 : a.rows;
    __syncthreads();  // the last tile's readers are done
    for (int r = threadIdx.x; r < tl.rows; r += kThreads) s_len[r] = __ldg(a.lens + tl.t0 + r);
    const int64_t n_words = (int64_t)tl.rows * a.nw * a.ncol;
    for (int64_t i = threadIdx.x; i < n_words; i += kThreads) tl.words[i] = 0ull;
    __syncthreads();
    pack<NW ? 4 : 8>(a, tl);  // rows past 192 positions: fewer tiles per SM, more loads each
    __syncthreads();
    const int items = tl.rows * a.M;
    for (int g = threadIdx.x; g < items; g += kThreads) {
      if constexpr (NW > 0) {
        RegBits<NW> e;
        run_item(e, a, tl, g);
      } else {
        TileBits e{tl.state + threadIdx.x, kThreads, a.nw};
        run_item(e, a, tl, g);
      }
    }
    if (!a.finals && !a.sfx) continue;
    __syncthreads();
    if (a.finals) finals_cols(a, tl);
    if (a.sfx && a.NS) suffix_bytes(a, tl);
  }
}

// Dynamic shared memory the kernel may use on each card, raised once per
// larger size. cudaFuncSetAttribute sets the limit for the calling thread's
// current card (the wrapper makes the tensors' card current), so the cached
// sizes are per card: kMaxCards slots indexed by cudaGetDevice, zero until a
// raise (the default 48 KB needs none). Several host threads launch: the
// sizes are atomics read without a lock, and a raise happens under g_mu,
// re-checked there.
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxCards = 64;
// Returned (as the launcher's error code) on a card numbered kMaxCards or more.
constexpr int kErrTooManyCards = 1 << 20;
// Returned when the wrapper's plan has no rows or blocks, or the conv
// output is not 16-byte aligned.
constexpr int kErrPlan = (1 << 20) + 1;
std::atomic<int> g_smem_set[kRegWords + 1][kMaxCards];
std::mutex g_mu;

template <typename Kernel>
int allow_smem(Kernel kernel, std::atomic<int>* per_card, int smem) {
  if (smem <= kDefaultSmem) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxCards) return kErrTooManyCards;
  std::atomic<int>* set = per_card + dev;
  if (smem <= set->load(std::memory_order_acquire)) return 0;
  std::lock_guard<std::mutex> lock(g_mu);
  if (smem <= set->load(std::memory_order_relaxed)) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused size leaves no error behind for the next launch
    return (int)err;
  }
  set->store(smem, std::memory_order_release);
  return 0;
}

template <int NW>
int launch(const Args& a, int grid, int smem, cudaStream_t s) {
  const int err = allow_smem(chain_kernel<NW>, g_smem_set[NW], smem);
  if (err) return err;
  chain_kernel<NW><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// conv [T, ncol, Q] bf16 (the conv output without its first `off` columns),
// data [T, L] u8, lens [T] i32, units [U, 8] i32, ucum [U + 1] i32, ops
// [n_ops, 4] i32, cls [ncls, 4] u64, fin [NF, 4] i32; Q = L + 2; W the
// kernel width (threshold 2W); M the members of all units; NS suffix
// columns; nbc bucket columns, written first in bh [T, ldo] u8; with
// `finals` the finals columns follow them; sfx [T, Q, NS] u8 or null.
// A block takes tiles of `rows` rows, `grid` blocks in all; the tile of
// `tile_u64` words lives in `smem` bytes of dynamic shared memory, or,
// with `scratch` (rows = 1), in grid slices of scratch (u64). The match
// words start the tile, its suffix, class and state areas start at
// at_sfx, at_cls and at_state words, and the staged ucum and lengths at
// at_ints bytes into shared memory (chain_plan lays them out). One launch
// on `stream` when T > 0. Returns cudaGetLastError(), or the refused
// attribute's error.
int cko_chain_match(const void* conv, const void* data, const void* lens, const void* units,
                    const void* ucum, const void* ops, const void* cls, const void* fin,
                    int T, int L, int Q, int ncol, int off, int W, int U, int M, int NS,
                    int NF, int ncls, int nbc, int ldo, int finals, int rows, int grid,
                    int smem, int at_sfx, int at_cls, int at_state, int tile_u64, int at_ints,
                    void* scratch, void* sfx, void* bh, void* stream) {
  if (T <= 0) return 0;
  Args a;
  a.conv = (const uint16_t*)conv;
  a.data = (const uint8_t*)data;
  a.lens = (const int32_t*)lens;
  a.units = (const int32_t*)units;
  a.ucum = (const int32_t*)ucum;
  a.ops = (const int32_t*)ops;
  a.cls = (const uint64_t*)cls;
  a.fin = (const int32_t*)fin;
  a.scratch = (uint64_t*)scratch;
  a.sfx = (uint8_t*)sfx;
  a.bh = (uint8_t*)bh;
  a.T = T;
  a.L = L;
  a.Q = Q;
  a.nw = (Q + 63) / 64;
  a.ncol = ncol;
  a.off = off;
  a.U = U;
  a.M = M;
  a.NS = NS;
  a.NF = finals ? NF : 0;
  a.ncls = ncls;
  a.nbc = nbc;
  a.ldo = ldo;
  a.finals = finals && NF > 0;
  a.rows = rows;
  a.tiles = rows > 0 ? (T + rows - 1) / rows : 0;
  a.tile_u64 = tile_u64;
  a.at_sfx = at_sfx;
  a.at_cls = at_cls;
  a.at_state = at_state;
  a.at_ints = at_ints;
  const float thr = 2.0f * (float)W;  // an integer up to 256: exact in bf16
  uint32_t thr_bits;
  memcpy(&thr_bits, &thr, 4);
  a.thr_bits = thr_bits >> 16;
  if (rows <= 0 || grid <= 0 || (scratch && rows != 1) || ((uintptr_t)conv & 15)) {
    return kErrPlan;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (a.nw == 1) return launch<1>(a, grid, smem, s);
  if (a.nw == 2) return launch<2>(a, grid, smem, s);
  if (a.nw == kRegWords) return launch<kRegWords>(a, grid, smem, s);
  return launch<0>(a, grid, smem, s);
}

const char* cko_error_string(int code) {
  if (code == kErrTooManyCards) return "the card's number is past the launcher's per-card caches (kMaxCards)";
  if (code == kErrPlan) {
    return "the wrapper's plan has no rows or blocks, or the conv output is not 16-byte aligned";
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
