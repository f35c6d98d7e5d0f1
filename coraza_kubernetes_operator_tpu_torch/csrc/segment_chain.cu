// Chain program of the conv-segment matcher for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's chain is the body of
// coraza_kubernetes_operator_tpu/ops/segment.py::match_segment_block
// (run_bucket, the suffix tier and the per-finals-key AND-any), one jax.jit
// that XLA fuses into a few fusions. Run eagerly in PyTorch the same
// unrolled chain is ~40k small kernels per segment block (~127k per blob
// window); here it is one launch per block, and a second one for the
// finals columns.
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
//   finals column f (second kernel), suffix column sc, n_lead, n_real, a_start:
//     gj[p] = S_sc[p + n_lead + n_real] and 1 <= p + n_lead and
//             p + n_lead + n_real <= len + 1 (and p + n_lead == 1 if a_start);
//     hit = any(M_f & gj).
// hi = -1 is an unbounded gap; shifts fill with 0 and drop what leaves [0, Q).
// The reference spells a class gap with non-class-count (NCE) tables and
// log-shift min passes; the walk below (a run counter of class bytes and the
// nearest set position) gives the same bits (tests/test_torch_segment_chain.py
// holds both to the JAX package).
//
// What bounds it: the bytes of the conv output, which every chain reads once
// per member column (bf16, Q per row and column), so one read of it at the
// card's memory rate.
//
// Design. One thread per (row, member column) of a unit; the items of all
// units are laid out unit by unit (rows, then members), so a warp mostly
// runs one unit's op list with the same shifts, and only its conv column
// differs. A unit's bitmap is ceil(Q / 64) words: in registers for Q <= 192
// (one kernel per word count), else in a global scratch the wrapper
// allocates, interleaved across threads, which then walk the items grid-
// stride. A seg op reads a conv word only where the state word is non-zero.
// gapany is word shifts (log passes as in the reference; a single bit scan
// when unbounded); gapcls walks the positions once with a run counter. The
// second kernel (chain_kernel_cols) reads the suffix words the first packed,
// and a conv word only where the finals column's group is reachable.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
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
  const uint64_t* cls;    // [n_classes, 4] 256-bit class masks
  const int32_t* fin;     // [NF, 4] per finals column: suffix column, n_lead, n_real, a_start
  uint64_t* bits;         // [nw, G] bitmap scratch (Q > 192), else null
  uint64_t* packed;       // [T, NS, nw] suffix words for chain_kernel_cols, or null
  uint8_t* sfx;           // [T, Q, NS] suffix bits as bytes, or null
  uint8_t* bh;            // [T, ldo] hit columns
  int T, L, Q, nw, ncol, off, U, M, NS, NF, nbc, ldo;
  int64_t G;              // threads that walk the items (the scratch's columns)
  float thr;              // 2W
};

// Per item: its row's operands.
struct Row {
  const uint16_t* conv;  // the row's [ncol, Q]
  const uint8_t* bytes;  // the row's L bytes
  int L, Q, nw, off, len1;
  float thr;
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
  // M_col at positions [64 k, 64 k + 64) cut at Q; col is a global column.
  if (k < 0) return 0ull;
  const uint16_t* src = r.conv + (int64_t)(col - r.off) * r.Q + 64 * k;
  const int n = r.Q - 64 * k < 64 ? r.Q - 64 * k : 64;
  uint64_t m = 0ull;
  for (int b = 0; b < n; ++b) {
    const float v = __uint_as_float((uint32_t)__ldg(src + b) << 16);
    m |= (uint64_t)(v >= r.thr) << b;
  }
  return m;
}

__device__ __forceinline__ uint32_t dpad(const Row& r, int p) {
  return (p >= 1 && p <= r.L) ? (uint32_t)__ldg(r.bytes + p - 1) : 0u;
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

struct GlobalBits {
  static constexpr int kWords = 0;  // runtime word count
  uint64_t* base;
  int64_t stride;
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

// gapcls: as spread, where the d bytes between must all lie in the class.
// After a shift by lo, one walk over the positions keeps the nearest set
// position and the run of class bytes next to p: the gap d fits iff
// d <= hi and d <= run.
template <class B>
__device__ void walk(B& e, int lo, int hi, const uint64_t* cls, bool up, const Row& r) {
  const uint64_t m0 = __ldg(cls), m1 = __ldg(cls + 1), m2 = __ldg(cls + 2), m3 = __ldg(cls + 3);
  const int hmax = hi < 0 ? kUnbounded : hi;
  const int n = words<B>(r);
  auto in_c = [&](int p) -> bool {
    const uint32_t b = dpad(r, p);
    const uint64_t mw = b < 64 ? m0 : b < 128 ? m1 : b < 192 ? m2 : m3;
    return (mw >> (b & 63)) & 1ull;
  };
  if (up) {
    shift_up(e, lo, false, r);
    int prev = kNone, run = 0;  // run: class bytes ending at p - 1
#pragma unroll
    for (int w = 0; w < n; ++w) {
      const uint64_t x = e.get(w);
      uint64_t o = 0ull;
      const int bend = r.Q - 64 * w < 64 ? r.Q - 64 * w : 64;
      for (int b = 0; b < bend; ++b) {
        const int p = 64 * w + b;
        if (p > 0) run = in_c(p - 1) ? run + 1 : 0;
        if ((x >> b) & 1ull) prev = p;
        const int d = lo + p - prev;
        if (prev != kNone && d <= hmax && d <= run) o |= 1ull << b;
      }
      e.set(w, o);
    }
  } else {
    shift_down(e, lo, false, r);
    int next = kNone, run = 0;  // run: class bytes starting at p
#pragma unroll
    for (int w = n - 1; w >= 0; --w) {
      const uint64_t x = e.get(w);
      uint64_t o = 0ull;
      const int bend = r.Q - 64 * w < 64 ? r.Q - 64 * w : 64;
      for (int b = bend - 1; b >= 0; --b) {
        const int p = 64 * w + b;
        run = in_c(p) ? run + 1 : 0;
        if ((x >> b) & 1ull) next = p;
        const int d = lo + next - p;
        if (next != kNone && d <= hmax && d <= run) o |= 1ull << b;
      }
      e.set(w, o);
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

// One item: row t, member j of unit u.
template <class B>
__device__ void run_item(B& e, const Args& a, int64_t g) {
  // The unit: T * ucum[u] <= g < T * ucum[u + 1].
  int lo = 0, hi = a.U;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if ((int64_t)a.T * __ldg(a.ucum + mid) <= g) lo = mid;
    else hi = mid;
  }
  const int32_t* u = a.units + kUnitInts * lo;
  const int nb = __ldg(u + U_NB), kind = __ldg(u + U_KIND);
  const int64_t local = g - (int64_t)a.T * __ldg(a.ucum + lo);
  const int t = (int)(local / nb), j = (int)(local - (int64_t)t * nb);
  Row r;
  r.conv = a.conv + (int64_t)t * a.ncol * a.Q;
  r.bytes = a.data + (int64_t)t * a.L;
  r.L = a.L;
  r.Q = a.Q;
  r.nw = a.nw;
  r.off = a.off;
  r.len1 = __ldg(a.lens + t) + 1;
  r.thr = a.thr;
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
    a.bh[(int64_t)t * a.ldo + __ldg(u + U_OUT) + j] = hit;
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
    else walk(e, p1, p2, a.cls + 4 * p3, up, r);
  }
  if (up) {
    const bool hit = any_in(e, a_end ? r.len1 : 0, r.len1, r);
    a.bh[(int64_t)t * a.ldo + __ldg(u + U_OUT) + j] = hit;
    return;
  }
  const int col = __ldg(u + U_SFX) + j;
  const int n = words<B>(r);
  if (a.packed) {
    uint64_t* dst = a.packed + ((int64_t)t * a.NS + col) * a.nw;
#pragma unroll
    for (int w = 0; w < n; ++w) dst[w] = e.get(w);
  }
  if (a.sfx) {
    uint8_t* dst = a.sfx + (int64_t)t * a.Q * a.NS + col;
#pragma unroll
    for (int w = 0; w < n; ++w) {
      const uint64_t x = e.get(w);
      const int bend = r.Q - 64 * w < 64 ? r.Q - 64 * w : 64;
      for (int b = 0; b < bend; ++b) dst[(int64_t)(64 * w + b) * a.NS] = (x >> b) & 1ull;
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads) chain_kernel_reg(Args a) {
  const int64_t items = (int64_t)a.T * a.M;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x; g < items; g += stride) {
    RegBits<NW> e;
    run_item(e, a, g);
  }
}

__global__ void __launch_bounds__(kThreads) chain_kernel_scratch(Args a) {
  const int64_t items = (int64_t)a.T * a.M;
  const int64_t gt = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  GlobalBits e{a.bits + gt, a.G, a.nw};
  for (int64_t g = gt; g < items; g += a.G) run_item(e, a, g);
}

// The finals columns: one thread per (row, column).
__global__ void __launch_bounds__(kThreads) chain_kernel_cols(Args a) {
  const int64_t items = (int64_t)a.T * a.NF;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x; g < items; g += stride) {
    const int t = (int)(g / a.NF), f = (int)(g - (int64_t)t * a.NF);
    Row r;
    r.conv = a.conv + (int64_t)t * a.ncol * a.Q;
    r.Q = a.Q;
    r.off = 0;  // the finals columns come first: conv column f
    r.thr = a.thr;
    const int len1 = __ldg(a.lens + t) + 1;
    const int32_t* d = a.fin + 4 * f;
    const int sc = __ldg(d), nl = __ldg(d + 1), nr = __ldg(d + 2), a_start = __ldg(d + 3);
    int plo = 1 - nl > 0 ? 1 - nl : 0;
    int phi = len1 - nr - nl;
    phi = phi < a.Q - 1 - nl - nr ? phi : a.Q - 1 - nl - nr;
    if (a_start) phi = phi < 1 - nl ? phi : 1 - nl;
    const uint64_t* s = a.packed + ((int64_t)t * a.NS + sc) * a.nw;
    const int k = nl + nr, ws = k >> 6, bs = k & 63;
    bool hit = false;
    for (int w = 0; w < a.nw && !hit; ++w) {
      const uint64_t m = range_word(w, plo, phi);
      if (!m) continue;
      const uint64_t lo = w + ws < a.nw ? s[w + ws] : 0ull;
      const uint64_t hi = w + ws + 1 < a.nw ? s[w + ws + 1] : 0ull;
      const uint64_t gj = m & (bs ? (lo >> bs) | (hi << (64 - bs)) : lo);
      if (gj) hit = (conv_word(r, f, w) & gj) != 0ull;
    }
    a.bh[(int64_t)t * a.ldo + a.nbc + f] = hit;
  }
}

int blocks_for(int64_t items) {
  const int64_t b = (items + kThreads - 1) / kThreads;
  return (int)(b < (1 << 30) ? b : (1 << 30));
}

}  // namespace

extern "C" {

// conv [T, ncol, Q] bf16 (the conv output without its first `off` columns),
// data [T, L] u8, lens [T] i32, units [U, 8] i32, ucum [U + 1] i32, ops
// [n_ops, 4] i32, cls [n_classes, 4] u64, fin [NF, 4] i32; Q = L + 2; W the
// kernel width (threshold 2W); M the members of all units; NS suffix
// columns; nbc bucket columns, written first in bh [T, ldo] u8; with
// `finals` the finals columns follow them (read from packed [T, NS, nw]
// u64, which the first kernel fills); sfx [T, Q, NS] u8 or null; bits
// [nw, G] u64 scratch when Q > 192 (G a multiple of 256), else null.
// Launches the chain kernel when T * M > 0 and the finals-columns kernel when
// `finals` and T * NF > 0, on `stream`. Returns cudaGetLastError().
int cko_chain_match(const void* conv, const void* data, const void* lens, const void* units,
                    const void* ucum, const void* ops, const void* cls, const void* fin,
                    int T, int L, int Q, int ncol, int off, int W, int U, int M, int NS,
                    int NF, int nbc, int ldo, int finals, int G, void* bits, void* packed,
                    void* sfx, void* bh, void* stream) {
  Args a;
  a.conv = (const uint16_t*)conv;
  a.data = (const uint8_t*)data;
  a.lens = (const int32_t*)lens;
  a.units = (const int32_t*)units;
  a.ucum = (const int32_t*)ucum;
  a.ops = (const int32_t*)ops;
  a.cls = (const uint64_t*)cls;
  a.fin = (const int32_t*)fin;
  a.bits = (uint64_t*)bits;
  a.packed = (uint64_t*)packed;
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
  a.NF = NF;
  a.nbc = nbc;
  a.ldo = ldo;
  a.G = G;
  a.thr = 2.0f * (float)W;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t items = (int64_t)T * M;
  if (items > 0) {
    if (a.nw == 1) chain_kernel_reg<1><<<blocks_for(items), kThreads, 0, s>>>(a);
    else if (a.nw == 2) chain_kernel_reg<2><<<blocks_for(items), kThreads, 0, s>>>(a);
    else if (a.nw == kRegWords) chain_kernel_reg<kRegWords><<<blocks_for(items), kThreads, 0, s>>>(a);
    else chain_kernel_scratch<<<G / kThreads, kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (finals && (int64_t)T * NF > 0) {
    chain_kernel_cols<<<blocks_for((int64_t)T * NF), kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

const char* cko_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
