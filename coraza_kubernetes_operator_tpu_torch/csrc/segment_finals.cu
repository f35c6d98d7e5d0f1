// Fused finals tier of the conv-segment matcher for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
//   cko_finals_match <- coraza_kubernetes_operator_tpu/ops/segment_pallas.py::_finals_kernel
//
// Contract: for row t and finals column n with group k = group[n],
//   out[t, n] = OR over p < Q of ( gj[t, p, k] AND
//               sum_{j < W, c < C} embed[t, p + j, c] * K[j*C + c, n] >= 2W )
// with embed 0/1 and K 0/1/2 (what build_segment_block makes). The
// reachability gj is not an operand: the kernel computes it from the suffix
// pass's results, suffix [T, Q, NS] 0/1, and the group's descriptor
// desc[k] = (col, n_lead, n_real, a_start), as ops/segment_finals.py's
// group_reach defines it:
//   gj[t, p, k] = r >= 1 && r + n_real <= 1 + len[t] && r + n_real < Q &&
//                 (!a_start || r == 1) && suffix[t, r + n_real, col],
//   r = p + n_lead.
// Every partial sum is a small integer, so integer arithmetic is exact.
//
// The TPU kernel spells the window score as MXU matmuls over a residue-block
// layout and reads gj as a dense [T, Q, Gf] operand. On this card the work
// the data needs is small: on seeded crs-lite rows only 0.12-0.29% of gj is
// set and 2-8% of rows have any reachable position, so dense tensor-core
// work (wgmma) would compute scores that are thrown away; the kernel stays
// on CUDA cores. What bounds it: the bytes of suffix and embed, read once.
//
// Design. A block owns one row at a time (grid-stride over rows) and walks
// its window starts in tiles of QT positions (QT <= 512, a multiple of 32,
// chosen by the wrapper so that shared memory stays under 227 KB; one tile
// covers Q = 66, five cover Q = 2050). Per tile:
//   (a) column masks: the block reads the suffix bytes of positions
//       [p0, p0 + QT + Dmax) in 16-byte loads (neighbouring lanes on
//       neighbouring columns of one position, so the loads are coalesced)
//       and sets one bit per set byte in a [NS, CW] word mask in shared
//       memory. Positions past len + 1 cannot be reachable and are not
//       read. A tile with no set byte stops here: a row with no reachable
//       group writes zeros, having read only its suffix bytes.
//   (b) reach masks: one thread per (group, 32 window starts) shifts its
//       column's mask by n_lead + n_real and ANDs the valid range, giving
//       a QT-bit reach mask per group. A tile where every mask is empty
//       stops here.
//   (c) embed words: the tile's embed positions are packed into 64-bit
//       words (C bits per position) in shared memory.
//   (d) scoring: one thread per column that has not hit yet walks only the
//       set bits of its group's mask (__ffs). A position's contribution is
//       popc(e & K1) + 2 popc(e & K2) over the weight bitplanes; a window
//       stops at the first position j after which even the largest
//       contribution the remaining positions can make cannot lift the
//       partial sum to 2W (thresholds thr[n, j], from the weights alone, so
//       exact for any 0/1 embed); a column stops at its first hit.
// Each reachable position is read once per row tile, never once per column
// tile. The weight bitplanes and thresholds are built once per block on the
// host and read through L1/L2; the shared-memory attribute is set once per
// size.

#include <atomic>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int r16(int n) { return (n + 15) & ~15; }

__device__ inline uint32_t range_bits(int lo, int hi) {
  // Bits b of a 32-bit word with lo <= b <= hi.
  lo = lo < 0 ? 0 : lo;
  hi = hi > 31 ? 31 : hi;
  if (lo > hi) return 0u;
  return (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo);
}

__global__ void __launch_bounds__(kThreads)
finals_kernel(const uint8_t* __restrict__ embed,    // [T, Lp, C] 0/1
              const uint8_t* __restrict__ suffix,   // [T, Q, NS] 0/1
              const int32_t* __restrict__ lens,     // [T]
              const uint64_t* __restrict__ kbits,   // [Nf, W, nw, 2]
              const int32_t* __restrict__ thr,      // [Nf, W]
              const int32_t* __restrict__ desc,     // [Gf, 4]
              const int32_t* __restrict__ group,    // [Nf]
              int T, int Lp, int C, int Q, int NS, int W, int Gf, int Nf,
              int QT, int Dmax, uint8_t* __restrict__ out) {  // [T, Nf]
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = (C + 63) >> 6;
  const int QW = QT >> 5;                  // reach-mask words per group
  const int CW = (QT + Dmax + 31) >> 5;    // column-mask words per suffix column
  const int EP = QT + W - 1;               // embed positions a tile reads
  const int HW = (Nf + 31) >> 5;
  uint64_t* s_emb = reinterpret_cast<uint64_t*>(smem);
  uint32_t* s_col = reinterpret_cast<uint32_t*>(smem + r16(EP * nw * 8));
  uint32_t* s_grp = s_col + r16(NS * CW * 4) / 4;
  uint32_t* s_hit = s_grp + r16(Gf * QW * 4) / 4;
  const int tid = threadIdx.x;
  const int64_t total = (int64_t)T * Q * NS;

  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    for (int i = tid; i < HW; i += kThreads) s_hit[i] = 0u;
    int q_end = lens[t] + 2;  // suffix positions <= len + 1 can be set usefully
    q_end = q_end < 0 ? 0 : (q_end > Q ? Q : q_end);
    for (int p0 = 0; p0 < q_end; p0 += QT) {
      __syncthreads();
      for (int i = tid; i < NS * CW; i += kThreads) s_col[i] = 0u;
      __syncthreads();

      // (a) column masks of suffix positions [p0, pend).
      const int pend = q_end < p0 + CW * 32 ? q_end : p0 + CW * 32;
      const int64_t start = ((int64_t)t * Q + p0) * NS;
      const int64_t stop = ((int64_t)t * Q + pend) * NS;
      int any = 0;
      for (int64_t a = (start & ~(int64_t)15) + 16 * tid; a < stop; a += 16 * kThreads) {
        union { uint4 v; uint8_t b[16]; } u;
        if (a + 16 <= total) {
          u.v = *reinterpret_cast<const uint4*>(suffix + a);
        } else {
          for (int k = 0; k < 16; ++k) u.b[k] = a + k < total ? suffix[a + k] : 0;
        }
        if ((u.v.x | u.v.y | u.v.z | u.v.w) == 0u) continue;
        for (int k = 0; k < 16; ++k) {
          const int64_t i = a + k;
          if (!u.b[k] || i < start || i >= stop) continue;
          const int rel = (int)(i - start);
          const int pp = rel / NS;
          const int col = rel - pp * NS;
          atomicOr(&s_col[col * CW + (pp >> 5)], 1u << (pp & 31));
          any = 1;
        }
      }
      if (!__syncthreads_or(any)) continue;

      // (b) reach masks: bit b of word wd is window start p = p0 + 32 wd + b.
      int anyg = 0;
      for (int i = tid; i < Gf * QW; i += kThreads) {
        const int k = i / QW;
        const int wd = i - k * QW;
        const int col = desc[4 * k], nl = desc[4 * k + 1], nr = desc[4 * k + 2];
        const int a_start = desc[4 * k + 3];
        const int o = wd * 32 + nl + nr;  // the suffix position's bit in s_col
        const uint32_t* cm = s_col + col * CW;
        const int lo = o >> 5, sh = o & 31;
        uint32_t m = 0u;
        if (lo < CW) {
          m = cm[lo] >> sh;
          if (sh && lo + 1 < CW) m |= cm[lo + 1] << (32 - sh);
        }
        const int pbase = p0 + wd * 32;
        const int plo = 1 - nl > 0 ? 1 - nl : 0;  // r >= 1
        const int phi = a_start ? 1 - nl : Q - 1;  // r == 1 when anchored
        m &= range_bits(plo - pbase, phi - pbase);
        s_grp[i] = m;
        anyg |= m != 0u;
      }
      if (!__syncthreads_or(anyg)) continue;

      // (c) the tile's embed positions as 64-bit words.
      const int ep = Lp - p0 < EP ? Lp - p0 : EP;
      for (int i = tid; i < ep * nw; i += kThreads) {
        const int pp = i / nw;
        const int wd = i - pp * nw;
        const uint8_t* e = embed + ((int64_t)t * Lp + p0 + pp) * C;
        const int c0 = wd * 64;
        const int c1 = C < c0 + 64 ? C : c0 + 64;
        uint64_t m = 0;
        for (int c = c0; c < c1; ++c) m |= (uint64_t)(e[c] != 0) << (c - c0);
        s_emb[i] = m;
      }
      __syncthreads();

      // (d) score each open column at its group's reachable starts.
      for (int n = tid; n < Nf; n += kThreads) {
        if ((s_hit[n >> 5] >> (n & 31)) & 1u) continue;
        const uint32_t* gm = s_grp + group[n] * QW;
        const uint64_t* kb = kbits + (int64_t)n * W * nw * 2;
        const int32_t* th = thr + (int64_t)n * W;
        bool hit = false;
        for (int wd = 0; wd < QW && !hit; ++wd) {
          uint32_t m = gm[wd];
          while (m && !hit) {
            const int pl = wd * 32 + __ffs(m) - 1;
            m &= m - 1u;
            int s = 0;
            int j = 0;
            for (; j < W; ++j) {
              const uint64_t* e = s_emb + (pl + j) * nw;
              const uint64_t* kj = kb + j * nw * 2;
              for (int x = 0; x < nw; ++x) {
                s += __popcll(e[x] & __ldg(kj + 2 * x)) + 2 * __popcll(e[x] & __ldg(kj + 2 * x + 1));
              }
              if (s < __ldg(th + j)) break;
            }
            hit = j == W;  // no break: s >= thr[W - 1] == 2W
          }
        }
        if (hit) atomicOr(&s_hit[n >> 5], 1u << (n & 31));
      }
    }
    __syncthreads();
    for (int n = tid; n < Nf; n += kThreads) {
      out[(int64_t)t * Nf + n] = (uint8_t)((s_hit[n >> 5] >> (n & 31)) & 1u);
    }
    __syncthreads();
  }
}

// Per card: the SM count (read once) and the dynamic shared memory the
// kernel may use (raised once per larger size; zero until a raise, as the
// default 48 KB needs none). Both belong to the calling thread's current
// card (the wrapper makes the tensors' card current): kMaxCards slots
// indexed by cudaGetDevice. Several host threads launch: both are atomics
// read without a lock and written under g_mu, re-checked there.
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxCards = 64;
// Returned (as the launcher's error code) on a card numbered kMaxCards or more.
constexpr int kErrTooManyCards = 1 << 20;
std::atomic<int> g_sms[kMaxCards];
std::atomic<int> g_smem_set[kMaxCards];
std::mutex g_mu;

}  // namespace

extern "C" {

// embed [T, Lp, C] u8, suffix [T, Q, NS] u8 (16-byte aligned), lens [T] i32,
// kbits [Nf, W, nw, 2] u64, thr [Nf, W] i32, desc [Gf, 4] i32, group [Nf]
// i32; QT window starts per tile (a multiple of 32), Dmax the largest
// n_lead + n_real, smem the block's shared bytes; out [T, Nf] u8. Returns
// cudaGetLastError().
int cko_finals_match(const void* embed, const void* suffix, const void* lens,
                     const void* kbits, const void* thr, const void* desc,
                     const void* group, int T, int Lp, int C, int Q, int NS, int W,
                     int Gf, int Nf, int QT, int Dmax, int smem, void* out,
                     void* stream) {
  if (T <= 0 || Nf <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxCards) return kErrTooManyCards;
  int sms = g_sms[dev].load(std::memory_order_acquire);
  if (sms == 0 || (smem > kDefaultSmem && smem > g_smem_set[dev].load(std::memory_order_acquire))) {
    std::lock_guard<std::mutex> lock(g_mu);
    sms = g_sms[dev].load(std::memory_order_relaxed);
    if (sms == 0) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
      g_sms[dev].store(sms, std::memory_order_release);
    }
    if (smem > kDefaultSmem && smem > g_smem_set[dev].load(std::memory_order_relaxed)) {
      err = cudaFuncSetAttribute(finals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      g_smem_set[dev].store(smem, std::memory_order_release);
    }
  }
  // Rows are independent; a few blocks per SM walk them grid-stride.
  const int blocks = T < 8 * sms ? T : 8 * sms;
  finals_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)embed, (const uint8_t*)suffix, (const int32_t*)lens,
      (const uint64_t*)kbits, (const int32_t*)thr, (const int32_t*)desc,
      (const int32_t*)group, T, Lp, C, Q, NS, W, Gf, Nf, QT, Dmax, (uint8_t*)out);
  return (int)cudaGetLastError();
}

const char* cko_error_string(int code) {
  if (code == kErrTooManyCards) return "the card's number is past the launcher's per-card caches (kMaxCards)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
