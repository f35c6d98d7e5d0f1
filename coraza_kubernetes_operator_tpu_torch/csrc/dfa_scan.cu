// Stacked-DFA row scans for Hopper (sm_90a): the three scan kernels of the
// serving path.
//
// Replaces the TPU Pallas kernels
//   cko_scan_dense  <- coraza_kubernetes_operator_tpu/ops/dfa_pallas.py::_scan_kernel
//   cko_scan_gather <- coraza_kubernetes_operator_tpu/ops/dfa_gather_pallas.py::_gather_kernel
//   cko_scan_flat   <- coraza_kubernetes_operator_tpu/ops/dfa_flat.py::_flat_kernel
//
// Contract (all three): for row b and group g, run DFA g over
// data[pipe(g)][b, :len[b]] and report
//   matched[b, g] = OR over steps of emit | match_end[g, end state] | always[g].
// The TPU kernels spell each table lookup as a one-hot matmul because the
// MXU is the TPU's fast unit. On Hopper a lookup from shared memory is the
// natural form, so every step here is one shared-memory read:
//   v = tab[row(byte)][state]; hit = v >= S; state = v - S * hit
// with v = next + S * emit stored as int16 (< 2S, exact for every S the
// bank planners admit). The dense and gather scans latch the end state at
// t == len - 1 (a length past the buffer leaves it at the start state); the
// flat scan checks the state after the last step.
//
// What bounds them on this card: each step is a dependent shared-memory
// lookup (the next step's address needs this step's result), so one
// (row, group) chain runs at the shared-memory latency, and throughput comes
// from many independent chains in flight; the ceiling is the shared-memory
// pipe, 32 lookups per SM per clock. The bytes are few: each pipeline's rows
// once per bank or group, and the tables.
//
// Every launch reads its pipelines' [B, L] bytes as they are (row-major,
// 16-byte loads where the rows allow) through a by-value struct of at most
// kMaxPipes pipeline bases; a call whose banks read more pipelines is split
// by the wrapper into several launches, each writing its own columns of the
// one output. No global byte load sits inside a dependent loop: a block
// stages its rows' bytes in shared memory first. The shared-memory attribute
// of each kernel is set once per size, not per launch.

#include <atomic>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

constexpr int kMaxPipes = 8;  // pipelines one launch reads

// A launch's pipeline inputs, passed by value (no device array).
struct ScanPipes {
  const uint8_t* data[kMaxPipes];   // [B, L] per pipeline slot
  const int32_t* lens[kMaxPipes];   // [B]
};

namespace {

constexpr int kThreads = 256;
constexpr int kGRows = 128;          // rows per tier block
constexpr int kGStride = kGRows + 4; // bytes between byte positions of the tier's tile
constexpr int kRec = 6;              // ints per tier record

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Copy a table of `elems` int16 (16-byte aligned, padded to 8 elements) into
// shared memory with 16-byte copies when it fits the block's reserve;
// returns where the walk reads it.
__device__ __forceinline__ const int16_t* stage_table(const int16_t* __restrict__ src, int elems,
                                                      int16_t* dst, int reserve_bytes) {
  if (elems * 2 > reserve_bytes) return src;  // read from global memory (L2)
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < (elems * 2 + 15) / 16; i += blockDim.x) d[i] = s[i];
  return dst;
}

// The dense and dfa-hot tiers: every bank of a tier in one launch.
//
// The reference launches one Pallas kernel per bank because its banks are
// cut to the TPU's VMEM budget; here a bank's tables are a few KB, so one
// launch covers the tier and the per-bank host work goes away. A dense
// bank's per-group [256][S] table is a gather table with C = 256 and the
// identity class map, so both tiers run this body, the class map compiled
// out for dense. Grid (row tiles of kGRows, records); a record is a bank or
// a run of at most 64 of its groups: (first group, groups, table offset,
// table elements, pipeline slot, bank). A block stages the record's int16
// [C, S] tables (each record 16-byte aligned; tables too large for the
// reserve stay in global memory, read through L2) and, for gather, the
// bank's byte -> class map; it reads its row tile of the pipeline's [B, L]
// in 16-byte loads where the rows allow and stores each byte (or its class)
// transposed, so the lanes of a warp, neighbouring rows, read neighbouring
// bytes. Then each thread walks (row, group) pairs over that sequence, one
// dependent shared-memory lookup per byte. Rows longer than the tile's Lt
// columns walk in column chunks, the states kept in shared memory between
// chunks; chunks past every row's length are skipped.
template <bool kClassMap>
__device__ __forceinline__ void tier_walk(
    const ScanPipes& pipes, int B, int L, int Lt, const int16_t* __restrict__ tab,
    const int32_t* __restrict__ recs, const int32_t* __restrict__ grp_info,
    const uint8_t* __restrict__ mend, const uint8_t* __restrict__ always,
    const uint8_t* __restrict__ cmaps, const uint8_t* __restrict__ on, int smem_tab_bytes,
    int gmax, uint8_t* __restrict__ out, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int32_t* rec = recs + kRec * blockIdx.y;
  const int g0 = rec[0], ng = rec[1], toff = rec[2], telems = rec[3], slot = rec[4];
  const int r0 = blockIdx.x * kGRows;
  const int nrows = B - r0 < kGRows ? B - r0 : kGRows;
  const int npairs = nrows * ng;
  const int tid = threadIdx.x;
  int any_on = 0;
  for (int g = 0; g < ng; ++g) any_on |= on[g0 + g];
  if (!any_on) {  // the kind mask turned the bank off: its columns are 0
    for (int i = tid; i < npairs; i += kThreads) {
      out[(int64_t)(r0 + i % nrows) * G + g0 + i / nrows] = 0;
    }
    return;
  }

  int16_t* s_tab = reinterpret_cast<int16_t*>(smem);
  uint8_t* s_cmap = smem + smem_tab_bytes;
  uint8_t* s_cls = s_cmap + 256;                                  // [Lt, kGStride]
  int16_t* s_state = reinterpret_cast<int16_t*>(s_cls + round16(Lt * kGStride));
  uint8_t* s_match = reinterpret_cast<uint8_t*>(s_state) + round16(kGRows * gmax * 2);
  int* s_maxn = reinterpret_cast<int*>(s_match + round16(kGRows * gmax));

  const int16_t* tb = stage_table(tab + toff, telems, s_tab, smem_tab_bytes);
  if (kClassMap) {
    for (int i = tid; i < 256; i += kThreads) s_cmap[i] = cmaps[rec[5] * 256 + i];
  }
  for (int i = tid; i < npairs; i += kThreads) {
    s_state[i] = 0;
    s_match[i] = 0;
  }
  if (tid == 0) *s_maxn = 0;
  __syncthreads();
  const uint8_t* data = pipes.data[slot];
  const int32_t* lens = pipes.lens[slot];
  for (int r = tid; r < nrows; r += kThreads) {
    const int len = lens[r0 + r];
    atomicMax(s_maxn, len < L ? len : L);
  }
  __syncthreads();
  const int maxn = *s_maxn;
  const bool vec = ((reinterpret_cast<uintptr_t>(data) | (uintptr_t)L) & 15) == 0;

  for (int c0 = 0; c0 < maxn; c0 += Lt) {
    const int cl = L - c0 < Lt ? L - c0 : Lt;  // columns of this chunk
    if (vec) {  // cl is a multiple of 16
      const int nch = cl >> 4;
      for (int i = tid; i < nrows * nch; i += kThreads) {
        const int r = i / nch;
        const int ch = i - r * nch;
        union { uint4 v; uint8_t b[16]; } u;
        u.v = *reinterpret_cast<const uint4*>(data + (int64_t)(r0 + r) * L + c0 + ch * 16);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          s_cls[(ch * 16 + k) * kGStride + r] = kClassMap ? s_cmap[u.b[k]] : u.b[k];
        }
      }
    } else {
      for (int i = tid; i < nrows * cl; i += kThreads) {
        const int r = i / cl;
        const int k = i - r * cl;
        const uint8_t byte = data[(int64_t)(r0 + r) * L + c0 + k];
        s_cls[k * kGStride + r] = kClassMap ? s_cmap[byte] : byte;
      }
    }
    __syncthreads();
    for (int i = tid; i < npairs; i += kThreads) {
      const int r = i % nrows;
      const int g = g0 + i / nrows;
      if (!on[g]) continue;
      const int len = lens[r0 + r];
      const int n = len < L ? len : L;
      const int steps = (n < c0 + cl ? n : c0 + cl) - c0;
      if (steps <= 0) continue;
      const int S = grp_info[3 * g + 1];
      const int16_t* tg = tb + grp_info[3 * g];
      int state = s_state[i];
      int matched = s_match[i];
      for (int k = 0; k < steps; ++k) {
        const int v = tg[s_cls[k * kGStride + r] * S + state];
        const int hit = v >= S;
        matched |= hit;
        state = v - (hit ? S : 0);
      }
      s_state[i] = (int16_t)state;
      s_match[i] = (uint8_t)matched;
    }
    __syncthreads();
  }
  for (int i = tid; i < npairs; i += kThreads) {
    const int r = i % nrows;
    const int g = g0 + i / nrows;
    uint8_t v = 0;
    if (on[g]) {
      // Latch the end state at len - 1: a length past the buffer leaves it
      // at the start state.
      const int end_state = lens[r0 + r] > L ? 0 : s_state[i];
      v = (s_match[i] | mend[grp_info[3 * g + 2] + end_state] | always[g]) ? 1 : 0;
    }
    out[(int64_t)(r0 + r) * G + g] = v;
  }
}

// Two entry points, so a profile tells the tiers apart by name.
__global__ void __launch_bounds__(kThreads)
dense_tier_kernel(ScanPipes pipes, int B, int L, int Lt, const int16_t* __restrict__ tab,
                  const int32_t* __restrict__ recs, const int32_t* __restrict__ grp_info,
                  const uint8_t* __restrict__ mend, const uint8_t* __restrict__ always,
                  const uint8_t* __restrict__ on, int smem_tab_bytes, int gmax,
                  uint8_t* __restrict__ out, int G) {
  tier_walk<false>(pipes, B, L, Lt, tab, recs, grp_info, mend, always, nullptr, on,
                   smem_tab_bytes, gmax, out, G);
}

__global__ void __launch_bounds__(kThreads)
gather_tier_kernel(ScanPipes pipes, int B, int L, int Lt, const int16_t* __restrict__ tab,
                   const int32_t* __restrict__ recs, const int32_t* __restrict__ grp_info,
                   const uint8_t* __restrict__ mend, const uint8_t* __restrict__ always,
                   const uint8_t* __restrict__ cmaps, const uint8_t* __restrict__ on,
                   int smem_tab_bytes, int gmax, uint8_t* __restrict__ out, int G) {
  tier_walk<true>(pipes, B, L, Lt, tab, recs, grp_info, mend, always, cmaps, on,
                  smem_tab_bytes, gmax, out, G);
}

// The fused flat bin: G groups with their own state counts (S_g from 68 to
// 118 on crs-lite, int16 [256][S_g] tables of up to 60 KB) over a few
// pipelines. Grid (row tiles of kThreads * R rows, groups of this launch);
// a record is (group, pipeline slot). A block stages its group's table once
// (16-byte copies; a table larger than the reserve is read from global
// memory) and serves it to R * 256 rows: the wrapper picks R, the rows per
// thread, as large as keeps at least one block per SM, so at 12288 x 64 a
// block serves 1024 rows. The row tile's bytes are staged row-major in
// shared memory with 16-byte loads before the walk (Lt + 4 bytes per row,
// so the word reads of 32 neighbouring rows fall in 32 banks); each thread
// walks its R rows with their chains interleaved, reading four bytes per
// shared word, so R independent lookups are in flight while one waits on
// shared-memory latency. Rows longer than Lt columns walk in column chunks,
// the states kept in registers between chunks; chunks past every row's
// length are skipped.
template <int R>
__global__ void __launch_bounds__(kThreads)
flat_kernel(ScanPipes pipes, int B, int L, int Lt, const int16_t* __restrict__ tab,
            const int32_t* __restrict__ recs, const int32_t* __restrict__ grp_info,
            const uint8_t* __restrict__ mend, const uint8_t* __restrict__ always,
            int smem_tab_bytes, uint8_t* __restrict__ out, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = kThreads * R;
  const int g = recs[2 * blockIdx.y], slot = recs[2 * blockIdx.y + 1];
  const int S = grp_info[3 * g + 1], moff = grp_info[3 * g + 2];
  const int r0 = blockIdx.x * kRows;
  const int nrows = B - r0 < kRows ? B - r0 : kRows;
  const int tid = threadIdx.x;
  const int stride = Lt + 4;  // Lt is a multiple of 16, so stride / 4 is odd
  uint8_t* s_rows = smem + smem_tab_bytes;
  int* s_maxn = reinterpret_cast<int*>(s_rows + round16(kRows * stride));

  const int16_t* tb = stage_table(tab + grp_info[3 * g], 256 * S,
                                  reinterpret_cast<int16_t*>(smem), smem_tab_bytes);
  if (tid == 0) *s_maxn = 0;
  __syncthreads();
  const uint8_t* data = pipes.data[slot];
  const int32_t* lens = pipes.lens[slot];
  int n[R], state[R], matched[R];
  int my_max = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = tid + j * kThreads;
    const int len = r < nrows ? lens[r0 + r] : 0;
    n[j] = len < L ? len : L;
    state[j] = 0;
    matched[j] = 0;
    my_max = n[j] > my_max ? n[j] : my_max;
  }
  atomicMax(s_maxn, my_max);
  __syncthreads();
  const int maxn = *s_maxn;
  const bool vec = ((reinterpret_cast<uintptr_t>(data) | (uintptr_t)L) & 15) == 0;

  for (int c0 = 0; c0 < maxn; c0 += Lt) {
    const int cl = L - c0 < Lt ? L - c0 : Lt;  // columns of this chunk
    if (vec) {  // cl is a multiple of 16; each row's offset is 4-byte aligned
      const int nch = cl >> 4;
      for (int i = tid; i < nrows * nch; i += kThreads) {
        const int r = i / nch;
        const int ch = i - r * nch;
        const uint4 v = *reinterpret_cast<const uint4*>(data + (int64_t)(r0 + r) * L + c0 + ch * 16);
        uint32_t* d = reinterpret_cast<uint32_t*>(s_rows + r * stride + ch * 16);
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
      }
    } else {
      for (int i = tid; i < nrows * cl; i += kThreads) {
        const int r = i / cl;
        const int k = i - r * cl;
        s_rows[r * stride + k] = data[(int64_t)(r0 + r) * L + c0 + k];
      }
    }
    __syncthreads();
    int steps[R];
    int kmax = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      steps[j] = (n[j] < c0 + cl ? n[j] : c0 + cl) - c0;
      kmax = steps[j] > kmax ? steps[j] : kmax;
    }
    for (int k = 0; k < kmax; k += 4) {
      uint32_t w[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        w[j] = *reinterpret_cast<const uint32_t*>(s_rows + (tid + j * kThreads) * stride + k);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (k + q < steps[j]) {
            const int v = tb[((w[j] >> (8 * q)) & 255) * S + state[j]];
            const int hit = v >= S;
            matched[j] |= hit;
            state[j] = v - (hit ? S : 0);
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites the tile
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = tid + j * kThreads;
    if (r < nrows) {
      out[(int64_t)(r0 + r) * G + g] = (matched[j] | mend[moff + state[j]] | always[g]) ? 1 : 0;
    }
  }
}

// Dynamic shared memory each kernel may use on each card, raised once per
// larger size. cudaFuncSetAttribute sets the limit for the calling thread's
// current card (the wrapper makes the tensors' card current), so the cached
// sizes are per card: kMaxCards slots indexed by cudaGetDevice, zero until a
// raise (the default 48 KB needs none). Several host threads launch (the
// sidecar's dispatch thread, a rollout's shadow engine): the sizes are
// atomics read without a lock, and a raise happens under g_smem_mu,
// re-checked there, so two threads never race on the attribute or its
// cached size.
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxCards = 64;
// Returned (as a launcher's error code) on a card numbered kMaxCards or more.
constexpr int kErrTooManyCards = 1 << 20;
std::atomic<int> g_smem_dense[kMaxCards];
std::atomic<int> g_smem_gather[kMaxCards];
std::atomic<int> g_smem_flat[3][kMaxCards];
std::mutex g_smem_mu;

template <typename Kernel>
int allow_smem(Kernel kernel, std::atomic<int>* per_card, int smem) {
  if (smem <= kDefaultSmem) return 0;
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return (int)got;
  if (dev < 0 || dev >= kMaxCards) return kErrTooManyCards;
  std::atomic<int>* set = per_card + dev;
  if (smem <= set->load(std::memory_order_acquire)) return 0;
  std::lock_guard<std::mutex> lock(g_smem_mu);
  if (smem <= set->load(std::memory_order_relaxed)) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set->store(smem, std::memory_order_release);
  return (int)err;
}

}  // namespace

extern "C" {

// The tier launchers: per pipeline slot its [B, L] bytes and [B] lengths
// (by value), the tier's tables, this launch's records [n_recs, 6] (slots
// local to the launch), per-group records and on/off flags; Lt byte columns
// per row tile, smem the block's shared bytes (smem_tab_bytes of them for a
// table), gmax the most groups of one record.
int cko_scan_dense(ScanPipes pipes, int B, int L, int Lt, const void* tab, const void* recs,
                   const void* grp_info, const void* mend, const void* always, const void* on,
                   int smem_tab_bytes, int smem, int n_recs, int gmax, void* out, int G,
                   void* stream) {
  if (B <= 0 || G <= 0 || n_recs <= 0) return 0;
  const int err = allow_smem(dense_tier_kernel, g_smem_dense, smem);
  if (err != 0) return err;
  dim3 grid((B + kGRows - 1) / kGRows, n_recs);
  dense_tier_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      pipes, B, L, Lt, (const int16_t*)tab, (const int32_t*)recs, (const int32_t*)grp_info,
      (const uint8_t*)mend, (const uint8_t*)always, (const uint8_t*)on, smem_tab_bytes, gmax,
      (uint8_t*)out, G);
  return (int)cudaGetLastError();
}

int cko_scan_gather(ScanPipes pipes, int B, int L, int Lt, const void* tab, const void* recs,
                    const void* grp_info, const void* mend, const void* always,
                    const void* cmaps, const void* on, int smem_tab_bytes, int smem,
                    int n_recs, int gmax, void* out, int G, void* stream) {
  if (B <= 0 || G <= 0 || n_recs <= 0) return 0;
  const int err = allow_smem(gather_tier_kernel, g_smem_gather, smem);
  if (err != 0) return err;
  dim3 grid((B + kGRows - 1) / kGRows, n_recs);
  gather_tier_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      pipes, B, L, Lt, (const int16_t*)tab, (const int32_t*)recs, (const int32_t*)grp_info,
      (const uint8_t*)mend, (const uint8_t*)always, (const uint8_t*)cmaps, (const uint8_t*)on,
      smem_tab_bytes, gmax, (uint8_t*)out, G);
  return (int)cudaGetLastError();
}

// Fused flat bin: per-group tables [256][S_g] (16-byte aligned), per-group
// records (table offset, S, end-match offset), this launch's records
// [n_recs, 2] (group, launch-local pipeline slot); R rows per thread (1, 2
// or 4), Lt byte columns per row tile.
int cko_scan_flat(ScanPipes pipes, int B, int L, int Lt, int R, const void* tab,
                  const void* recs, const void* grp_info, const void* mend, const void* always,
                  int smem_tab_bytes, int smem, int n_recs, void* out, int G, void* stream) {
  if (B <= 0 || G <= 0 || n_recs <= 0) return 0;
  const int rows = kThreads * R;
  dim3 grid((B + rows - 1) / rows, n_recs);
  cudaStream_t st = (cudaStream_t)stream;
  const int16_t* t = (const int16_t*)tab;
  const int32_t* rc = (const int32_t*)recs;
  const int32_t* gi = (const int32_t*)grp_info;
  const uint8_t* me = (const uint8_t*)mend;
  const uint8_t* al = (const uint8_t*)always;
  uint8_t* o = (uint8_t*)out;
  int err;
  switch (R) {
    case 1:
      if ((err = allow_smem(flat_kernel<1>, g_smem_flat[0], smem)) != 0) return err;
      flat_kernel<1><<<grid, kThreads, smem, st>>>(pipes, B, L, Lt, t, rc, gi, me, al, smem_tab_bytes, o, G);
      break;
    case 2:
      if ((err = allow_smem(flat_kernel<2>, g_smem_flat[1], smem)) != 0) return err;
      flat_kernel<2><<<grid, kThreads, smem, st>>>(pipes, B, L, Lt, t, rc, gi, me, al, smem_tab_bytes, o, G);
      break;
    case 4:
      if ((err = allow_smem(flat_kernel<4>, g_smem_flat[2], smem)) != 0) return err;
      flat_kernel<4><<<grid, kThreads, smem, st>>>(pipes, B, L, Lt, t, rc, gi, me, al, smem_tab_bytes, o, G);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* cko_error_string(int code) {
  if (code == kErrTooManyCards) return "the card's number is past the launcher's per-card caches (kMaxCards)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
