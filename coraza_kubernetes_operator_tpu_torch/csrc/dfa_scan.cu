// Stacked-DFA row scans for Hopper (sm_90a): the three scan kernels of the
// serving path. The dense and flat scans share one device routine
// (dfa_scan_kernel, behind launch()); the dfa-hot gather banks of a whole
// tier run in one launch of their own kernel (gather_tier_kernel, see its
// note below).
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
// bank planners admit).
//
// What bounds it on this card: each step is a dependent shared-memory
// lookup (the next step's address needs this step's result), so one
// (row, group) chain runs at the shared-memory latency and throughput comes
// from many independent chains in flight; the ceiling is the shared-memory
// pipe, 32 lookups per SM per clock. The bytes are few: one read of the
// [L, B] transposed byte array per group, coalesced because neighbouring
// threads walk neighbouring rows. Design: grid (row blocks, groups); each
// block stages its group's table in shared memory once, then each thread
// walks whole rows with the state in a register, stopping at the row's
// length. The
// byte loads do not depend on the state, so they are issued kUnroll at a
// time ahead of the dependent lookups, which keeps the global-memory
// latency off the chain. A group whose table exceeds the block's
// shared-memory budget (fused flat bins admit S up to a few thousand)
// reads it from global memory (L2) inside the same kernel.

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxPipes = 8;  // pipelines one gather launch reads

// The gather launch's pipeline inputs, passed by value (no device array).
struct GatherPipes {
  const uint8_t* data[kMaxPipes];   // [B, L] per pipeline slot
  const int32_t* lens[kMaxPipes];   // [B]
};

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kGRows = 128;          // rows per gather block
constexpr int kGStride = kGRows + 4; // bytes between byte positions of the class tile

__global__ void __launch_bounds__(kThreads)
dfa_scan_kernel(const uint8_t* __restrict__ dataT,   // [P, L, B]
                const int32_t* __restrict__ lens,    // [P, B]
                int L, int B,
                const int16_t* __restrict__ tab_all, // concatenated [256, S_g] tables
                const int64_t* __restrict__ tab_off, // [G] element offset of each table
                const int32_t* __restrict__ n_states,// [G]
                const int32_t* __restrict__ pipe,    // [G] pipeline index, or null (all 0)
                const uint8_t* __restrict__ mend_all,// concatenated [S_g] end-match flags
                const int64_t* __restrict__ mend_off,// [G]
                const uint8_t* __restrict__ always,  // [G]
                int smem_tab_bytes,                  // shared bytes reserved for a table
                int latch_end,                       // 1: end check on the state at len-1
                uint8_t* __restrict__ out,           // [B, G]
                int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.y;
  const int S = n_states[g];
  const int64_t tab_elems = (int64_t)256 * S;
  const int16_t* tab = tab_all + tab_off[g];
  int16_t* s_tab = reinterpret_cast<int16_t*>(smem);

  if (tab_elems * 2 <= (int64_t)smem_tab_bytes) {
    for (int64_t i = threadIdx.x; i < tab_elems; i += blockDim.x) s_tab[i] = tab[i];
    tab = s_tab;
  }
  __syncthreads();

  const int p = pipe != nullptr ? pipe[g] : 0;
  const uint8_t* dT = dataT + (int64_t)p * L * B;
  const int32_t* ln = lens + (int64_t)p * B;
  const uint8_t* mend = mend_all + mend_off[g];
  const int always_g = always[g];

  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < B;
       row += gridDim.x * blockDim.x) {
    const int len = ln[row];
    const int n = len < L ? len : L;
    int state = 0;
    int matched = 0;
    auto step = [&](int byte) {
      const int v = tab[byte * S + state];
      const int hit = v >= S;
      matched |= hit;
      state = v - (hit ? S : 0);
    };
    const uint8_t* col = dT + row;
    int t = 0;
    for (; t + kUnroll <= n; t += kUnroll) {
      int b[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) b[k] = col[(int64_t)(t + k) * B];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) step(b[k]);
    }
    for (; t < n; ++t) step(col[(int64_t)t * B]);
    // The dense and gather scans latch the end state at t == len - 1, so a
    // length past the buffer leaves it at the start state; the flat scan
    // checks the state after the last step.
    const int end_state = (latch_end && len > L) ? 0 : state;
    out[(int64_t)row * G + g] = (matched | mend[end_state] | always_g) ? 1 : 0;
  }
}

int launch(const void* dataT, const void* lens, int L, int B, const void* tab,
           const void* tab_off, const void* n_states, const void* pipe,
           const void* mend, const void* mend_off, const void* always,
           int smem, int latch_end, void* out, int G, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      dfa_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // Enough blocks for a few waves over the SMs; more row blocks would only
  // re-stage the same tables.
  const int row_blocks_max = (B + kThreads - 1) / kThreads;
  int row_blocks = (4 * sms + G - 1) / G;
  if (row_blocks > row_blocks_max) row_blocks = row_blocks_max;
  if (row_blocks < 1) row_blocks = 1;
  dim3 grid(row_blocks, G);
  dfa_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)dataT, (const int32_t*)lens, L, B, (const int16_t*)tab,
      (const int64_t*)tab_off, (const int32_t*)n_states, (const int32_t*)pipe,
      (const uint8_t*)mend, (const int64_t*)mend_off, (const uint8_t*)always,
      smem, latch_end, (uint8_t*)out, G);
  return (int)cudaGetLastError();
}

// The dfa-hot gather tier: every gather bank of a model in one launch.
//
// The reference launches one Pallas kernel per bank because its banks are
// cut to the TPU's VMEM budget; on Hopper a bank's whole table is 288 B to
// 28 KB (crs-lite), so one launch covers the tier and the per-bank host
// work (a transpose of the data, an allocation, a ctypes call, attribute
// and device queries) goes away. Grid (row tiles of kGRows, banks). A
// block stages its bank's 256-entry byte -> class map and its groups'
// int16 [C, S] tables in shared memory with 16-byte copies (each bank's
// tables start 16-byte aligned; tables too large for the reserve stay in
// global memory, read through L2), reads its row tile of the bank's
// pipeline [B, L] row-major as it is, in 16-byte loads where the rows
// allow, and maps each byte to its class once (stored transposed, so the
// lanes of a warp, neighbouring rows, read neighbouring bytes). Then each
// thread walks (row, group) pairs of the bank over that class sequence,
// one dependent shared-memory lookup per byte. Rows longer than the tile's
// Lt columns (L = 2048) walk in column chunks, the states kept in shared
// memory between chunks; chunks past every row's length are skipped.
// cp.async is not used: the staging is a few KB per block against the
// dependent walk. What bounds it: the dependent lookups (the shared-memory
// pipe); the bytes are each pipeline's rows once per bank.

__global__ void __launch_bounds__(kThreads)
gather_tier_kernel(GatherPipes pipes, int B, int L, int Lt,
                   const int16_t* __restrict__ tab,        // banks' tables, concatenated
                   const int32_t* __restrict__ bank_info,  // [NB, 5]
                   const int32_t* __restrict__ grp_info,   // [G, 3]
                   const uint8_t* __restrict__ mend,       // concatenated [S] per group
                   const uint8_t* __restrict__ always,     // [G]
                   const uint8_t* __restrict__ cmaps,      // [NB, 256]
                   const uint8_t* __restrict__ on,         // [G]
                   int smem_tab_bytes, int gmax, uint8_t* __restrict__ out, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bank = blockIdx.y;
  const int g0 = bank_info[5 * bank], ng = bank_info[5 * bank + 1];
  const int toff = bank_info[5 * bank + 2], telems = bank_info[5 * bank + 3];
  const int slot = bank_info[5 * bank + 4];
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
  int16_t* s_state = reinterpret_cast<int16_t*>(s_cls + ((Lt * kGStride + 15) & ~15));
  uint8_t* s_match = reinterpret_cast<uint8_t*>(s_state) + ((kGRows * gmax * 2 + 15) & ~15);
  int* s_maxn = reinterpret_cast<int*>(s_match + ((kGRows * gmax + 15) & ~15));

  const int16_t* tb = tab + toff;
  if (telems * 2 <= smem_tab_bytes) {
    const uint4* src = reinterpret_cast<const uint4*>(tb);
    uint4* dst = reinterpret_cast<uint4*>(s_tab);
    for (int i = tid; i < (telems * 2 + 15) / 16; i += kThreads) dst[i] = src[i];
    tb = s_tab;
  }
  for (int i = tid; i < 256; i += kThreads) s_cmap[i] = cmaps[bank * 256 + i];
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
        for (int k = 0; k < 16; ++k) s_cls[(ch * 16 + k) * kGStride + r] = s_cmap[u.b[k]];
      }
    } else {
      for (int i = tid; i < nrows * cl; i += kThreads) {
        const int r = i / cl;
        const int k = i - r * cl;
        s_cls[k * kGStride + r] = s_cmap[data[(int64_t)(r0 + r) * L + c0 + k]];
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

int g_gather_smem_set = 48 * 1024;  // dynamic shared memory gather_tier_kernel may use

}  // namespace

extern "C" {

// Dense byte-indexed bank: tables [G][256][S].
int cko_scan_dense(const void* dataT, const void* lens, int L, int B,
                   const void* tab, const void* tab_off, const void* n_states,
                   const void* mend, const void* mend_off, const void* always,
                   int smem_tab_bytes, void* out, int G, void* stream) {
  return launch(dataT, lens, L, B, tab, tab_off, n_states, nullptr,
                mend, mend_off, always, smem_tab_bytes, 1,
                out, G, stream);
}

// Every joint-byte-class bank of a tier in one launch: per pipeline slot
// its [B, L] bytes and [B] lengths (by value), the banks' tables and class
// maps, per-group records and on/off flags; Lt byte columns per row tile,
// smem the block's shared bytes (smem_tab_bytes of them for a table).
int cko_scan_gather(GatherPipes pipes, int B, int L, int Lt, const void* tab,
                    const void* bank_info, const void* grp_info, const void* mend,
                    const void* always, const void* cmaps, const void* on,
                    int smem_tab_bytes, int smem, int n_banks, int gmax, void* out,
                    int G, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  if (smem > g_gather_smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_tier_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    g_gather_smem_set = smem;
  }
  dim3 grid((B + kGRows - 1) / kGRows, n_banks);
  gather_tier_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      pipes, B, L, Lt, (const int16_t*)tab, (const int32_t*)bank_info,
      (const int32_t*)grp_info, (const uint8_t*)mend, (const uint8_t*)always,
      (const uint8_t*)cmaps, (const uint8_t*)on, smem_tab_bytes, gmax, (uint8_t*)out, G);
  return (int)cudaGetLastError();
}

// Fused flat bin: per-group tables [256][S_g], per-group pipeline data.
int cko_scan_flat(const void* dataT, const void* lens, int L, int B,
                  const void* tab, const void* tab_off, const void* n_states,
                  const void* mend, const void* mend_off, const void* always,
                  const void* pipe, int smem_tab_bytes, void* out, int G,
                  void* stream) {
  return launch(dataT, lens, L, B, tab, tab_off, n_states, pipe, mend,
                mend_off, always, smem_tab_bytes, 0, out, G, stream);
}

const char* cko_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
