// Stacked-DFA row scans for Hopper (sm_90a): the three scan kernels of the
// serving path, one shared device routine behind three C launchers.
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
// block stages its group's table (and, for the gather kernel, the 256-entry
// byte -> class map) in shared memory once, then each thread walks whole
// rows with the state in a register, stopping at the row's length. The
// byte loads do not depend on the state, so they are issued kUnroll at a
// time ahead of the dependent lookups, which keeps the global-memory
// latency off the chain. A group whose table exceeds the block's
// shared-memory budget (fused flat bins admit S up to a few thousand)
// reads it from global memory (L2) inside the same kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <bool kClassmap>
__global__ void __launch_bounds__(kThreads)
dfa_scan_kernel(const uint8_t* __restrict__ dataT,   // [P, L, B]
                const int32_t* __restrict__ lens,    // [P, B]
                int L, int B,
                const int16_t* __restrict__ tab_all, // concatenated [R, S_g] tables
                const int64_t* __restrict__ tab_off, // [G] element offset of each table
                const int32_t* __restrict__ n_states,// [G]
                const int32_t* __restrict__ pipe,    // [G] pipeline index, or null (all 0)
                const uint8_t* __restrict__ mend_all,// concatenated [S_g] end-match flags
                const int64_t* __restrict__ mend_off,// [G]
                const uint8_t* __restrict__ always,  // [G]
                const uint8_t* __restrict__ classmap,// [256] byte -> class (kClassmap)
                int n_rows_tab,                      // R: 256 (byte rows) or C (classes)
                int smem_tab_bytes,                  // shared bytes reserved for a table
                int latch_end,                       // 1: end check on the state at len-1
                uint8_t* __restrict__ out,           // [B, G]
                int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.y;
  const int S = n_states[g];
  const int64_t tab_elems = (int64_t)n_rows_tab * S;
  const int16_t* tab = tab_all + tab_off[g];
  int16_t* s_tab = reinterpret_cast<int16_t*>(smem);
  uint8_t* s_cls = smem + smem_tab_bytes;

  if (tab_elems * 2 <= (int64_t)smem_tab_bytes) {
    for (int64_t i = threadIdx.x; i < tab_elems; i += blockDim.x) s_tab[i] = tab[i];
    tab = s_tab;
  }
  if (kClassmap) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) s_cls[i] = classmap[i];
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
      const int r = kClassmap ? (int)s_cls[byte] : byte;
      const int v = tab[r * S + state];
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

template <bool kClassmap>
int launch(const void* dataT, const void* lens, int L, int B, const void* tab,
           const void* tab_off, const void* n_states, const void* pipe,
           const void* mend, const void* mend_off, const void* always,
           const void* classmap, int n_rows_tab, int smem_tab_bytes,
           int latch_end, void* out, int G, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  const int smem = smem_tab_bytes + (kClassmap ? 256 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      dfa_scan_kernel<kClassmap>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  dfa_scan_kernel<kClassmap><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)dataT, (const int32_t*)lens, L, B, (const int16_t*)tab,
      (const int64_t*)tab_off, (const int32_t*)n_states, (const int32_t*)pipe,
      (const uint8_t*)mend, (const int64_t*)mend_off, (const uint8_t*)always,
      (const uint8_t*)classmap, n_rows_tab, smem_tab_bytes, latch_end,
      (uint8_t*)out, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dense byte-indexed bank: tables [G][256][S].
int cko_scan_dense(const void* dataT, const void* lens, int L, int B,
                   const void* tab, const void* tab_off, const void* n_states,
                   const void* mend, const void* mend_off, const void* always,
                   int smem_tab_bytes, void* out, int G, void* stream) {
  return launch<false>(dataT, lens, L, B, tab, tab_off, n_states, nullptr,
                       mend, mend_off, always, nullptr, 256, smem_tab_bytes, 1,
                       out, G, stream);
}

// Joint-byte-class bank: classmap [256] and tables [G][C][S].
int cko_scan_gather(const void* dataT, const void* lens, int L, int B,
                    const void* tab, const void* tab_off, const void* n_states,
                    const void* mend, const void* mend_off, const void* always,
                    const void* classmap, int n_classes, int smem_tab_bytes,
                    void* out, int G, void* stream) {
  return launch<true>(dataT, lens, L, B, tab, tab_off, n_states, nullptr, mend,
                      mend_off, always, classmap, n_classes, smem_tab_bytes, 1,
                      out, G, stream);
}

// Fused flat bin: per-group tables [256][S_g], per-group pipeline data.
int cko_scan_flat(const void* dataT, const void* lens, int L, int B,
                  const void* tab, const void* tab_off, const void* n_states,
                  const void* mend, const void* mend_off, const void* always,
                  const void* pipe, int smem_tab_bytes, void* out, int G,
                  void* stream) {
  return launch<false>(dataT, lens, L, B, tab, tab_off, n_states, pipe, mend,
                       mend_off, always, nullptr, 256, smem_tab_bytes, 0, out,
                       G, stream);
}

const char* cko_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
