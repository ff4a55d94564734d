// bucket_dedup — radix-partitioned open-addressing PTT insert on Hopper
// (sm_90a).
//
// Replaces: the Pallas kernel repro/kernels/bucket_dedup.py::bucket_dedup
// (its body `_kernel`), driven by repro/kernels/ops.py::radix_dedup_insert.
//
// Computes, for each partition p independently, exactly
// repro.core.hashset.insert_masked of keys[p, :] into the table slice
// table[p, :]: double-hash probing for at most 64 rounds, first-wins with
// the LOWEST lane winning an empty slot, and the losers' twin re-read.
// Inputs keys_hi/keys_lo uint32[n_parts, part_len], valid uint8[n_parts,
// part_len], table_hi/table_lo uint32[n_parts, cap] (updated in place, as the
// Pallas kernel aliases them input -> output).  Outputs is_new
// uint8[n_parts, part_len] and ovf uint8[n_parts] (some lane still unplaced
// after 64 rounds).
//
// Bound on an H100: device memory.  The least traffic the input needs is
// the valid flag and the verdict of every lane (2 bytes), the keys of the
// lanes that hold one (8 bytes), and the 32-byte sectors of the table's hi
// and lo arrays that the probes read and the new keys are written to, at
// 3.35 TB/s.  The arithmetic (a dozen integer operations a probe) is far
// below the integer rate.
//
// Design: one CTA per partition holds its table slice (hi, lo) and an
// int32 claim array — 12 bytes a slot — in dynamic shared memory, the
// counterpart of the TPU's VMEM-resident slice, so no probe reads the table
// in device memory.  Shared memory caps a slice at kSlice = 16384 slots
// (192 KB of the 227 KB a block may use); the engine picks n_parts =
// max(1, capacity / kSlice) so every slice fits.  The cost of the design is
// staging: every launch reads and writes back every slot of every slice
// (16 bytes a slot), whether or not a probe touched it, far more than the
// least traffic when a batch holds few keys per slice.  The
// per-lane keys and states stay in device memory (L2-resident): part_len is
// sized from all lanes of the batch, not from distinct keys, and reaches
// thousands of lanes on the OJM step.  Each round is lock-step across the
// block: read the occupant; found or empty; atomicMin(&claim[slot], lane);
// barrier; the winner (claim == lane) writes its key; barrier; losers
// re-read for the twin check and the claims are reset; the loop ends when
// __syncthreads_or(active) is false.  A bare atomicCAS would let any lane
// win and give a different table from the reference.
//
// C interface (bound with ctypes): bucket_dedup_launch returns a
// cudaError_t.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSlice = 16384;  // largest table slice (slots) a CTA holds
constexpr int kThreads = 1024;
constexpr int kMaxProbeRounds = 64;  // hashset.MAX_PROBE_ROUNDS
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kNoClaim = INT_MAX;
// lane states, kept in the is_new buffer until the final pass
constexpr uint8_t kActive = 0;
constexpr uint8_t kDup = 1;  // done, not new (or invalid)
constexpr uint8_t kNew = 2;  // done, inserted by this lane

__device__ __forceinline__ int probe_slot(uint32_t hi, uint32_t lo, uint32_t r,
                                          uint32_t mask) {
  const uint32_t base = lo & mask;
  const uint32_t step = ((hi | 1u) & mask) | 1u;  // odd: coprime with cap
  return (int)((base + r * step) & mask);
}

__global__ void __launch_bounds__(kThreads)
bucket_dedup_kernel(const uint32_t* __restrict__ keys_hi,
                    const uint32_t* __restrict__ keys_lo,
                    const uint8_t* __restrict__ valid, uint32_t* table_hi,
                    uint32_t* table_lo, uint8_t* is_new, uint8_t* ovf,
                    int part_len, int cap) {
  extern __shared__ uint32_t smem[];
  uint32_t* s_hi = smem;
  uint32_t* s_lo = smem + cap;
  int* claim = reinterpret_cast<int*>(smem + 2 * cap);

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t koff = (size_t)blockIdx.x * part_len;
  const size_t toff = (size_t)blockIdx.x * cap;
  const uint32_t* khi = keys_hi + koff;
  const uint32_t* klo = keys_lo + koff;
  const uint8_t* kval = valid + koff;
  uint8_t* st = is_new + koff;
  uint32_t* thi = table_hi + toff;
  uint32_t* tlo = table_lo + toff;
  const uint32_t mask = (uint32_t)cap - 1u;

  for (int s = tid; s < cap; s += nt) {
    s_hi[s] = thi[s];
    s_lo[s] = tlo[s];
    claim[s] = kNoClaim;
  }
  int local = 0;
  for (int l = tid; l < part_len; l += nt) {
    const uint8_t a = kval[l] ? kActive : kDup;
    st[l] = a;
    local |= (a == kActive);
  }
  int any = __syncthreads_or(local);

  for (uint32_t r = 0; any && r < (uint32_t)kMaxProbeRounds; ++r) {
    // 1-3: read the occupant; found -> duplicate; empty -> claim (lowest lane)
    for (int l = tid; l < part_len; l += nt) {
      if (st[l] != kActive) continue;
      const uint32_t h = khi[l], o = klo[l];
      const int slot = probe_slot(h, o, r, mask);
      const uint32_t oh = s_hi[slot], ol = s_lo[slot];
      if (oh == kEmpty && ol == kEmpty) {
        atomicMin(&claim[slot], l);
      } else if (oh == h && ol == o) {
        st[l] = kDup;
      }
    }
    __syncthreads();
    // 4-5: the winner of each claimed slot writes its key
    for (int l = tid; l < part_len; l += nt) {
      if (st[l] != kActive) continue;
      const uint32_t h = khi[l], o = klo[l];
      const int slot = probe_slot(h, o, r, mask);
      const int c = claim[slot];
      if (c == l) {
        s_hi[slot] = h;
        s_lo[slot] = o;
        st[l] = kNew;
      } else if (c != kNoClaim && h == kEmpty && o == kEmpty) {
        st[l] = kDup;  // a key equal to EMPTY "found" its empty slot
      }
    }
    __syncthreads();
    // 6-7: losers re-read (a same-key twin won -> duplicate); reset claims
    local = 0;
    for (int l = tid; l < part_len; l += nt) {
      if (st[l] != kActive) continue;
      const uint32_t h = khi[l], o = klo[l];
      const int slot = probe_slot(h, o, r, mask);
      if (s_hi[slot] == h && s_lo[slot] == o) {
        st[l] = kDup;
      } else {
        local = 1;
      }
    }
    for (int s = tid; s < cap; s += nt) claim[s] = kNoClaim;
    any = __syncthreads_or(local);
  }

  for (int s = tid; s < cap; s += nt) {
    thi[s] = s_hi[s];
    tlo[s] = s_lo[s];
  }
  local = 0;
  for (int l = tid; l < part_len; l += nt) {
    const uint8_t a = st[l];
    local |= (a == kActive);
    st[l] = (a == kNew) ? 1 : 0;
  }
  any = __syncthreads_or(local);
  if (tid == 0) ovf[blockIdx.x] = any ? 1 : 0;
}

}  // namespace

extern "C" int bucket_dedup_launch(const void* keys_hi, const void* keys_lo,
                                   const void* valid, void* table_hi,
                                   void* table_lo, void* is_new, void* ovf,
                                   int n_parts, int part_len, int cap,
                                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_parts < 1 || part_len < 1 || cap < 1 || cap > kSlice ||
      (cap & (cap - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cap * 12;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bucket_dedup_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bucket_dedup_kernel<<<n_parts, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys_hi), static_cast<const uint32_t*>(keys_lo),
      static_cast<const uint8_t*>(valid), static_cast<uint32_t*>(table_hi),
      static_cast<uint32_t*>(table_lo), static_cast<uint8_t*>(is_new),
      static_cast<uint8_t*>(ovf), part_len, cap);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
