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
// Design: one CTA of 512 threads per partition; two CTAs fit on an SM.
// - The table stays in device memory and is probed in place: a probe reads
//   its slot's (hi, lo) with ld.global.cg (L2, coherent with this CTA's own
//   writes after a barrier; never the non-coherent path), and a winner
//   writes its key straight into the table.  No slot is staged, so a
//   launch touches only the sectors its keys probe; the SOM table (16.8 MB)
//   stays in the 50 MB L2 across a predicate's launches.
// - Claims live in shared memory, one int32 a slot (kSlice slots, 64 KB,
//   bounds the slice a CTA takes), set to kNoClaim once a launch.  After a
//   round only the claimed slots are reset, each by its winner.
// - The lanes are walked once: a vectorised pass reads the partition's
//   valid flags (16 a thread) and compacts the valid lanes into a list
//   (warp-aggregated places from a shared counter); the is_new row is
//   zeroed.  Each entry keeps the lane's original index, its key and its
//   state; the first kList entries live in shared memory, the rest (a
//   dense partition) as bare lane indices in a global scratch row, their
//   keys re-read from the inputs.  A list of kSortMin entries or more is
//   sorted by the slot range of its first probe, so that a warp's probes
//   and its winners' stores fall on neighbouring sectors.  The list's order
//   does not matter: claims key on the original lane index (atomicMin), so
//   the lowest lane wins whatever thread holds it.  A bare atomicCAS on the
//   table slot would let any lane win and give a different table from the
//   reference.
// - Each round walks the list, skipping done entries, in the reference's
//   three phases: (1) read the occupant; found -> duplicate; empty ->
//   atomicMin(&claim[slot], lane); (2) the lowest claimer writes its key and
//   is_new and releases its claim, a key equal to the EMPTY pair that lost
//   its slot is a duplicate; (3) losers re-read their slot for a same-key
//   twin.  A barrier ends (1) and one ends (2); (3) shares a pass with the
//   next round's (1), whose reads follow every write of this round's (2)
//   and whose claims follow every release, and its __syncthreads_or
//   decides whether another round runs; its last value is the partition's
//   overflow flag.
//
// C interface (bound with ctypes): bucket_dedup_launch returns a
// cudaError_t; bucket_dedup_ctas_per_sm reports the occupancy.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSlice = 16384;  // largest table slice (slots): the claim array
constexpr int kList = 3072;    // compacted lanes a CTA keeps in shared memory
constexpr int kThreads = 512;
constexpr int kPer = kList / kThreads;  // shared entries a thread sorts
constexpr int kBuckets = 256;  // slot ranges the first round's probes sort into
constexpr int kSortMin = 2 * kThreads;  // shared entries worth the sort
static_assert(kList % kThreads == 0 && kBuckets % 32 == 0 && kBuckets <= kThreads, "");
constexpr int kUnroll = 4;  // 16-byte flag loads in flight a thread
constexpr int kMaxProbeRounds = 64;  // hashset.MAX_PROBE_ROUNDS
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kNoClaim = INT_MAX;
// An entry's word: its lane index (below kClaimed) and a state.
constexpr uint32_t kDone = 1u << 31;     // found, inserted or a duplicate
constexpr uint32_t kClaimed = 1u << 30;  // claimed an empty slot this round
constexpr uint32_t kLane = kClaimed - 1u;

__device__ __forceinline__ int probe_slot(uint32_t hi, uint32_t lo, uint32_t r,
                                          uint32_t mask) {
  const uint32_t base = lo & mask;
  const uint32_t step = ((hi | 1u) & mask) | 1u;  // odd: coprime with cap
  return (int)((base + r * step) & mask);
}

__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((x & 0xFFu) != 0) | (((x >> 8) & 0xFFu) != 0) << 1 |
         (((x >> 16) & 0xFFu) != 0) << 2 | ((x >> 24) != 0) << 3;
}

// Valid flags of the 16 lanes of chunk k as a bit mask: the chunk is the
// k-th aligned 16 bytes from (row - a), so the row's first and last chunks
// may hold lanes outside [0, len).
__device__ __forceinline__ uint32_t chunk_flags(const uint8_t* __restrict__ row,
                                                int k, int a, int len) {
  const int first = 16 * k - a;
  if (first >= len) return 0;
  if (first >= 0 && first + 16 <= len) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + first));
    return nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 | nonzero_bytes(v.z) << 8 |
           nonzero_bytes(v.w) << 12;
  }
  uint32_t m = 0;
  for (int j = 0; j < 16; ++j) {
    const int l = first + j;
    if (l >= 0 && l < len && row[l]) m |= 1u << j;
  }
  return m;
}

__device__ __forceinline__ void zero_row(uint8_t* row, int len, int tid) {
  const int head = min(len, (int)((16u - ((uintptr_t)row & 15u)) & 15u));
  const int n16 = (len - head) >> 4;
  uint4* body = reinterpret_cast<uint4*>(row + head);
  for (int i = tid; i < head; i += kThreads) row[i] = 0;
  for (int i = tid; i < n16; i += kThreads) body[i] = make_uint4(0, 0, 0, 0);
  for (int i = head + 16 * n16 + tid; i < len; i += kThreads) row[i] = 0;
}

// The partition's compacted lanes: entry i < cap in shared memory (key and
// word), entry i >= cap as a word in the global scratch row, its key read
// from the inputs by lane index.
struct LaneList {
  uint32_t* hi;
  uint32_t* lo;
  uint32_t* word;
  uint32_t* spill;
  const uint32_t* __restrict__ khi;
  const uint32_t* __restrict__ klo;
  int cap;

  __device__ __forceinline__ uint32_t get(int i) const {
    return i < cap ? word[i] : spill[i - cap];
  }
  __device__ __forceinline__ void set(int i, uint32_t w) const {
    if (i < cap) word[i] = w; else spill[i - cap] = w;
  }
  __device__ __forceinline__ void key(int i, uint32_t w, uint32_t& h,
                                      uint32_t& o) const {
    if (i < cap) {
      h = hi[i];
      o = lo[i];
    } else {
      h = __ldg(khi + (w & kLane));
      o = __ldg(klo + (w & kLane));
    }
  }
};

// Round r's probe of an active entry (word w, key h:o): read the occupant;
// found -> done; empty -> claim the slot for the entry's lane.  Returns the
// entry's new word.
__device__ __forceinline__ uint32_t probe(const uint32_t* thi, const uint32_t* tlo,
                                         int* claim, uint32_t w, uint32_t h,
                                         uint32_t o, uint32_t r, uint32_t mask) {
  const int slot = probe_slot(h, o, r, mask);
  const uint32_t oh = __ldcg(thi + slot), ol = __ldcg(tlo + slot);
  if (oh == kEmpty && ol == kEmpty) {
    atomicMin(&claim[slot], (int)w);
    return w | kClaimed;
  }
  return (oh == h && ol == o) ? (w | kDone) : w;
}

__global__ void __launch_bounds__(kThreads, 2)
bucket_dedup_kernel(const uint32_t* __restrict__ keys_hi,
                    const uint32_t* __restrict__ keys_lo,
                    const uint8_t* __restrict__ valid, uint32_t* table_hi,
                    uint32_t* table_lo, uint8_t* is_new, uint8_t* ovf,
                    uint32_t* spill, int part_len, int cap, int list_cap) {
  extern __shared__ uint32_t smem[];
  __shared__ int n_lanes;
  __shared__ int bucket[kBuckets];
  __shared__ int warp_sum[kBuckets / 32];
  int* claim = reinterpret_cast<int*>(smem);
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const size_t koff = (size_t)blockIdx.x * part_len;
  const uint8_t* kval = valid + koff;
  uint8_t* new_row = is_new + koff;
  uint32_t* thi = table_hi + (size_t)blockIdx.x * cap;
  uint32_t* tlo = table_lo + (size_t)blockIdx.x * cap;
  const uint32_t mask = (uint32_t)cap - 1u;
  const LaneList L{smem + cap, smem + cap + list_cap, smem + cap + 2 * list_cap,
                   spill + (size_t)blockIdx.x * (part_len - list_cap),
                   keys_hi + koff, keys_lo + koff, list_cap};

  // the first valid flags are in flight while the claims are set
  const int a = (int)((uintptr_t)kval & 15u);
  const int n_chunks = (a + part_len + 15) >> 4;
  uint32_t flags[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    flags[u] = chunk_flags(kval, u * kThreads + tid, a, part_len);
  // cap is a power of two; below 4 slots the vector loop does nothing
  for (int s = tid; s < (cap >> 2); s += kThreads)
    reinterpret_cast<int4*>(claim)[s] = make_int4(kNoClaim, kNoClaim, kNoClaim, kNoClaim);
  if (tid < (cap & 3)) claim[tid] = kNoClaim;
  if (tid == 0) n_lanes = 0;
  if (tid < kBuckets) bucket[tid] = 0;
  __syncthreads();

  // compact the valid lanes' indices; every thread runs the same trip
  // count, so the warp's votes see all 32 lanes
  for (int k0 = 0; k0 < n_chunks; k0 += kThreads * kUnroll) {
    if (k0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        flags[u] = chunk_flags(kval, k0 + u * kThreads + tid, a, part_len);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!__any_sync(0xFFFFFFFFu, flags[u])) continue;
      // the warp's valid lanes take consecutive places: one shared atomic
      // a warp, then a ballot for each of the 16 lanes of the chunks
      const int total = __reduce_add_sync(0xFFFFFFFFu, __popc(flags[u]));
      int base = 0;
      if (lane_id == 0) base = atomicAdd(&n_lanes, total);
      base = __shfl_sync(0xFFFFFFFFu, base, 0);
      const int first = 16 * (k0 + u * kThreads + tid) - a;
      const uint32_t below = (1u << lane_id) - 1u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool v = flags[u] >> j & 1u;
        const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, v);
        // two predicated stores, not an if/else: a branch nested in this
        // divergent test makes the warp reconverge at every lane
        const int p = base + __popc(ballot & below);
        if (v && p < list_cap) L.word[p] = (uint32_t)(first + j);
        if (v && p >= list_cap) L.spill[p - list_cap] = (uint32_t)(first + j);
        base += __popc(ballot);
      }
    }
  }
  __syncthreads();
  const int n = n_lanes;

  // Read each shared entry's key from the inputs, once.  With kSortMin
  // entries or more, sort them by the slot range of their first probe, so
  // that a warp's round-0 probes and its winners' stores fall on
  // neighbouring sectors (a counting sort into kBuckets ranges); fewer
  // entries stay where they are.  The scratch row's entries stay unsorted.
  const int m = min(n, list_cap);
  const bool sort = m >= kSortMin;
  const int shift = max(0, 23 - __clz(cap));  // log2(cap) - log2(kBuckets)
  uint32_t ew[kPer], eh[kPer], eo[kPer];
  int erank[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kThreads;
    if (i < m) {
      ew[j] = L.word[i];
      eh[j] = __ldg(L.khi + ew[j]);
      eo[j] = __ldg(L.klo + ew[j]);
      if (sort) erank[j] = atomicAdd(&bucket[probe_slot(eh[j], eo[j], 0, mask) >> shift], 1);
    }
  }
  // the is_new row is zeroed before the barriers after which winners write it
  zero_row(new_row, part_len, tid);
  if (sort) {
    __syncthreads();
    int count = 0, incl = 0;
    if (tid < kBuckets) {
      count = incl = bucket[tid];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane_id >= d) incl += v;
      }
      if (lane_id == 31) warp_sum[tid >> 5] = incl;
    }
    __syncthreads();
    if (tid < kBuckets) {
      for (int k = 0; k < (tid >> 5); ++k) incl += warp_sum[k];
      bucket[tid] = incl - count;  // the range's first sorted place
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kThreads;
    if (i < m) {
      const int p =
          sort ? bucket[probe_slot(eh[j], eo[j], 0, mask) >> shift] + erank[j] : i;
      L.hi[p] = eh[j];
      L.lo[p] = eo[j];
      L.word[p] = ew[j];
    }
  }
  __syncthreads();

  // round 0's probes
  int local = 0;
  for (int i = tid; i < n; i += kThreads) {
    const uint32_t w = L.get(i);
    uint32_t h, o;
    L.key(i, w, h, o);
    const uint32_t w1 = probe(thi, tlo, claim, w, h, o, 0, mask);
    if (w1 != w) L.set(i, w1);
    local |= !(w1 & kDone);
  }
  int any = __syncthreads_or(local);
  for (uint32_t r = 0; any; ++r) {
    // the lowest claimer of each slot writes its key and releases the claim
    // (a loser reads the claim before or after the release: either way it
    // is not its own lane)
    for (int i = tid; i < n; i += kThreads) {
      const uint32_t w = L.get(i);
      if (!(w & kClaimed)) continue;
      const uint32_t lane = w & kLane;
      uint32_t h, o;
      L.key(i, w, h, o);
      const int slot = probe_slot(h, o, r, mask);
      if (claim[slot] == (int)lane) {
        thi[slot] = h;
        tlo[slot] = o;
        new_row[lane] = 1;
        claim[slot] = kNoClaim;
        L.set(i, lane | kDone);
      } else if (h == kEmpty && o == kEmpty) {
        L.set(i, lane | kDone);  // a key equal to EMPTY "found" its empty slot
      }
    }
    __syncthreads();
    // losers re-read their slot (a same-key twin won -> duplicate), then
    // every entry still active probes round r + 1
    local = 0;
    for (int i = tid; i < n; i += kThreads) {
      const uint32_t w = L.get(i);
      if (w & kDone) continue;
      const uint32_t lane = w & kLane;
      uint32_t h, o;
      L.key(i, w, h, o);
      if (w & kClaimed) {
        const int slot = probe_slot(h, o, r, mask);
        if (__ldcg(thi + slot) == h && __ldcg(tlo + slot) == o) {
          L.set(i, lane | kDone);
          continue;
        }
      }
      if (r + 1 == (uint32_t)kMaxProbeRounds) {
        local = 1;  // unplaced after the last round
        continue;
      }
      const uint32_t w1 = probe(thi, tlo, claim, lane, h, o, r + 1, mask);
      if (w1 != w) L.set(i, w1);
      local |= !(w1 & kDone);
    }
    any = __syncthreads_or(local);
    if (r + 1 == (uint32_t)kMaxProbeRounds) break;
  }
  if (tid == 0) ovf[blockIdx.x] = any ? 1 : 0;
}

cudaError_t configure(int part_len, int cap, size_t* smem) {
  *smem = ((size_t)cap + 3 * (size_t)min(part_len, kList)) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      bucket_dedup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bucket_dedup_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// spill: uint32[n_parts, spill_len], spill_len = part_len - min(part_len,
// kList) (the caller's LIST); uninitialised, and unused when spill_len is 0.
extern "C" int bucket_dedup_launch(const void* keys_hi, const void* keys_lo,
                                   const void* valid, void* table_hi,
                                   void* table_lo, void* is_new, void* ovf,
                                   void* spill, int n_parts, int part_len,
                                   int cap, int spill_len, void* stream,
                                   int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_parts < 1 || part_len < 1 || part_len > (int)kLane || cap < 1 ||
      cap > kSlice || (cap & (cap - 1)) != 0 ||
      spill_len != part_len - min(part_len, kList))
    return (int)cudaErrorInvalidValue;
  size_t smem;
  err = configure(part_len, cap, &smem);
  if (err != cudaSuccess) return (int)err;
  bucket_dedup_kernel<<<n_parts, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys_hi), static_cast<const uint32_t*>(keys_lo),
      static_cast<const uint8_t*>(valid), static_cast<uint32_t*>(table_hi),
      static_cast<uint32_t*>(table_lo), static_cast<uint8_t*>(is_new),
      static_cast<uint8_t*>(ovf), static_cast<uint32_t*>(spill), part_len, cap,
      min(part_len, kList));
  return (int)cudaGetLastError();
}

// CTAs of the kernel resident on one SM at this shape, or -1 on an error.
extern "C" int bucket_dedup_ctas_per_sm(int part_len, int cap, int device) {
  int blocks = -1;
  size_t smem;
  if (cudaSetDevice(device) != cudaSuccess || configure(part_len, cap, &smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bucket_dedup_kernel,
                                                    kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
