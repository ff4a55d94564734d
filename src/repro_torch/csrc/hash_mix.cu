// hash_mix — fused 64-bit triple-key mixing on Hopper (sm_90a).
//
// Replaces: the Pallas kernel repro/kernels/hash_mix.py::hash_mix (its body
// `_kernel`), reached through repro/kernels/ops.py::fused_hash_mix.
//
// Computes exactly repro.core.hashing.mix64 over W word rows: two murmur3
// accumulator lanes seeded from the 64-bit salt, each absorbing every word,
// then the sequential cross-lane avalanche and the remap of the reserved
// EMPTY/EMPTY pair.  words uint32[W, n] (row-major) -> hi, lo uint32[n].
//
// Bound on an H100: the integer ALU pipe and device memory, close to each
// other.  It reads n*4*W bytes and writes n*8, so n*(4W+8) bytes at
// 3.35 TB/s; the compiled loop issues about 37 ALU instructions per word
// (LOP3, SHF, IADD3; the multiplies go to the FMA pipe as IMAD), and the ALU
// pipe retires 64 a clock on each SM, so at W=5 the ALU term is the larger
// (chip_smoke.py counts both from the compiled code).  Design: one thread
// per element over a grid-stride loop, so neighbouring threads load
// neighbouring words of each row (coalesced words[w*n + i]) and store
// neighbouring keys; W is a template parameter (1..8), so the fold is
// unrolled and every lane stays in registers; no shared memory.
//
// C interface (bound with ctypes): hash_mix_launch returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 32;  // 32 blocks per SM, then stride

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t combine32(uint32_t acc, uint32_t word) {
  const uint32_t w = fmix32(word);
  return fmix32(acc ^ (w + kGolden + (acc << 6) + (acc >> 2)));
}

template <int W>
__global__ void __launch_bounds__(kThreads)
hash_mix_kernel(const uint32_t* __restrict__ words, long long n,
                uint32_t seed_hi, uint32_t seed_lo,
                uint32_t* __restrict__ out_hi, uint32_t* __restrict__ out_lo) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t hi = seed_hi;
    uint32_t lo = seed_lo;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t x = __ldg(words + (long long)w * n + i);
      hi = combine32(hi, x);
      lo = combine32(lo, x ^ kGolden);
    }
    const uint32_t hi2 = fmix32(hi ^ (lo >> 1));
    uint32_t lo2 = fmix32(lo ^ hi2);
    if (hi2 == kEmpty && lo2 == kEmpty) lo2 = kEmpty - 1;  // keep EMPTY reserved
    out_hi[i] = hi2;
    out_lo[i] = lo2;
  }
}

template <int W>
void launch(const uint32_t* words, long long n, uint32_t shi, uint32_t slo,
            uint32_t* hi, uint32_t* lo, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  hash_mix_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(words, n, shi, slo,
                                                                hi, lo);
}

}  // namespace

extern "C" int hash_mix_launch(const void* words, int n_words, long long n,
                               unsigned long long salt, void* out_hi,
                               void* out_lo, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_words < 1 || n_words > 8 || n < 1) return (int)cudaErrorInvalidValue;
  const uint32_t shi = fmix32(0x243F6A88u ^ (uint32_t)(salt & 0xFFFFFFFFull));
  const uint32_t slo = fmix32(0x13198A2Eu ^ (uint32_t)(salt >> 32));
  const uint32_t* w = static_cast<const uint32_t*>(words);
  uint32_t* hi = static_cast<uint32_t*>(out_hi);
  uint32_t* lo = static_cast<uint32_t*>(out_lo);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 1: launch<1>(w, n, shi, slo, hi, lo, s); break;
    case 2: launch<2>(w, n, shi, slo, hi, lo, s); break;
    case 3: launch<3>(w, n, shi, slo, hi, lo, s); break;
    case 4: launch<4>(w, n, shi, slo, hi, lo, s); break;
    case 5: launch<5>(w, n, shi, slo, hi, lo, s); break;
    case 6: launch<6>(w, n, shi, slo, hi, lo, s); break;
    case 7: launch<7>(w, n, shi, slo, hi, lo, s); break;
    default: launch<8>(w, n, shi, slo, hi, lo, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
