// nested_join — the naive engine's all-pairs equality join on Hopper
// (sm_90a).
//
// Replaces: the Pallas kernel repro/kernels/nested_join.py::nested_join (its
// body `_kernel`), reached through repro/kernels/ops.py::blocked_nested_join;
// the same function as repro/core/naive.py::nested_loop_join, which the JAX
// engine's naive OJM calls.
//
// Computes, for every child row i of child_keys int32[m], the parent
// subjects whose key equals child_keys[i], in parent index order:
// out[i, c] for c < min(count_i, K) holds the c-th matching parent subject,
// the rest of the row is -1, and counts[i] is the number of matches
// (possibly more than K; the wrapper derives `valid` and `truncated`).
// Parent rows are parent_keys / parent_subjects int32[n].  Nothing matches
// padding: the ragged edge of the last parent tile is masked by its length
// and rows past m do no work (the Pallas kernel pads both sides with -1).
//
// Bound on an H100: operations.  It does m*n integer compares, at 64 a
// clock on each SM's ALU pipe; the bytes the function must move (4m + 8n
// read; the int32 subjects and the bool valid mask, 5*m*K, written) are a
// small term at the engine's shapes (1M x 1M rows, K = 85: 10^12 compares,
// about 60 ms, against 0.43 GB, about 0.13 ms).
//
// Design (simple first; ROADMAP lists the faster redesign): one thread per
// child row, kRows rows a CTA; the thread keeps its key and its fill cursor
// in registers.  The CTA streams the parent (key, subject) pairs through
// shared memory in tiles of kTile, loaded coalesced by all threads; every
// thread then scans the tile in order, so all lanes of a warp read the
// same word (a broadcast, no bank conflict) and a row's matches arrive in
// parent order across tiles.  One shared-memory read, one compare and one
// branch a pair; a match at cursor c < K stores out[row*K + c] (row*K in
// 64 bits).  Each thread pads its own row with -1 at the end.
//
// C interface (bound with ctypes): nested_join_launch returns a
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;   // child rows a CTA, one a thread
constexpr int kTile = 2048;  // parent pairs a shared-memory tile (16 KB)

__global__ void __launch_bounds__(kRows)
nested_join_kernel(const int* __restrict__ child_keys,
                   const int* __restrict__ parent_keys,
                   const int* __restrict__ parent_subjects, long long m,
                   long long n, int K, int* __restrict__ out,
                   int* __restrict__ counts) {
  __shared__ int s_key[kTile];
  __shared__ int s_subj[kTile];

  const long long row = (long long)blockIdx.x * kRows + threadIdx.x;
  const bool live = row < m;
  const int key = live ? child_keys[row] : 0;
  int* orow = out + (live ? row : 0) * (long long)K;
  int cnt = 0;

  for (long long base = 0; base < n; base += kTile) {
    const int len = (int)((n - base) < kTile ? (n - base) : kTile);
    __syncthreads();  // the previous tile is scanned by every thread
    for (int j = threadIdx.x; j < len; j += kRows) {
      s_key[j] = __ldg(parent_keys + base + j);
      s_subj[j] = __ldg(parent_subjects + base + j);
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        if (s_key[j] == key) {
          if (cnt < K) orow[cnt] = s_subj[j];
          ++cnt;
        }
      }
    }
  }
  if (live) {
    for (int c = cnt; c < K; ++c) orow[c] = -1;
    counts[row] = cnt;
  }
}

}  // namespace

extern "C" int nested_join_launch(const void* parent_keys,
                                  const void* parent_subjects,
                                  const void* child_keys, long long n,
                                  long long m, int K, void* out, void* counts,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 1 || n < 0 || n > 0x7FFFFFFFLL || K < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (m + kRows - 1) / kRows;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  nested_join_kernel<<<(unsigned)blocks, kRows, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(child_keys), static_cast<const int*>(parent_keys),
      static_cast<const int*>(parent_subjects), m, n, K,
      static_cast<int*>(out), static_cast<int*>(counts));
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
