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
// Design: register blocking, so the loop is one compare a pair.  A thread
// holds R child rows (R = 4 or 2, chosen by the wrapper so the grid
// fills the card): their keys and fill cursors live in registers; a CTA of
// kThreads threads covers kThreads * R rows, row r of thread t being
// cta_row0 + r * kThreads + t (a warp's rows contiguous for each r).  The
// CTA streams the parents through shared memory in tiles of kTile, keys
// and subjects in separate arrays, double-buffered: cp.async brings tile
// t + 1 while tile t is scanned, one barrier a tile.  The scan reads the
// keys 16 bytes at a time (one LDS.128 for 4 parents, a broadcast: every
// lane reads the same word) and compares the 4 parents with the R keys in
// two independent chains of predicated compares (setp.eq.or, ISETP on the
// ALU pipe) OR-ed at the end, then branches once for the 4 * R pairs.
// Only a hit (rare: a child key matches a few of the n parents) takes the
// slow path, which walks the 4 parents in index order and appends
// each matching subject at its row's cursor: parent order holds inside a
// group, groups and tiles are scanned in order.  The launch fills the
// output with -1 (cudaMemsetAsync), so the kernel writes only matches and
// counts.  Parent padding (n % 4 in the last tile) repeats the tile's last
// key, so a hit there is a hit of a real parent too, and the slow path
// masks it by the tile's length; rows past m repeat the key of row m - 1
// and are masked by the row count.
//
// C interface (bound with ctypes): nested_join_launch returns a
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;  // a CTA: two warps, so 16 CTAs share an SM
constexpr int kTile = 512;    // parents a shared-memory tile (2 x 2 x 2 KB)

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One parent group against the thread's rows: 1 if any of the 4 parent
// keys p equals any of the R row keys k.  Two chains of setp.eq.or (rows
// [0, R/2) and [R/2, R)) keep the dependent predicate chain half as long.
#define NJ_EQ(h, k, p) "setp.eq.s32 " h ", " k ", " p ";\n"
#define NJ_OR(h, k, p) "setp.eq.or.s32 " h ", " k ", " p ", " h ";\n"
#define NJ_ROW(h, k, p0, p1, p2, p3) \
  NJ_OR(h, k, p0) NJ_OR(h, k, p1) NJ_OR(h, k, p2) NJ_OR(h, k, p3)

template <int R>
__device__ __forceinline__ unsigned any_eq(const int (&k)[R], int4 p);

template <>
__device__ __forceinline__ unsigned any_eq<2>(const int (&k)[2], int4 p) {
  unsigned hit;
  asm("{\n.reg .pred ha, hb;\n"
      NJ_EQ("ha", "%1", "%3") NJ_OR("ha", "%1", "%4") NJ_OR("ha", "%1", "%5")
      NJ_OR("ha", "%1", "%6")
      NJ_EQ("hb", "%2", "%3") NJ_OR("hb", "%2", "%4") NJ_OR("hb", "%2", "%5")
      NJ_OR("hb", "%2", "%6")
      "or.pred ha, ha, hb;\n"
      "selp.u32 %0, 1, 0, ha;\n}"
      : "=r"(hit)
      : "r"(k[0]), "r"(k[1]), "r"(p.x), "r"(p.y), "r"(p.z), "r"(p.w));
  return hit;
}

template <>
__device__ __forceinline__ unsigned any_eq<4>(const int (&k)[4], int4 p) {
  unsigned hit;
  asm("{\n.reg .pred ha, hb;\n"
      NJ_EQ("ha", "%1", "%5") NJ_OR("ha", "%1", "%6") NJ_OR("ha", "%1", "%7")
      NJ_OR("ha", "%1", "%8") NJ_ROW("ha", "%2", "%5", "%6", "%7", "%8")
      NJ_EQ("hb", "%3", "%5") NJ_OR("hb", "%3", "%6") NJ_OR("hb", "%3", "%7")
      NJ_OR("hb", "%3", "%8") NJ_ROW("hb", "%4", "%5", "%6", "%7", "%8")
      "or.pred ha, ha, hb;\n"
      "selp.u32 %0, 1, 0, ha;\n}"
      : "=r"(hit)
      : "r"(k[0]), "r"(k[1]), "r"(k[2]), "r"(k[3]), "r"(p.x), "r"(p.y),
        "r"(p.z), "r"(p.w));
  return hit;
}

#undef NJ_ROW
#undef NJ_OR
#undef NJ_EQ

// Queue tile `t` (parents [t * kTile, ...)) into buffer slot s_key/s_subj,
// padding its length to a multiple of 4 with its last key.
__device__ __forceinline__ void load_tile(const int* __restrict__ parent_keys,
                                          const int* __restrict__ parent_subjects,
                                          long long n, long long t, int* s_key,
                                          int* s_subj) {
  const long long base = t * kTile;
  const int len = (int)((n - base) < kTile ? (n - base) : kTile);
  for (int j = threadIdx.x; j < len; j += kThreads) {
    cp_async4(s_key + j, parent_keys + base + j);
    cp_async4(s_subj + j, parent_subjects + base + j);
  }
  const int pad = ((len + 3) & ~3) - len;
  if ((int)threadIdx.x < pad) s_key[len + threadIdx.x] = __ldg(parent_keys + base + len - 1);
  cp_async_commit();
}

template <int R>
__global__ void __launch_bounds__(kThreads, 16)
nested_join_kernel(const int* __restrict__ child_keys,
                   const int* __restrict__ parent_keys,
                   const int* __restrict__ parent_subjects, long long m,
                   long long n, int K, int* __restrict__ out,
                   int* __restrict__ counts) {
  __shared__ __align__(16) int s_key[2][kTile];
  __shared__ int s_subj[2][kTile];

  const long long row0 = (long long)blockIdx.x * (kThreads * R) + threadIdx.x;
  // rows of this thread below m: a prefix of its R rows
  const long long left = m - row0;
  const int live = left <= 0 ? 0 : (left > (long long)(R - 1) * kThreads
                                        ? R : (int)((left + kThreads - 1) / kThreads));
  int key[R], cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = row0 + (long long)r * kThreads;
    key[r] = __ldg(child_keys + (row < m ? row : m - 1));
    cnt[r] = 0;
  }

  const long long n_tiles = (n + kTile - 1) / kTile;
  if (n_tiles > 0) load_tile(parent_keys, parent_subjects, n, 0, s_key[0], s_subj[0]);
  for (long long t = 0; t < n_tiles; ++t) {
    const int buf = (int)(t & 1);
    cp_async_wait_all();
    // tile t has landed in every thread's copies, and every thread has
    // scanned tile t - 1, whose buffer the next copy overwrites
    __syncthreads();
    if (t + 1 < n_tiles)
      load_tile(parent_keys, parent_subjects, n, t + 1, s_key[buf ^ 1], s_subj[buf ^ 1]);
    const long long base = t * kTile;
    const int len = (int)((n - base) < kTile ? (n - base) : kTile);
    const int4* k4 = reinterpret_cast<const int4*>(s_key[buf]);
    const int n_groups = (len + 3) >> 2;
#pragma unroll 4
    for (int g = 0; g < n_groups; ++g) {
      const int4 p = k4[g];
      if (any_eq<R>(key, p)) {
        // rare: walk the 4 parents in index order
        const int pk[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * g + q;
          if (j >= len) break;
          const int subj = s_subj[buf][j];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if (r < live && key[r] == pk[q]) {
              if (cnt[r] < K)
                out[(row0 + (long long)r * kThreads) * K + cnt[r]] = subj;
              ++cnt[r];
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < live) counts[row0 + (long long)r * kThreads] = cnt[r];
}

template <int R>
cudaError_t launch_rows(const int* ck, const int* pk, const int* ps,
                        long long m, long long n, int K, int* out, int* counts,
                        cudaStream_t stream) {
  const long long blocks = (m + kThreads * R - 1) / (kThreads * R);
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  nested_join_kernel<R><<<(unsigned)blocks, kThreads, 0, stream>>>(
      ck, pk, ps, m, n, K, out, counts);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nested_join_launch(const void* parent_keys,
                                  const void* parent_subjects,
                                  const void* child_keys, long long n,
                                  long long m, int K, int rows_per_thread,
                                  void* out, void* counts, void* stream,
                                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m < 1 || n < 0 || n > 0x7FFFFFFFLL || K < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // -1 everywhere: the kernel writes only the matches
  err = cudaMemsetAsync(out, 0xFF, (size_t)m * (size_t)K * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int* ck = static_cast<const int*>(child_keys);
  const int* pk = static_cast<const int*>(parent_keys);
  const int* ps = static_cast<const int*>(parent_subjects);
  int* o = static_cast<int*>(out);
  int* c = static_cast<int*>(counts);
  switch (rows_per_thread) {
    case 2: return (int)launch_rows<2>(ck, pk, ps, m, n, K, o, c, s);
    case 4: return (int)launch_rows<4>(ck, pk, ps, m, n, K, o, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
