// scan_join — the serving fast path's fused scan-join chain on Hopper
// (sm_90a).
//
// Replaces: the Pallas kernel repro/kernels/scan_join.py::pallas_scan_join
// (grid=(batch,), one program per query running `chain_query`), reached
// through repro/serve/fastpath.py on backends that compile Pallas.
//
// Computes, for each query b of a batch (one packed int32 row of qbuf:
// the (R, 3) constants, a valid flag, a limit), the chain of R <= 3
// pattern readers over the store's sorted indexes:
//   stage 0  two binary searches on the reader's split 63-bit keys
//            (khi, klo), seeded by the primary term's row range
//            prim_start[t] .. prim_start[t+1] when the primary is bound,
//            with exactly `rounds` iterations and the lo < hi guard; the
//            bound columns are gathered for rows j < caps[0];
//   stage k  for every left row i < caps[k-1], that row's seeded range
//            (count 0 past the left count n); an inclusive prefix sum of
//            the counts; output row j < caps[k] belongs to the left row
//            upper_bound(cum, j) and gathers the carried columns and the
//            reader's new ones; rows past min(total, cap) are -1;
//   tail     the projected columns, invalid rows keyed INT32_MAX, sorted
//            lexicographically over every output column (a bitonic sort:
//            capacities are powers of two; every column is a key, so equal
//            keys are identical rows and an unstable sort gives the stable
//            sort's table), invalid rows reset to -1, the limit applied.
// Outputs: n_out columns [B, caps[R-1]], counts [B] and needed [B, R]
// (the exact rows each stage wanted; the wrapper takes the max over B).
//
// Bound on an H100: at batch <= 64 it is latency, not bytes or operations.
// Stage 0 is a chain of `rounds` dependent loads per search (about 21 at
// 1M rows, or the primary term's few rounds when seeded), and each bind
// stage adds a chain of prim_rounds loads per left row; the bytes the
// searches touch (a few 32-byte sectors of khi/klo per round), the gathered
// columns and the outputs are kilobytes a query.
//
// Design (simple first): one block of 256 threads per query, so a batch of
// 64 fills at most 64 of the 132 SMs.  Stage 0's lower and upper searches
// run on two threads of different warps; a bind stage gives each thread
// left rows (strided) and scans their counts in chunks of 256 with warp
// shuffles and a carried total, since caps[k-1] can exceed shared memory.
// The chain's columns live in global scratch, ping-ponged between stages
// (per query: 2 * n_cols + 2 columns of capmax ints).  The tail sorts in
// shared memory when n_out * cap fits 32 KB, else in place in the output.
//
// C interface (bound with ctypes): scan_join_launch returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxReaders = 3;
constexpr int kMaxCols = 12;
constexpr int kMaxOut = 16;
constexpr int kSortSmem = 8192;  // ints of the shared-memory sort (32 KB)
constexpr int kI32Max = 0x7FFFFFFF;
constexpr int kNumPtrs = 6 * kMaxReaders + 4 + kMaxOut;
constexpr int kIntsPerReader = 15;
constexpr int kNumInts = 9 + kIntsPerReader * kMaxReaders + kMaxOut;
constexpr int kConst = 0, kBound = 1, kWild = 2;

struct Reader {
  const int* khi;
  const int* klo;
  const int* col[3];
  const int* prim;
  int src_kind[3];
  int src_arg[3];
  int n_out;
  int out_j[3];
  int out_col[3];
  int prim_rounds;
  int n_terms;  // prim has n_terms + 1 entries
};

struct Chain {
  Reader rd[kMaxReaders];
  const int* qbuf;
  int* counts;
  int* needed;
  int* scratch;
  int* outs[kMaxOut];
  int n_readers, n_cols, n_out, key_bits, rounds, store_n;
  int caps[kMaxReaders];
  int out_cols[kMaxOut];
  long long capmax;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int32 add with two's-complement wrap, as the JAX int32 arithmetic does
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ unsigned field(int x, int bits) {
  // clip BEFORE the +1; -1 packs to field 0, below every real id
  return (unsigned)clampi(x, -1, (1 << bits) - 2) + 1u;
}

// scan_join.py::pack_bound: the split 63-bit key of a bound triple
__device__ __forceinline__ void pack_bound(int q0, int q1, int q2, int bits,
                                           int& qhi, int& qlo) {
  const unsigned f0 = field(q0, bits), f1 = field(q1, bits), f2 = field(q2, bits);
  const unsigned hi = (f0 << (2 * bits - 32)) | (f1 >> (32 - bits));
  const unsigned lo = ((f1 & ((1u << (32 - bits)) - 1u)) << bits) | f2;
  qhi = (int)hi;
  qlo = (int)(lo ^ 0x80000000u);
}

// scan_join.py::lex_search2.  The JAX loop runs `rounds` times; once
// lo >= hi no round changes lo or hi, so leaving then gives the same
// answer.
__device__ int lex_search2(const int* __restrict__ khi,
                           const int* __restrict__ klo, int n, int qhi,
                           int qlo, bool upper, int rounds, int lo, int hi) {
  const int last = n - 1 > 0 ? n - 1 : 0;
  for (int r = 0; r < rounds && lo < hi; ++r) {
    const int mid = lo + ((hi - lo) >> 1);
    const int g = clampi(mid, 0, last);
    const int mhi = __ldg(khi + g), mlo = __ldg(klo + g);
    const bool tail = upper ? (mlo <= qlo) : (mlo < qlo);
    const bool before = (mhi < qhi) || (mhi == qhi && tail);
    if (before) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// one of the reader's bounds: index-order position j's lower (or upper)
// value, from a constant, the chain column `cur` at `row`, or a wildcard
__device__ __forceinline__ int bound_at(const Reader& r, int j, bool upper,
                                        const int* q, const int* cur,
                                        long long cm, int row) {
  const int kind = r.src_kind[j], arg = r.src_arg[j];
  if (kind == kConst) return q[arg];
  if (kind == kBound) return cur[arg * cm + row];
  return upper ? kI32Max : -1;
}

// scan_join.py::_reader_range, one side: the lower (upper=false) or upper
// end of the reader's range for one query row
__device__ int reader_end(const Chain& ch, const Reader& r, bool upper,
                          const int* q, const int* cur, long long cm, int row) {
  int qhi, qlo;
  pack_bound(bound_at(r, 0, upper, q, cur, cm, row),
             bound_at(r, 1, upper, q, cur, cm, row),
             bound_at(r, 2, upper, q, cur, cm, row), ch.key_bits, qhi, qlo);
  if (r.src_kind[0] == kWild)
    return lex_search2(r.khi, r.klo, ch.store_n, qhi, qlo, upper, ch.rounds,
                       0, ch.store_n);
  const int primary = bound_at(r, 0, false, q, cur, cm, row);
  if (primary < 0) return 0;  // unknown constant / pad row / unbound left
  const int T = r.n_terms;
  const int g0 = clampi(primary, 0, T - 1 > 0 ? T - 1 : 0);
  return lex_search2(r.khi, r.klo, ch.store_n, qhi, qlo, upper, r.prim_rounds,
                     __ldg(r.prim + g0), __ldg(r.prim + g0 + 1));
}

// -1 / 0 / +1: row i against row p, lexicographically over the columns
__device__ __forceinline__ int cmp_rows(int* const* cols, int n_out, int i,
                                        int p) {
  for (int t = 0; t < n_out; ++t) {
    const int a = cols[t][i], b = cols[t][p];
    if (a != b) return a < b ? -1 : 1;
  }
  return 0;
}

__device__ void bitonic_sort_rows(int* const* cols, int n_out, int cap) {
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < cap; i += kThreads) {
        const int p = i ^ stride;
        if (p > i) {
          const int c = cmp_rows(cols, n_out, i, p);
          if ((i & size) == 0 ? c > 0 : c < 0) {
            for (int t = 0; t < n_out; ++t) {
              const int x = cols[t][i];
              cols[t][i] = cols[t][p];
              cols[t][p] = x;
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads) scan_join_kernel(const Chain ch) {
  __shared__ int s_end[2];
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_carry;
  __shared__ int s_sort[kSortSmem];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int R = ch.n_readers;
  const int* q = ch.qbuf + (long long)b * (3 * R + 2);
  const bool qvalid = q[3 * R] != 0;
  const int qlimit = q[3 * R + 1];
  const long long cm = ch.capmax;
  int* cur = ch.scratch + (long long)b * (2 * ch.n_cols + 2) * cm;
  int* nxt = cur + ch.n_cols * cm;
  int* cum = cur + 2 * ch.n_cols * cm;
  int* los = cum + cm;
  unsigned have = 0;  // chain columns bound so far (the same in every thread)

  // ---- stage 0: the scan's range, then its bound columns
  const Reader& r0 = ch.rd[0];
  if (tid == 0) s_end[0] = reader_end(ch, r0, false, q, cur, cm, 0);
  if (tid == 32) s_end[1] = reader_end(ch, r0, true, q, cur, cm, 0);
  __syncthreads();
  const int lo0 = s_end[0];
  const int count = qvalid ? s_end[1] - lo0 : 0;
  int cap = ch.caps[0];
  for (int j = tid; j < cap; j += kThreads) {
    const bool valid = j < count;
    const int r = clampi(wrap_add(lo0, j), 0, ch.store_n - 1);
    for (int o = 0; o < r0.n_out; ++o)
      cur[r0.out_col[o] * cm + j] = valid ? __ldg(r0.col[r0.out_j[o]] + r) : -1;
  }
  for (int o = 0; o < r0.n_out; ++o) have |= 1u << r0.out_col[o];
  int n = count < cap ? count : cap;
  if (tid == 0) ch.needed[(long long)b * R] = count;
  __syncthreads();

  // ---- bind stages
  for (int k = 1; k < R; ++k) {
    const Reader& rk = ch.rd[k];
    const int* qk = q + 3 * k;
    const int cl = ch.caps[k - 1];
    if (tid == 0) s_carry = 0;
    __syncthreads();
    for (int base = 0; base < cl; base += kThreads) {
      const int i = base + tid;
      int c = 0;
      if (i < cl) {
        const int lo = reader_end(ch, rk, false, qk, cur, cm, i);
        const int hi = reader_end(ch, rk, true, qk, cur, cm, i);
        los[i] = lo;
        c = i < n ? hi - lo : 0;
      }
      // inclusive block scan of c (int32 with wrap, as jnp.cumsum)
      unsigned v = (unsigned)c;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(0xFFFFFFFFu, v, off);
        if (lane >= off) v += t;
      }
      if (lane == 31) s_warp[warp] = v;
      __syncthreads();
      if (warp == 0) {
        unsigned w = lane < kWarps ? s_warp[lane] : 0u;
        for (int off = 1; off < kWarps; off <<= 1) {
          const unsigned t = __shfl_up_sync(0xFFFFFFFFu, w, off);
          if (lane >= off) w += t;
        }
        if (lane < kWarps) s_warp[lane] = w;
      }
      __syncthreads();
      const unsigned incl = v + (warp > 0 ? s_warp[warp - 1] : 0u) + s_carry;
      if (i < cl) cum[i] = (int)incl;
      __syncthreads();  // every thread has read s_carry
      if (tid == kThreads - 1) s_carry = incl;
      __syncthreads();
    }
    const int total = (int)s_carry;
    cap = ch.caps[k];
    const int lim = total < cap ? total : cap;
    for (int j = tid; j < cap; j += kThreads) {
      // searchsorted(cum, j, side="right"): the left rows with cum <= j
      int a = 0, z = cl;
      while (a < z) {
        const int m = (a + z) >> 1;
        if (cum[m] <= j) a = m + 1;
        else z = m;
      }
      const int rowc = clampi(a, 0, cl - 1);
      const int prev = rowc > 0 ? cum[rowc - 1] : 0;
      const int rr = clampi(wrap_add(los[rowc], j - prev), 0, ch.store_n - 1);
      const bool valid = j < lim;
      for (int col = 0; col < ch.n_cols; ++col)
        if (have & (1u << col))
          nxt[col * cm + j] = valid ? cur[col * cm + rowc] : -1;
      for (int o = 0; o < rk.n_out; ++o)
        nxt[rk.out_col[o] * cm + j] = valid ? __ldg(rk.col[rk.out_j[o]] + rr) : -1;
    }
    for (int o = 0; o < rk.n_out; ++o) have |= 1u << rk.out_col[o];
    int* t = cur;
    cur = nxt;
    nxt = t;
    n = lim;
    if (tid == 0) ch.needed[(long long)b * R + k] = total;
    __syncthreads();
  }

  // ---- tail: project, sort over every output column, limit
  const int n_out = ch.n_out;
  if (n_out > 0) {
    const bool in_smem = (long long)n_out * cap <= kSortSmem;
    int* cols[kMaxOut];
    for (int t = 0; t < n_out; ++t)
      cols[t] = in_smem ? s_sort + t * cap : ch.outs[t] + (long long)b * cap;
    for (int j = tid; j < cap; j += kThreads) {
      for (int t = 0; t < n_out; ++t) {
        const int col = ch.out_cols[t];
        const int v = (col >= 0 && (have & (1u << col))) ? cur[col * cm + j] : -1;
        cols[t][j] = j < n ? v : kI32Max;
      }
    }
    __syncthreads();
    bitonic_sort_rows(cols, n_out, cap);
    for (int j = tid; j < cap; j += kThreads)
      for (int t = 0; t < n_out; ++t)
        ch.outs[t][(long long)b * cap + j] = j < n ? cols[t][j] : -1;
  }
  if (tid == 0) ch.counts[b] = (qlimit >= 0 && qlimit < n) ? qlimit : n;
}

}  // namespace

extern "C" int scan_join_launch(const unsigned long long* ptrs, int n_ptrs,
                                const int* ints, int n_ints, int batch,
                                long long capmax, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_ptrs != kNumPtrs || n_ints != kNumInts || batch < 1 || capmax < 2)
    return (int)cudaErrorInvalidValue;
  Chain ch = {};
  const int* in = ints;
  ch.n_readers = in[0];
  ch.n_cols = in[1];
  ch.n_out = in[2];
  ch.key_bits = in[3];
  ch.rounds = in[4];
  ch.store_n = in[5];
  if (ch.n_readers < 1 || ch.n_readers > kMaxReaders || ch.n_cols < 0 ||
      ch.n_cols > kMaxCols || ch.n_out < 0 || ch.n_out > kMaxOut ||
      ch.key_bits < 16 || ch.key_bits > 31 || ch.store_n < 1 || ch.rounds < 0)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < kMaxReaders; ++k) {
    ch.caps[k] = in[6 + k];
    if (k < ch.n_readers &&
        (ch.caps[k] < 2 || (ch.caps[k] & (ch.caps[k] - 1)) || ch.caps[k] > capmax))
      return (int)cudaErrorInvalidValue;
  }
  in += 9;
  for (int k = 0; k < kMaxReaders; ++k, in += kIntsPerReader) {
    Reader& r = ch.rd[k];
    const unsigned long long* p = ptrs + 6 * k;
    r.khi = reinterpret_cast<const int*>(p[0]);
    r.klo = reinterpret_cast<const int*>(p[1]);
    for (int j = 0; j < 3; ++j) r.col[j] = reinterpret_cast<const int*>(p[2 + j]);
    r.prim = reinterpret_cast<const int*>(p[5]);
    for (int j = 0; j < 3; ++j) {
      r.src_kind[j] = in[j];
      r.src_arg[j] = in[3 + j];
    }
    r.n_out = in[6];
    for (int j = 0; j < 3; ++j) {
      r.out_j[j] = in[7 + j];
      r.out_col[j] = in[10 + j];
    }
    r.prim_rounds = in[13];
    r.n_terms = in[14];
    if (k >= ch.n_readers) continue;
    if (r.n_out < 0 || r.n_out > 3 || r.n_terms < 1 || r.prim_rounds < 0)
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j) {
      const int kind = r.src_kind[j], arg = r.src_arg[j];
      if ((kind == kConst && (arg < 0 || arg > 2)) ||
          (kind == kBound && (k == 0 || arg < 0 || arg >= ch.n_cols)) ||
          kind < kConst || kind > kWild)
        return (int)cudaErrorInvalidValue;
    }
    for (int o = 0; o < r.n_out; ++o)
      if (r.out_j[o] < 0 || r.out_j[o] > 2 || r.out_col[o] < 0 ||
          r.out_col[o] >= ch.n_cols)
        return (int)cudaErrorInvalidValue;
  }
  for (int t = 0; t < kMaxOut; ++t) {
    ch.out_cols[t] = in[t];
    if (t < ch.n_out && ch.out_cols[t] >= ch.n_cols)
      return (int)cudaErrorInvalidValue;
  }
  const unsigned long long* p = ptrs + 6 * kMaxReaders;
  ch.qbuf = reinterpret_cast<const int*>(p[0]);
  ch.counts = reinterpret_cast<int*>(p[1]);
  ch.needed = reinterpret_cast<int*>(p[2]);
  ch.scratch = reinterpret_cast<int*>(p[3]);
  for (int t = 0; t < kMaxOut; ++t) ch.outs[t] = reinterpret_cast<int*>(p[4 + t]);
  ch.capmax = capmax;
  scan_join_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(ch);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
