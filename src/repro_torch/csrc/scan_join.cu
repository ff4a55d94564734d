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
//            with exactly `rounds` iterations and the lo < hi guard (the
//            kernel finds the same row: see the precondition below); the
//            bound columns are gathered for rows j < caps[0];
//   stage k  for every left row i < caps[k-1], that row's seeded range
//            (count 0 past the left count n); an inclusive prefix sum of
//            the counts; output row j < caps[k] belongs to the left row
//            upper_bound(cum, j) and gathers the carried columns and the
//            reader's new ones; rows past min(total, cap) are -1;
//   tail     the projected columns, invalid rows keyed INT32_MAX, sorted
//            lexicographically over every output column (every column is a
//            key, so equal keys are identical rows and an unstable sort
//            gives the stable sort's table), invalid rows reset to -1, the
//            limit applied.
// Outputs: n_out columns [B, caps[R-1]], counts [B] and needed [B, R]
// (the exact rows each stage wanted; the wrapper takes the max over B);
// and, when its pointer is not null, stage0_loads [B, 2]: the dependent
// global loads each query's lower and upper stage-0 search made (the
// primary term's range when seeded, then one a round), as counted.
//
// Precondition of the searches: every search's round count covers its
// window, rounds >= bit_length(hi - lo).  The JAX bisection then always
// ends at the window's partition point (the first row that is not
// `before` the bound, or hi), which is a function of the window alone, so
// any search that finds that point gives its answer: a k-ary search, or a
// bisection that leaves once lo >= hi.  ChainSpec.rounds is
// bit_length(store_n) and ReaderSpec.prim_rounds is bit_length of the
// widest primary-term range (serve/fastpath.py, kg/store.py); the launch
// refuses rounds below bit_length(store_n), and the wrapper's
// check_search_rounds refuses a spec whose prim_rounds fall short.
//
// Bound on an H100: at batch <= 64 it is latency, not bytes or operations.
// A query is a chain of dependent loads: stage 0's search (about 21
// bisection rounds over a 1M-row window), each bind stage's per-row seeded
// searches, the gathers; the bytes the searches touch (a few 32-byte
// sectors of khi/klo per round), the gathered columns and the outputs are
// kilobytes a query.
//
// Design: one block of 256 threads per query (a batch of 64 fills at most
// 64 of the 132 SMs; several queries a block would raise occupancy, not cut
// latency).  What it does about the chain:
//   * Stage 0's lower and upper searches each take a warp (warps 0 and 1)
//     and search 33-ary: each round every lane probes one of 32 pivots
//     lo + (l + 1) * w / 33 of the window [lo, hi) (w = hi - lo); the
//     probes' `before` bits form a prefix, so __ballot_sync and __popc give
//     the sub-window, at most w / 33 wide.  A 1M-row window takes 4 rounds
//     (each one dependent khi/klo load) where the bisection takes 20-21.
//     More pivots a lane would cut rounds but multiply each round's
//     scattered loads, which then queue in the memory system.
//   * A bind stage gives each left row a group of G lanes, as many as 256
//     threads allow for its n left rows (32 up to 8 rows, 16 up to 16, 8
//     up to 32, 4 up to 64, else 2).  The row's lower and upper searches
//     share the primary term's window: one of at most G rows is probed
//     whole in one round (both ends from the same loads); a wider one is
//     searched by the group's halves, one end each, (G/2 + 1)-ary.  The
//     bind readers' primary-term ranges at the serving benchmark's 1M
//     stores are under 32 rows, so a bind stage of up to 8 left rows takes
//     one round where a thread's bisection took up to 5 for each end; that
//     round also loads the reader's new columns of the window's rows, so
//     the stage's gather reads shared memory.  Rows past the left count are
//     not searched (their count is 0 and no output row reads their start).
//   * The readers' fields are copied to shared memory during stage 0 for
//     the bind stages: every step of a search chain reads them, and a
//     constant-cache miss on a kernel parameter costs an L2 trip.
//   * The chain's columns, ping-ponged between stages, and the count prefix
//     sums and range starts (2 * n_cols + 2 columns of capmax ints) live in
//     shared memory when they fit kChainSmemInts (every shape the serving
//     benchmark reaches), else in global scratch (per query); the kernel is
//     compiled for each, so shared columns are addressed as shared.
//   * A bind stage of at most 32 left rows scans their counts on one warp
//     (one barrier), more in chunks of 256 with a carried total.
//   * The tail ranks when cap <= 32: lane j holds output row j's columns
//     in registers, counts the valid rows before it (all lanes read row i
//     at once, a broadcast) and writes its row there: n steps that depend
//     on nothing but the loads, where a shuffle network has
//     log2(cap)(log2(cap)+1)/2 dependent exchanges; warp 0 counts alone,
//     with no barrier.
//     Above 32 a block-wide bitonic sort runs in shared memory when
//     n_out * cap fits kSortSmemInts, else in place in the output.  Every
//     column is a sort key, so equal keys are identical rows and any sort
//     gives the stable sort's table.
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
constexpr int kChainSmemInts = 12288;  // 48 KB: the chain's columns on chip
constexpr int kSortSmemInts = 8192;    // 32 KB: the block-wide sort's rows
constexpr int kWarpSortCap = 32;       // caps up to this sort by ranks
constexpr int kI32Max = 0x7FFFFFFF;
constexpr int kNumPtrs = 6 * kMaxReaders + 5 + kMaxOut;
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
  int* scratch;  // global chain columns, when they do not fit on chip
  int* stage0_loads;  // null, or [B, 2] stage-0 search loads
  int* outs[kMaxOut];
  int n_readers, n_cols, n_out, key_bits, rounds, store_n;
  int caps[kMaxReaders];
  int out_cols[kMaxOut];
  long long capmax;
  int chain_in_smem;  // the chain's columns at the start of shared memory
  int sort_in_smem;   // the block-wide sort's rows in shared memory
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

// is the index row with split key (mhi, mlo) lexicographically before the
// packed bound?
__device__ __forceinline__ bool before_key(int mhi, int mlo, int qhi, int qlo,
                                           bool upper) {
  const bool tail = upper ? (mlo <= qlo) : (mlo < qlo);
  return (mhi < qhi) || (mhi == qhi && tail);
}

__device__ __forceinline__ bool before_row(const int* __restrict__ khi,
                                           const int* __restrict__ klo, int g,
                                           int qhi, int qlo, bool upper) {
  return before_key(__ldg(khi + g), __ldg(klo + g), qhi, qlo, upper);
}

// The partition point of [lo, hi) (the first row not `before` the bound,
// or hi), searched by an aligned group of G lanes (1 to 32) that all call
// it with the same arguments: rounds of G pivots, pivot l = lo + (l + 1) *
// w / (G + 1) (w = hi - lo) on lane l, until the window is empty.  The
// pivots are nondecreasing and `before` holds on a prefix of the sorted
// index, so the ballot's set bits are the group's lowest c lanes and the
// point lies in (pivot c-1, pivot c].  With G = 1 it is the bisection of
// scan_join.py::lex_search2, which ends there too (its remaining rounds
// change nothing once lo >= hi).  `rounds` gets the rounds it took.
template <int G>
__device__ __forceinline__ int group_search(const int* __restrict__ khi,
                                            const int* __restrict__ klo,
                                            int qhi, int qlo, bool upper,
                                            int lo, int hi, int& rounds) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int first = lane & ~(G - 1);
  const unsigned gmask = G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << first;
  rounds = 0;
  while (lo < hi) {
    const unsigned w = (unsigned)(hi - lo);
    const int g = lo + (int)((unsigned long long)(gl + 1) * w / (G + 1));
    const bool b = before_row(khi, klo, g, qhi, qlo, upper);
    const int c = __popc(__ballot_sync(gmask, b) & gmask);
    const int nlo = c > 0 ? lo + (int)((unsigned long long)c * w / (G + 1)) + 1 : lo;
    hi = c < G ? lo + (int)((unsigned long long)(c + 1) * w / (G + 1)) : hi;
    lo = nlo;
    ++rounds;
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

// scan_join.py::_reader_range, one side, up to the search: the packed
// bound and the window [lo, hi); false for an empty range (a negative
// primary: unknown constant / pad row / unbound left)
struct Window {
  int qhi, qlo, lo, hi;
};

__device__ __forceinline__ bool reader_window(const Chain& ch, const Reader& r, bool upper,
                              const int* q, const int* cur, long long cm,
                              int row, Window& w) {
  pack_bound(bound_at(r, 0, upper, q, cur, cm, row),
             bound_at(r, 1, upper, q, cur, cm, row),
             bound_at(r, 2, upper, q, cur, cm, row), ch.key_bits, w.qhi, w.qlo);
  if (r.src_kind[0] == kWild) {
    w.lo = 0;
    w.hi = ch.store_n;
    return true;
  }
  const int primary = bound_at(r, 0, false, q, cur, cm, row);
  if (primary < 0) return false;
  const int T = r.n_terms;
  const int g0 = clampi(primary, 0, T - 1 > 0 ? T - 1 : 0);
  w.lo = __ldg(r.prim + g0);
  w.hi = __ldg(r.prim + g0 + 1);
  return true;
}

// the lower (upper=false) or upper end of a stage-0 reader's range, searched
// by a warp; `loads` gets the dependent global loads on its way
__device__ __forceinline__ int reader_end_warp(const Chain& ch, const Reader& r,
                                               bool upper, const int* q, int& loads) {
  Window w;
  loads = 0;
  if (!reader_window(ch, r, upper, q, nullptr, 0, 0, w)) return 0;
  const int e = group_search<32>(r.khi, r.klo, w.qhi, w.qlo, upper, w.lo, w.hi, loads);
  loads += r.src_kind[0] != kWild;  // the primary term's range, loaded first
  return e;
}

// Lanes a left row of a bind stage with n left rows: as many as 256
// threads allow, from 32 down to 2 (scan_join.py::bind_search_lanes).
__device__ __forceinline__ int bind_lanes(int n) {
  return n <= 8 ? 32 : n <= 16 ? 16 : n <= 32 ? 8 : n <= 64 ? 4 : 2;
}

// A bind stage's left rows i < n: the start of each one's range in los[i]
// and its row count in cum[i].  Each row takes a group of G consecutive
// lanes.  Its lower and upper searches share the primary term's window:
// one that fits the group is probed whole in one round (lane l loads row
// lo + l, and the two ballots of `before` count the rows below each end);
// a wider one is searched by the group's halves, the lower end on the
// first G/2 lanes and the upper end on the rest.  When every row fits one
// pass (n * G <= 256), a window probed whole also has the reader's new
// columns of its rows loaded in the same round, into s_pref (slot
// i * G + l, 3 ints), with its first row in s_win0[i] (-1: not loaded), so
// the stage's gather reads them from shared memory.
template <int G>
__device__ __forceinline__ void bind_ranges(const Chain& ch, const Reader& r,
                                            const int* q, const int* cur,
                                            long long cm, int n, int* los,
                                            int* cum, int* s_pref, int* s_win0) {
  constexpr int kRowsPerPass = kThreads / G;
  const bool pref = n <= kRowsPerPass;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int first = lane & ~(G - 1);
  const unsigned gmask = G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u) << first;
  for (int base = 0; base < n; base += kRowsPerPass) {
    const int i = base + (int)threadIdx.x / G;
    Window wl, wu;
    int lo = 0, hi = 0, win0 = -1;
    if (i < n && reader_window(ch, r, false, q, cur, cm, i, wl) &&
        reader_window(ch, r, true, q, cur, cm, i, wu)) {
      if (wl.hi - wl.lo <= G) {
        const int g = wl.lo + gl;
        bool bl = false, bu = false;
        if (g < wl.hi) {
          const int mhi = __ldg(r.khi + g), mlo = __ldg(r.klo + g);
          bl = before_key(mhi, mlo, wl.qhi, wl.qlo, false);
          bu = before_key(mhi, mlo, wu.qhi, wu.qlo, true);
          if (pref)
            for (int o = 0; o < r.n_out; ++o)
              s_pref[(i * G + gl) * 3 + o] = __ldg(r.col[r.out_j[o]] + g);
        }
        lo = wl.lo + __popc(__ballot_sync(gmask, bl) & gmask);
        hi = wl.lo + __popc(__ballot_sync(gmask, bu) & gmask);
        win0 = wl.lo;
      } else {
        const bool upper = gl >= G / 2;
        const Window& w = upper ? wu : wl;
        int rounds;
        const int e = group_search<G / 2>(r.khi, r.klo, w.qhi, w.qlo, upper, w.lo, w.hi,
                                          rounds);
        lo = __shfl_sync(gmask, e, first);
        hi = __shfl_sync(gmask, e, first + G / 2);
      }
    }
    if (i < n && gl == 0) {
      los[i] = lo;
      cum[i] = hi - lo;
      if (pref) s_win0[i] = win0;
    }
  }
}

// column t of the block-wide sort: in shared memory, or in place in the
// output
__device__ __forceinline__ int* sort_col(const Chain& ch, int* s_sort, int b,
                                         int cap, int t) {
  return ch.sort_in_smem ? s_sort + t * cap : ch.outs[t] + (long long)b * cap;
}

// -1 / 0 / +1: row i against row p, lexicographically over the columns
__device__ __forceinline__ int cmp_rows(const Chain& ch, int* s_sort, int b,
                                        int cap, int i, int p) {
  for (int t = 0; t < ch.n_out; ++t) {
    const int* col = sort_col(ch, s_sort, b, cap, t);
    const int x = col[i], y = col[p];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

__device__ void bitonic_sort_rows(const Chain& ch, int* s_sort, int b, int cap) {
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < cap; i += kThreads) {
        const int p = i ^ stride;
        if (p > i) {
          const int c = cmp_rows(ch, s_sort, b, cap, i, p);
          if ((i & size) == 0 ? c > 0 : c < 0) {
            for (int t = 0; t < ch.n_out; ++t) {
              int* col = sort_col(ch, s_sort, b, cap, t);
              const int x = col[i];
              col[i] = col[p];
              col[p] = x;
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// The tail for cap <= 32, on warp 0: lane j holds output row j's columns
// (invalid rows keyed INT32_MAX) in registers and in the staging table
// s_rows (kMaxOut x 32); row j's place in the sorted table is the number of
// valid rows before it (rows compare lexicographically over the columns;
// equal rows are identical, so ties go by row index).  Every lane reads row
// i at once (a broadcast), so counting takes n steps of n_out compares, no
// exchange and no barrier.  Called by every thread; kCols >= n_out bounds
// the unrolled column loops (a predicated-off column still issues).
template <int kCols>
__device__ __forceinline__ void rank_tail(const Chain& ch, const int* cur,
                                          long long cm, unsigned have, int n,
                                          int cap, int b, int* s_rows) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int n_out = ch.n_out;
  int v[kCols];
#pragma unroll
  for (int t = 0; t < kCols; ++t) {
    if (t < n_out) {
      const int c = ch.out_cols[t];
      v[t] = lane >= n ? kI32Max
                       : (c >= 0 && (have & (1u << c))) ? cur[c * cm + lane] : -1;
      s_rows[t * 32 + lane] = v[t];
    }
  }
  __syncwarp();
  int rank = 0;
  for (int i = 0; i < n; ++i) {
    // column t's verdict at bit kCols - 1 - t: the first differing column
    // is the highest set bit of lt | gt
    unsigned lt = 0, gt = 0;
#pragma unroll
    for (int t = 0; t < kCols; ++t) {
      if (t < n_out) {
        const int x = s_rows[t * 32 + i];
        lt |= (unsigned)(x < v[t]) << (kCols - 1 - t);
        gt |= (unsigned)(x > v[t]) << (kCols - 1 - t);
      }
    }
    rank += lt > gt || (lt == gt && i < lane);
  }
  if (lane < cap) {
    const int at = lane < n ? rank : lane;
#pragma unroll
    for (int t = 0; t < kCols; ++t)
      if (t < n_out) ch.outs[t][(long long)b * cap + at] = lane < n ? v[t] : -1;
  }
}

// kChainSmem: the chain's columns in shared memory (ch.chain_in_smem), so
// the compiler addresses them as shared, not generic
template <bool kChainSmem>
__global__ void __launch_bounds__(kThreads)
scan_join_kernel(const __grid_constant__ Chain ch) {
  extern __shared__ int s_dyn[];
  __shared__ int s_end[2];
  __shared__ unsigned s_warp[kWarps];
  __shared__ unsigned s_carry;
  __shared__ int s_rows[kMaxOut * kWarpSortCap];
  __shared__ Reader s_rd[kMaxReaders];
  __shared__ int s_pref[kThreads * 3];
  __shared__ int s_win0[kThreads / 2];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int R = ch.n_readers;
  const int* q = ch.qbuf + (long long)b * (3 * R + 2);
  const bool qvalid = q[3 * R] != 0;
  const int qlimit = q[3 * R + 1];
  const long long cm = ch.capmax;
  const long long chain_ints = (2LL * ch.n_cols + 2) * cm;
  int* cur = kChainSmem ? s_dyn : ch.scratch + (long long)b * chain_ints;
  int* nxt = cur + ch.n_cols * cm;
  int* cum = cur + 2 * ch.n_cols * cm;
  int* los = cum + cm;
  int* s_sort = s_dyn + (kChainSmem ? chain_ints : 0);
  unsigned have = 0;  // chain columns bound so far (the same in every thread)

  // the readers' fields in shared memory for the bind stages (a search
  // chain reads them at every step, and a constant-cache miss on a kernel
  // parameter is an L2 trip), copied by the warps stage 0 leaves idle
  if (warp >= 2)
    for (int i = tid - 64; i < (int)(sizeof(s_rd) / sizeof(int)); i += kThreads - 64)
      reinterpret_cast<int*>(s_rd)[i] = reinterpret_cast<const int*>(ch.rd)[i];

  // ---- stage 0: the scan's range (a warp a search), then its bound columns
  const Reader& r0 = ch.rd[0];
  if (warp < 2) {
    int loads;
    const int e = reader_end_warp(ch, r0, warp == 1, q, loads);
    if (lane == 0) {
      s_end[warp] = e;
      if (ch.stage0_loads) ch.stage0_loads[2LL * b + warp] = loads;
    }
  }
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
    const Reader& rk = s_rd[k];
    const int* qk = q + 3 * k;
    const int cl = ch.caps[k - 1];
    // each left row's range start (los) and count (cum, scanned below),
    // on search groups as wide as the left row count allows
    const int G = bind_lanes(n);
    const bool pref = n * G <= kThreads;  // as bind_ranges decides
    switch (G) {
      case 32: bind_ranges<32>(ch, rk, qk, cur, cm, n, los, cum, s_pref, s_win0); break;
      case 16: bind_ranges<16>(ch, rk, qk, cur, cm, n, los, cum, s_pref, s_win0); break;
      case 8: bind_ranges<8>(ch, rk, qk, cur, cm, n, los, cum, s_pref, s_win0); break;
      case 4: bind_ranges<4>(ch, rk, qk, cur, cm, n, los, cum, s_pref, s_win0); break;
      default: bind_ranges<2>(ch, rk, qk, cur, cm, n, los, cum, s_pref, s_win0);
    }
    for (int i = n + tid; i < cl; i += kThreads) {
      los[i] = 0;
      cum[i] = 0;
    }
    if (tid == 0) s_carry = 0;
    __syncthreads();
    // inclusive scan of the counts in place, in chunks of kThreads (int32
    // with wrap, as jnp.cumsum)
    if (cl <= 32) {  // one warp, one barrier
      if (warp == 0) {
        unsigned v = lane < cl ? (unsigned)cum[lane] : 0u;
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned t = __shfl_up_sync(0xFFFFFFFFu, v, off);
          if (lane >= off) v += t;
        }
        if (lane < cl) cum[lane] = (int)v;
        if (lane == 31) s_carry = v;
      }
      __syncthreads();
    }
    for (int base = 0; cl > 32 && base < cl; base += kThreads) {
      const int i = base + tid;
      unsigned v = i < cl ? (unsigned)cum[i] : 0u;
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
      const int w0 = valid && pref ? s_win0[rowc] : -1;
      for (int o = 0; o < rk.n_out; ++o)
        nxt[rk.out_col[o] * cm + j] =
            !valid ? -1
            : w0 >= 0 ? s_pref[(rowc * G + rr - w0) * 3 + o]
                      : __ldg(rk.col[rk.out_j[o]] + rr);
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
  if (tid == 0) ch.counts[b] = (qlimit >= 0 && qlimit < n) ? qlimit : n;
  if (n_out > 0 && cap <= kWarpSortCap) {
    if (n_out <= 1) rank_tail<1>(ch, cur, cm, have, n, cap, b, s_rows);
    else if (n_out <= 2) rank_tail<2>(ch, cur, cm, have, n, cap, b, s_rows);
    else if (n_out <= 4) rank_tail<4>(ch, cur, cm, have, n, cap, b, s_rows);
    else if (n_out <= 8) rank_tail<8>(ch, cur, cm, have, n, cap, b, s_rows);
    else rank_tail<16>(ch, cur, cm, have, n, cap, b, s_rows);
  } else if (n_out > 0) {
    for (int j = tid; j < cap; j += kThreads) {
      for (int t = 0; t < n_out; ++t) {
        const int col = ch.out_cols[t];
        const int v = (col >= 0 && (have & (1u << col))) ? cur[col * cm + j] : -1;
        sort_col(ch, s_sort, b, cap, t)[j] = j < n ? v : kI32Max;
      }
    }
    __syncthreads();
    bitonic_sort_rows(ch, s_sort, b, cap);
    for (int j = tid; j < cap; j += kThreads)
      for (int t = 0; t < n_out; ++t)
        ch.outs[t][(long long)b * cap + j] = j < n ? sort_col(ch, s_sort, b, cap, t)[j] : -1;
  }
}

int bit_length(int x) {
  int bits = 0;
  for (unsigned u = (unsigned)x; u; u >>= 1) ++bits;
  return bits;
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
  ch.stage0_loads = reinterpret_cast<int*>(p[4]);
  for (int t = 0; t < kMaxOut; ++t) ch.outs[t] = reinterpret_cast<int*>(p[5 + t]);
  ch.capmax = capmax;
  // the searches' precondition, where the launch can see it
  if (ch.rounds < bit_length(ch.store_n)) return (int)cudaErrorInvalidValue;
  const long long chain_ints = (2LL * ch.n_cols + 2) * capmax;
  ch.chain_in_smem = chain_ints <= kChainSmemInts;
  if (!ch.chain_in_smem && ch.scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int cap = ch.caps[ch.n_readers - 1];
  const long long sort_ints = (long long)ch.n_out * cap;
  ch.sort_in_smem = cap > kWarpSortCap && sort_ints <= kSortSmemInts;
  const size_t smem = sizeof(int) * ((ch.chain_in_smem ? chain_ints : 0) +
                                     (ch.sort_in_smem ? sort_ints : 0));
  static bool smem_raised[64] = {};  // the attribute is set once a device
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_raised[device]) {
    void (*const kernels[2])(Chain) = {scan_join_kernel<true>, scan_join_kernel<false>};
    for (auto kernel : kernels) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sizeof(int) * (kChainSmemInts + kSortSmemInts));
      if (err != cudaSuccess) return (int)err;
    }
    smem_raised[device] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ch.chain_in_smem) scan_join_kernel<true><<<batch, kThreads, smem, s>>>(ch);
  else scan_join_kernel<false><<<batch, kThreads, smem, s>>>(ch);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
