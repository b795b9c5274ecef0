// Match-range scans of the join over the sorted packed words.
//
// Replaces the TPU kernel dj_tpu/ops/pallas_scan.py::join_scans
// (_make_scan_kernel). From the ascending packed u64 words
// ((key - min) << tag_bits | tag, padding all-ones) it writes four int32
// arrays: stag (decoded merged tag), run_start (start of the position's
// key run), cnt (refs in the run, for a valid left row) and csum (the
// inclusive int32 cumsum of cnt, wrapping past 2^31 as the JAX kernel
// does; the exact int64 total is cnt's sum, taken by the caller).
//
// Bound on this card: bytes. It must read 8 B and write 16 B per
// position and does a few integer operations on each, far below the
// card's operation rate, so the least time is 24 B x S over the memory
// rate (about 1.4 ms at S = 200M on an H100 SXM).
//
// Design: the TPU kernel carries its prefix state (query count, run
// carries, csum) in SMEM across a grid that runs in order. Hopper blocks
// run in no order, so the carry becomes one single-pass scan with
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA 2016), in one launch:
//   1. each block takes the next tile of TILE positions from a global
//      counter, so every tile before it has started and the look-back
//      cannot wait on a tile that is not resident;
//   2. it decodes its words and scans, across the block, the run state
//      of a segment (Run: query count, last run boundary, queries before
//      that boundary; composing two segments is associative). It
//      publishes the tile's aggregate with status AGGREGATE, then one
//      warp walks back over the earlier tiles' records, composing them
//      until it meets one with status PREFIX, and publishes the tile's
//      inclusive prefix with status PREFIX;
//   3. from that carry it writes stag, run_start and cnt, keeps cnt in
//      registers, and runs the same look-back on the int32 cnt sums
//      (status and sum packed in one 64-bit word), so csum is written
//      without reading cnt back.
// The words are read once (plus one word before each tile), 16 B are
// written: the bound's 24 B a position. Loads and stores go through
// shared memory (consecutive threads on consecutive words, 256 B a warp
// instruction; each thread then works on ITEMS consecutive positions),
// which measured far faster on an H100 than loading each thread's
// positions directly (a warp instruction then spans 4 KB); 16-byte vector
// loads and stores, other tile shapes, and reading several windows of 32
// tiles a look-back measured slower or no faster. Every record carries
// its status in the same 64-bit word as its value (a run record is two
// such words, taken only when both carry one status), so no fence orders
// a value before its status, which also measured faster. The
// records and the tile counter are zeroed by one cudaMemsetAsync on the
// stream before every launch.
//
// Scratch (int32): [0] tile counter, [1] and [2] the most tiles any run
// and csum look-back read, [3] the run records all look-backs read (three
// diagnostics), then two u64 run words a tile, then one u64 csum record
// a tile.

#include <climits>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int NEG = INT_MIN;
constexpr int HEADER = 4;                 // ints before the tiles' records
constexpr int AGGREGATE = 1, PREFIX = 2;  // status of a tile's record
constexpr unsigned BACKOFF_MIN = 16, BACKOFF_MAX = 128;  // ns a look-back sleeps, doubling
constexpr unsigned FULL = 0xffffffffu;

// Run state of a segment of positions: its query count, its last run
// boundary (-1: none) and the queries before that boundary within it.
struct Run {
  int nq, lastb, qb;
};

__device__ __forceinline__ Run run_identity() { return Run{0, -1, 0}; }

// Segment x followed by segment y.
__device__ __forceinline__ Run compose(const Run& x, const Run& y) {
  if (y.lastb >= 0) return Run{x.nq + y.nq, y.lastb, x.nq + y.qb};
  return Run{x.nq + y.nq, x.lastb, x.qb};
}

struct Compose {
  __device__ Run operator()(const Run& x, const Run& y) const { return compose(x, y); }
};
struct Add {
  __device__ int operator()(int a, int b) const {
    return (int)((unsigned)a + (unsigned)b);  // int32 wraparound
  }
};

__device__ __forceinline__ int shfl_up(int v, int d) { return __shfl_up_sync(FULL, v, d); }
__device__ __forceinline__ Run shfl_up(const Run& v, int d) {
  return Run{shfl_up(v.nq, d), shfl_up(v.lastb, d), shfl_up(v.qb, d)};
}
__device__ __forceinline__ Run shfl_down(const Run& v, int d) {
  return Run{__shfl_down_sync(FULL, v.nq, d), __shfl_down_sync(FULL, v.lastb, d),
             __shfl_down_sync(FULL, v.qb, d)};
}
__device__ __forceinline__ Run shfl0(const Run& v) {
  return Run{__shfl_sync(FULL, v.nq, 0), __shfl_sync(FULL, v.lastb, 0), __shfl_sync(FULL, v.qb, 0)};
}

template <class T, class Op>
__device__ __forceinline__ T warp_inclusive(T v, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T y = shfl_up(v, d);
    if (lane >= d) v = op(y, v);
  }
  return v;
}

// Exclusive scan of one value per thread across the block, in thread
// order (op need not commute); ``total`` receives the block aggregate.
// ``buf`` holds >= 32 values of shared memory.
template <class T, class Op>
__device__ T block_exclusive(T v, Op op, T identity, T* buf, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T incl = warp_inclusive(v, op);
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nw ? buf[lane] : identity;
    w = warp_inclusive(w, op);
    if (lane < nw) buf[lane] = w;
  }
  __syncthreads();
  T before_warp = warp == 0 ? identity : buf[warp - 1];
  total = buf[nw - 1];
  T excl = shfl_up(incl, 1);
  if (lane == 0) excl = identity;
  __syncthreads();  // buf may be reused by the next call
  return op(before_warp, excl);
}

__device__ __forceinline__ u64 ld_volatile(const u64* p) { return *(const volatile u64*)p; }
__device__ __forceinline__ void st_volatile(u64* p, u64 v) { *(volatile u64*)p = v; }

constexpr u64 MASK31 = (1ull << 31) - 1;

// A tile's run record: two words, each with the status in its top two
// bits: status << 62 | nq << 31 | (lastb + 1), and status << 62 | qb.
// Each word is written and read whole (an aligned 64-bit access is
// single-copy atomic), and a reader takes a pair only when both words
// carry one status, so the two halves always come from one publication.
// No fence is needed between them: a word's value travels with its
// status.
__device__ __forceinline__ void publish_run(u64* recs, int t, const Run& r, u64 s) {
  st_volatile(recs + 2 * t, s << 62 | (u64)r.nq << 31 | (u64)(r.lastb + 1));
  st_volatile(recs + 2 * t + 1, s << 62 | (u64)r.qb);
}

__device__ __forceinline__ bool run_pending(u64 x, u64 y) {
  return (x >> 62) == 0 || (x >> 62) != (y >> 62);
}

// Run state of every position before tile t > 0, by one warp: lane i
// reads tile base - i, waits (sleeping BACKOFF_MIN to BACKOFF_MAX ns)
// until all 32 tiles have a status, and the warp composes its window back
// to the nearest PREFIX record, or moves 32 tiles further back if it met
// none. Lanes past tile 0 read the identity as a PREFIX record.
// ``walked`` receives the number of records composed.
__device__ Run look_back_runs(int t, const u64* recs, int& walked) {
  const int lane = threadIdx.x & 31;
  Run excl = run_identity();
  walked = 0;
  for (int base = t - 1;; base -= 32) {
    const int j = base - lane;
    u64 x = (u64)PREFIX << 62, y = x;
    if (j >= 0) {
      x = ld_volatile(recs + 2 * j);
      y = ld_volatile(recs + 2 * j + 1);
    }
    for (unsigned ns = BACKOFF_MIN; __any_sync(FULL, run_pending(x, y));
         ns = ns < BACKOFF_MAX ? 2 * ns : ns) {
      __nanosleep(ns);
      if (run_pending(x, y)) {
        x = ld_volatile(recs + 2 * j);
        y = ld_volatile(recs + 2 * j + 1);
      }
    }
    Run r{(int)((x >> 31) & MASK31), (int)(x & MASK31) - 1, (int)(y & MASK31)};
    const unsigned pm = __ballot_sync(FULL, (int)(x >> 62) == PREFIX);
    const int stop = pm ? __ffs(pm) - 1 : 31;  // lanes 0..stop are composed
    if (lane > stop) r = run_identity();
    // Lane i + d holds earlier tiles than lane i: compose it first.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run o = shfl_down(r, d);
      if (lane + d < 32) r = compose(o, r);
    }
    excl = compose(shfl0(r), excl);
    walked += min(stop + 1, base + 1);
    if (pm) return excl;
  }
}

__device__ __forceinline__ u64 csum_record(int s, int sum) {
  return ((u64)s << 32) | (unsigned)sum;
}

// The int32 cnt sum of every position before tile t > 0, by one warp,
// as look_back_runs; a record is (status << 32 | sum) in one word.
__device__ int look_back_csum(int t, const u64* recs, int& walked) {
  const int lane = threadIdx.x & 31;
  int excl = 0;
  walked = 0;
  for (int base = t - 1;; base -= 32) {
    const int j = base - lane;
    u64 w = j >= 0 ? ld_volatile(recs + j) : csum_record(PREFIX, 0);
    for (unsigned ns = BACKOFF_MIN; __any_sync(FULL, (w >> 32) == 0);
         ns = ns < BACKOFF_MAX ? 2 * ns : ns) {
      __nanosleep(ns);
      if ((w >> 32) == 0) w = ld_volatile(recs + j);
    }
    const unsigned pm = __ballot_sync(FULL, (int)(w >> 32) == PREFIX);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    int v = lane <= stop ? (int)(unsigned)w : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v = Add()(v, __shfl_xor_sync(FULL, v, d));
    excl = Add()(excl, v);
    walked += min(stop + 1, base + 1);
    if (pm) return excl;
  }
}

struct Geometry {
  long long S;
  int L, R, tag_bits;
};

__device__ __forceinline__ int decode_tag(u64 w, const Geometry& g) {
  const int raw = (int)(w & ((1ull << g.tag_bits) - 1));
  const int S = (int)g.S;
  return raw < g.R ? raw + g.L : (raw < S ? raw - g.R : S);
}

// Shared-memory index of tile position i: one pad word every 32 keeps
// a thread's ITEMS consecutive positions off each other's banks.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }
constexpr int STAGE = TILE + TILE / 32;  // padded positions of a tile

// The tile's words from base (all-ones past S), loaded coalesced
// (consecutive threads, consecutive words) into ``stage``; returns this
// thread's ITEMS consecutive words and the word before them.
__device__ __forceinline__ void load_tile(const u64* sp, long long S, long long base,
                                          u64* stage, u64 (&w)[ITEMS], u64& prev) {
  __shared__ u64 s_before;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + threadIdx.x;
    stage[padded(i)] = base + i < S ? sp[base + i] : ~0ull;
  }
  if (threadIdx.x == 0) s_before = base > 0 ? sp[base - 1] : 0ull;
  __syncthreads();
  const int i0 = threadIdx.x * ITEMS;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) w[k] = stage[padded(i0 + k)];
  prev = threadIdx.x ? stage[padded(i0 - 1)] : s_before;
}

// This thread's ITEMS consecutive ints into ``stage``; the caller syncs,
// then store_staged writes the tile coalesced.
__device__ __forceinline__ void stage_ints(int* stage, const int (&v)[ITEMS]) {
  const int i0 = threadIdx.x * ITEMS;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) stage[padded(i0 + k)] = v[k];
}

__device__ __forceinline__ void store_staged(int* out, long long S, long long base,
                                             const int* stage) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int i = k * THREADS + threadIdx.x;
    if (base + i < S) out[base + i] = stage[padded(i)];
  }
}

struct Outputs {
  int *stag, *run_start, *cnt, *csum;
};

__global__ void __launch_bounds__(THREADS)
join_scans_kernel(const u64* sp, Geometry geo, const int* counts, Outputs out, int* header,
                  u64* run_recs, u64* csum_recs) {
  // The tile's words, then (once every thread holds its own) two int
  // stages of the outputs.
  __shared__ u64 stage_words[STAGE];
  __shared__ Run run_buf[32];
  __shared__ int sum_buf[32];
  __shared__ int s_tile, s_csum;
  __shared__ Run s_run;
  int* stage0 = reinterpret_cast<int*>(stage_words);
  int* stage1 = stage0 + STAGE;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_tile = atomicAdd(header, 1);
  __syncthreads();
  const int t = s_tile;
  const int l_count = counts[0], r_count = counts[1];
  const long long base = (long long)t * TILE;
  const long long g0 = base + (long long)threadIdx.x * ITEMS;
  u64 w[ITEMS], prev;
  load_tile(sp, geo.S, base, stage_words, w, prev);

  // Per position: decoded tag, whether it starts a key run.
  int stag[ITEMS];
  bool bnd[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const u64 before = k == 0 ? prev : w[k - 1];
    stag[k] = decode_tag(w[k], geo);
    bnd[k] = g0 + k < geo.S && (g0 + k == 0 || (w[k] >> geo.tag_bits) != (before >> geo.tag_bits));
  }

  // Run state: this thread's segment, the block's scan, the tile's carry.
  Run mine = run_identity();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (bnd[k]) {
      mine.lastb = (int)(g0 + k);
      mine.qb = mine.nq;
    }
    mine.nq += stag[k] < geo.L ? 1 : 0;
  }
  Run tile_run;
  const Run before = block_exclusive(mine, Compose(), run_identity(), run_buf, tile_run);
  if (threadIdx.x < 32) {
    Run excl = run_identity();
    if (t == 0) {
      if (lane == 0) publish_run(run_recs, 0, tile_run, PREFIX);
    } else {
      if (lane == 0) publish_run(run_recs, t, tile_run, AGGREGATE);
      int walked;
      excl = look_back_runs(t, run_recs, walked);
      if (lane == 0) {
        publish_run(run_recs, t, compose(excl, tile_run), PREFIX);
        atomicMax(header + 1, walked);
        atomicAdd(header + 3, walked);
      }
    }
    if (lane == 0) s_run = excl;
  }
  __syncthreads();

  // run_start and cnt from the carried (query count, run_start, run_lo);
  // run_lo at a boundary b is ref_before(b) = b - q_before(b).
  const Run at = compose(s_run, before);
  int q = at.nq;
  int rs = at.lastb >= 0 ? at.lastb : NEG;
  int rl = at.lastb >= 0 ? at.lastb - at.qb : NEG;
  int run_start[ITEMS], cnt[ITEMS];
  int csum_local = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int ref_before = (int)(g0 + k) - q;
    q += stag[k] < geo.L ? 1 : 0;
    if (bnd[k]) {
      rs = (int)(g0 + k);
      rl = ref_before;
    }
    run_start[k] = rs;
    const int hi = min(ref_before, r_count);
    cnt[k] = stag[k] < l_count ? max(hi - rl, 0) : 0;
    if (g0 + k < geo.S) csum_local = Add()(csum_local, cnt[k]);
  }
  int tile_sum;
  const int sum_before = block_exclusive(csum_local, Add(), 0, sum_buf, tile_sum);
  if (threadIdx.x == 0)
    st_volatile(csum_recs + t, csum_record(t == 0 ? PREFIX : AGGREGATE, tile_sum));
  // The block scan's barriers have passed every thread's reads of the
  // words: their stage holds stag and run_start now.
  stage_ints(stage0, stag);
  stage_ints(stage1, run_start);
  __syncthreads();
  store_staged(out.stag, geo.S, base, stage0);
  store_staged(out.run_start, geo.S, base, stage1);

  // csum: the second look-back, over the tiles' cnt sums.
  if (threadIdx.x < 32) {
    int excl = 0;
    if (t > 0) {
      int walked;
      excl = look_back_csum(t, csum_recs, walked);
      if (lane == 0) {
        st_volatile(csum_recs + t, csum_record(PREFIX, Add()(excl, tile_sum)));
        atomicMax(header + 2, walked);
      }
    }
    if (lane == 0) s_csum = excl;
  }
  __syncthreads();
  int c = Add()(s_csum, sum_before);
  int csum[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    c = Add()(c, cnt[k]);
    csum[k] = c;
  }
  stage_ints(stage0, cnt);
  stage_ints(stage1, csum);
  __syncthreads();
  store_staged(out.cnt, geo.S, base, stage0);
  store_staged(out.csum, geo.S, base, stage1);
}

int num_tiles(long long S) { return (int)((S + TILE - 1) / TILE); }

}  // namespace

// The header, then two u64 run words and one u64 csum record a tile.
extern "C" long long dj_join_scans_scratch_ints(long long S) {
  return HEADER + 6LL * num_tiles(S);
}

// sp: S words; counts: device int32 [l_count, r_count]; outputs: S int32
// each; scratch: dj_join_scans_scratch_ints(S) int32, 16-byte aligned.
// Zeroes the scratch (counter, diagnostics and every record) on the
// stream, then launches the kernel. Returns the first CUDA error, 0 when
// both were accepted.
extern "C" int dj_join_scans(const u64* sp, const int* counts, int* stag,
                             int* run_start, int* cnt, int* csum, int* scratch,
                             long long S, int L, int R, int tag_bits, void* stream) {
  if (S <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = num_tiles(S);
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (size_t)dj_join_scans_scratch_ints(S) * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  Geometry geo{S, L, R, tag_bits};
  u64* run_recs = reinterpret_cast<u64*>(scratch + HEADER);
  join_scans_kernel<<<nb, THREADS, 0, st>>>(sp, geo, counts, Outputs{stag, run_start, cnt, csum},
                                            scratch, run_recs, run_recs + 2 * nb);
  return (int)cudaGetLastError();
}
