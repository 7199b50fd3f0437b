// K3: dense int32 histogram of values[valid] over [0, size).
//
// Replaces kmer_spans_tpu/ops/pallas_kernels.py, pallas_histogram (kernel
// _count_kernel through _histogram_flat), which built the histogram as an
// int8 one-hot matrix product on the TPU's matrix unit, for sizes that are
// multiples of 128 (a scatter below that), on input masked in XLA first.
// Here it is an atomic histogram for any size >= 1 that reads the mask
// itself: two streams, int32 values as int4 loads and the bool valid bytes
// four to a 32-bit load beside each int4.  A value counts at bin v when its
// valid byte is non-zero and 0 <= v < size, else nowhere.
//
// The least any form moves on an H100 is the two input streams, 5 bytes a
// position (2^28 positions: 1.34 GB, >= 0.40 ms at 3.35 TB/s), and the
// counters once.  One CTA of 1024 threads holds at most kHistBins = 2^15
// int32 counters (128 KiB of shared memory).  Five forms, with their times
// at 2^28 positions on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 6; PERF.md section 6, K3):
//   * sliced (0): grid.y splits the bins into slices of 2^15 counters, one
//     CTA each, and every slice re-reads the input (from L2 where it fits).
//     Bound by bytes at one slice (0.430 ms at 256 bins); by the re-reads
//     above (0.714 ms at 4^8, 2.43 at 4^9, 119.1 at 4^12);
//   * cluster (1, size > 2^15): a thread-block cluster of C <= 8 CTAs (the
//     portable limit) holds C slices of 2^15 counters, up to 2^18 bins, in
//     distributed shared memory.  Every thread adds into the slice's owner
//     through cluster.map_shared_rank, so the input is read once.  A
//     cluster.sync() after the stream keeps every CTA's shared memory alive
//     until no other CTA adds into it.  Bound by the remote adds: 0.467 ms
//     on the sort screen's sparse runs, 1.64 on a dense 4^8 spectrum, 3.8
//     where a warp's lanes all hold one bin (32 adds to one SM);
//   * cluster_merged (4, size > 2^15): the cluster form where the lanes of
//     a warp that hold one bin first elect one lane (__match_any_sync),
//     which adds their number: one remote add per distinct bin a warp step.
//     0.545 ms on one hot bin, 0.409 on the cohort's window counts (equal
//     neighbours); the match costs where bins differ (2.49 ms at 4^8);
//   * global (2, any size): no private counters; each warp's distinct
//     values (__match_any_sync) add into the int32 output in global memory.
//     Bound by atomics in L2 (3.19 ms at 4^10), and in HBM where the
//     output outgrows the 50 MB L2 (12.19 ms at 4^12, 21.97 at 4^15);
//   * partitioned (3, size <= 2^30): the values are split by their high
//     bits into parts of 2^15 bins, and each part is counted in shared
//     memory (the partitioned counters of KMC 2 and Gerbil).  Pass A counts
//     each CTA's share of the input by part; one CTA scans the counts into
//     places (each CTA's run in each part's bucket, the parts one after
//     another) and work items; pass B reads the share again and writes each
//     value's low 15 bits as uint16 into its part's bucket, for more than
//     8 parts through a tile of 16384 values sorted by part in shared
//     memory so that a part's values leave in runs (above 2^14 parts, and
//     at 8 or fewer, one warp step at a time); pass C's persistent CTAs
//     take the work items (a part's bucket in chunks of at most item_len
//     values, so that one hot part spreads over the card) from a counter
//     and count each in 2^15 shared counters, then add the non-zero ones
//     into the output.  It moves about 5 + 5 + 2 + 2 bytes a position and
//     the counters once (>= 1.1 ms at 4^12), and takes 2.05 ms at 4^9,
//     2.43 at 4^10, 2.93 at 4^12, 12.48 at 4^14.  Pass B takes most of it,
//     and its ranks most of pass B: a returning shared atomic for each
//     part a warp step holds, behind ballots, with the tile's phases
//     (loads, ranks, scan, staging, writes) one after another.
// Sizes above one cluster's 2^18 bins take grid.y rows of clusters.  The
// wrapper (ops/histogram.py histogram_form) picks the form by a rule from
// these times, the input's length and what the caller counts.  The
// shared-memory forms flush each CTA's non-zero counters with one global
// atomic each at its end; the caller zeroes the output (or hands in
// counts to add to).

#include <cooperative_groups.h>

#include <cstdint>

#include <cuda_runtime.h>

#include "histogram.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kBins = kst::kHistBins;
constexpr int kThreads = kst::kHistThreads;
constexpr int kGlobalThreads = 256;
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // a lane that adds nothing

enum Form {
  kSliced = 0,
  kClusterForm = 1,
  kGlobal = 2,
  kPartitioned = 3,
  kClusterMerged = 4,
};

__device__ __forceinline__ uint32_t lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1;
}

// The lanes of the warp that share one add with this one: all lanes with
// a key where every such lane holds the same one (a ballot, a shuffle and
// a vote: a warp of one hot bin or part), else this lane alone.  Every
// lane of the warp calls it together, with kNoKey where it adds nothing;
// the lowest lane of the set (leads) adds __popc of it.
__device__ __forceinline__ uint32_t peers_if_uniform(uint32_t key) {
  const uint32_t active = __ballot_sync(0xFFFFFFFFu, key != kNoKey);
  const uint32_t first =
      __shfl_sync(0xFFFFFFFFu, key, active ? __ffs(active) - 1 : 0);
  return __all_sync(0xFFFFFFFFu, key == kNoKey || key == first)
             ? active
             : 1u << (threadIdx.x & 31);
}

// The lanes of the warp that hold this lane's key, by one ballot for each
// of the key's low ``bits`` bits (the multisplit of radix sorts): exact for
// keys below 2^bits, cheap where __match_any_sync is not.  The lanes with
// kNoKey come out as one set.  Every lane calls it with the same bits.
__device__ __forceinline__ uint32_t peers_by_bits(uint32_t key, int bits) {
  const uint32_t adding = __ballot_sync(0xFFFFFFFFu, key != kNoKey);
  uint32_t peers = key != kNoKey ? adding : ~adding;
  for (int j = 0; j < bits; ++j) {
    const bool bit = (key >> j) & 1;
    const uint32_t set = __ballot_sync(0xFFFFFFFFu, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

__device__ __forceinline__ bool leads(uint32_t peers) {
  return (int)(threadIdx.x & 31) == __ffs(peers) - 1;
}

// One position's add into the row's counters.  kMerge: every lane of the
// warp calls it together, and the lanes of one bin share one add.
template <bool kCluster, bool kMerge>
struct Adder {
  int32_t* bins;
  uint32_t row_lo;
  uint32_t row_n;

  __device__ __forceinline__ void operator()(int32_t v, uint32_t ok) const {
    // unsigned: every v outside [row_lo, row_lo + row_n) wraps past row_n
    const uint32_t rel = (uint32_t)v - row_lo;
    const bool in = ok && rel < row_n;
    int32_t count = 1;
    if constexpr (kMerge) {
      const uint32_t peers =
          __match_any_sync(0xFFFFFFFFu, in ? rel : kNoKey);  // rel < 2^18
      if (!in || !leads(peers)) return;
      count = __popc(peers);
    } else if (!in) {
      return;
    }
    if constexpr (kCluster) {
      int32_t* owner = cg::this_cluster().map_shared_rank(bins, rel >> 15);
      atomicAdd(owner + (rel & (kBins - 1)), count);
    } else {
      atomicAdd(bins + rel, 1);
    }
  }
};

template <bool kCluster>
__device__ __forceinline__ void sync_bins() {
  if constexpr (kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// The valid bytes of int4 group i of the values, one byte a value (one
// 32-bit load when kVecValid: valid + head is 4-byte aligned).
template <bool kVecValid>
__device__ __forceinline__ uint32_t valid_bytes(const uint8_t* m, int64_t i) {
  if constexpr (kVecValid) {
    return __ldg(reinterpret_cast<const uint32_t*>(m) + i);
  } else {
    return (uint32_t)__ldg(m + 4 * i) | ((uint32_t)__ldg(m + 4 * i + 1) << 8) |
           ((uint32_t)__ldg(m + 4 * i + 2) << 16) |
           ((uint32_t)__ldg(m + 4 * i + 3) << 24);
  }
}

// add(v, ok) for the values of int4 groups [g0, g1) in steps of ``step``
// groups from this thread's, ok the valid byte: an int4 of values beside
// four valid bytes.  values[0, head) lie before their first 16-byte
// boundary and fewer than four follow the last whole group; the threads of
// CTA (0, y) take those one by one.  kWarpSteps: the group loop goes a warp
// at a time and the head and tail go to warp 0, every lane of the warp in
// each step, so that add may match lanes.
template <bool kVecValid, bool kWarpSteps, class Add>
__device__ __forceinline__ void for_each_value(
    const int32_t* __restrict__ values, const uint8_t* __restrict__ valid,
    int64_t n, int64_t head, int64_t g0, int64_t g1, int64_t step,
    const Add& add) {
  const int lane = (int)(threadIdx.x & 31);
  const int64_t rest = head + 4 * ((n - head) / 4);
  const int4* v4 = reinterpret_cast<const int4*>(values + head);
  const uint8_t* m = valid + head;
  if constexpr (kWarpSteps) {
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      const bool in = lane < head + (n - rest);
      const int64_t i = lane < head ? lane : rest + (lane - head);
      add(in ? values[i] : 0, in ? (uint32_t)valid[i] : 0u);
    }
  } else if (blockIdx.x == 0) {
    for (int64_t i = threadIdx.x; i < head + (n - rest); i += blockDim.x) {
      const int64_t at = i < head ? i : rest + (i - head);
      add(values[at], valid[at]);
    }
  }
  const int64_t from = g0 + (kWarpSteps ? (threadIdx.x & ~31u) : threadIdx.x);
  for (int64_t base = from; base < g1; base += step) {
    const int64_t i = kWarpSteps ? base + lane : base;
    int4 q = make_int4(0, 0, 0, 0);
    uint32_t b = 0;
    if (!kWarpSteps || i < g1) {
      q = __ldg(v4 + i);
      b = valid_bytes<kVecValid>(m, i);
    }
    add(q.x, b & 0xFF);
    add(q.y, (b >> 8) & 0xFF);
    add(q.z, (b >> 16) & 0xFF);
    add(q.w, b >> 24);
  }
}

template <bool kCluster, bool kMerge, bool kVecValid>
__global__ void __launch_bounds__(kThreads)
    masked_hist_kernel(const int32_t* __restrict__ values,
                       const uint8_t* __restrict__ valid, int64_t n,
                       int64_t head, int32_t size, int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  int rank = 0;
  int csize = 1;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    csize = (int)cluster.num_blocks();
  }
  const int64_t row_lo = (int64_t)blockIdx.y * csize * kBins;
  const int64_t own_lo = row_lo + (int64_t)rank * kBins;
  const int64_t own_left = size - own_lo;
  const int own_n = own_left <= 0 ? 0 : (own_left < kBins ? (int)own_left
                                                           : kBins);
  const int64_t row_left = size - row_lo;
  const Adder<kCluster, kMerge> add{
      bins, (uint32_t)row_lo,
      (uint32_t)(row_left < (int64_t)csize * kBins ? row_left
                                                   : (int64_t)csize * kBins)};
  for (int i = threadIdx.x; i < own_n; i += blockDim.x) bins[i] = 0;
  sync_bins<kCluster>();  // every slice of the cluster is zero

  // every CTA of a row strides over all int4 groups
  for_each_value<kVecValid, kMerge>(values, valid, n, head,
                                    (int64_t)blockIdx.x * blockDim.x,
                                    (n - head) / 4,
                                    (int64_t)gridDim.x * blockDim.x, add);
  sync_bins<kCluster>();  // no CTA adds into another's slice any more

  for (int i = threadIdx.x; i < own_n; i += blockDim.x) {
    const int32_t c = bins[i];
    if (c) atomicAdd(out + own_lo + i, c);
  }
}

template <bool kCluster, bool kMerge, bool kVecValid>
cudaError_t launch(const int32_t* values, const uint8_t* valid, int64_t n,
                   int64_t head, int32_t size, int32_t* out, int num_sms,
                   cudaStream_t stream) {
  auto kernel = masked_hist_kernel<kCluster, kMerge, kVecValid>;
  const int needed = (int)((size + (int64_t)kBins - 1) / kBins);
  const int csize = kCluster ? (needed < kMaxCluster ? needed : kMaxCluster)
                             : 1;
  const int64_t row_bins = (int64_t)csize * kBins;
  const int rows = (int)((size + row_bins - 1) / row_bins);
  const size_t smem = (size_t)(size < kBins ? size : kBins) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  // enough CTAs to fill the card once, and no more than the input feeds
  // (16 positions a thread): every CTA pays a flush of its slice
  const int64_t feed = (n + 16 * kThreads - 1) / (16 * kThreads);
  int64_t gx;
  if (kCluster) {
    cfg.gridDim = dim3((unsigned)csize, (unsigned)rows, 1);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    int64_t fill = clusters / rows;
    if (fill < 1) fill = 1;
    int64_t fed = (feed + csize - 1) / csize;
    if (fed < 1) fed = 1;
    gx = (fill < fed ? fill : fed) * csize;
  } else {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    const int64_t fill = per_sm > 0 ? (int64_t)num_sms * per_sm / rows : 1;
    gx = fill < feed ? fill : feed;
    if (gx < 1) gx = 1;
  }
  cfg.gridDim = dim3((unsigned)gx, (unsigned)rows, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, values, valid, n, head, size, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


// One warp's values into the global counters: lanes holding equal values
// (ok) elect their lowest lane, which adds their number.  Every lane of the
// warp calls it together.
__device__ __forceinline__ void warp_add(int32_t* __restrict__ out, int32_t v,
                                         bool ok) {
  const uint32_t key = ok ? (uint32_t)v : 0xFFFFFFFFu;  // v < 2^31: no clash
  const uint32_t peers = __match_any_sync(0xFFFFFFFFu, key);
  if (ok && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(out + v, __popc(peers));
}

// The global form.  values[0, head) and the tail after the last whole int4
// (fewer than 4 values each) go one atomic a value; the int4 groups go a
// warp at a time, every lane of the warp in each step, so that each of the
// four values of a group can be matched across the warp.
template <bool kVecValid>
__global__ void __launch_bounds__(kGlobalThreads)
    global_hist_kernel(const int32_t* __restrict__ values,
                       const uint8_t* __restrict__ valid, int64_t n,
                       int64_t head, int32_t size, int32_t* __restrict__ out) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;  // a multiple of 32
  const int64_t n4 = (n - head) / 4;
  const int64_t rest = head + 4 * n4;
  if (tid < head + (n - rest)) {
    const int64_t i = tid < head ? tid : rest + (tid - head);
    const int32_t v = values[i];
    if (valid[i] && (uint32_t)v < (uint32_t)size) atomicAdd(out + v, 1);
  }
  const int4* v4 = reinterpret_cast<const int4*>(values + head);
  const uint8_t* m = valid + head;
  for (int64_t base = tid - (threadIdx.x & 31); base < n4; base += stride) {
    const int64_t i = base + (threadIdx.x & 31);
    int4 q = make_int4(0, 0, 0, 0);
    uint32_t b0 = 0, b1 = 0, b2 = 0, b3 = 0;
    if (i < n4) {
      q = __ldg(v4 + i);
      if constexpr (kVecValid) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(m) + i);
        b0 = w & 0xFF;
        b1 = (w >> 8) & 0xFF;
        b2 = (w >> 16) & 0xFF;
        b3 = w >> 24;
      } else {
        b0 = __ldg(m + 4 * i);
        b1 = __ldg(m + 4 * i + 1);
        b2 = __ldg(m + 4 * i + 2);
        b3 = __ldg(m + 4 * i + 3);
      }
    }
    warp_add(out, q.x, b0 && (uint32_t)q.x < (uint32_t)size);
    warp_add(out, q.y, b1 && (uint32_t)q.y < (uint32_t)size);
    warp_add(out, q.z, b2 && (uint32_t)q.z < (uint32_t)size);
    warp_add(out, q.w, b3 && (uint32_t)q.w < (uint32_t)size);
  }
}

template <bool kVecValid>
cudaError_t launch_global(const int32_t* values, const uint8_t* valid,
                          int64_t n, int64_t head, int32_t size, int32_t* out,
                          int num_sms, cudaStream_t stream) {
  auto kernel = global_hist_kernel<kVecValid>;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kGlobalThreads, 0);
  if (err != cudaSuccess) return err;
  // enough CTAs to fill the card once, and no more than the input feeds
  // (16 positions a thread); at least one, for the head and tail
  const int64_t fill = (int64_t)num_sms * (per_sm > 0 ? per_sm : 1);
  const int64_t feed = (n + 16 * kGlobalThreads - 1) / (16 * kGlobalThreads);
  int64_t gx = fill < feed ? fill : feed;
  if (gx < 1) gx = 1;
  kernel<<<(unsigned)gx, kGlobalThreads, 0, stream>>>(values, valid, n, head,
                                                      size, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- partitioned
// Part j holds the bins [j * 2^15, (j + 1) * 2^15): a value's part is
// v >> 15, its place in the part v & (2^15 - 1).  Scratch (int32 words,
// then the bucket): base [parts * grid + 1], item_off [parts + 1], next [1],
// then from the next 16-byte boundary the uint16 bucket [n] and 16 spare
// bytes (pass C reads the bucket 8 places at a time).

constexpr int kPartBits = 15;
constexpr int kTileGroups = 4;  // int4 groups a thread a tile
constexpr int kTile = 4 * kTileGroups * kThreads;  // 16384 values
// pass B sorts a tile by part for kDirectParts < parts <= kStagedParts:
// with fewer parts a warp's values of one part already leave in runs, and
// the tile's syncs cost more than they save (the crossover measured on the
// card lies between 8 and 16 parts); with more, the tile's counters and
// places outgrow the shared memory
constexpr int kDirectParts = 8;
constexpr int kStagedParts = 1 << 14;

// CTA g's share of the int4 groups: [*g0, *g1)
__device__ __forceinline__ void share_of(int64_t n, int64_t head, int64_t* g0,
                                         int64_t* g1) {
  const int64_t n4 = (n - head) / 4;
  const int64_t share = (n4 + gridDim.x - 1) / gridDim.x;
  *g0 = (int64_t)blockIdx.x * share;
  *g1 = *g0 + share < n4 ? *g0 + share : n4;
}

// Pass A: CTA g counts its share by part in shared memory, into
// base[p * grid + g] (part-major).  A warp whose counted values lie in one
// part adds once.
template <bool kVecValid>
__global__ void __launch_bounds__(kThreads)
    part_count_kernel(const int32_t* __restrict__ values,
                      const uint8_t* __restrict__ valid, int64_t n,
                      int64_t head, int32_t size, int parts,
                      int32_t* __restrict__ base) {
  extern __shared__ int32_t cnt[];
  for (int p = threadIdx.x; p < parts; p += blockDim.x) cnt[p] = 0;
  __syncthreads();
  int64_t g0, g1;
  share_of(n, head, &g0, &g1);
  const auto add = [&](int32_t v, uint32_t ok) {
    const bool in = ok && (uint32_t)v < (uint32_t)size;
    const uint32_t key = in ? (uint32_t)v >> kPartBits : kNoKey;
    const uint32_t peers = peers_if_uniform(key);
    if (in && leads(peers)) atomicAdd(cnt + key, __popc(peers));
  };
  for_each_value<kVecValid, true>(values, valid, n, head, g0, g1, blockDim.x,
                                  add);
  __syncthreads();
  for (int p = threadIdx.x; p < parts; p += blockDim.x)
    base[(int64_t)p * gridDim.x + blockIdx.x] = cnt[p];
}

// a[0, m) in place into its exclusive prefix sums, by the CTA (every
// thread calls it); returns the total to every thread.  Chunks of four
// values a thread, each thread's four consecutive (coalesced across the
// warp), scanned by warp shuffles and the warps' totals.
__device__ int32_t block_exclusive_scan(int32_t* a, int64_t m) {
  __shared__ int32_t warp_sums[kThreads / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t c0 = 0; c0 < m; c0 += 4 * (int64_t)blockDim.x) {
    const int64_t at = c0 + 4 * (int64_t)threadIdx.x;
    int32_t x[4];
    int32_t own = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = at + j < m ? a[at + j] : 0;
      own += x[j];
    }
    int32_t incl = own;  // inclusive scan of own across the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xFFFFFFFFu, w, d);
        if (lane >= d) w += y;
      }
      if (lane < nwarps) warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    int32_t run = carry + (warp ? warp_sums[warp - 1] : 0) + incl - own;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (at + j < m) a[at + j] = run;
      run += x[j];
    }
    __syncthreads();  // every thread has read carry and warp_sums
    if (threadIdx.x == 0) carry += warp_sums[nwarps - 1];
    __syncthreads();
  }
  const int32_t total = carry;
  __syncthreads();  // read by all before a next scan resets it
  return total;
}

// Between A and B, one CTA: base into its exclusive prefix sums (CTA g's
// first place in part p's bucket, the parts one after another), each
// part's work items (ceil(count / item_len)) into theirs, and the work
// counter to 0.
__global__ void __launch_bounds__(kThreads)
    part_scan_kernel(int32_t* __restrict__ base, int parts, int grid,
                     int32_t item_len, int32_t* __restrict__ item_off,
                     int32_t* __restrict__ next) {
  const int64_t m = (int64_t)parts * grid;
  const int32_t total = block_exclusive_scan(base, m);
  if (threadIdx.x == 0) {
    base[m] = total;
    *next = 0;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < parts; p += blockDim.x) {
    const int32_t c = base[(int64_t)(p + 1) * grid] - base[(int64_t)p * grid];
    item_off[p] = (c + item_len - 1) / item_len;
  }
  __syncthreads();
  const int32_t items = block_exclusive_scan(item_off, parts);
  if (threadIdx.x == 0) item_off[parts] = items;
}

// Pass B: CTA g reads its share again, as pass A did, and writes each
// counted value's place in its part behind the part's cursor cur[p], which
// starts at base[p * grid + g].  kStaged (parts <= kStagedParts): a tile of
// kTile values at a time is sorted by part in shared memory (the lanes of a
// warp in one part take one add for their ranks), then written out in
// order, so that each part's values leave as one run; else each value goes
// out alone.
template <bool kStaged, bool kVecValid>
__global__ void __launch_bounds__(kThreads)
    part_scatter_kernel(const int32_t* __restrict__ values,
                        const uint8_t* __restrict__ valid, int64_t n,
                        int64_t head, int32_t size, int parts,
                        const int32_t* __restrict__ base,
                        uint16_t* __restrict__ bucket) {
  extern __shared__ int32_t smem[];
  int32_t* cur = smem;              // [parts]
  int32_t* off = smem + parts;      // [parts]: the tile's counts, offsets
  uint32_t* stage = reinterpret_cast<uint32_t*>(off + parts);  // [kTile]
  for (int p = threadIdx.x; p < parts; p += blockDim.x) {
    cur[p] = base[(int64_t)p * gridDim.x + blockIdx.x];
    if constexpr (kStaged) off[p] = 0;
  }
  __syncthreads();
  int64_t g0, g1;
  share_of(n, head, &g0, &g1);
  // place of a value (key: its part, kNoKey where not counted) among the
  // values of its part that the warp places at once, behind counter[key]:
  // one add for each part a warp step holds; every lane calls it
  const int bits = parts > 1 ? 32 - __clz(parts - 1) : 0;
  const auto place = [bits](int32_t* counter, uint32_t key) {
    const uint32_t peers = peers_by_bits(key, bits);
    int32_t at = 0;
    if (key != kNoKey && leads(peers))
      at = atomicAdd(counter + key, __popc(peers));
    return __shfl_sync(0xFFFFFFFFu, at, __ffs(peers) - 1) +
           __popc(peers & lanes_below());
  };
  const auto key_of = [&](int32_t v, uint32_t ok) {
    return ok && (uint32_t)v < (uint32_t)size ? (uint32_t)v >> kPartBits
                                              : kNoKey;
  };
  const uint32_t low = (1u << kPartBits) - 1;
  if constexpr (!kStaged) {
    const auto add = [&](int32_t v, uint32_t ok) {
      const uint32_t key = key_of(v, ok);
      const int32_t at = place(cur, key);
      if (key != kNoKey) bucket[at] = (uint16_t)((uint32_t)v & low);
    };
    for_each_value<kVecValid, true>(values, valid, n, head, g0, g1,
                                    blockDim.x, add);
    return;
  }
  // the head and tail (CTA 0, fewer than eight values) go out alone
  const auto alone = [&](int32_t v, uint32_t ok) {
    const uint32_t key = key_of(v, ok);
    const int32_t at = place(cur, key);
    if (key != kNoKey) bucket[at] = (uint16_t)((uint32_t)v & low);
  };
  for_each_value<kVecValid, true>(values, valid, n, head, 0, 0, blockDim.x,
                                  alone);
  __syncthreads();
  const int4* v4 = reinterpret_cast<const int4*>(values + head);
  const uint8_t* m = valid + head;
  for (int64_t t0 = g0; t0 < g1; t0 += kTileGroups * blockDim.x) {
    uint32_t e[4 * kTileGroups];  // part << 16 | place in the part
    int32_t r[4 * kTileGroups];   // rank among the tile's values of the part
    int4 qs[kTileGroups];         // every load of the tile in flight at once
    uint32_t bs[kTileGroups];
#pragma unroll
    for (int it = 0; it < kTileGroups; ++it) {
      const int64_t i = t0 + it * blockDim.x + threadIdx.x;
      qs[it] = make_int4(0, 0, 0, 0);
      bs[it] = 0;
      if (i < g1) {
        qs[it] = __ldg(v4 + i);
        bs[it] = valid_bytes<kVecValid>(m, i);
      }
    }
#pragma unroll
    for (int it = 0; it < kTileGroups; ++it) {
      const int4 q = qs[it];
      const uint32_t b = bs[it];
      const int32_t vs[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t key = key_of(vs[c], (b >> (8 * c)) & 0xFF);
        r[4 * it + c] = place(off, key);
        e[4 * it + c] =
            key == kNoKey ? kNoKey : key << 16 | ((uint32_t)vs[c] & low);
      }
    }
    __syncthreads();
    const int32_t total = block_exclusive_scan(off, parts);
#pragma unroll
    for (int j = 0; j < 4 * kTileGroups; ++j)
      if (e[j] != kNoKey) stage[off[e[j] >> 16] + r[j]] = e[j];
    __syncthreads();
    for (int j = threadIdx.x; j < total; j += blockDim.x) {
      const uint32_t x = stage[j];
      const uint32_t p = x >> 16;
      bucket[cur[p] + (j - off[p])] = (uint16_t)(x & low);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < parts; p += blockDim.x)
      cur[p] += (p + 1 < parts ? off[p + 1] : total) - off[p];
    __syncthreads();
    for (int p = threadIdx.x; p < parts; p += blockDim.x) off[p] = 0;
    __syncthreads();
  }
}

// Pass C: persistent CTAs take work items from the counter.  Item t is
// chunk j = t - item_off[p] of part p's bucket (item_off[p] <= t <
// item_off[p + 1]), at most item_len values, counted in 2^15 shared
// counters from 16-byte loads of 8 places; the non-zero counters go into
// the output with one add each, a plain one where the item is the whole
// part (no other CTA touches its bins in this launch).  Equal values are
// not merged: the card takes a warp's shared atomics on one address about
// as fast as a match would let one lane add (PERF.md, K3).
__global__ void __launch_bounds__(kThreads)
    part_items_kernel(const uint16_t* __restrict__ bucket,
                      const int32_t* __restrict__ base,
                      const int32_t* __restrict__ item_off,
                      int32_t* __restrict__ next, int parts, int grid,
                      int32_t item_len, int32_t size,
                      int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  __shared__ int32_t job[4];  // part (-1: no more), first, end, whole
  const int32_t items = item_off[parts];
  const uint4* b8 = reinterpret_cast<const uint4*>(bucket);
  for (;;) {
    if (threadIdx.x == 0) {
      const int32_t t = atomicAdd(next, 1);
      job[0] = -1;
      if (t < items) {
        int lo = 0, hi = parts;  // the last part with item_off <= t
        while (hi - lo > 1) {
          const int mid = (lo + hi) / 2;
          if (item_off[mid] <= t)
            lo = mid;
          else
            hi = mid;
        }
        const int32_t first = base[(int64_t)lo * grid];
        const int32_t end = base[(int64_t)(lo + 1) * grid];
        const int32_t from = first + (t - item_off[lo]) * item_len;
        job[0] = lo;
        job[1] = from;
        job[2] = end - from < item_len ? end : from + item_len;
        job[3] = end - first <= item_len;
      }
    }
    __syncthreads();
    const int p = job[0];
    if (p < 0) break;
    const int32_t from = job[1], end = job[2];
    const bool whole = job[3];
    const int64_t bin_lo = (int64_t)p << kPartBits;
    const int nb = size - bin_lo < kBins ? (int)(size - bin_lo) : kBins;
    for (int i = threadIdx.x; i < nb; i += blockDim.x) bins[i] = 0;
    __syncthreads();
    for (int32_t g = from / 8 + (int32_t)threadIdx.x; g < (end + 7) / 8;
         g += blockDim.x) {
      const uint4 w = b8[g];
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int32_t i = 8 * g + j;
        if (i >= from && i < end)
          atomicAdd(bins + ((words[j / 2] >> (16 * (j & 1))) & 0xFFFF), 1);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      const int32_t c = bins[i];
      if (!c) continue;
      if (whole)
        out[bin_lo + i] += c;
      else
        atomicAdd(out + bin_lo + i, c);
    }
    __syncthreads();  // job and bins are free for the next item
  }
}

int64_t part_bucket_at(int parts, int grid) {
  return ((int64_t)4 * ((int64_t)parts * grid + parts + 3) + 15) / 16 * 16;
}

template <bool kVecValid>
cudaError_t launch_partitioned(const int32_t* values, const uint8_t* valid,
                               int64_t n, int64_t head, int32_t size,
                               int32_t* out, void* scratch,
                               int64_t scratch_bytes, int grid,
                               int32_t item_len, int num_sms,
                               cudaStream_t stream) {
  const int parts = (int)((size + (int64_t)kBins - 1) / kBins);
  const int64_t bucket_at = part_bucket_at(parts, grid);
  if (parts > kBins || grid < 1 || item_len < 1 || n > (1 << 30) ||
      scratch_bytes < bucket_at + 2 * n + 16)
    return cudaErrorInvalidValue;
  int32_t* base = static_cast<int32_t*>(scratch);
  int32_t* item_off = base + (int64_t)parts * grid + 1;
  int32_t* next = item_off + parts + 1;
  uint16_t* bucket = reinterpret_cast<uint16_t*>(
      static_cast<char*>(scratch) + bucket_at);
  const bool staged = kDirectParts < parts && parts <= kStagedParts;
  const size_t count_smem = (size_t)parts * sizeof(int32_t);
  const size_t scatter_smem =
      staged ? (2 * (size_t)parts + kTile) * sizeof(int32_t) : count_smem;
  const size_t bin_smem = (size_t)kBins * sizeof(int32_t);
  auto count = part_count_kernel<kVecValid>;
  auto scatter = staged ? part_scatter_kernel<true, kVecValid>
                        : part_scatter_kernel<false, kVecValid>;
  cudaError_t err = cudaFuncSetAttribute(
      count, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)count_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(scatter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)scatter_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(part_items_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bin_smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, part_items_kernel, kThreads, bin_smem);
  if (err != cudaSuccess) return err;
  count<<<grid, kThreads, count_smem, stream>>>(values, valid, n, head, size,
                                                parts, base);
  part_scan_kernel<<<1, kThreads, 0, stream>>>(base, parts, grid, item_len,
                                               item_off, next);
  scatter<<<grid, kThreads, scatter_smem, stream>>>(values, valid, n, head,
                                                    size, parts, base, bucket);
  part_items_kernel<<<num_sms * (per_sm > 0 ? per_sm : 1), kThreads,
                      bin_smem, stream>>>(bucket, base, item_off, next, parts,
                                          grid, item_len, size, out);
  return cudaGetLastError();
}

}  // namespace

// values: int32 [n]; valid: bool [n] (one byte each); counts: int32 [size],
// zeroed by the caller (or holding counts to add to).  form: 0 the sliced
// form, 1 the cluster form and 4 the cluster form with merged adds above
// 2^15 bins (the sliced form at or below), 2 the global form, 3 the
// partitioned form (size <= 2^30, n <= 2^30), which takes scratch of
// scratch_bytes bytes (ops/histogram.py partition_plan: passes A and B run
// on grid CTAs, pass C's work items hold at most item_len values).
// Returns a cudaError_t.
extern "C" int kst_histogram(const void* values, const void* valid, int64_t n,
                             int32_t size, int32_t form, void* counts,
                             void* scratch, int64_t scratch_bytes,
                             int32_t grid, int32_t item_len, int32_t num_sms,
                             void* stream) {
  if (size < 1 || n < 0 || form < kSliced || form > kClusterMerged)
    return (int)cudaErrorInvalidValue;
  const int32_t* v = static_cast<const int32_t*>(values);
  const uint8_t* m = static_cast<const uint8_t*>(valid);
  int64_t head = (int64_t)(((16 - ((uintptr_t)v & 15)) & 15) / 4);
  if (head > n) head = n;
  const bool vec = (((uintptr_t)(m + head)) & 3) == 0;
  int32_t* out = static_cast<int32_t*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (form == kPartitioned) {
    err = vec ? launch_partitioned<true>(v, m, n, head, size, out, scratch,
                                         scratch_bytes, grid, item_len,
                                         num_sms, s)
              : launch_partitioned<false>(v, m, n, head, size, out, scratch,
                                          scratch_bytes, grid, item_len,
                                          num_sms, s);
  } else if (form == kGlobal) {
    err = vec ? launch_global<true>(v, m, n, head, size, out, num_sms, s)
              : launch_global<false>(v, m, n, head, size, out, num_sms, s);
  } else if (size > kBins && form == kClusterForm) {
    err = vec ? launch<true, false, true>(v, m, n, head, size, out, num_sms, s)
              : launch<true, false, false>(v, m, n, head, size, out, num_sms,
                                           s);
  } else if (size > kBins && form == kClusterMerged) {
    err = vec ? launch<true, true, true>(v, m, n, head, size, out, num_sms, s)
              : launch<true, true, false>(v, m, n, head, size, out, num_sms,
                                          s);
  } else {
    err = vec ? launch<false, false, true>(v, m, n, head, size, out, num_sms,
                                           s)
              : launch<false, false, false>(v, m, n, head, size, out,
                                            num_sms, s);
  }
  return (int)err;
}
