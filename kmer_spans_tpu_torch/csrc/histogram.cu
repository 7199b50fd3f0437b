// K3: dense int32 histogram of values[valid] over [0, size).
//
// Replaces kmer_spans_tpu/ops/pallas_kernels.py, pallas_histogram (kernel
// _count_kernel through _histogram_flat), which built the histogram as an
// int8 one-hot matrix product on the TPU's matrix unit, for sizes that are
// multiples of 128 (a scatter below that), on input masked in XLA first.
// Here it is a privatised shared-memory atomic histogram for any
// size >= 1 that reads the mask itself: two streams, int32 values as int4
// loads and the bool valid bytes four to a 32-bit load beside each int4.
// A value counts at bin v when its valid byte is non-zero and
// 0 <= v < size, else nowhere.
//
// What bounds it on an H100: the two input streams, 5 bytes a position
// (2^28 positions move 1.34 GB, >= 0.40 ms at 3.35 TB/s), and, on skewed
// input, shared atomics on a few hot bins, which serialise within a warp.
//
// The design.  One CTA of 1024 threads holds at most kHistBins = 2^15 int32
// counters (128 KiB of shared memory):
//   * size <= 2^15: one slice, one read of the input;
//   * cluster form (size > 2^15): a thread-block cluster of C <= 8 CTAs
//     (the portable limit) holds C slices of 2^15 counters, up to 2^18 bins,
//     in distributed shared memory.  Every thread adds into the slice's
//     owner through cluster.map_shared_rank, so the input is read once.  A
//     cluster.sync() after the stream keeps every CTA's shared memory alive
//     until no other CTA adds into it;
//   * sliced form: grid.y splits the bins into slices of 2^15 counters, one
//     CTA each, and every slice re-reads the input;
//   * global form (any size; the 4^10-4^15 spectra): no private counters.
//     The input is read once, and each valid position adds into the int32
//     output in global memory (the L2), after its warp has gathered equal
//     values (__match_any_sync): one atomic per distinct value in the warp,
//     so a low-complexity run of one k-mer costs one add per 32 positions.
// Sizes above one cluster's 2^18 bins take grid.y rows of clusters.  The
// wrapper (ops/histogram.py) picks the form by a fixed rule measured on the
// card: a remote add into another SM's shared memory costs several local
// ones, so the cluster form wins where few values land in other CTAs'
// slices (two CTAs, the sort screen's sparse run histograms) and loses to
// the sliced form's L2-served re-reads where every position counts into
// eight slices (the 4^9 spectrum); the sliced form re-reads the input once
// per 2^15 bins (512 times at 4^12), so above a measured crossover the
// global form's one read wins.  Each CTA of the shared-memory forms flushes
// its own non-zero counters with one global atomic each at its end; the
// caller zeroes the output.

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

enum Form { kSliced = 0, kClusterForm = 1, kGlobal = 2 };

template <bool kCluster>
struct Adder {
  int32_t* bins;
  uint32_t row_lo;
  uint32_t row_n;

  __device__ __forceinline__ void operator()(int32_t v, uint32_t ok) const {
    // unsigned: every v outside [row_lo, row_lo + row_n) wraps past row_n
    const uint32_t rel = (uint32_t)v - row_lo;
    if (!ok || rel >= row_n) return;
    if constexpr (kCluster) {
      int32_t* owner = cg::this_cluster().map_shared_rank(bins, rel >> 15);
      atomicAdd(owner + (rel & (kBins - 1)), 1);
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

// values[0, head) lie before their first 16-byte boundary and go one by one;
// the rest go as an int4 of values beside four valid bytes (one 32-bit load
// when kVecValid: valid + head is 4-byte aligned), plus a scalar tail.
template <bool kCluster, bool kVecValid>
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
  const Adder<kCluster> add{
      bins, (uint32_t)row_lo,
      (uint32_t)(row_left < (int64_t)csize * kBins ? row_left
                                                   : (int64_t)csize * kBins)};
  for (int i = threadIdx.x; i < own_n; i += blockDim.x) bins[i] = 0;
  sync_bins<kCluster>();  // every slice of the cluster is zero

  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < head; i += stride) add(values[i], valid[i]);
  const int4* v4 = reinterpret_cast<const int4*>(values + head);
  const uint8_t* m = valid + head;
  const int64_t n4 = (n - head) / 4;
  for (int64_t i = tid; i < n4; i += stride) {
    const int4 q = __ldg(v4 + i);
    uint32_t b0, b1, b2, b3;
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
    add(q.x, b0);
    add(q.y, b1);
    add(q.z, b2);
    add(q.w, b3);
  }
  for (int64_t i = head + 4 * n4 + tid; i < n; i += stride)
    add(values[i], valid[i]);
  sync_bins<kCluster>();  // no CTA adds into another's slice any more

  for (int i = threadIdx.x; i < own_n; i += blockDim.x) {
    const int32_t c = bins[i];
    if (c) atomicAdd(out + own_lo + i, c);
  }
}

template <bool kCluster, bool kVecValid>
cudaError_t launch(const int32_t* values, const uint8_t* valid, int64_t n,
                   int64_t head, int32_t size, int32_t* out, int num_sms,
                   cudaStream_t stream) {
  auto kernel = masked_hist_kernel<kCluster, kVecValid>;
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

}  // namespace

// values: int32 [n]; valid: bool [n] (one byte each); counts: int32 [size],
// zeroed by the caller.  form: 0 the sliced form, 1 the cluster form above
// 2^15 bins (the sliced form at or below), 2 the global form.  Returns a
// cudaError_t.
extern "C" int kst_histogram(const void* values, const void* valid, int64_t n,
                             int32_t size, int32_t form, void* counts,
                             int32_t num_sms, void* stream) {
  if (size < 1 || n < 0 || form < kSliced || form > kGlobal)
    return (int)cudaErrorInvalidValue;
  const int32_t* v = static_cast<const int32_t*>(values);
  const uint8_t* m = static_cast<const uint8_t*>(valid);
  int64_t head = (int64_t)(((16 - ((uintptr_t)v & 15)) & 15) / 4);
  if (head > n) head = n;
  const bool vec_valid = (((uintptr_t)(m + head)) & 3) == 0;
  const bool use_cluster = form == kClusterForm && size > kBins;
  int32_t* out = static_cast<int32_t*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == kGlobal)
    return (int)(vec_valid
                     ? launch_global<true>(v, m, n, head, size, out, num_sms, s)
                     : launch_global<false>(v, m, n, head, size, out, num_sms,
                                            s));
  if (use_cluster)
    return (int)(vec_valid
                     ? launch<true, true>(v, m, n, head, size, out, num_sms, s)
                     : launch<true, false>(v, m, n, head, size, out, num_sms,
                                           s));
  return (int)(vec_valid
                   ? launch<false, true>(v, m, n, head, size, out, num_sms, s)
                   : launch<false, false>(v, m, n, head, size, out, num_sms,
                                          s));
}
