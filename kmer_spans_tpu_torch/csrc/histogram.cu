// K3: dense int32 histogram of masked values.
//
// Replaces kmer_spans_tpu/ops/pallas_kernels.py, pallas_histogram (kernel
// _count_kernel through _histogram_flat), which built the histogram as an
// int8 one-hot matrix product on the TPU's matrix unit, for sizes that are
// multiples of 128 (a scatter below that).  Here it is the privatised
// shared-memory atomic histogram of histogram.cuh, for any size >= 1: up to
// 2^15 bins one slice of shared counters per block, above that one slice
// per grid.y row, each re-reading the input.
//
// The wrapper (ops/histogram.py) masks first, as the reference does outside
// its kernel: an invalid position arrives as -1.  A word counts at bin w
// when 0 <= w < size, else nowhere.  The decode is the identity: the bin
// slice [lo, lo + nbins) of hist_add already rejects every other word.
//
// What bounds it on an H100: the int4 stream of the input (4 bytes a word)
// and, on skewed input, shared atomics on a few hot bins (the pm screen's
// run lengths fall almost all on bins 1..3), which serialise within a warp.

#include "histogram.cuh"

namespace {

struct Identity {
  __device__ __forceinline__ int operator()(int32_t w) const { return w; }
};

}  // namespace

// counts: int32 [size], zeroed by the caller.  Returns a cudaError_t.
extern "C" int kst_histogram(const void* values, int64_t n, int32_t size,
                             void* counts, int32_t num_sms, void* stream) {
  return (int)kst::launch_histogram(
      static_cast<const int32_t*>(values), n, size,
      static_cast<int32_t*>(counts), num_sms,
      static_cast<cudaStream_t>(stream), Identity{});
}
