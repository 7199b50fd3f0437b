// K1: dense 4^k k-mer spectrum straight from aug words.
//
// Replaces kmer_spans_tpu/ops/pallas_kernels.py, pallas_count_aug (kernel
// _count_aug_kernel), which built the spectrum as an int8 one-hot matrix
// product on the TPU's matrix unit.  Hopper has fast shared-memory atomics
// instead, so this is a privatised atomic histogram (histogram.cuh says what
// bounds it and how the 4^8 table is split across blocks).
//
// aug word: bit 16 = the k-mer ending here is valid, bits 0..15 = its code.
// A word counts at bin (aug & 0xFFFF) when bit 16 is set and the code is
// below 4^k; every other word (padding included) counts nowhere, as in the
// TPU kernel.

#include "histogram.cuh"

namespace {

struct AugCode {
  __device__ __forceinline__ int operator()(int32_t w) const {
    return ((w >> 16) & 1) ? (w & 0xFFFF) : -1;
  }
};

}  // namespace

// counts: int32 [4^k], zeroed by the caller.  Returns a cudaError_t.
extern "C" int kst_count_aug(const void* aug, int64_t n, int32_t k,
                             void* counts, int32_t num_sms, void* stream) {
  if (k < 4 || k > 8) return (int)cudaErrorInvalidValue;
  return (int)kst::launch_histogram(
      static_cast<const int32_t*>(aug), n, 1 << (2 * k),
      static_cast<int32_t*>(counts), num_sms,
      static_cast<cudaStream_t>(stream), AugCode{});
}
