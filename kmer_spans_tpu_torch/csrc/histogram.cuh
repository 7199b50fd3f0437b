// Dense int32 histogram through block-private shared-memory bins.
//
// Shared by the aug spectrum count (count_aug.cu) and meant for the masked
// value histogram still to be ported (kmer_spans_tpu/ops/pallas_kernels.py,
// pallas_histogram): a Decode functor maps each input word to its bin in
// [0, size), or to -1 when the word counts nowhere.  Only the decode differs
// between the two.
//
// What bounds it on an H100: one shared-memory atomic per counted word, and
// the int4 stream of the input (4 bytes a word).  A block cannot hold a
// whole 4^8 table of int32 counters (256 KiB against the 227 KiB a block may
// use), so grid.y splits [0, size) into slices of kHistBins counters
// (128 KiB) and every slice reads the whole input: two reads at k = 8, one
// at k <= 7.  Counters stay int32, so no block can overflow them however
// skewed the input (a poly-A run puts every word on one bin); such runs only
// serialise the atomics of a warp.  Each block flushes its non-zero counters
// once, with one global atomic each, at its end.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace kst {

constexpr int kHistBins = 1 << 15;  // 128 KiB of int32 counters per block
constexpr int kHistThreads = 1024;

template <class Decode>
__device__ __forceinline__ void hist_add(int32_t* bins, int32_t w, int lo,
                                         int nbins, const Decode& decode) {
  const int v = decode(w) - lo;
  if (v >= 0 && v < nbins) atomicAdd(bins + v, 1);
}

// x[0, head) lies before the first 16-byte boundary and is read word by
// word; the rest goes as int4 loads plus a scalar tail.
template <class Decode>
__global__ void __launch_bounds__(kHistThreads)
    hist_kernel(const int32_t* __restrict__ x, int64_t n, int64_t head,
                int size, int32_t* __restrict__ out, Decode decode) {
  extern __shared__ int32_t bins[];
  const int lo = blockIdx.y * kHistBins;
  const int nbins = min(kHistBins, size - lo);
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) bins[i] = 0;
  __syncthreads();

  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < head; i += stride)
    hist_add(bins, x[i], lo, nbins, decode);
  const int4* x4 = reinterpret_cast<const int4*>(x + head);
  const int64_t n4 = (n - head) / 4;
  for (int64_t i = tid; i < n4; i += stride) {
    const int4 q = __ldg(x4 + i);
    hist_add(bins, q.x, lo, nbins, decode);
    hist_add(bins, q.y, lo, nbins, decode);
    hist_add(bins, q.z, lo, nbins, decode);
    hist_add(bins, q.w, lo, nbins, decode);
  }
  for (int64_t i = head + 4 * n4 + tid; i < n; i += stride)
    hist_add(bins, x[i], lo, nbins, decode);
  __syncthreads();

  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    const int32_t c = bins[i];
    if (c) atomicAdd(out + lo + i, c);
  }
}

// Adds the histogram of x[0, n) into out[0, size), which the caller zeroes.
// Returns the launch's cudaError_t.
template <class Decode>
cudaError_t launch_histogram(const int32_t* x, int64_t n, int size,
                             int32_t* out, int num_sms, cudaStream_t stream,
                             Decode decode) {
  if (size <= 0) return cudaErrorInvalidValue;
  const int splits = (size + kHistBins - 1) / kHistBins;
  const int nbins = size < kHistBins ? size : kHistBins;
  const size_t smem = (size_t)nbins * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<Decode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hist_kernel<Decode>, kHistThreads, smem);
  if (err != cudaSuccess) return err;
  // enough blocks to fill the card once, and no more than the input feeds
  // (16 words a thread); every block pays a flush of its whole bin slice
  const int64_t fill = per_sm > 0 ? (int64_t)num_sms * per_sm / splits : 1;
  const int64_t feed = (n + 16 * kHistThreads - 1) / (16 * kHistThreads);
  int64_t gx = fill < feed ? fill : feed;
  if (gx < 1) gx = 1;
  int64_t head = (int64_t)(((16 - ((uintptr_t)x & 15)) & 15) / 4);
  if (head > n) head = n;
  hist_kernel<Decode><<<dim3((unsigned)gx, (unsigned)splits), kHistThreads,
                        smem, stream>>>(x, n, head, size, out, decode);
  return cudaGetLastError();
}

}  // namespace kst
