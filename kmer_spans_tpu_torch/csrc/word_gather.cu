// K4: packed rank-class gather fused with the integer screen score.
//
// Replaces kmer_spans_tpu/ops/gather.py, pallas_word_gather (kernel
// _gather_kernel), together with the nibble extract and class_scores_int
// that both its callers apply to the gathered word (the class screen of
// spans/pipeline.py and rank_ub_gather of ops/sortscreen.py):
//
//   s[i] = (((words[(e >> 3) & (W - 1)] >> ((e & 7) * 4)) & 15) + 1) * 256
//          + 3 - thr_q,   e = entry[i].
//
// On the TPU the lookup enumerated the table's rows against pre-rolled
// copies (Mosaic gathers see only an 8-row window).  Here the whole table
// (W <= 2^15 int32 words, 128 KiB at k = 9) is staged once per CTA in
// dynamic shared memory, and each lookup is one shared-memory load.
//
// What bounds it on an H100: the int4 streams of entries in and scores out
// (8 bytes an entry; 2^28 entries move 2.15 GB, >= 0.64 ms at 3.35 TB/s).
// Random shared-memory lookups cost a few bank conflicts a warp, well under
// that.  The table is not read through L1, as K2 (screen_scan.cu) reads
// its own: that is K2's likely limit.  A persistent grid of about one CTA
// per SM (the table fills most of an SM's shared memory at k = 9) walks
// the entries grid-stride; a scalar head reaches the first 16-byte
// boundary of the entries, and when the output is not aligned with them
// the stores go one word at a time.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxWords = 1 << 15;

__device__ __forceinline__ int32_t score(const int32_t* tab, int32_t mask,
                                         int32_t base, int32_t e) {
  const int32_t w = tab[(e >> 3) & mask];
  return ((w >> ((e & 7) * 4)) & 15) * 256 + base;
}

template <bool kVecOut>
__global__ void __launch_bounds__(kThreads)
    word_gather_kernel(const int32_t* __restrict__ entry, int64_t n,
                       int64_t head, const int32_t* __restrict__ words,
                       int32_t n_words, const int32_t* __restrict__ thr_q,
                       int32_t* __restrict__ out) {
  extern __shared__ int32_t tab[];
  for (int i = threadIdx.x; i < n_words; i += blockDim.x)
    tab[i] = __ldg(words + i);
  __syncthreads();
  const int32_t mask = n_words - 1;
  // s = (nibble + 1) * 256 + 3 - thr_q = nibble * 256 + base
  const int32_t base = 256 + 3 - __ldg(thr_q);

  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = tid; i < head; i += stride)
    out[i] = score(tab, mask, base, entry[i]);
  const int4* e4 = reinterpret_cast<const int4*>(entry + head);
  const int64_t n4 = (n - head) / 4;
  for (int64_t i = tid; i < n4; i += stride) {
    const int4 q = __ldg(e4 + i);
    int4 s;
    s.x = score(tab, mask, base, q.x);
    s.y = score(tab, mask, base, q.y);
    s.z = score(tab, mask, base, q.z);
    s.w = score(tab, mask, base, q.w);
    if (kVecOut) {
      reinterpret_cast<int4*>(out + head)[i] = s;
    } else {
      int32_t* o = out + head + 4 * i;
      o[0] = s.x;
      o[1] = s.y;
      o[2] = s.z;
      o[3] = s.w;
    }
  }
  for (int64_t i = head + 4 * n4 + tid; i < n; i += stride)
    out[i] = score(tab, mask, base, entry[i]);
}

}  // namespace

// entry: int32 [n]; words: int32 [n_words], n_words a power of two in
// [2, 2^15] (an entry's word index wraps modulo n_words); thr_q: one int32
// on the device; out: int32 [n].  Returns a cudaError_t.
extern "C" int kst_word_gather(const void* entry, int64_t n, const void* words,
                               int32_t n_words, const void* thr_q, void* out,
                               int32_t num_sms, void* stream) {
  if (n < 0 || n_words < 2 || n_words > kMaxWords ||
      (n_words & (n_words - 1)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int32_t* e = static_cast<const int32_t*>(entry);
  int32_t* o = static_cast<int32_t*>(out);
  int64_t head = (int64_t)(((16 - ((uintptr_t)e & 15)) & 15) / 4);
  if (head > n) head = n;
  const bool vec_out = (((uintptr_t)(o + head)) & 15) == 0;
  void (*kernel)(const int32_t*, int64_t, int64_t, const int32_t*, int32_t,
                 const int32_t*, int32_t*) =
      vec_out ? word_gather_kernel<true> : word_gather_kernel<false>;
  const size_t smem = (size_t)n_words * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // fill the card once, and no more than the entries feed (16 a thread):
  // every CTA pays one load of the whole table
  const int64_t fill = (int64_t)num_sms * (per_sm > 0 ? per_sm : 1);
  const int64_t feed = (n + 16 * kThreads - 1) / (16 * kThreads);
  const int64_t grid = fill < feed ? fill : feed;
  kernel<<<(unsigned)grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      e, n, head, static_cast<const int32_t*>(words), n_words,
      static_cast<const int32_t*>(thr_q), o);
  return (int)cudaGetLastError();
}
