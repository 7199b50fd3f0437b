// K2: fused class gather, integer screen score and per-block max-plus
// summaries.
//
// Replaces kmer_spans_tpu/ops/screen_scan.py, fused_screen_scan.  On the TPU
// the class lookup went through pre-rolled table copies (Mosaic gathers see
// only an 8-row window) and the scans were shifted adds (Mosaic lowers no
// cumsum).  Neither limit exists here: the packed class words are read
// through the read-only cache (32 KiB at k = 8 with 4-bit classes, so they
// stay in L1), and each block is scanned by one CTA.
//
// For every `block` positions b (one CTA each), with
//   s = (cls + 1) * unit + 3 - thr_q at scored positions (aug bit 17), else 0,
//   A  = inclusive cumsum of s,
//   Bv = A - cummin(A at scored positions, 2^30 elsewhere),
// it writes out[0][b] = A_end, out[1][b] = Bv_end, out[2][b] = max A,
// out[3][b] = max Bv.  A block with no scored position gives Bv = A - 2^30,
// the "no scored position" sentinel the host decodes as -inf.  All
// arithmetic is int32, as on the TPU (|sums| < 2^27 for blocks up to 32768).
//
// What bounds it on an H100: the aug stream (4 bytes a position, read once)
// and one L1 gather per position.  The design stages the block's scores in
// shared memory, then runs three short passes over each thread's contiguous
// run (sum; running min; summaries) around two block-wide scans.  Shared
// slots are skewed by one every 32 so that the threads of a warp, each
// walking its own run, hit distinct banks.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kInf = 1 << 30;
constexpr int32_t kUnscored = INT_MIN;

__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

struct Add {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const {
    return a + b;
  }
};
struct Min {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const {
    return min(a, b);
  }
};
struct Max {
  __device__ __forceinline__ int32_t operator()(int32_t a, int32_t b) const {
    return max(a, b);
  }
};

// Exclusive block-wide scan of one value a thread (op commutative and
// associative, `identity` its neutral element); *total gets op over all.
template <class Op>
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t identity,
                                              Op op, int32_t* buf,
                                              int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(x, y);
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t t = lane < kWarps ? buf[lane] : identity;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = op(t, y);
    }
    if (lane < kWarps) buf[lane] = t;
  }
  __syncthreads();
  int32_t prev = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) prev = identity;
  const int32_t r = op(warp ? buf[warp - 1] : identity, prev);
  *total = buf[kWarps - 1];
  __syncthreads();  // buf is reused by the next scan
  return r;
}

template <int CB>
__global__ void __launch_bounds__(kThreads)
    screen_scan_kernel(const int32_t* __restrict__ aug,
                       const int32_t* __restrict__ words, int32_t word_mask,
                       const int32_t* __restrict__ thr_q, int32_t block,
                       int64_t nb, int32_t* __restrict__ out) {
  constexpr int kLevels = 1 << CB;
  constexpr int kPerWord = 32 / CB;
  constexpr int kWordShift = CB == 4 ? 3 : 4;  // log2(kPerWord)
  constexpr int32_t kUnit = 4096 / kLevels;
  extern __shared__ int32_t score[];
  __shared__ int32_t buf[kWarps];

  const int64_t b = blockIdx.x;
  const int32_t* src = aug + b * block;
  const int32_t tq = __ldg(thr_q);
  for (int i = threadIdx.x; i < block; i += kThreads) {
    const int32_t w = src[i];
    const int32_t c = w & 0xFFFF;
    const int32_t word = __ldg(words + ((c >> kWordShift) & word_mask));
    const int32_t cls = (word >> ((c & (kPerWord - 1)) * CB)) & (kLevels - 1);
    score[skew(i)] = ((w >> 17) & 1) ? (cls + 1) * kUnit + 3 - tq : kUnscored;
  }
  __syncthreads();

  const int per = block / kThreads;
  const int first = threadIdx.x * per;
  int32_t sum = 0;
  for (int j = 0; j < per; ++j) {
    const int32_t s = score[skew(first + j)];
    if (s != kUnscored) sum += s;
  }
  int32_t total;
  const int32_t a0 = block_scan(sum, 0, Add{}, buf, &total);

  int32_t a = a0;
  int32_t run_min = kInf;
  for (int j = 0; j < per; ++j) {
    const int32_t s = score[skew(first + j)];
    if (s != kUnscored) {
      a += s;
      run_min = min(run_min, a);
    }
  }
  const int32_t m0 = block_scan(run_min, kInf, Min{}, buf, &total);

  a = a0;
  int32_t m = m0;
  int32_t max_a = INT_MIN;
  int32_t max_b = INT_MIN;
  for (int j = 0; j < per; ++j) {
    const int32_t s = score[skew(first + j)];
    if (s != kUnscored) {
      a += s;
      m = min(m, a);
    }
    max_a = max(max_a, a);
    max_b = max(max_b, a - m);
  }
  if (threadIdx.x == kThreads - 1) {
    out[b] = a;
    out[nb + b] = a - m;
  }
  block_scan(max_a, INT_MIN, Max{}, buf, &total);
  if (threadIdx.x == 0) out[2 * nb + b] = total;
  block_scan(max_b, INT_MIN, Max{}, buf, &total);
  if (threadIdx.x == 0) out[3 * nb + b] = total;
}

}  // namespace

// aug: int32 [nb * block]; words: int32 [n_words], n_words a power of two
// (codes index it modulo n_words); thr_q: one int32 on the device; out:
// int32 [4, nb].  block a multiple of 256.  Returns a cudaError_t.
extern "C" int kst_screen_scan(const void* aug, int64_t nb, int32_t block,
                               const void* words, int32_t n_words,
                               int32_t class_bits, const void* thr_q,
                               void* out, void* stream) {
  if (nb < 1 || block < kThreads || block % kThreads || n_words < 1 ||
      (n_words & (n_words - 1)))
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const int32_t*, const int32_t*, int32_t, const int32_t*,
                 int32_t, int64_t, int32_t*);
  if (class_bits == 4)
    kernel = screen_scan_kernel<4>;
  else if (class_bits == 2)
    kernel = screen_scan_kernel<2>;
  else
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)skew(block) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(aug), static_cast<const int32_t*>(words),
      n_words - 1, static_cast<const int32_t*>(thr_q), block, nb,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
