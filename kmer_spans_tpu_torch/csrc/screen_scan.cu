// K2: fused class gather, integer screen score and per-block max-plus
// summaries.
//
// Replaces kmer_spans_tpu/ops/screen_scan.py, fused_screen_scan.  On the TPU
// the class lookup went through pre-rolled table copies (Mosaic gathers see
// only an 8-row window) and the scans were shifted adds (Mosaic lowers no
// cumsum).  Neither limit exists here.
//
// For every `block` positions b, with
//   s = (cls + 1) * unit + 3 - thr_q at scored positions (aug bit 17), else 0,
//   A  = inclusive cumsum of s,
//   Bv = A - cummin(A at scored positions, 2^30 elsewhere),
// it writes out[0][b] = A_end, out[1][b] = Bv_end, out[2][b] = max A,
// out[3][b] = max Bv.  A block with no scored position gives Bv = A - 2^30,
// the "no scored position" sentinel the host decodes as -inf.  All
// arithmetic is int32, as on the TPU (|A| < 2^28 for blocks up to 32768).
//
// What bounds it on an H100: the aug stream, 4 bytes a position read once
// (2^28 positions move 1.07 GB, >= 0.32 ms at 3.35 TB/s).  The design keeps
// every other cost off that stream:
//   * persistent CTAs (as many as fit, about two per SM at block 8192) stage
//     the packed class table in shared memory once (the words a 16-bit code
//     can reach: at most 8192, 32 KiB) and walk the blocks grid-stride, so
//     each class lookup is one shared-memory load, not a trip to L2;
//   * each block's aug words come into a 2-stage shared-memory ring by
//     cp.async.bulk (1-D TMA) with one mbarrier a stage, so the next block's
//     load overlaps this block's compute (one stage where two do not fit);
//   * each thread takes a contiguous run of the block in one pass of
//     registers: the run's sum, running minimum, maximum and largest rise
//     over its minimum, all relative to the run's start.  Two block-wide
//     warp-shuffle scans (the sum, then the minimum) and one reduction of
//     (max A, max Bv) turn them into the block's four summaries, exactly:
//     Bv at a position is max(A - M0, A - m_run), M0 being the minimum
//     before the run, so max Bv over a run is max(max A - M0, that rise).
//   * a run of 32 positions is read as 8 int4 loads rotated by lane (a
//     quarter-warp's 8 threads then hit 8 distinct bank groups) and rotated
//     back in registers.  Blocks that are not multiples of 1024 (or of 8192
//     above 8192) read their runs one word at a time.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int32_t kInf = 1 << 30;
// a thread's run on the vector path is read in sub-runs of this many words
constexpr int kSub = 32;
// dynamic shared memory a CTA may take, with room for the static part
constexpr int kSmemLimit = 232448 - 1024;

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One thread: expect `bytes` on `bar`, then copy them from global to shared
// memory by the bulk-copy engine, which completes them on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  // order this CTA's earlier reads of dst (generic proxy) before the copy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------------ scans

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

// Exclusive block-wide scan of one value a thread (op commutative and
// associative, `identity` its neutral element); *total gets op over all.
template <class Op>
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t identity,
                                              Op op, int32_t* buf,
                                              int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(x, y);
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t t = lane < nw ? buf[lane] : identity;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = op(t, y);
    }
    if (lane < nw) buf[lane] = t;
  }
  __syncthreads();
  int32_t prev = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) prev = identity;
  const int32_t r = op(warp ? buf[warp - 1] : identity, prev);
  *total = buf[nw - 1];
  __syncthreads();  // buf is reused by the next scan
  return r;
}

// Block-wide max of two values a thread; thread 0 gets both.
__device__ __forceinline__ void block_max2(int32_t& a, int32_t& b,
                                           int32_t* buf) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    a = max(a, __shfl_xor_sync(0xffffffffu, a, d));
    b = max(b, __shfl_xor_sync(0xffffffffu, b, d));
  }
  if (lane == 0) {
    buf[warp] = a;
    buf[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < nw ? buf[lane] : INT_MIN;
    b = lane < nw ? buf[32 + lane] : INT_MIN;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      a = max(a, __shfl_xor_sync(0xffffffffu, a, d));
      b = max(b, __shfl_xor_sync(0xffffffffu, b, d));
    }
  }
  __syncthreads();  // buf is reused by the next block
}

// ------------------------------------------------------------ one run

// A thread's run, relative to A just before it: r = running sum, lm = least
// r at a scored position (kInf before the first), maxr = max r, rise =
// max(r - lm) over the positions from the first scored one on.
struct Run {
  int32_t r = 0;
  int32_t lm = kInf;
  int32_t maxr = INT_MIN;
  int32_t rise = INT_MIN;
};

template <int CB>
struct Scorer {
  const int32_t* tab;  // packed class words in shared memory
  int32_t mask;        // n_words - 1
  int32_t base;        // s = cls * unit + base
  static constexpr int kLevels = 1 << CB;
  static constexpr int kPerWord = 32 / CB;
  static constexpr int kWordShift = CB == 4 ? 3 : 4;  // log2(kPerWord)
  static constexpr int32_t kUnit = 4096 / kLevels;

  __device__ __forceinline__ void operator()(Run& st, int32_t w) const {
    const int32_t c = w & 0xFFFF;
    const int32_t word = tab[(c >> kWordShift) & mask];
    const int32_t cls = (word >> ((c & (kPerWord - 1)) * CB)) & (kLevels - 1);
    if ((w >> 17) & 1) {
      st.r += cls * kUnit + base;
      st.lm = min(st.lm, st.r);
    }
    st.maxr = max(st.maxr, st.r);
    if (st.lm != kInf) st.rise = max(st.rise, st.r - st.lm);
  }
};

__device__ __forceinline__ int4 pick(bool take, int4 a, int4 b) {
  return take ? a : b;
}

// The thread's run of `per` words at `run` (16-byte aligned, per a multiple
// of kSub), in sub-runs of 8 int4 loads rotated by lane.
template <int CB>
__device__ __forceinline__ void scan_run_vec(Run& st, const int32_t* run,
                                             int per, const Scorer<CB>& score) {
  const int rot = threadIdx.x & 7;
  for (int sub = 0; sub < per; sub += kSub) {
    const int4* q4 = reinterpret_cast<const int4*>(run + sub);
    int4 q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = q4[(j + rot) & 7];
    // q[j] holds chunk (j + rot) & 7: rotate right by rot, one bit at a time
#pragma unroll
    for (int bit = 0; bit < 3; ++bit) {
      const int sh = 1 << bit;
      const bool take = (rot >> bit) & 1;
      int4 t[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) t[c] = pick(take, q[(c - sh) & 7], q[c]);
#pragma unroll
      for (int c = 0; c < 8; ++c) q[c] = t[c];
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      score(st, q[c].x);
      score(st, q[c].y);
      score(st, q[c].z);
      score(st, q[c].w);
    }
  }
}

template <int CB, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    screen_scan_kernel(const int32_t* __restrict__ aug,
                       const int32_t* __restrict__ words, int32_t n_words,
                       int32_t staged, int32_t table_pad,
                       const int32_t* __restrict__ thr_q, int32_t block,
                       int64_t nb, int32_t stages,
                       int32_t* __restrict__ out) {
  extern __shared__ __align__(128) int32_t smem[];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ int32_t buf[64];
  int32_t* tab = smem;
  int32_t* ring = smem + table_pad;
  const uint32_t stage_bytes = (uint32_t)block * sizeof(int32_t);
  const int64_t first = blockIdx.x;
  const int64_t step = gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // blocks 0 .. stages - 2 of this CTA go ahead of the loop
    for (int s = 0; s + 1 < stages; ++s)
      if (first + s * step < nb)
        tma_load(ring + (size_t)s * block, aug + (first + s * step) * block,
                 stage_bytes, &full[s]);
  }
  for (int i = threadIdx.x; i < staged; i += blockDim.x) tab[i] = __ldg(words + i);
  const Scorer<CB> score{tab, n_words - 1,
                         Scorer<CB>::kUnit + 3 - __ldg(thr_q)};
  __syncthreads();

  const int per = block / (int)blockDim.x;
  int it = 0;
  for (int64_t b = first; b < nb; b += step, ++it) {
    // the load `stages - 1` blocks ahead goes into the stage that the
    // previous block left: every thread is past its reads of it (the
    // scans below end in __syncthreads)
    if (threadIdx.x == 0) {
      const int64_t ahead = b + (int64_t)(stages - 1) * step;
      const int s = (it + stages - 1) % stages;
      if (ahead < nb)
        tma_load(ring + (size_t)s * block, aug + ahead * block, stage_bytes,
                 &full[s]);
    }
    const int s = it % stages;
    mbar_wait(&full[s], (uint32_t)(it / stages) & 1);
    const int32_t* run = ring + (size_t)s * block + threadIdx.x * per;

    Run st;
    if constexpr (kVec) {
      scan_run_vec<CB>(st, run, per, score);
    } else {
      for (int j = 0; j < per; ++j) score(st, run[j]);
    }

    int32_t total;
    const int32_t a0 = block_scan(st.r, 0, Add{}, buf, &total);
    const int32_t lm = st.lm == kInf ? kInf : a0 + st.lm;
    int32_t gmin;
    const int32_t m0 = block_scan(lm, kInf, Min{}, buf, &gmin);
    int32_t max_a = a0 + st.maxr;
    int32_t max_b = max(max_a - m0, st.rise);
    block_max2(max_a, max_b, buf);
    if (threadIdx.x == 0) {
      out[b] = total;
      out[nb + b] = total - gmin;
      out[2 * nb + b] = max_a;
      out[3 * nb + b] = max_b;
    }
  }
}

}  // namespace

// aug: int32 [nb * block], 16-byte aligned; words: int32 [n_words], n_words
// a power of two (codes index it modulo n_words); thr_q: one int32 on the
// device; out: int32 [4, nb].  block a multiple of 256 in [256, 32768].
// Returns a cudaError_t.
extern "C" int kst_screen_scan(const void* aug, int64_t nb, int32_t block,
                               const void* words, int32_t n_words,
                               int32_t class_bits, const void* thr_q,
                               void* out, int32_t num_sms, void* stream) {
  if (nb < 1 || block < 256 || block > 32768 || block % 256 ||
      n_words < 1 || (n_words & (n_words - 1)) ||
      ((uintptr_t)aug & 15) || (class_bits != 2 && class_bits != 4))
    return (int)cudaErrorInvalidValue;
  // a 16-bit code reaches word (code >> log2(32 / class_bits)) at most
  const int32_t reach = class_bits == 4 ? (1 << 13) : (1 << 12);
  const int32_t staged = n_words < reach ? n_words : reach;
  const int32_t table_pad = (staged + 31) & ~31;  // 128-byte aligned ring
  const bool vec = block % 1024 == 0 && (block <= 8192 || block % 8192 == 0);
  const int threads = vec && block < 8192 ? block / kSub : kMaxThreads;
  const size_t stage_bytes = (size_t)block * sizeof(int32_t);
  const size_t table_bytes = (size_t)table_pad * sizeof(int32_t);
  const int stages = table_bytes + 2 * stage_bytes <= (size_t)kSmemLimit ? 2
                                                                          : 1;
  const size_t smem = table_bytes + stages * stage_bytes;

  void (*kernel)(const int32_t*, const int32_t*, int32_t, int32_t, int32_t,
                 const int32_t*, int32_t, int64_t, int32_t, int32_t*);
  if (class_bits == 4 && vec)
    kernel = screen_scan_kernel<4, true>;
  else if (class_bits == 4)
    kernel = screen_scan_kernel<4, false>;
  else if (vec)
    kernel = screen_scan_kernel<2, true>;
  else
    kernel = screen_scan_kernel<2, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t fill = (int64_t)num_sms * (per_sm > 0 ? per_sm : 1);
  const int64_t grid = fill < nb ? fill : nb;
  kernel<<<(unsigned)grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(aug), static_cast<const int32_t*>(words),
      n_words, staged, table_pad, static_cast<const int32_t*>(thr_q), block,
      nb, stages, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
