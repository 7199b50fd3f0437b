// Windowed counts: from a group's codes to K3's input in one pass.
//
// Replaces no Pallas kernel.  The JAX package's window_group
// (kmer_spans_tpu/ops/window.py) is two XLA cumsums, and the port's plain
// version (ops/window.py window_group + dist_values) is two int32
// torch.cumsums over a [T, m + window] tile, a chain of compares and masks,
// and the combined (kmer, count) indices.  For the window starting at s,
// tracked row t and window w:
//
//   cnt[t, s]    = #{p in [s + k - 1, s + w - 1] : kv[p] && code[p] == tr[t]}
//                  (0 where the window is invalid)
//   wv[s]        = no invalid base in [s, s + w - 1]
//   values[t, s] = cnt[t, s] + t * (w + 2) [+ seg[s] * nbins]
//   valid[t, s]  = wv[s]
//
// positions at or past n read as N.  The count moves by at most one a
// start: cnt[t, s + 1] = cnt[t, s] + [hit at s + w] - [hit at s + k - 1],
// and the invalid bases of the window likewise, so each position is
// compared and added in once a row, never summed into a prefix in global
// memory.
//
// What bounds it on an H100: bytes.  It reads 6 B a position (int32 code,
// k-mer validity, base validity) and writes K3's input, 5 B a row a start
// (int32 value, bool mask), 1 B of window validity a start and, with
// positions asked for, 4 B more a row: ~81 B a start at T = 16, 0.34 GB for
// a group of 2^22 starts, >= 0.10 ms at 3.35 TB/s.  The operations (two
// compares and a scan step a row a start) are far below the card's rate.
//
// What the design does about it: a CTA takes a run of consecutive starts
// (1 to 16 sub-tiles of 1024) and stages, aligned with its starts, the
// codes and flags entering (start + w) and leaving (start + k - 1, and the
// base at the start) in shared memory: each input byte comes from device
// memory about twice, whatever w.  Per row, the first window's count is
// summed once, then each sub-tile gives every thread 4 consecutive
// starts: the ±1 steps are prefix-summed in the thread, across the warp by
// shuffles and across the 8 warps through shared memory, so one barrier a
// row a sub-tile.  The rows are stored along the starts, 16 bytes of
// values and 4 of masks a thread, coalesced.  The run grows with w, so
// that the first window lies in the staged leaving arrays (beyond 16
// sub-tiles it is read from L2), and shrinks on short inputs so that the
// grid still covers the card.  Counts are exact integers, so the outputs
// equal the plain version's bit for bit, whatever the tiling.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                    // starts a thread holds
constexpr int kTile = kThreads * kPer;     // starts of a sub-tile
constexpr int kMaxRunTiles = 16;           // 176 KiB of shared memory
constexpr int kFillRunTiles = 4;           // the run where w does not ask more
constexpr int kSmemPerStart = 4 + 4 + 1 + 1 + 1;

struct Args {
  const int32_t* codes;    // [n], from the group's first start
  const uint8_t* kv;       // [n] k-mer validity
  const uint8_t* v;        // [n] base validity (non-N)
  int64_t n;
  const int32_t* tracked;  // [T]
  int32_t T;
  int32_t k;
  int32_t window;
  int64_t m;               // window starts
  const int32_t* seg;      // [m] each start's scaffold, or null
  uint32_t nbins;          // T * (window + 2): the bins of one scaffold
  int32_t* values;         // [T, m]
  uint8_t* valid;          // [T, m]
  uint8_t* wv;             // [m]
  int32_t* cnt;            // [T, m], or null
  int32_t run;             // starts a CTA takes, a multiple of kTile
};

// The CTA's sum of x, in every thread.  The caller puts a barrier between
// two calls (the sub-tile loop has one), as red is reused.
__device__ __forceinline__ int block_sum(int x, int* red) {
  x = __reduce_add_sync(0xffffffffu, x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// The exclusive prefix, in thread order, of each thread's tot over the
// CTA; all gets the CTA's total.  wtot is double-buffered by parity: a
// thread writes the next buffer only after this barrier, which every
// thread passes after reading the last one.
__device__ __forceinline__ int tile_scan(int tot, int (*wtot)[kWarps],
                                         int& parity, int& all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  int* buf = wtot[parity];
  parity ^= 1;
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  int before = 0;
  all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = buf[w];
    all += x;
    before += w < warp ? x : 0;
  }
  return before + incl - tot;
}

__device__ __forceinline__ int hit(uint8_t flag, int32_t code, int32_t tc) {
  return (flag & 1) && code == tc;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) window_counts_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wtot[2][kWarps];
  __shared__ int red[kWarps];
  const int run = a.run;
  int32_t* ecode = reinterpret_cast<int32_t*>(smem);  // code at start + w
  int32_t* lcode = ecode + run;                       // code at start + k - 1
  uint8_t* eflag = reinterpret_cast<uint8_t*>(lcode + run);
  uint8_t* lflag = eflag + run;
  uint8_t* wvs = lflag + run;                         // the run's wv
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * run;
  const int64_t n = a.n;
  const int k1 = a.k - 1, w = a.window;

  // flags: bit 0 the k-mer's validity, bit 1 the base's (eflag: both at
  // start + w; lflag: the k-mer at start + k - 1, the base at the start)
  for (int j = tid; j < run; j += kThreads) {
    const int64_t pe = r0 + j + w, pl = r0 + j + k1, pv = r0 + j;
    const bool ie = pe < n, il = pl < n;
    ecode[j] = ie ? __ldg(a.codes + pe) : 0;
    eflag[j] = ie ? (uint8_t)(__ldg(a.kv + pe) | (__ldg(a.v + pe) << 1)) : 0;
    lcode[j] = il ? __ldg(a.codes + pl) : 0;
    lflag[j] = (uint8_t)((il ? __ldg(a.kv + pl) : 0) |
                         (pv < n ? __ldg(a.v + pv) << 1 : 0));
  }

  __syncthreads();
  // the first window of the run lies in the leaving arrays when w <= run:
  // its bases at lflag[0, w), its k-mers at lcode[0, w - k + 1)
  const bool staged = w <= run;

  // window validity: the invalid bases of [r0, r0 + w), then a step a start
  int part = 0;
  for (int x = tid; x < w; x += kThreads) {
    const int64_t p = r0 + x;
    part += staged ? !(lflag[x] & 2) : !(p < n && __ldg(a.v + p));
  }
  int carry = block_sum(part, red);
  int parity = 0;
  for (int s0 = 0; s0 < run; s0 += kTile) {
    const int j0 = s0 + kPer * tid;
    const uchar4 ef = *reinterpret_cast<const uchar4*>(eflag + j0);
    const uchar4 lf = *reinterpret_cast<const uchar4*>(lflag + j0);
    // invalid entering less invalid leaving = valid leaving less entering
    const int d0 = ((lf.x >> 1) & 1) - ((ef.x >> 1) & 1);
    const int d1 = ((lf.y >> 1) & 1) - ((ef.y >> 1) & 1);
    const int d2 = ((lf.z >> 1) & 1) - ((ef.z >> 1) & 1);
    const int d3 = ((lf.w >> 1) & 1) - ((ef.w >> 1) & 1);
    int all;
    int c = carry + tile_scan(d0 + d1 + d2 + d3, wtot, parity, all);
    uchar4 o;
    o.x = c == 0;
    c += d0;
    o.y = c == 0;
    c += d1;
    o.z = c == 0;
    c += d2;
    o.w = c == 0;
    *reinterpret_cast<uchar4*>(wvs + j0) = o;
    const int64_t s = r0 + j0;
    if (kVec) {
      if (s < a.m) *reinterpret_cast<uchar4*>(a.wv + s) = o;
    } else {
      const uint8_t b[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        if (s + e < a.m) a.wv[s + e] = b[e];
    }
    carry += all;
  }

  // the rows: the first window's count, then a step a start
  for (int t = 0; t < a.T; ++t) {
    const int32_t tc = __ldg(a.tracked + t);
    part = 0;
    for (int x = tid; x < w - k1; x += kThreads) {
      const int64_t p = r0 + k1 + x;
      part += staged ? hit(lflag[x], lcode[x], tc)
                     : p < n && __ldg(a.kv + p) && __ldg(a.codes + p) == tc;
    }
    carry = block_sum(part, red);
    const uint32_t row = (uint32_t)t * (uint32_t)(w + 2);
    int32_t* vrow = a.values + (int64_t)t * a.m;
    uint8_t* mrow = a.valid + (int64_t)t * a.m;
    int32_t* crow = a.cnt ? a.cnt + (int64_t)t * a.m : nullptr;
    for (int s0 = 0; s0 < run; s0 += kTile) {
      const int j0 = s0 + kPer * tid;
      const int4 ec = *reinterpret_cast<const int4*>(ecode + j0);
      const int4 lc = *reinterpret_cast<const int4*>(lcode + j0);
      const uchar4 ef = *reinterpret_cast<const uchar4*>(eflag + j0);
      const uchar4 lf = *reinterpret_cast<const uchar4*>(lflag + j0);
      const int d0 = hit(ef.x, ec.x, tc) - hit(lf.x, lc.x, tc);
      const int d1 = hit(ef.y, ec.y, tc) - hit(lf.y, lc.y, tc);
      const int d2 = hit(ef.z, ec.z, tc) - hit(lf.z, lc.z, tc);
      const int d3 = hit(ef.w, ec.w, tc) - hit(lf.w, lc.w, tc);
      int all;
      const int c0 = carry + tile_scan(d0 + d1 + d2 + d3, wtot, parity, all);
      carry += all;
      const int64_t s = r0 + j0;
      if (s >= a.m) continue;  // no barrier follows in this iteration
      const uchar4 ok = *reinterpret_cast<const uchar4*>(wvs + j0);
      int4 cv;
      cv.x = ok.x ? c0 : 0;
      cv.y = ok.y ? c0 + d0 : 0;
      cv.z = ok.z ? c0 + d0 + d1 : 0;
      cv.w = ok.w ? c0 + d0 + d1 + d2 : 0;
      uint32_t off[kPer] = {row, row, row, row};
      if (a.seg) {
#pragma unroll
        for (int e = 0; e < kPer; ++e)
          if (s + e < a.m)
            off[e] += (uint32_t)__ldg(a.seg + s + e) * a.nbins;
      }
      int4 val;
      val.x = (int32_t)((uint32_t)cv.x + off[0]);
      val.y = (int32_t)((uint32_t)cv.y + off[1]);
      val.z = (int32_t)((uint32_t)cv.z + off[2]);
      val.w = (int32_t)((uint32_t)cv.w + off[3]);
      if (kVec) {
        *reinterpret_cast<int4*>(vrow + s) = val;
        *reinterpret_cast<uchar4*>(mrow + s) = ok;
        if (crow) *reinterpret_cast<int4*>(crow + s) = cv;
      } else {
        const int32_t vv[4] = {val.x, val.y, val.z, val.w};
        const int32_t cc[4] = {cv.x, cv.y, cv.z, cv.w};
        const uint8_t bb[4] = {ok.x, ok.y, ok.z, ok.w};
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          if (s + e < a.m) {
            vrow[s + e] = vv[e];
            mrow[s + e] = bb[e];
            if (crow) crow[s + e] = cc[e];
          }
        }
      }
    }
  }
}

}  // namespace

// codes: int32 [n], kv and v: bool [n], all from the group's first start
// (positions at or past n read as N); tracked: int32 [T]; seg: int32 [m]
// or null, with nbins = T * (window + 2), the bins of a scaffold; values:
// int32 [T, m]; valid: bool [T, m]; wv: bool [m]; cnt: int32 [T, m] or
// null.  1 <= k <= window.
// Returns a cudaError_t.
extern "C" int kst_window_counts(const void* codes, const void* kv,
                                 const void* v, int64_t n,
                                 const void* tracked, int32_t T, int32_t k,
                                 int32_t window, int64_t m, const void* seg,
                                 int32_t nbins, void* values, void* valid,
                                 void* wv, void* cnt, int32_t num_sms,
                                 void* stream) {
  if (n < 0 || m < 0 || T < 0 || k < 1 || window < k || nbins < 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  // a run of at least `window` starts, where the card stays full; at most
  // kMaxRunTiles sub-tiles of shared memory
  const int64_t by_window = ((int64_t)window + kTile - 1) / kTile;
  const int64_t by_fill = m / ((int64_t)kTile * (num_sms > 0 ? num_sms : 1));
  int64_t tiles = by_fill < kFillRunTiles ? by_fill : kFillRunTiles;
  if (tiles < by_window) tiles = by_window;
  if (tiles < 1) tiles = 1;
  if (tiles > kMaxRunTiles) tiles = kMaxRunTiles;
  Args a;
  a.codes = static_cast<const int32_t*>(codes);
  a.kv = static_cast<const uint8_t*>(kv);
  a.v = static_cast<const uint8_t*>(v);
  a.n = n;
  a.tracked = static_cast<const int32_t*>(tracked);
  a.T = T;
  a.k = k;
  a.window = window;
  a.m = m;
  a.seg = static_cast<const int32_t*>(seg);
  a.nbins = (uint32_t)nbins;
  a.values = static_cast<int32_t*>(values);
  a.valid = static_cast<uint8_t*>(valid);
  a.wv = static_cast<uint8_t*>(wv);
  a.cnt = static_cast<int32_t*>(cnt);
  a.run = (int32_t)(tiles * kTile);
  // rows start on 16-byte boundaries when m is a multiple of 4 (and the
  // outputs' bases are, as the allocator gives them)
  const bool vec = (m % 4) == 0 &&
                   (((uintptr_t)values | (uintptr_t)valid | (uintptr_t)wv |
                     (uintptr_t)cnt) & 15) == 0;
  void (*kernel)(Args) =
      vec ? window_counts_kernel<true> : window_counts_kernel<false>;
  const size_t smem = (size_t)a.run * kSmemPerStart;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t grid = (m + a.run - 1) / a.run;
  kernel<<<(unsigned)grid, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
