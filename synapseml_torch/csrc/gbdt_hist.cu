// Deterministic GBDT level histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel synapseml_tpu/gbdt/pallas_hist.py::_hist_kernel
// (launched by pallas_segment_histogram, called once per feature inside
// lax.scan by trees._level_histogram). That kernel builds one-hot tiles in
// VMEM and feeds the MXU, because a scatter-add is serialised on the TPU.
// Here a scatter into shared memory is cheap, so the kernel scatters, and one
// launch of gbdt_level_hist() computes the whole level:
//
//   hist[w, f, b, c] = sum over rows r with node[r] - base == w and
//                      bins[r, f] == b of data_c[r],   data = (grad, hess, presence)
//
// for w < W, f < F, b < B, c < 3. Rows whose node is outside [base, base+W)
// and bins outside [0, B) add nothing. With bins == NULL every row has bin 0
// (F = 1, B = 1): the per-node totals of the final level.
//
// Determinism. Float atomics add in a different order on every run, and one
// flipped near-tie split changes the whole forest. So every value is turned
// into a 64-bit integer with one power-of-two scale per channel and launch,
// 2^k with k = 61 - bitlen(N) - exponent(max|value|), chosen so that no sum of
// N values can overflow; integer adds give the same sum in any order. The
// scale comes from a device-side max reduction (no host sync). Scaling runs in
// double, where a float times 2^k is exact for every k the rule gives (-99 to
// 209 for finite values), then rounds half to even; the sums are converted
// to float32 once: float((double)sum * 2^-k). Every step is exact or
// correctly rounded, so the plain version in synapseml_torch/gbdt/hist.py
// reproduces the kernel bit for bit.
//
// Launches, in order, on the caller's stream:
//   1. cudaMemsetAsync of the int64 accumulator and the three max words;
//   2. absmax_kernel: max |grad|, |hess|, |presence| over all N rows (float
//      bit patterns of non-negative values order as unsigned ints, so
//      atomicMax on them is exact and order-free);
//   3. hist_kernel, grid (feature groups, row chunks, segment tiles): each
//      block owns a group of features, a chunk of rows and a tile of the
//      W*B (node, bin) segments, and accumulates in shared memory, each
//      64-bit sum kept as a (low, high) pair of 32-bit words added with
//      32-bit atomics (see add_split; a 64-bit shared atomic add is a
//      compare-and-swap loop, and the kernel ran 1.8x slower with it on an
//      H100). It then adds its
//      nonzero sums to the global int64 accumulator (64-bit global atomics,
//      which the hardware has). The feature axis sits in the grid; a group
//      holds as many features as the shared tile allows (all 28 of Higgs at
//      width 1, one at width 32 with 256 bins), and a tile covers as many
//      segments as fit (all 8192 at width 32);
//   4. convert_kernel: int64 sums -> float32 (W, F, B, 3).
//
// Bound, at the Higgs shape (N = 1e6, F = 28, B = 256, uint8 bins): the bytes
// it must move, N*F (bins) + 4*N*4 (grad, hess, presence, node) + W*F*B*3*4
// (the histogram) = 44.1 MB at width 1 and 46.8 MB at width 32, 13.2-14.0 us
// at 3.35 TB/s. Its arithmetic is negligible. This first version is held up by
// the shared-memory atomics (3 to 6 per row and feature), by strided bin reads
// where a block holds one feature, by the second pass over grad/hess/presence
// for the scale, and by the int64 accumulator's memset, flush and conversion
// (5.5 MB at width 32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSlotBytes = 3 * 2 * sizeof(unsigned int);  // one segment: 3 channels, lo + hi
constexpr int kMaxSmemBytes = 224 * 1024;                 // of the 227 KB a block may use
constexpr int kMaxSegs = kMaxSmemBytes / kSlotBytes;

// The channel's scale exponent: |value| * 2^k < 2^(61 - bitlen(n)), so a sum
// of n scaled values stays below 2^61.
__device__ __forceinline__ int scale_exp(unsigned int maxbits, int n) {
  int e = 0;
  frexpf(__uint_as_float(maxbits), &e);
  const int nb = n > 0 ? 32 - __clz(n) : 0;
  const int k = 61 - nb - e;
  return min(max(k, -1000), 1000);
}

__device__ __forceinline__ double pow2(int k) {  // exact for -1022 <= k <= 1023
  return __longlong_as_double((long long)(k + 1023) << 52);
}

__global__ void absmax_kernel(const float* __restrict__ g, const float* __restrict__ h,
                              const float* __restrict__ p, int n,
                              unsigned int* __restrict__ maxbits) {
  unsigned int mg = 0, mh = 0, mp = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    mg = max(mg, __float_as_uint(fabsf(g[i])));
    mh = max(mh, __float_as_uint(fabsf(h[i])));
    mp = max(mp, __float_as_uint(fabsf(p[i])));
  }
  // warp, then block: one atomic per block and channel (same-address
  // atomics from every warp of a large grid serialise at the L2)
  __shared__ unsigned int part[3][32];
  for (int off = 16; off > 0; off >>= 1) {
    mg = max(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    mh = max(mh, __shfl_xor_sync(0xffffffffu, mh, off));
    mp = max(mp, __shfl_xor_sync(0xffffffffu, mp, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = mg;
    part[1][warp] = mh;
    part[2][warp] = mp;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned int m = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) m = max(m, part[threadIdx.x][i]);
    atomicMax(&maxbits[threadIdx.x], m);
  }
}

// Adds the 64-bit q into a shared (lo, hi) pair with 32-bit atomics, which
// the hardware has for shared memory (a 64-bit one is a compare-and-swap
// loop): the low words wrap modulo 2^32 and each wrap carries one into the
// high word. The pair's total is the same whatever the order of the adds.
__device__ __forceinline__ void add_split(unsigned int* lo, int* hi, long long q) {
  const unsigned int qlo = (unsigned int)q;
  const unsigned int old = atomicAdd(lo, qlo);
  const int carry_hi = (int)(q >> 32) + (old + qlo < old ? 1 : 0);
  if (carry_hi) atomicAdd(hi, carry_hi);
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ g,
            const float* __restrict__ h, const float* __restrict__ p,
            const int* __restrict__ node, int n, int F, int base, int W, int B,
            int group, int seg_tile, int rows_per_block,
            const unsigned int* __restrict__ maxbits,
            unsigned long long* __restrict__ acc) {
  // planes [channel][group][seg_tile] of low words, then of high words: a
  // warp's random segments spread over all 32 banks
  extern __shared__ unsigned int sh[];
  const int plane = group * seg_tile;
  unsigned int* lo = sh;
  int* hi = reinterpret_cast<int*>(sh + 3 * plane);
  const int f0 = blockIdx.x * group;
  const int nf = min(group, F - f0);
  const int s0 = blockIdx.z * seg_tile;
  const int ns = min(seg_tile, W * B - s0);
  for (int i = threadIdx.x; i < 6 * plane; i += blockDim.x) sh[i] = 0u;
  const double scale_g = pow2(scale_exp(maxbits[0], n));
  const double scale_h = pow2(scale_exp(maxbits[1], n));
  const double scale_p = pow2(scale_exp(maxbits[2], n));
  __syncthreads();

  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min((long long)n, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int w = node[r] - base;
    if (w < 0 || w >= W) continue;
    const long long qg = __double2ll_rn((double)g[r] * scale_g);
    const long long qh = __double2ll_rn((double)h[r] * scale_h);
    const long long qp = __double2ll_rn((double)p[r] * scale_p);
    const int seg0 = w * B - s0;
    const BinT* row = bins == nullptr ? nullptr : bins + r * F + f0;
    for (int j = 0; j < nf; ++j) {
      const int b = row == nullptr ? 0 : (int)row[j];
      if (b < 0 || b >= B) continue;
      const int s = seg0 + b;
      if (s < 0 || s >= ns) continue;
      const int at = j * seg_tile + s;
      if (qg) add_split(lo + at, hi + at, qg);
      if (qh) add_split(lo + plane + at, hi + plane + at, qh);
      if (qp) add_split(lo + 2 * plane + at, hi + 2 * plane + at, qp);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < 3 * nf * ns; i += blockDim.x) {
    const int s = i % ns;
    const int t = i / ns;
    const int j = t % nf;
    const int c = t / nf;
    const int at = c * plane + j * seg_tile + s;
    const unsigned long long v =
        ((unsigned long long)(unsigned int)hi[at] << 32) + (unsigned long long)lo[at];
    if (v == 0ull) continue;
    const int seg = s0 + s;
    const int w = seg / B;
    const int b = seg - w * B;
    atomicAdd(acc + (((long long)w * F + f0 + j) * B + b) * 3 + c, v);
  }
}

__global__ void convert_kernel(const unsigned long long* __restrict__ acc,
                               float* __restrict__ out, long long total, int n,
                               const unsigned int* __restrict__ maxbits) {
  double inv[3];
  for (int c = 0; c < 3; ++c) inv[c] = pow2(-scale_exp(maxbits[c], n));
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = __double2float_rn(__ll2double_rn((long long)acc[i]) * inv[i % 3]);
  }
}

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

template <typename BinT>
cudaError_t launch_hist(const BinT* bins, const float* g, const float* h, const float* p,
                        const int* node, int n, int F, int base, int W, int B,
                        const unsigned int* maxbits, unsigned long long* acc,
                        cudaStream_t stream) {
  const long long WB = (long long)W * B;
  const int seg_tile = (int)(WB < kMaxSegs ? WB : kMaxSegs);
  const int tiles = ceil_div(WB, seg_tile);
  int group = kMaxSegs / seg_tile;
  if (group > F) group = F;
  const int groups = ceil_div(F, group);
  group = ceil_div(F, groups);  // even out the groups
  const int smem = group * seg_tile * kSlotBytes;

  cudaError_t err = cudaFuncSetAttribute(hist_kernel<BinT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel<BinT>, kThreads, smem);
  if (per_sm < 1) per_sm = 1;
  // one wave of blocks, split over row chunks; a chunk keeps at least four
  // rows per segment of its tile, so the flush stays small beside the scatter
  const long long resident = (long long)sms * per_sm;
  long long chunks = resident / ((long long)groups * tiles);
  const long long max_chunks = n / (4LL * seg_tile);
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  if (chunks > 65535) chunks = 65535;
  const int rows_per_block = ceil_div(n, chunks);
  dim3 grid(groups, (unsigned)chunks, tiles);
  hist_kernel<BinT><<<grid, kThreads, smem, stream>>>(
      bins, g, h, p, node, n, F, base, W, B, group, seg_tile, rows_per_block, maxbits, acc);
  return cudaGetLastError();
}

}  // namespace

// bins: [n, F] row-major, uint8 (bin_bytes 1), int32 (bin_bytes 4), or NULL
// (bin_bytes 0: every row in bin 0; F and B must be 1). out: float32
// [W, F, B, 3]. scratch: int64 [W*F*B*3 + 2], zeroed here. Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int gbdt_level_hist(const void* bins, int bin_bytes, const float* grad,
                               const float* hess, const float* presence, const int* node,
                               int n, int F, int base, int W, int B, float* out,
                               void* scratch, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const long long total = (long long)W * F * B * 3;
  unsigned long long* acc = static_cast<unsigned long long*>(scratch);
  unsigned int* maxbits = reinterpret_cast<unsigned int*>(acc + total);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (total + 2) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = n < 256 * 1024 ? ceil_div(n, 256) : 1024;
    absmax_kernel<<<blocks, 256, 0, stream>>>(grad, hess, presence, n, maxbits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (bin_bytes == 1)
      err = launch_hist(static_cast<const uint8_t*>(bins), grad, hess, presence, node, n, F,
                        base, W, B, maxbits, acc, stream);
    else
      err = launch_hist(static_cast<const int32_t*>(bins), grad, hess, presence, node, n, F,
                        base, W, B, maxbits, acc, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = total < 256LL * 4096 ? ceil_div(total, 256) : 4096;
  convert_kernel<<<blocks, 256, 0, stream>>>(acc, out, total, n, maxbits);
  return (int)cudaGetLastError();
}
