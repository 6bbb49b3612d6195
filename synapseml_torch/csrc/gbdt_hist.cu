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
// into a 64-bit integer with one power-of-two scale per channel, 2^k with
// k = 61 - bitlen(N) - exponent(max|value|) over all N rows, chosen so that no
// sum of N values can overflow; integer adds give the same sum in any order.
// Scaling runs in double, where a float times 2^k is exact for every k the
// rule gives (-99 to 209 for finite values), then rounds half to even; the
// sums are converted to float32 once: float((double)sum * 2^-k). Every step is
// exact or correctly rounded, so the plain version in
// synapseml_torch/gbdt/hist.py reproduces the kernel bit for bit.
//
// The scale depends on grad, hess, presence and N only, none of which changes
// while a tree grows, so gbdt_hist_scales() computes the three exponents once
// a tree (gbdt_scale_kernel: a max reduction whose last block, found by an
// atomic ticket, turns the maxima into exponents) and every level's launch
// reads them from the device. A level is one kernel, gbdt_hist_kernel, and no
// other device operation: its int64 accumulator and tickets live in a scratch
// buffer that the caller zeroes once and that each launch leaves zeroed.
//
// Rows split over processes (a data-parallel fit). Each process holds some
// of the rows; the histogram of all of them must be the one-process
// histogram bit for bit. So every process quantises with the same k: the
// scale pass takes the one-process row count (n_scale) instead of its own,
// and the caller reduces the exponents with MIN across the processes, which
// gives the k of the largest |value| anywhere (k falls as the maximum rises).
// The level launch then writes the raw int64 sums (sums != NULL) instead of
// converting them; the caller adds them across the processes (integer adds,
// in any order) and converts once, float((double)sum * 2^-k), as the kernel
// does. With sums == NULL and n_scale == n the launch is the one-process one.
//
// The level kernel. Grid (segment tiles x row chunks x feature groups), one
// 1024-thread block an SM. A block's tile is S consecutive (node, bin)
// segments (whole nodes where they fit) times G features, S * G <= 8192, each
// 64-bit sum a (low, high) pair of 32-bit words in shared memory (192 KB):
//   - a warp reads the node ids of 4 x 32 rows at once, drops the rows outside
//     its tile's nodes after that 4-byte read, loads the values of the rest and
//     stages them (row, node, three quantised values: 32 bytes) until it holds
//     32; then each lane adds one staged row, feature by feature, its bins read
//     as 4-byte words (uint8 bins, 4-aligned) all at once;
//   - add_split adds a 64-bit value with 32-bit shared atomics: the low word,
//     and the high word only when it changes (a 0/1 presence has a zero low
//     word, so it costs one atomic); a 64-bit shared atomic add compiles to a
//     compare-and-swap loop (ATOMS.CAST.SPIN.64) and ran slower;
//   - the two blocks of a cluster (two row chunks of one tile, on neighbouring
//     SMs) sum their tiles through distributed shared memory, each half of the
//     slots, and add the nonzero sums to the global accumulator; the last block
//     of a (tile, group) to finish, found with an atomic ticket after
//     __threadfence(), converts it to float32, writes it out and zeroes its
//     part of the accumulator and its ticket.
// Tiles keep at least 4 features where they can: at the Higgs shape (N = 1e6,
// F = 28, B = 256) width 1 is one tile of 28 features, width 32 four tiles of 8
// nodes x 7 groups of 4 features. Measured on an H100 (PERF.md): one feature
// a tile (the earlier kernel's split at width 32) re-reads every row once a
// feature; one node a tile scans every node id once a node and waits on those
// loads; a warp's lanes owning one feature each (no bank conflicts) lost to
// the serial load-then-add chain of one row a step; larger clusters (4) and
// fewer warps lost.
//
// Bound, at the Higgs shape: the bytes it must move, N*F (bins) + 4*N*4
// (grad, hess, presence, node) + W*F*B*3*4 (the histogram) = 44.1 MB at width
// 1 and 46.8 MB at width 32, 13.2-14.0 us at 3.35 TB/s. Its arithmetic is
// negligible. What sets its time is the shared-memory atomic unit: 5 atomics a
// (row, feature) pair (2 for grad, 2 for hess, 1 for the count), about half of
// a level's time at width 1; the rest is the loop's loads and the flush.

#include <cuda_runtime.h>
#include <stdint.h>
#include <cooperative_groups.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 8192;       // (segment, feature) sums a block holds: 192 KB
constexpr int kMinGroup = 4;       // features a tile keeps at least, where it can
constexpr int kMaxGroup = 32;      // features a tile holds at most
constexpr int kAhead = 4;          // batches of 32 rows a warp loads at once
constexpr int kConvert = 8;        // sums a thread of the converting block loads at once
constexpr int kCluster = 2;        // row chunks of a tile that sum their tiles before the flush
constexpr int kStageBytes = kWarps * 32 * 32;         // 32 rows x 32 B a warp: 32 KB
constexpr int kSmemBytes = 6 * kSlots * 4 + kStageBytes;  // at most 224 KB of the 227 KB
constexpr int kMaxDevices = 64;

// Words of shared memory before the stage: lo, hi x 3 channels of G x S sums,
// rounded up to 16 bytes.
__host__ __device__ constexpr int stage_offset(int G, int S) { return (6 * G * S + 3) & ~3; }

// A staged row: its three quantised values, its index and its node in the level.
struct alignas(16) Staged {
  long long q0, q1, q2;
  int row, w;
};

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

// buf (int32, zeroed by the caller): [0..2] max |value| bit patterns, [3] the
// ticket, [4..6] the exponents for a sum of n_scale values.
__global__ void gbdt_scale_kernel(const float* __restrict__ g, const float* __restrict__ h,
                                  const float* __restrict__ p, int n, int n_scale,
                                  int* __restrict__ buf) {
  unsigned int mg = 0, mh = 0, mp = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    // float bit patterns of non-negative values order as unsigned ints
    mg = max(mg, __float_as_uint(fabsf(g[i])));
    mh = max(mh, __float_as_uint(fabsf(h[i])));
    mp = max(mp, __float_as_uint(fabsf(p[i])));
  }
  __shared__ unsigned int part[3][32];
  __shared__ bool last;
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
    atomicMax(reinterpret_cast<unsigned int*>(buf) + threadIdx.x, m);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(buf + 3, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last && threadIdx.x < 3) {
    const unsigned int m = atomicOr(reinterpret_cast<unsigned int*>(buf) + threadIdx.x, 0u);
    buf[4 + threadIdx.x] = scale_exp(m, n_scale);
  }
}

// Adds the 64-bit q into a shared (lo, hi) pair with 32-bit atomics: the low
// words wrap modulo 2^32 and each wrap carries one into the high word. The
// pair's total is the same whatever the order of the adds.
__device__ __forceinline__ void add_split(unsigned int* lo, int* hi, long long q) {
  const unsigned int qlo = (unsigned int)q;
  int carry_hi = (int)(q >> 32);
  if (qlo) {
    const unsigned int old = atomicAdd(lo, qlo);
    carry_hi += old + qlo < old ? 1 : 0;
  }
  if (carry_hi) atomicAdd(hi, carry_hi);
}

// Adds one row (its index, its node in the level and its three quantised
// values) to the block's tile, feature by feature; the sums of channel c,
// feature j, segment s sit at c * plane + j * S + s.
template <typename BinT>
__device__ __forceinline__ void add_row(long long r, int w, long long q0, long long q1,
                                        long long q2, const BinT* __restrict__ bins, int F,
                                        int f0, int nf, int B, int s0, int S, int ns,
                                        bool words, unsigned int* lo, int* hi) {
  const int seg0 = w * B - s0;
  const int plane = nf * S;
  auto add = [&](int j, int b) {
    const int seg = seg0 + b;
    if (b < 0 || b >= B || seg < 0 || seg >= ns) return;
    const int at = j * S + seg;
    add_split(lo + at, hi + at, q0);
    add_split(lo + plane + at, hi + plane + at, q1);
    add_split(lo + 2 * plane + at, hi + 2 * plane + at, q2);
  };
  if (bins == nullptr) {
    add(0, 0);
  } else if (words) {  // uint8 bins, 4-aligned: the row's bins as 4-byte words, loaded at once
    const unsigned int* row = reinterpret_cast<const unsigned int*>(bins + r * F + f0);
    unsigned int wd[kMaxGroup / 4];
#pragma unroll
    for (int k = 0; k < kMaxGroup / 4; ++k) wd[k] = 4 * k < nf ? __ldg(row + k) : 0u;
#pragma unroll
    for (int k = 0; k < kMaxGroup / 4; ++k) {
      if (4 * k >= nf) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * k + e < nf) add(4 * k + e, (int)((wd[k] >> (8 * e)) & 0xffu));
    }
  } else {
    const BinT* row = bins + r * F + f0;
#pragma unroll 4
    for (int j = 0; j < nf; ++j) add(j, (int)__ldg(row + j));
  }
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads, 1)
gbdt_hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ g,
                 const float* __restrict__ h, const float* __restrict__ p,
                 const int* __restrict__ node, int n, int F, int base, int W, int B, int S,
                 int G, int rows_per_chunk, const int* __restrict__ exps,
                 unsigned long long* __restrict__ acc, unsigned int* __restrict__ tickets,
                 float* __restrict__ out, long long* __restrict__ sums) {
  extern __shared__ __align__(16) unsigned int sh[];
  Staged* stage = reinterpret_cast<Staged*>(sh + stage_offset(G, S)) + (threadIdx.x >> 5) * 32;
  __shared__ bool last;

  const int tile = blockIdx.x, group = blockIdx.z;
  const int f0 = group * G;
  const int nf = min(G, F - f0);
  const int s0 = tile * S;
  const int ns = (int)min((long long)S, (long long)W * B - s0);
  const int w_lo = s0 / B, w_hi = (s0 + ns - 1) / B;  // the tile's nodes
  const int plane = nf * S;
  unsigned int* lo = sh;
  int* hi = reinterpret_cast<int*>(sh + 3 * plane);
  const int lane = threadIdx.x & 31;
  const bool words = sizeof(BinT) == 1 && ((F | f0 | (int)(uintptr_t)bins) & 3) == 0;

  for (int i = threadIdx.x; i < 6 * plane; i += kThreads) sh[i] = 0u;
  const double scale_g = pow2(exps[0]), scale_h = pow2(exps[1]), scale_p = pow2(exps[2]);
  __syncthreads();

  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min((long long)n, r0 + rows_per_chunk);
  // a warp drops the rows outside its tile after their 4-byte node id and
  // stages the rest until it holds 32, then adds them, one a lane
  int cnt = 0;  // rows this warp has staged (the same in every lane)
  auto add_staged = [&]() {
    __syncwarp();
    if (lane < cnt) {
      const Staged st = stage[lane];
      add_row(st.row, st.w, st.q0, st.q1, st.q2, bins, F, f0, nf, B, s0, S, ns, words, lo, hi);
    }
    __syncwarp();
  };
  for (long long rb = r0 + (threadIdx.x & ~31) * kAhead; rb < r1; rb += kThreads * kAhead) {
    // kAhead batches of 32 rows: their node ids, then the values of the
    // rows in the tile, all loads in flight at once
    int wv[kAhead];
    float gv[kAhead], hv[kAhead], pv[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long r = rb + a * 32 + lane;
      wv[a] = r < r1 ? node[r] - base : -1;
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const long long r = rb + a * 32 + lane;
      if (wv[a] >= w_lo && wv[a] <= w_hi) {
        gv[a] = g[r];
        hv[a] = h[r];
        pv[a] = p[r];
      } else {
        wv[a] = -1;
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const unsigned int ball = __ballot_sync(0xffffffffu, wv[a] >= 0);
      const int m = __popc(ball);
      if (cnt + m > 32) {
        add_staged();
        cnt = 0;
      }
      if (wv[a] >= 0) {
        Staged st;
        st.q0 = __double2ll_rn((double)gv[a] * scale_g);
        st.q1 = __double2ll_rn((double)hv[a] * scale_h);
        st.q2 = __double2ll_rn((double)pv[a] * scale_p);
        st.row = (int)(rb + a * 32 + lane);
        st.w = wv[a];
        stage[cnt + __popc(ball & ((1u << lane) - 1u))] = st;
      }
      cnt += m;
    }
  }
  if (cnt) add_staged();
  __syncthreads();

  // flush: the blocks of a cluster (row chunks of one tile) sum their tiles
  // through distributed shared memory, each a share of the slots
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();
  for (int i = rank * kThreads + threadIdx.x; i < 3 * plane; i += nc * kThreads) {
    const int c = i / plane, t = i - c * plane, j = t / S, s = t - j * S;
    if (s >= ns) continue;
    unsigned long long v = 0ull;
    for (int k = 0; k < nc; ++k) {
      const unsigned int* rlo = cluster.map_shared_rank(lo, k);
      const int* rhi = cluster.map_shared_rank(hi, k);
      v += ((unsigned long long)(unsigned int)rhi[i] << 32) + rlo[i];
    }
    if (v == 0ull) continue;
    const int seg = s0 + s, w = seg / B, b = seg - w * B;
    atomicAdd(acc + (((long long)w * F + f0 + j) * B + b) * 3 + c, v);
  }
  cluster.sync();
  __threadfence();
  __syncthreads();
  unsigned int* ticket = tickets + (long long)tile * gridDim.z + group;
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;

  // the last block of this (tile, group): convert (or hand over the raw sums),
  // and leave the scratch zeroed
  __threadfence();
  const double inv_g = pow2(-exps[0]), inv_h = pow2(-exps[1]), inv_p = pow2(-exps[2]);
  const int total = 3 * nf * ns;
  for (int i0 = threadIdx.x; i0 < total; i0 += kConvert * kThreads) {
    long long at[kConvert], v[kConvert];
#pragma unroll
    for (int u = 0; u < kConvert; ++u) {  // all loads first, then the stores
      const int i = i0 + u * kThreads;
      const int c = i % 3, t = i / 3, s = t % ns, j = t / ns;
      const int seg = s0 + s, w = seg / B, b = seg - w * B;
      at[u] = i < total ? (((long long)w * F + f0 + j) * B + b) * 3 + c : -1;
      v[u] = at[u] < 0 ? 0 : __ldcg(reinterpret_cast<const long long*>(acc) + at[u]);
    }
#pragma unroll
    for (int u = 0; u < kConvert; ++u) {
      if (at[u] < 0) continue;
      const int c = (i0 + u * kThreads) % 3;
      acc[at[u]] = 0ull;
      if (sums != nullptr) {
        sums[at[u]] = v[u];
        continue;
      }
      const double inv = c == 0 ? inv_g : c == 1 ? inv_h : inv_p;
      out[at[u]] = __double2float_rn(__ll2double_rn(v[u]) * inv);
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// A block's tile: S consecutive (node, bin) segments of the level, whole
// nodes where a node fits, times a group of G features, S * G <= kSlots.
struct Layout {
  int S, G;
  long long tiles, groups, acc_words, ticket_words;
};

Layout layout(int F, int W, int B) {
  Layout l;
  const long long WB = (long long)W * B;
  const int gmin = F < kMinGroup ? F : kMinGroup;
  long long S = kSlots / gmin;
  if (S >= B) S -= S % B;
  l.S = (int)(WB < S ? WB : S);
  int gmax = kSlots / l.S;
  gmax = gmax < kMaxGroup ? gmax : kMaxGroup;
  l.groups = ceil_div(F, gmax < F ? gmax : F);
  l.G = (int)ceil_div(F, l.groups);  // even out the groups, in whole 4-byte words of bins
  if (l.G % 4 && l.G > 4 && (l.G + 3) / 4 * 4 <= gmax) l.G = (l.G + 3) / 4 * 4;
  l.groups = ceil_div(F, l.G);
  l.tiles = ceil_div(WB, l.S);
  l.acc_words = (long long)W * F * B * 3;
  l.ticket_words = ceil_div(l.tiles * l.groups, 2);  // uint32 tickets in int64 words
  return l;
}

struct DeviceInfo {
  bool ready[2];
  int sms;
};
DeviceInfo g_devices[kMaxDevices];

template <typename BinT>
cudaError_t launch_hist(const BinT* bins, const float* g, const float* h, const float* p,
                        const int* node, int n, int F, int base, int W, int B, const int* exps,
                        float* out, long long* sums, unsigned long long* scratch, int device,
                        cudaStream_t stream) {
  DeviceInfo& info = g_devices[device];
  const int kind = sizeof(BinT) == 1 ? 0 : 1;
  if (!info.ready[kind]) {  // once per device and bin type: no host query per call
    cudaError_t err = cudaFuncSetAttribute(gbdt_hist_kernel<BinT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemBytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    info.ready[kind] = true;
  }
  const Layout l = layout(F, W, B);
  // one block an SM (up to 224 KB of shared memory); row chunks fill the
  // card, at least 1024 rows each, in clusters of kCluster chunks of a tile
  long long chunks = info.sms / (l.tiles * l.groups);
  chunks = chunks < ceil_div(n, kThreads) ? chunks : ceil_div(n, kThreads);
  if (chunks < 1) chunks = 1;
  int cl = kCluster;
  while (cl > 1 && chunks < cl) cl >>= 1;
  chunks -= chunks % cl;
  const int rows_per_chunk = (int)ceil_div(n, chunks);
  dim3 grid((unsigned)l.tiles, (unsigned)chunks, (unsigned)l.groups);
  const int smem = stage_offset(l.G, l.S) * 4 + kStageBytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cl;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, gbdt_hist_kernel<BinT>, bins, g, h, p, node, n, F, base, W, B, l.S, l.G,
      rows_per_chunk, exps, scratch, reinterpret_cast<unsigned int*>(scratch + l.acc_words), out,
      sums);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// int64 words of scratch a level launch of this shape needs: the accumulator
// and one ticket per (segment tile, feature group). A scratch that fits the
// widest level fits every narrower one.
extern "C" long long gbdt_hist_scratch_words(int F, int W, int B) {
  const Layout l = layout(F, W, B);
  return l.acc_words + l.ticket_words;
}

// The per-tree scale: buf int32 [8], zeroed by the caller; on return (in
// stream order) buf[4..6] hold the exponents of grad, hess and presence for a
// sum of n_scale values (n for a one-process fit; the fit's row count when
// its rows are split over processes).
extern "C" int gbdt_hist_scales(const float* grad, const float* hess, const float* presence,
                                int n, int n_scale, int* buf, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int blocks = n < 256 * 1024 ? (int)ceil_div(n > 0 ? n : 1, 256) : 1024;
  gbdt_scale_kernel<<<blocks, 256, 0, stream>>>(grad, hess, presence, n, n_scale, buf);
  return (int)cudaGetLastError();
}

// bins: [n, F] row-major, uint8 (bin_bytes 1), int32 (bin_bytes 4), or NULL
// (bin_bytes 0: every row in bin 0; F and B must be 1). exps: int32 [3] from
// gbdt_hist_scales. out: float32 [W, F, B, 3], every element written; or,
// with sums non-NULL, sums: int64 [W, F, B, 3], the raw fixed-point sums, every
// element written (out is not touched). scratch: int64 [scratch_words], zero on
// entry and left zero. One kernel launch; returns cudaGetLastError() after it
// (0 = success).
extern "C" int gbdt_level_hist(const void* bins, int bin_bytes, const float* grad,
                               const float* hess, const float* presence, const int* node,
                               int n, int F, int base, int W, int B, const int* exps, float* out,
                               long long* sums, void* scratch, long long scratch_words,
                               int device, void* stream_ptr) {
  if (device < 0 || device >= kMaxDevices || scratch_words < gbdt_hist_scratch_words(F, W, B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  unsigned long long* acc = static_cast<unsigned long long*>(scratch);
  cudaError_t err;
  if (bin_bytes == 4)
    err = launch_hist(static_cast<const int32_t*>(bins), grad, hess, presence, node, n, F, base,
                      W, B, exps, out, sums, acc, device, stream);
  else
    err = launch_hist(static_cast<const uint8_t*>(bins), grad, hess, presence, node, n, F, base,
                      W, B, exps, out, sums, acc, device, stream);
  return (int)err;
}
