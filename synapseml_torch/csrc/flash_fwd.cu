// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C entry point loaded with ctypes (synapseml_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernel synapseml_tpu/ops/attention.py::
// _flash_fwd_kernel (launched by _flash_core_fwd_impl). Same function:
//   * q, k, v: [BH, T, D] row-major, float or bfloat16; mask: int32 [BH, Tk]
//     (nonzero = attend); out: [BH, Tq, D] in q's type; lse: f32 [BH, Tq].
//   * s = (q . k) * scale in f32, scale = 1/sqrt(true head dim) applied
//     after the dot; masked (and, when causal, kv > q) entries are set to
//     -1e30 and gated to p = 0 (s <= -5e29), so a fully masked row gives
//     O = 0 and a finite LSE, never NaN.
//   * online softmax over kv tiles; P is rounded to V's type before the PV
//     product, both products accumulate in f32; O = acc / max(l, 1e-30),
//     lse = m + log(max(l, 1e-30)).
//   * causal: kv tiles wholly above the diagonal are skipped.
//
// Design. The TPU kernel walks kv blocks as the sequential third grid axis
// and carries (m, l, acc) in VMEM scratch between grid steps. Blocks of a
// CUDA grid run in no order, so here one block owns a 64-row query tile and
// loops over all kv tiles itself; nothing carries between blocks and there
// are no atomics, so the output is deterministic. The grid is
// (B*H, ceil(Tq/64)): B*H goes on x, whose limit is 2^31-1, because large
// offline batches exceed y's limit of 65535.
//
// 128 threads (4 warps). Thread (tr = tid/8, tc = tid%8) owns query rows
// tr + 16*i (i < 4), score columns tc + 8*j (j < 8) and output columns
// tc + 8*j (j < D/8); the running max, sum and the f32 accumulator stay in
// its registers. Row reductions are three xor-shuffles over the 8 lanes
// that share a row. Q^T and K^T tiles (row stride 65 floats), the V tile
// and the P tile (row stride 72) live in dynamic shared memory as f32, so
// the inner loops read f32 without conversion and without bank conflicts.
//
// Bound on this card. At BERT-base scoring shapes (B*H = 384, T = 128,
// D = 64, bf16) the function reads q, k, v and the mask and writes out and
// lse: about 25.6 MB against 1.6 GFLOP, i.e. 7.6 us at 3.35 TB/s against
// 1.6 us at 989 TFLOP/s: bandwidth-bound. This first version reads each
// input once (one K/V pass per 64-row query tile: two passes at T = 128)
// but does both products with scalar f32 FMAs from shared memory, so it
// runs well above that bound; mma/wgmma tiles and vector loads are the
// next step (PERF.md records its time beside the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;   // query rows per block
constexpr int BLOCK_N = 64;   // kv rows per tile
constexpr int THREADS = 128;
constexpr int LDT = 65;       // row stride of the transposed Q/K tiles
constexpr int LDP = 72;       // row stride of the P tile
constexpr float NEG_INF = -1e30f;
constexpr float MASK_GATE = -5e29f;  // NEG_INF * 0.5, the TPU kernel's gate
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch and XLA cast
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 4));
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  return x + __shfl_xor_sync(FULL, x, 4);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * D * LDT + BLOCK_N * D + BLOCK_M * LDP) + sizeof(int) * BLOCK_N;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ mask, T* __restrict__ out, float* __restrict__ lse,
                 int tq, int tk, int causal, float scale) {
  constexpr int DC = D / 8;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_t = reinterpret_cast<float*>(smem_raw);  // [D][LDT]      Q^T
  float* k_t = q_t + D * LDT;                       // [D][LDT]      K^T
  float* v_s = k_t + D * LDT;                       // [BLOCK_N][D]  V
  float* p_s = v_s + BLOCK_N * D;                   // [BLOCK_M][LDP] P
  int* valid_s = reinterpret_cast<int*>(p_s + BLOCK_M * LDP);  // [BLOCK_N]

  const int tid = threadIdx.x;
  const int tr = tid / 8;
  const int tc = tid % 8;
  const size_t bh = blockIdx.x;
  const int q0 = blockIdx.y * BLOCK_M;

  const T* qg = q + bh * tq * D;
  const T* kg = k + bh * tk * D;
  const T* vg = v + bh * tk * D;
  const int* mg = mask + bh * tk;

  for (int e = tid; e < BLOCK_M * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = q0 + r;
    q_t[d * LDT + r] = row < tq ? to_f32(qg[(size_t)row * D + d]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int n_kv = (tk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    // tiles with kv0 <= last query row of this tile, as the TPU kernel's
    // pl.when(kv_blk * block_k <= (q_blk + 1) * block_q - 1)
    n_kv = min(n_kv, (q0 + BLOCK_M - 1) / BLOCK_N + 1);
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int kv0 = kt * BLOCK_N;
    __syncthreads();  // the previous tile's K, V, P are no longer read
    for (int e = tid; e < BLOCK_N * D; e += THREADS) {
      const int r = e / D, d = e % D;
      const int col = kv0 + r;
      float kx = 0.f, vx = 0.f;
      if (col < tk) {
        kx = to_f32(kg[(size_t)col * D + d]);
        vx = to_f32(vg[(size_t)col * D + d]);
      }
      k_t[d * LDT + r] = kx;
      v_s[r * D + d] = vx;
    }
    if (tid < BLOCK_N) {
      const int col = kv0 + tid;
      valid_s[tid] = col < tk && mg[col] != 0;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_t[d * LDT + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = k_t[d * LDT + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cj = tc + 8 * j;
        const bool ok = valid_s[cj] && (!causal || kv0 + cj <= row);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max8(mx));
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // gate, not just subtract: on a fully masked row s == m_new == -1e30
        // and exp(0) would count masked entries
        const float p = s[i][j] <= MASK_GATE ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        p_s[(tr + 16 * i) * LDP + tc + 8 * j] = to_f32(from_f32<T>(p));
      }
      l_i[i] = l_i[i] * alpha + row_sum8(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BLOCK_N; ++c) {
      float a[4], b[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = p_s[(tr + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) b[j] = v_s[c * D + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row < tq) {
      const float safe_l = fmaxf(l_i[i], 1e-30f);
      T* og = out + (bh * tq + row) * D;
#pragma unroll
      for (int j = 0; j < DC; ++j) og[tc + 8 * j] = from_f32<T>(acc[i][j] / safe_l);
      if (tc == 0) lse[bh * tq + row] = m_i[i] + logf(safe_l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           void* lse, int bh, int tq, int tk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (tq + BLOCK_M - 1) / BLOCK_M);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<T*>(out), static_cast<float*>(lse),
      tq, tk, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* mask, void* out,
               void* lse, int bh, int tq, int tk, int d, int causal, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, mask, out, lse, bh, tq, tk, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, mask, out, lse, bh, tq, tk, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, mask, out, lse, bh, tq, tk, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success); launches on `stream` and allocates nothing.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                         void* out, void* lse, int bh, int tq, int tk, int d, int causal,
                         float scale, int dtype, void* stream) {
  if (bh <= 0 || tq <= 0 || tk < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, mask, out, lse, bh, tq, tk, d, causal, scale, s);
    case 1: return dispatch_d<__nv_bfloat16>(q, k, v, mask, out, lse, bh, tq, tk, d, causal,
                                             scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
