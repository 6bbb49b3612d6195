// Flash-attention backward for Hopper (sm_90a), bound to Python through a
// plain C entry point loaded with ctypes (synapseml_torch/ops/attention.py).
//
// Replaces synapseml_tpu/ops/attention.py::_flash_core_bwd, the backward
// that jax.custom_vjp gives the Pallas forward. That one is XLA (lax.scan
// over kv blocks for dq, over q blocks for dk and dv), not a Pallas kernel;
// it is a kernel here because what defines flash attention is memory,
// O(T * block) and never the [T, T] score matrix, and a plain PyTorch loop
// over block pairs would take thousands of launches a training step. Same
// function, given the forward's output O and its natural-log LSE:
//   * delta_i = sum_d f32(O_id) * f32(dO_id);
//   * P is recomputed as exp(s - lse) with s = (q . k) * scale in f32,
//     gated to 0 where the mask (or, when causal, kv > q) removes the entry,
//     as _flash_core_bwd's `s <= -5e29` gate: a fully masked row and a
//     padded key get exactly zero gradient;
//   * dV += P^T dO with P rounded to dO's type; dP = dO V^T;
//     dS = P * (dP - delta); dQ += scale * dS K and dK += scale * dS^T Q with
//     dS rounded to the input type; every product accumulates in f32.
//   * q, k, v, O, dO: [B, T, H, D] with any (batch, token, head) element
//     strides, D innermost, 16-byte aligned; mask: int32 [B, tk]; lse and
//     delta (scratch written here): f32 [B*H, tq]; dq, dk, dv: contiguous
//     [B, T, H, D] in the input type.
//
// Three kernels, one after the other on the caller's stream, and no
// atomics, so a second launch is bitwise the first:
//   (a) flash_bwd_delta_kernel: delta, a group of D/8 (bf16) or D/4 (f32)
//       lanes a row, one 16-byte load each of O and dO, shuffled sum.
//   (b) dk/dv: one block per (batch*head, 64-row kv tile), looping over the
//       q tiles; under causal the q tiles wholly before the kv tile are
//       skipped.
//   (c) dq: one block per (batch*head, 64-row q tile), looping over the kv
//       tiles; under causal the kv tiles wholly above the diagonal are
//       skipped.
// (b) and (c) both recompute S and dP: 7 products of 2*T*T*D per (batch,
// head) instead of 5, the price of no atomics and no [T, T] buffer.
//
// Bound on this card. At BERT-base training shapes (B*H = 384, T = 128,
// D = 64) the function reads q, k, v, O and dO and writes dq, dk and dv:
// about 50.3 MB in bf16, 15.0 us at 3.35 TB/s, against 5 products of
// 0.805 GFLOP, 4.1 us at 989 TFLOP/s: bound by bytes. At B*H = 96, T = 512
// the bytes are 4x fewer per product and it is bound by operations.
//
// bf16: flash_bwd_dkdv_mma_kernel and flash_bwd_dq_mma_kernel, mma.sync
// m16n8k16 with f32 accumulators, four warps, warp w owning rows
// 16w..16w+15 of the block's tile, every operand pattern of the forward:
//   * an A operand from a tile's rows (K and V in (b), Q and dO in (c))
//     through ldmatrix, held in registers up to D = 64;
//   * a B operand whose n runs over a tile's rows (Q^T, dO^T in (b); K^T,
//     V^T in (c)) through ldmatrix, and one whose k runs over them (dO and Q
//     in (b), K in (c)) through ldmatrix.trans;
//   * P^T, dS^T and dS are the m16n8 accumulators rounded to bf16, used
//     directly as A operands (the forward's P trick): no P goes through
//     shared memory.
// The streamed tiles arrive by 16-byte cp.async, double-buffered, with the
// LSE, delta or mask entries beside them by 4-byte cp.async. dK, dV and dQ
// are staged through shared memory and written with 16-byte stores.
//
// f32: flash_bwd_dkdv_f32_kernel and flash_bwd_dq_f32_kernel on the CUDA
// cores (FFMA, exact f32), 256 threads as a 16 x 16 grid, each thread a
// 4 x 4 block of S and dP and a 4 x D/16 block of its outputs, every tile in
// shared memory with rows padded by one float (conflict-free column reads).
// Simple and exact; a tensor-core f32 backward (split TF32, as the forward)
// is later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const int* mask;    // [B, tk]
  const float* lse;   // [B*H, tq]
  float* delta;       // [B*H, tq], written by (a)
  void* dq;           // contiguous [B, tq, H, d]
  void* dk;           // contiguous [B, tk, H, d]
  void* dv;
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int64_t g_sb, g_st, g_sh;  // dO
  int B, H, tq, tk, causal;
  float scale;
};

// ---------------------------------------------------------------- delta ----

template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const BwdParams p) {
  constexpr int VEC = 16 / sizeof(T);  // elements in one 16-byte load
  constexpr int L = D / VEC;           // lanes a row: a power of two dividing 32
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.tq;
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t r = gid / L;  // row (b, t, h), h fastest
  const int c = static_cast<int>(gid % L) * VEC;
  float acc = 0.f;
  int b = 0, t = 0, h = 0;
  if (r < rows) {
    h = static_cast<int>(r % p.H);
    const int64_t bt = r / p.H;
    t = static_cast<int>(bt % p.tq);
    b = static_cast<int>(bt / p.tq);
    const uint4 o4 = *reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.out) + b * p.o_sb + t * p.o_st + h * p.o_sh + c);
    const uint4 g4 = *reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.dout) + b * p.g_sb + t * p.g_st + h * p.g_sh + c);
    const T* o = reinterpret_cast<const T*>(&o4);
    const T* g = reinterpret_cast<const T*>(&g4);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if constexpr (sizeof(T) == 2) {
        acc = fmaf(__bfloat162float(o[i]), __bfloat162float(g[i]), acc);
      } else {
        acc = fmaf(o[i], g[i], acc);
      }
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2) acc += __shfl_xor_sync(FULL, acc, off);
  if (r < rows && gid % L == 0) p.delta[(static_cast<int64_t>(b) * p.H + h) * p.tq + t] = acc;
}

// ---------------------------------------------------------------- bf16 ----

template <int D>
struct BwdTile {
  static constexpr int LD = D + 8;             // padded row, in bf16
  static constexpr int ROW = LD * 2;           // bytes
  static constexpr int BYTES = BLOCK_M * ROW;  // one 64-row tile
  static constexpr int CH = D / 8;             // 16-byte chunks a row
  static constexpr int RS = THREADS / CH;      // rows one pass of the block loads
  // six tiles, then two 64-entry f32 or int vectors, double-buffered
  static constexpr size_t SMEM = 6 * BYTES + 4 * BLOCK_M * sizeof(float);
};

// The warp's 16 rows of an f32 accumulator, times `scale`, rounded to bf16
// into its own rows of a shared tile at `so` (row stride ROW bytes), then
// copied to rows row0 + 16 * warp ... (below `limit`) of `dst` (token
// stride `st`) with 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows_bf16(unsigned char* so, const float (&acc)[D / 8][4],
                                                float scale, bf16* dst, int64_t st, int row0,
                                                int limit, int warp, int lane) {
  using M = BwdTile<D>;
  const int g = lane / 4, t = lane % 4;
  so += warp * 16 * M::ROW;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(so + g * M::ROW + (n * 8 + 2 * t) * 2) =
        pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * M::ROW + (n * 8 + 2 * t) * 2) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * M::CH / 32; ++i) {
    const int c = lane + i * 32;
    const int r = c / M::CH, cc = c % M::CH;
    const int row = row0 + warp * 16 + r;
    if (row < limit)
      *reinterpret_cast<uint4*>(dst + row * st + cc * 8) =
          *reinterpret_cast<const uint4*>(so + r * M::ROW + cc * 16);
  }
}

// (b) dK and dV of one 64-row kv tile. Warp w owns kv rows 16w..16w+15 and
// computes, per q tile, S^T = K Q^T and dP^T = V dO^T (16 x 64 each), then
// dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
flash_bwd_dkdv_mma_kernel(const BwdParams p) {
  using M = BwdTile<D>;
  constexpr int KS = D / 16;       // k-steps over D
  constexpr int NT = D / 8;        // 8-column tiles of dK and dV
  constexpr bool HOLD = D <= 64;   // K and V fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [64][LD] K, [64][LD] V, [2][64][LD] Q, [2][64][LD] dO, [2][64] lse, [2][64] delta
  const uint32_t sk = smem_addr(smem_raw);
  const uint32_t sv = sk + M::BYTES;
  const uint32_t sq = sv + M::BYTES;
  const uint32_t sg = sq + 2 * M::BYTES;
  const uint32_t sstat = sg + 2 * M::BYTES;
  const float* lse_s = reinterpret_cast<const float*>(smem_raw + 6 * M::BYTES);
  const float* delta_s = lse_s + 2 * BLOCK_M;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_bh = gridDim.x / n_tiles(p.tk);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / p.H, h = bh % p.H;
  const int kv0 = blockIdx.x / n_bh * BLOCK_N;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* gg = static_cast<const bf16*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const float* lse_g = p.lse + static_cast<int64_t>(bh) * p.tq;
  const float* delta_g = p.delta + static_cast<int64_t>(bh) * p.tq;
  const int* mg = p.mask + static_cast<int64_t>(b) * p.tk;
  const int n_q = n_tiles(p.tq);
  // causal: q tiles whose last row lies before kv0 see none of this tile
  const int q_first = p.causal ? kv0 / BLOCK_M : 0;

  const int ld_row = tid / M::CH, ld_col = tid % M::CH * 8;
  const uint32_t ld_smem = ld_row * M::ROW + ld_col * 2;
  load_tile<M::RS, M::ROW>(sk + ld_smem, kg + (kv0 + ld_row) * p.k_st + ld_col, p.k_st,
                           kv0 + ld_row, p.tk, kg);
  load_tile<M::RS, M::ROW>(sv + ld_smem, vg + (kv0 + ld_row) * p.v_st + ld_col, p.v_st,
                           kv0 + ld_row, p.tk, vg);
  cp_async_commit();
  auto load_q = [&](int i) {
    const int q0 = i * BLOCK_M;
    const int buf = (i - q_first) & 1;
    load_tile<M::RS, M::ROW>(sq + buf * M::BYTES + ld_smem, qg + (q0 + ld_row) * p.q_st + ld_col,
                             p.q_st, q0 + ld_row, p.tq, qg);
    load_tile<M::RS, M::ROW>(sg + buf * M::BYTES + ld_smem, gg + (q0 + ld_row) * p.g_st + ld_col,
                             p.g_st, q0 + ld_row, p.tq, gg);
    if (tid < 2 * BLOCK_M) {  // lse (threads 0-63) and delta (64-127) of the tile's rows
      const int r = tid % BLOCK_M, row = q0 + r;
      const float* src = tid < BLOCK_M ? lse_g : delta_g;
      cp_async4(sstat + ((tid / BLOCK_M * 2 + buf) * BLOCK_M + r) * 4,
                row < p.tq ? src + row : src, row < p.tq);
    }
    cp_async_commit();
  };
  if (q_first < n_q) load_q(q_first);

  // this thread's two kv rows, and whether each may be attended at all
  const int row_a = kv0 + warp * 16 + g, row_b = row_a + 8;
  const bool ok_a = row_a < p.tk && mg[row_a] != 0;
  const bool ok_b = row_b < p.tk && mg[row_b] != 0;
  const float scale2 = p.scale * LOG2E;

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  uint32_t kf[HOLD ? KS : 1][4], vf[HOLD ? KS : 1][4];
  // this lane's ldmatrix row addresses: A from the warp's rows of K and V;
  // B with n over Q/dO rows; B with k over Q/dO rows (transposed)
  const uint32_t a_lane = (warp * 16 + lane % 16) * M::ROW + (lane / 16) * 16;
  const uint32_t bn_lane = (lane % 8) * M::ROW + (lane / 8) * 16;
  const uint32_t bt_lane = (lane % 8 + (lane / 8 & 1) * 8) * M::ROW + (lane / 16) * 16;

  for (int i = q_first; i < n_q; ++i) {
    const int it = i - q_first, q0 = i * BLOCK_M;
    const uint32_t buf = (it & 1) * M::BYTES;
    if (i + 1 < n_q) {
      load_q(i + 1);  // into the other buffer, freed by the last iteration's sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (HOLD && it == 0) {
#pragma unroll
      for (int ks = 0; ks < (HOLD ? KS : 1); ++ks) {
        ldmatrix_x4(kf[ks], sk + a_lane + ks * 32);
        ldmatrix_x4(vf[ks], sv + a_lane + ks * 32);
      }
    }

    // S^T = K Q^T and dP^T = V dO^T: 16 x 64 per warp, 8 tiles of m16n8
    float st[8][4], dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t qb[4], gb[4];  // b0, b1 of k-steps 2kk and 2kk + 1
        ldmatrix_x4(qb, sq + buf + bn_lane + n * 8 * M::ROW + kk * 64);
        ldmatrix_x4(gb, sg + buf + bn_lane + n * 8 * M::ROW + kk * 64);
        if constexpr (HOLD) {
          mma_bf16(st[n], kf[2 * kk], qb[0], qb[1]);
          mma_bf16(st[n], kf[2 * kk + 1], qb[2], qb[3]);
          mma_bf16(dpt[n], vf[2 * kk], gb[0], gb[1]);
          mma_bf16(dpt[n], vf[2 * kk + 1], gb[2], gb[3]);
        } else {
          uint32_t ka[4], va[4];
          ldmatrix_x4(ka, sk + a_lane + kk * 64);
          ldmatrix_x4(va, sv + a_lane + kk * 64);
          mma_bf16(st[n], ka, qb[0], qb[1]);
          mma_bf16(dpt[n], va, gb[0], gb[1]);
          ldmatrix_x4(ka, sk + a_lane + kk * 64 + 32);
          ldmatrix_x4(va, sv + a_lane + kk * 64 + 32);
          mma_bf16(st[n], ka, qb[2], qb[3]);
          mma_bf16(dpt[n], va, gb[2], gb[3]);
        }
      }
    }

    // P^T = exp(s - lse) where attended, else 0; dS^T = P^T (dP^T - delta).
    // Element e of tile n: kv row (e < 2 ? row_a : row_b), q column
    // q0 + n*8 + 2t + (e & 1).
    const float* lse_t = lse_s + (it & 1) * BLOCK_M;
    const float* delta_t = delta_s + (it & 1) * BLOCK_M;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int q = q0 + col, kv = e < 2 ? row_a : row_b;
        const bool ok = (e < 2 ? ok_a : ok_b) && q < p.tq && (!p.causal || kv <= q);
        const float pv = ok ? exp2f(st[n][e] * scale2 - lse_t[col] * LOG2E) : 0.f;
        st[n][e] = pv;
        dpt[n][e] = pv * (dpt[n][e] - delta_t[col]);
      }

    // dV += P^T dO and dK += dS^T Q: k runs over the tile's 64 q rows
#pragma unroll
    for (int kk = 0; kk < BLOCK_M / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t gb[4], qb[4];  // b0, b1 of output tiles 2dn and 2dn + 1
        ldmatrix_x4_trans(gb, sg + buf + bt_lane + kk * 16 * M::ROW + dn * 32);
        mma_bf16(dv[2 * dn], pa, gb[0], gb[1]);
        mma_bf16(dv[2 * dn + 1], pa, gb[2], gb[3]);
        ldmatrix_x4_trans(qb, sq + buf + bt_lane + kk * 16 * M::ROW + dn * 32);
        mma_bf16(dk[2 * dn], sa, qb[0], qb[1]);
        mma_bf16(dk[2 * dn + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled at the top of iteration it + 2
  }
  cp_async_wait<0>();
  __syncthreads();  // K and V tiles are free (also when no q tile ran)

  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  const int64_t o_b = (static_cast<int64_t>(b) * p.tk * p.H + h) * D;
  store_rows_bf16<D>(smem_raw, dk, p.scale, static_cast<bf16*>(p.dk) + o_b, o_st, kv0, p.tk,
                     warp, lane);
  store_rows_bf16<D>(smem_raw + M::BYTES, dv, 1.f, static_cast<bf16*>(p.dv) + o_b, o_st, kv0,
                     p.tk, warp, lane);
}

// (c) dQ of one 64-row q tile. Warp w owns q rows 16w..16w+15 and computes,
// per kv tile, S = Q K^T and dP = dO V^T (16 x 64 each), then dQ += dS K.
template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 2 : 1)
flash_bwd_dq_mma_kernel(const BwdParams p) {
  using M = BwdTile<D>;
  constexpr int KS = D / 16;
  constexpr int NT = D / 8;
  constexpr bool HOLD = D <= 64;   // Q and dO fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [64][LD] Q, [64][LD] dO, [2][64][LD] K, [2][64][LD] V, [2][64] mask
  const uint32_t sq = smem_addr(smem_raw);
  const uint32_t sg = sq + M::BYTES;
  const uint32_t sk = sg + M::BYTES;
  const uint32_t sv = sk + 2 * M::BYTES;
  const uint32_t smask = sv + 2 * M::BYTES;
  const int* mask_s = reinterpret_cast<const int*>(smem_raw + 6 * M::BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_bh = gridDim.x / n_tiles(p.tq);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x / n_bh * BLOCK_M;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* gg = static_cast<const bf16*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const int* mg = p.mask + static_cast<int64_t>(b) * p.tk;
  int n_kv = n_tiles(p.tk);
  if (p.causal) n_kv = min(n_kv, (q0 + BLOCK_M - 1) / BLOCK_N + 1);

  const int ld_row = tid / M::CH, ld_col = tid % M::CH * 8;
  const uint32_t ld_smem = ld_row * M::ROW + ld_col * 2;
  auto load_kv = [&](int j) {
    const int kv0 = j * BLOCK_N;
    const uint32_t buf = (j & 1) * M::BYTES;
    load_tile<M::RS, M::ROW>(sk + buf + ld_smem, kg + (kv0 + ld_row) * p.k_st + ld_col, p.k_st,
                             kv0 + ld_row, p.tk, kg);
    load_tile<M::RS, M::ROW>(sv + buf + ld_smem, vg + (kv0 + ld_row) * p.v_st + ld_col, p.v_st,
                             kv0 + ld_row, p.tk, vg);
    if (tid < BLOCK_N) {
      const int col = kv0 + tid;
      cp_async4(smask + ((j & 1) * BLOCK_N + tid) * 4, col < p.tk ? mg + col : mg,
                col < p.tk);
    }
    cp_async_commit();
  };
  load_tile<M::RS, M::ROW>(sq + ld_smem, qg + (q0 + ld_row) * p.q_st + ld_col, p.q_st,
                           q0 + ld_row, p.tq, qg);
  load_tile<M::RS, M::ROW>(sg + ld_smem, gg + (q0 + ld_row) * p.g_st + ld_col, p.g_st,
                           q0 + ld_row, p.tq, gg);
  cp_async_commit();
  if (n_kv > 0) load_kv(0);

  // this thread's two q rows, their LSE (base 2) and delta
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float* lse_g = p.lse + static_cast<int64_t>(bh) * p.tq;
  const float* delta_g = p.delta + static_cast<int64_t>(bh) * p.tq;
  const float lse2[2] = {row_a < p.tq ? lse_g[row_a] * LOG2E : 0.f,
                         row_b < p.tq ? lse_g[row_b] * LOG2E : 0.f};
  const float dl[2] = {row_a < p.tq ? delta_g[row_a] : 0.f,
                       row_b < p.tq ? delta_g[row_b] : 0.f};
  const float scale2 = p.scale * LOG2E;

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  uint32_t qf[HOLD ? KS : 1][4], gf[HOLD ? KS : 1][4];
  const uint32_t a_lane = (warp * 16 + lane % 16) * M::ROW + (lane / 16) * 16;
  const uint32_t bn_lane = (lane % 8) * M::ROW + (lane / 8) * 16;
  const uint32_t bt_lane = (lane % 8 + (lane / 8 & 1) * 8) * M::ROW + (lane / 16) * 16;

  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BLOCK_N;
    const uint32_t buf = (j & 1) * M::BYTES;
    if (j + 1 < n_kv) {
      load_kv(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (HOLD && j == 0) {
#pragma unroll
      for (int ks = 0; ks < (HOLD ? KS : 1); ++ks) {
        ldmatrix_x4(qf[ks], sq + a_lane + ks * 32);
        ldmatrix_x4(gf[ks], sg + a_lane + ks * 32);
      }
    }

    // S = Q K^T and dP = dO V^T: 16 x 64 per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, sk + buf + bn_lane + n * 8 * M::ROW + kk * 64);
        ldmatrix_x4(vb, sv + buf + bn_lane + n * 8 * M::ROW + kk * 64);
        if constexpr (HOLD) {
          mma_bf16(s[n], qf[2 * kk], kb[0], kb[1]);
          mma_bf16(s[n], qf[2 * kk + 1], kb[2], kb[3]);
          mma_bf16(dp[n], gf[2 * kk], vb[0], vb[1]);
          mma_bf16(dp[n], gf[2 * kk + 1], vb[2], vb[3]);
        } else {
          uint32_t qa[4], ga[4];
          ldmatrix_x4(qa, sq + a_lane + kk * 64);
          ldmatrix_x4(ga, sg + a_lane + kk * 64);
          mma_bf16(s[n], qa, kb[0], kb[1]);
          mma_bf16(dp[n], ga, vb[0], vb[1]);
          ldmatrix_x4(qa, sq + a_lane + kk * 64 + 32);
          ldmatrix_x4(ga, sg + a_lane + kk * 64 + 32);
          mma_bf16(s[n], qa, kb[2], kb[3]);
          mma_bf16(dp[n], ga, vb[2], vb[3]);
        }
      }
    }

    // dS = P (dP - delta), P = exp(s - lse) where attended, else 0
    const int* mask_t = mask_s + (j & 1) * BLOCK_N;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int2 m2 = *reinterpret_cast<const int2*>(mask_t + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = kv0 + n * 8 + 2 * t + (e & 1);
        const int q = e < 2 ? row_a : row_b;
        const bool ok = ((e & 1) ? m2.y : m2.x) != 0 && (!p.causal || kv <= q);
        const float pv = ok ? exp2f(s[n][e] * scale2 - lse2[e >> 1]) : 0.f;
        s[n][e] = pv * (dp[n][e] - dl[e >> 1]);
      }
    }

    // dQ += dS K: k runs over the tile's 64 kv rows
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t sa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, sk + buf + bt_lane + kk * 16 * M::ROW + dn * 32);
        mma_bf16(dq[2 * dn], sa, kb[0], kb[1]);
        mma_bf16(dq[2 * dn + 1], sa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled at the top of iteration j + 1
  }
  cp_async_wait<0>();
  __syncthreads();  // the Q tile is free (also when no kv tile ran)

  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  const int64_t o_b = (static_cast<int64_t>(b) * p.tq * p.H + h) * D;
  store_rows_bf16<D>(smem_raw, dq, p.scale, static_cast<bf16*>(p.dq) + o_b, o_st, q0, p.tq,
                     warp, lane);
}

// ----------------------------------------------------------------- f32 ----

constexpr int F_THREADS = 256;  // a 16 x 16 grid: (ty, tx)

template <int D>
struct F32Tile {
  static constexpr int LD = D + 1;             // padded row, in floats
  static constexpr int TILE = BLOCK_M * LD;    // floats in one 64-row tile
  static constexpr int PLD = BLOCK_N + 1;      // a [64][64] P or dS tile's row
  // four tiles, one or two [64][65] tiles, three 64-entry vectors
  static constexpr size_t SMEM_DKDV = (4 * TILE + 2 * BLOCK_M * PLD + 3 * BLOCK_M) * 4;
  static constexpr size_t SMEM_DQ = (4 * TILE + BLOCK_M * PLD + 3 * BLOCK_M) * 4;
};

// rows row0.. of a [T, D] slice (token stride st) into a padded tile; rows
// at or past `limit` are zero
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int64_t st, int row0,
                                              int limit) {
  for (int e = threadIdx.x; e < BLOCK_M * D; e += F_THREADS) {
    const int r = e / D, c = e % D;
    dst[r * F32Tile<D>::LD + c] = row0 + r < limit ? src[(row0 + r) * st + c] : 0.f;
  }
}

// S = A B^T and dP = G W^T over D for this thread's 4 x 4 entries (rows
// ty + 16a of A and G, rows tx + 16b of B and W)
template <int D>
__device__ __forceinline__ void two_products_f32(const float* a, const float* bt, const float* gt,
                                                 const float* wt, int ty, int tx,
                                                 float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int LD = F32Tile<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], gv[4], bv[4], wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * LD + d];
      gv[i] = gt[(ty + 16 * i) * LD + d];
      bv[i] = bt[(tx + 16 * i) * LD + d];
      wv[i] = wt[(tx + 16 * i) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], wv[j], dp[i][j]);
      }
  }
}

// (b) in f32: per q tile, S and dP (q rows x kv columns), P and dS into
// shared memory, then dV += P^T dO and dK += dS^T Q for this thread's kv
// rows ty + 16a and columns tx + 16c.
template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dkdv_f32_kernel(const BwdParams p) {
  using M = F32Tile<D>;
  constexpr int LD = M::LD, PLD = M::PLD, C = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);
  float* vs = ks + M::TILE;
  float* qs = vs + M::TILE;
  float* gs = qs + M::TILE;
  float* ps = gs + M::TILE;
  float* dss = ps + BLOCK_M * PLD;
  float* lse_s = dss + BLOCK_M * PLD;
  float* delta_s = lse_s + BLOCK_M;
  int* mask_s = reinterpret_cast<int*>(delta_s + BLOCK_M);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n_bh = gridDim.x / n_tiles(p.tk);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / p.H, h = bh % p.H;
  const int kv0 = blockIdx.x / n_bh * BLOCK_N;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gg = static_cast<const float*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const float* lse_g = p.lse + static_cast<int64_t>(bh) * p.tq;
  const float* delta_g = p.delta + static_cast<int64_t>(bh) * p.tq;
  const int* mg = p.mask + static_cast<int64_t>(b) * p.tk;

  load_rows_f32<D>(ks, kg, p.k_st, kv0, p.tk);
  load_rows_f32<D>(vs, vg, p.v_st, kv0, p.tk);
  if (tid < BLOCK_N) mask_s[tid] = kv0 + tid < p.tk ? mg[kv0 + tid] : 0;

  float dk[4][C], dv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[i][c] = dv[i][c] = 0.f;
  const int n_q = n_tiles(p.tq);
  for (int qi = p.causal ? kv0 / BLOCK_M : 0; qi < n_q; ++qi) {
    const int q0 = qi * BLOCK_M;
    __syncthreads();  // the last tile's reads are done
    load_rows_f32<D>(qs, qg, p.q_st, q0, p.tq);
    load_rows_f32<D>(gs, gg, p.g_st, q0, p.tq);
    if (tid < BLOCK_M) {
      lse_s[tid] = q0 + tid < p.tq ? lse_g[q0 + tid] : 0.f;
    } else if (tid < 2 * BLOCK_M) {
      const int r = tid - BLOCK_M;
      delta_s[r] = q0 + r < p.tq ? delta_g[q0 + r] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // q rows ty + 16i, kv columns tx + 16j
    two_products_f32<D>(qs, ks, gs, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int q = q0 + r, kv = kv0 + c;
        const bool ok = mask_s[c] != 0 && q < p.tq && (!p.causal || kv <= q);
        const float pv = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.f;
        ps[r * PLD + c] = pv;
        dss[r * PLD + c] = pv * (dp[i][j] - delta_s[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BLOCK_M; ++r) {
      float pv[4], sv[4], gv[C], qv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * PLD + ty + 16 * i];
        sv[i] = dss[r * PLD + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        gv[c] = gs[r * LD + tx + 16 * c];
        qv[c] = qs[r * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv[i][c] = fmaf(pv[i], gv[c], dv[i][c]);
          dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
        }
    }
  }

  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  const int64_t o_b = (static_cast<int64_t>(b) * p.tk * p.H + h) * D;
  float* dkg = static_cast<float*>(p.dk) + o_b;
  float* dvg = static_cast<float*>(p.dv) + o_b;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = kv0 + ty + 16 * i;
    if (row >= p.tk) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dkg[row * o_st + tx + 16 * c] = dk[i][c] * p.scale;
      dvg[row * o_st + tx + 16 * c] = dv[i][c];
    }
  }
}

// (c) in f32: per kv tile, S and dP, dS into shared memory, then dQ += dS K
// for this thread's q rows ty + 16a and columns tx + 16c.
template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dq_f32_kernel(const BwdParams p) {
  using M = F32Tile<D>;
  constexpr int LD = M::LD, PLD = M::PLD, C = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* gs = qs + M::TILE;
  float* ks = gs + M::TILE;
  float* vs = ks + M::TILE;
  float* dss = vs + M::TILE;
  float* lse_s = dss + BLOCK_M * PLD;
  float* delta_s = lse_s + BLOCK_M;
  int* mask_s = reinterpret_cast<int*>(delta_s + BLOCK_M);

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n_bh = gridDim.x / n_tiles(p.tq);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x / n_bh * BLOCK_M;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* gg = static_cast<const float*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const float* lse_g = p.lse + static_cast<int64_t>(bh) * p.tq;
  const float* delta_g = p.delta + static_cast<int64_t>(bh) * p.tq;
  const int* mg = p.mask + static_cast<int64_t>(b) * p.tk;
  int n_kv = n_tiles(p.tk);
  if (p.causal) n_kv = min(n_kv, (q0 + BLOCK_M - 1) / BLOCK_N + 1);

  load_rows_f32<D>(qs, qg, p.q_st, q0, p.tq);
  load_rows_f32<D>(gs, gg, p.g_st, q0, p.tq);
  if (tid < BLOCK_M) {
    lse_s[tid] = q0 + tid < p.tq ? lse_g[q0 + tid] : 0.f;
  } else if (tid < 2 * BLOCK_M) {
    const int r = tid - BLOCK_M;
    delta_s[r] = q0 + r < p.tq ? delta_g[q0 + r] : 0.f;
  }

  float dq[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dq[i][c] = 0.f;
  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BLOCK_N;
    __syncthreads();  // the last tile's reads are done
    load_rows_f32<D>(ks, kg, p.k_st, kv0, p.tk);
    load_rows_f32<D>(vs, vg, p.v_st, kv0, p.tk);
    if (tid < BLOCK_N) mask_s[tid] = kv0 + tid < p.tk ? mg[kv0 + tid] : 0;
    __syncthreads();

    float s[4][4], dp[4][4];  // q rows ty + 16i, kv columns tx + 16j
    two_products_f32<D>(qs, ks, gs, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = ty + 16 * i, c = tx + 16 * jj;
        const int q = q0 + r, kv = kv0 + c;
        const bool ok = mask_s[c] != 0 && (!p.causal || kv <= q);
        const float pv = ok ? expf(s[i][jj] * p.scale - lse_s[r]) : 0.f;
        dss[r * PLD + c] = pv * (dp[i][jj] - delta_s[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int c2 = 0; c2 < BLOCK_N; ++c2) {
      float sv[4], kv[C];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(ty + 16 * i) * PLD + c2];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = ks[c2 * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) dq[i][c] = fmaf(sv[i], kv[c], dq[i][c]);
    }
  }

  const int64_t o_st = static_cast<int64_t>(p.H) * D;
  float* dqg = static_cast<float*>(p.dq) + (static_cast<int64_t>(b) * p.tq * p.H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.tq) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) dqg[row * o_st + tx + 16 * c] = dq[i][c] * p.scale;
  }
}

// --------------------------------------------------------------- launch ----

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, int64_t blocks, const BwdParams& p,
           cudaStream_t stream) {
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int run(int dtype, const BwdParams& p, int bh, cudaStream_t s) {
  const int64_t rows = static_cast<int64_t>(bh) * p.tq;
  const int64_t kv_blocks = static_cast<int64_t>(bh) * n_tiles(p.tk);  // kv tile major
  const int64_t q_blocks = static_cast<int64_t>(bh) * n_tiles(p.tq);   // q tile major
  int err;
  switch (dtype) {
    case 0: {
      constexpr int64_t L = D / 4;
      if ((err = launch(flash_bwd_delta_kernel<float, D>, 256, 0, (rows * L + 255) / 256, p, s)))
        return err;
      if ((err = launch(flash_bwd_dkdv_f32_kernel<D>, F_THREADS, F32Tile<D>::SMEM_DKDV,
                        kv_blocks, p, s)))
        return err;
      return launch(flash_bwd_dq_f32_kernel<D>, F_THREADS, F32Tile<D>::SMEM_DQ, q_blocks, p, s);
    }
    case 1: {
      constexpr int64_t L = D / 8;
      if ((err = launch(flash_bwd_delta_kernel<bf16, D>, 256, 0, (rows * L + 255) / 256, p, s)))
        return err;
      if ((err = launch(flash_bwd_dkdv_mma_kernel<D>, THREADS, BwdTile<D>::SMEM, kv_blocks, p,
                        s)))
        return err;
      return launch(flash_bwd_dq_mma_kernel<D>, THREADS, BwdTile<D>::SMEM, q_blocks, p, s);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out, dout: [B, T, H, d] with element strides (batch, token, head)
// and unit stride along d; the pointers and strides are 16-byte aligned.
// mask: int32 [B, tk]; lse: f32 [B*H, tq] from flash_fwd; delta: f32
// [B*H, tq] scratch; dq, dk, dv: contiguous [B, T, H, d]. dtype: 0 =
// float32 (CUDA-core kernels), 1 = bfloat16 (tensor-core kernels). Returns
// the cudaError_t of the first launch that failed (0 on success); launches
// on `stream` and allocates nothing.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* mask,
                         const void* out, const void* dout, const void* lse, void* delta,
                         void* dq, void* dk, void* dv, int B, int H, int tq, int tk, int d,
                         int64_t q_sb, int64_t q_st, int64_t q_sh,
                         int64_t k_sb, int64_t k_st, int64_t k_sh,
                         int64_t v_sb, int64_t v_st, int64_t v_sh,
                         int64_t o_sb, int64_t o_st, int64_t o_sh,
                         int64_t g_sb, int64_t g_st, int64_t g_sh,
                         int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || tq <= 0 || tk < 0) return (int)cudaErrorInvalidValue;
  const BwdParams p{q, k, v, out, dout, static_cast<const int*>(mask),
                    static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
                    q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
                    g_sb, g_st, g_sh, B, H, tq, tk, causal, scale};
  const int bh = B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return run<32>(dtype, p, bh, s);
    case 64: return run<64>(dtype, p, bh, s);
    case 128: return run<128>(dtype, p, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
