// Flash-attention forward for Hopper (sm_90a), bound to Python through a
// plain C entry point loaded with ctypes (synapseml_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernel synapseml_tpu/ops/attention.py::
// _flash_fwd_kernel (launched by _flash_core_fwd_impl). Same function:
//   * q: [B, Tq, H, D], k, v: [B, Tk, H, D], out: [B, Tq, H, D] in q's type,
//     each with any element strides (batch, token, head) and unit stride
//     along D, so the model's projection views go in and its output comes
//     out without a copy; mask: int32 [B, Tk] (nonzero = attend), shared by
//     the heads of a batch row; lse: f32 [B*H, Tq].
//   * s = (q . k) * scale in f32, scale = 1/sqrt(true head dim) applied
//     after the dot; masked (and, when causal, kv > q) entries are set to
//     -1e30 and gated to p = 0 (s <= -5e29), so a fully masked row gives
//     O = 0 and a finite LSE, never NaN.
//   * online softmax over kv tiles; P is rounded to V's type before the PV
//     product, both products accumulate in f32; O = acc / max(l, 1e-30),
//     lse = m + log(max(l, 1e-30)).
//   * causal: kv tiles wholly above the diagonal are skipped.
//
// Grid. The TPU kernel walks kv blocks as the sequential third grid axis
// and carries (m, l, acc) in VMEM scratch between grid steps. Blocks of a
// CUDA grid run in no order, so here one block owns a 64-row query tile of
// one (batch, head) and loops over all kv tiles itself; nothing carries
// between blocks and there are no atomics, so the output is deterministic.
// The grid is one-dimensional, B*H*ceil(Tq/64) blocks on x (whose limit is
// 2^31-1; large offline batches exceed y's 65535), query tile major: the
// first wave reads each (batch, head)'s K/V from memory, later query tiles
// of the same head mostly find them in L2.
//
// Bound on this card. At BERT-base scoring shapes (B*H = 384, T = 128,
// D = 64) the function reads q, k, v and the mask and writes out and lse.
// In bf16 that is about 25.6 MB against 1.6 GFLOP: 7.6 us at 3.35 TB/s
// against 1.6 us at 989 TFLOP/s. In f32 it is 50.7 MB, 15.1 us, against
// three TF32 products of 1.6 GFLOP each (the split below), 9.8 us at
// 495 TFLOP/s. Both are bound by bytes, so the design aims at moving each
// byte once, in wide transactions, with loads in flight during math.
//
// Both kernels: four warps; warp w owns query rows 16w..16w+15 of the
// tile. QK^T and PV run on mma.sync with f32 accumulators. The online
// softmax runs on the S accumulators in registers, in base 2 (scores times
// log2 e, one exp2 each); a row's max and sum take two xor-shuffles within
// the quad that holds it. Q, K and V tiles arrive by 16-byte cp.async
// (zero-filled past the sequence end) into padded rows, double-buffered,
// so tile j+1 loads while tile j computes; the mask rides along by 4-byte
// cp.async, so no thread stalls on a plain load. The output is staged
// through shared memory and written with 16-byte stores.
//
// bf16: flash_fwd_mma_kernel, mma.sync.m16n8k16 (bf16 in).
//   * The Q fragments are loaded once with ldmatrix and stay in registers;
//     K fragments come through ldmatrix, V fragments through ldmatrix.trans.
//   * P is rounded to bf16 in registers and used directly as the A operand
//     of the PV product (the m16n8 accumulator layout of two adjacent score
//     tiles is the m16n8k16 A layout): no P goes through shared memory.
//   * Rows are padded by 16 bytes, which keeps ldmatrix free of bank
//     conflicts. Shared memory is 5 tiles of 64 x (D+8) bf16: 46 KB at
//     D = 64. Registers are capped at 168 a thread up to D = 64, so that 3
//     blocks (12 warps) share an SM.
// f32: flash_fwd_tf32_kernel, mma.sync.m16n8k8 (TF32 in) in split TF32.
//   * A tensor core reads an f32 operand as TF32, 10 mantissa bits, which
//     the f32 path's 2e-5 tolerance does not allow. So each operand x is
//     split into hi = x rounded to TF32 (to nearest, ties away from zero,
//     as cvt.rna) and lo = x - hi truncated to TF32, and each product step
//     is three mma: a_lo*b_hi, a_hi*b_lo, then a_hi*b_hi, accumulated in
//     f32 (the dropped a_lo*b_lo is about 2^-22 of the product). The kernel
//     splits always; it does not depend on torch's allow_tf32. The split is
//     most of the kernel's ALU work, so it is done with integer ops (see
//     split_tf32 in flash_common.cuh, shared with the f32 backward) where
//     cvt.rna would cost several instructions a part.
//   * ldmatrix moves 16-bit elements, so fragments are 32-bit shared loads.
//     The order of k within one m16n8k8 step is free as long as A and B
//     follow it, so thread (g, t) takes k = 2t, 2t+1 where the instruction
//     says t, t+4: Q and K fragments are then one 8-byte load each (rows
//     padded by 8 floats: conflict-free), and P is the S accumulator as it
//     stands (columns 2t, 2t+1), with no shuffle; V's fragment is rows
//     2t, 2t+1 of one column (rows padded by 4 floats: conflict-free).
//   * Q, K, V and P are split where they are used, by each warp. Splitting
//     K and V once on arrival into hi/lo tiles was slower (a second pass,
//     twice the shared loads and 108 KB of shared memory at D = 64); so was
//     holding Q in registers (spills at D = 128) or capping registers for a
//     third block an SM (spills). Shared memory is 3 tiles of 64 x (D+8)
//     and 2 of 64 x (D+4) f32: 88 KB at D = 64, 2 blocks an SM.
//   * The output is staged through the warp's own rows of the Q tile.

#include "flash_common.cuh"

namespace {

using namespace flash;  // constants and helpers shared with flash_bwd_*.cu

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* mask;  // [B, tk]
  void* out;
  float* lse;       // [B*H, tq]
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int H, tq, tk, causal;
  float scale;
};

__device__ __forceinline__ int n_kv_tiles(const Params& p, int q0) {
  int n = (p.tk + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) {
    // tiles with kv0 <= last query row of this tile, as the TPU kernel's
    // pl.when(kv_blk * block_k <= (q_blk + 1) * block_q - 1)
    n = min(n, (q0 + BLOCK_M - 1) / BLOCK_N + 1);
  }
  return n;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// One kv tile of the online softmax, on a warp's m16n8 score accumulators:
// s[n][0..1] are row row_a, s[n][2..3] row row_b, columns n*8 + 2t + {0, 1}
// of the tile at kv0; mask_tile is the tile's 64 mask entries. Scales and
// masks s, replaces it with p (base 2: scores times log2 e, so that each
// exponential is one exp2; the LSE converts back), updates m_i and l_i and
// rescales acc.
template <int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&acc)[NT][4],
                                             float (&m_i)[2], float (&l_i)[2],
                                             const int* mask_tile, int t, int row_a, int row_b,
                                             int kv0, const Params& p) {
  uint32_t ok_cols = 0;  // bit 2n + c: column n*8 + 2t + c may be attended
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int2 m2 = *reinterpret_cast<const int2*>(mask_tile + n * 8 + 2 * t);
    ok_cols |= (uint32_t)(m2.x != 0) << (2 * n) | (uint32_t)(m2.y != 0) << (2 * n + 1);
  }
  const float scale2 = p.scale * LOG2E;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n * 8 + 2 * t + (e & 1);
      const int row = e < 2 ? row_a : row_b;
      const bool ok = (ok_cols >> (2 * n + (e & 1)) & 1) && (!p.causal || kv0 + col <= row);
      s[n][e] = ok ? s[n][e] * scale2 : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_i[r], quad_max(mx[r]));
    alpha[r] = exp2f(m_i[r] - m_new);
    m_i[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // gate, not just subtract: on a fully masked row s == m_new == -1e30
      // and exp(0) would count masked entries
      const float x = s[n][e];
      s[n][e] = x <= MASK_GATE ? 0.f : exp2f(x - m_i[e >> 1]);
      rs[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// The LSE of rows row_a and row_b, written by the quad's first thread.
__device__ __forceinline__ void write_lse(const Params& p, int bh, int t, float (&m_i)[2],
                                          const float (&safe_l)[2], int row_a, int row_b) {
  if (t != 0) return;
  float* lse = p.lse + static_cast<int64_t>(bh) * p.tq;
  // back from base 2; a fully masked row keeps the -1e30 max, as unscaled
#pragma unroll
  for (int r = 0; r < 2; ++r) m_i[r] = m_i[r] <= MASK_GATE ? NEG_INF : m_i[r] * LN2;
  if (row_a < p.tq) lse[row_a] = m_i[0] + logf(safe_l[0]);
  if (row_b < p.tq) lse[row_b] = m_i[1] + logf(safe_l[1]);
}

// ---------------------------------------------------------------- bf16 ----
// (ldmatrix, mma_bf16 and pack_bf16 are in flash_common.cuh)

template <int D>
struct MmaTile {
  static constexpr int LD = D + 8;                  // padded row, in bf16
  static constexpr int ROW = LD * 2;                // bytes
  static constexpr int BYTES = BLOCK_M * ROW;       // one Q, K or V tile
  static constexpr int CH = D / 8;                  // 16-byte chunks a row
  static constexpr int RS = THREADS / CH;           // rows one pass of the block loads
  static constexpr size_t SMEM = 5 * BYTES + sizeof(int) * 2 * BLOCK_N;
};

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 2)
flash_fwd_mma_kernel(const Params p) {
  using M = MmaTile<D>;
  constexpr int KS = D / 16;  // k-steps of QK^T
  constexpr int NT = D / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [64][LD] Q (later the O staging), [2][64][LD] K, [2][64][LD] V, [2][64] mask
  const uint32_t sq = smem_addr(smem_raw);
  const uint32_t sk = sq + M::BYTES;
  const uint32_t sv = sk + 2 * M::BYTES;
  const uint32_t smask = sv + 2 * M::BYTES;
  const int* mask_s = reinterpret_cast<const int*>(smem_raw + 5 * M::BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // row in the 8-row group, column pair
  const int n_bh = gridDim.x / n_tiles(p.tq);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x / n_bh * BLOCK_M;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* og = static_cast<bf16*>(p.out) + b * p.o_sb + h * p.o_sh;
  const int* mg = p.mask + static_cast<int64_t>(b) * p.tk;
  const int n_kv = n_kv_tiles(p, q0);

  // this thread's chunk of the tile loads
  const int ld_row = tid / M::CH, ld_col = tid % M::CH * 8;
  const uint32_t ld_smem = ld_row * M::ROW + ld_col * 2;
  auto load_kv = [&](int j) {
    const int kv0 = j * BLOCK_N;
    const uint32_t buf = (j & 1) * M::BYTES;
    load_tile<M::RS, M::ROW>(sk + buf + ld_smem, kg + (kv0 + ld_row) * p.k_st + ld_col, p.k_st,
                             kv0 + ld_row, p.tk, kg);
    load_tile<M::RS, M::ROW>(sv + buf + ld_smem, vg + (kv0 + ld_row) * p.v_st + ld_col, p.v_st,
                             kv0 + ld_row, p.tk, vg);
    if (tid < BLOCK_N) {  // the mask too, so that no thread waits on a plain load
      const int col = kv0 + tid;
      cp_async4(smask + ((j & 1) * BLOCK_N + tid) * 4, col < p.tk ? mg + col : mg,
                col < p.tk);
    }
    cp_async_commit();
  };

  load_tile<M::RS, M::ROW>(sq + ld_smem, qg + (q0 + ld_row) * p.q_st + ld_col, p.q_st,
                           q0 + ld_row, p.tq, qg);
  cp_async_commit();
  if (n_kv > 0) load_kv(0);

  float m_i[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of the warp's 16
  float l_i[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[KS][4];
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  // this lane's ldmatrix row addresses, tile offsets added as immediates
  const uint32_t q_lane = sq + (warp * 16 + lane % 16) * M::ROW + (lane / 16) * 16;
  const uint32_t k_lane = sk + (lane % 8) * M::ROW + (lane / 8) * 16;
  const uint32_t v_lane = sv + (lane % 8 + (lane / 8 & 1) * 8) * M::ROW + (lane / 16) * 16;

  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BLOCK_N;
    const uint32_t buf = (j & 1) * M::BYTES;
    if (j + 1 < n_kv) {
      load_kv(j + 1);  // into the other buffer, freed by the last iteration's sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], q_lane + ks * 32);
    }

    // S = Q K^T: 16 x 64 per warp, 8 tiles of m16n8
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t kf[4];  // b0, b1 of k-steps 2kk and 2kk + 1
        ldmatrix_x4(kf, k_lane + buf + n * 8 * M::ROW + kk * 64);
        mma_bf16(s[n], qf[2 * kk], kf[0], kf[1]);
        mma_bf16(s[n], qf[2 * kk + 1], kf[2], kf[3]);
      }
    }

    softmax_tile(s, acc, m_i, l_i, mask_s + (j & 1) * BLOCK_N, t, row_a, row_b, kv0, p);

    // O += P V: P from registers (rounded to bf16), V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vf[4];  // b0, b1 of O tiles 2dn and 2dn + 1
        ldmatrix_x4_trans(vf, v_lane + buf + kk * 16 * M::ROW + dn * 32);
        mma_bf16(acc[2 * dn], pf, vf[0], vf[1]);
        mma_bf16(acc[2 * dn + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled at the top of iteration j + 1
  }
  cp_async_wait<0>();
  __syncthreads();  // the Q tile is free (also when no kv tile ran)

  // epilogue: the warp writes its 16 rows of O into its rows of the Q tile,
  // then copies them out 16 bytes at a time
  const float safe_l[2] = {fmaxf(l_i[0], 1e-30f), fmaxf(l_i[1], 1e-30f)};
  unsigned char* so = smem_raw + warp * 16 * M::ROW;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(so + g * M::ROW + (n * 8 + 2 * t) * 2) =
        pack_bf16(acc[n][0] / safe_l[0], acc[n][1] / safe_l[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * M::ROW + (n * 8 + 2 * t) * 2) =
        pack_bf16(acc[n][2] / safe_l[1], acc[n][3] / safe_l[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * M::CH / 32; ++i) {
    const int c = lane + i * 32;
    const int r = c / M::CH, cc = c % M::CH;
    const int row = q0 + warp * 16 + r;
    if (row < p.tq)
      *reinterpret_cast<uint4*>(og + row * p.o_st + cc * 8) =
          *reinterpret_cast<const uint4*>(so + r * M::ROW + cc * 16);
  }
  write_lse(p, bh, t, m_i, safe_l, row_a, row_b);
}

// ----------------------------------------------------------------- f32 ----

// (split_tf32, mma_tf32 and mma_3xtf32 are in flash_common.cuh)

template <int D>
struct Tf32Tile {
  static constexpr int LDQ = D + 8;                  // Q and K rows, in floats: 8-byte
                                                     // fragment loads conflict-free
  static constexpr int LDV = D + 4;                  // V row: loads of rows 2t, 2t+1 conflict-free
  static constexpr int QK_BYTES = BLOCK_N * LDQ * 4;  // one Q or K tile
  static constexpr int V_BYTES = BLOCK_N * LDV * 4;
  static constexpr int CH = D / 4;                   // 16-byte chunks a row
  static constexpr int RS = THREADS / CH;            // rows one pass of the block loads
  static constexpr size_t SMEM = 3 * QK_BYTES + 2 * V_BYTES + sizeof(int) * 2 * BLOCK_N;
};

template <int D>
__global__ void __launch_bounds__(THREADS, D <= 32 ? 4 : D <= 64 ? 2 : 1)
flash_fwd_tf32_kernel(const Params p) {
  using M = Tf32Tile<D>;
  constexpr int KS = D / 8;   // k-steps of QK^T
  constexpr int NT = D / 8;   // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [64][LDQ] Q (later the O staging), [2][64][LDQ] K, [2][64][LDV] V, [2][64] mask
  float* q_s = reinterpret_cast<float*>(smem_raw);
  const float* k_s = q_s + BLOCK_M * M::LDQ;
  const float* v_s = k_s + 2 * BLOCK_N * M::LDQ;
  const int* mask_s = reinterpret_cast<const int*>(v_s + 2 * BLOCK_N * M::LDV);
  const uint32_t sq = smem_addr(q_s), sk = smem_addr(k_s), sv = smem_addr(v_s);
  const uint32_t smask = smem_addr(mask_s);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // row in the 8-row group, column pair
  const int n_bh = gridDim.x / n_tiles(p.tq);
  const int bh = blockIdx.x % n_bh;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x / n_bh * BLOCK_M;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh;
  const int* mg = p.mask + static_cast<int64_t>(b) * p.tk;
  const int n_kv = n_kv_tiles(p, q0);

  // this thread's chunk of the tile loads
  const int ld_row = tid / M::CH, ld_col = tid % M::CH * 4;
  const uint32_t ld_q = (ld_row * M::LDQ + ld_col) * 4;
  const uint32_t ld_v = (ld_row * M::LDV + ld_col) * 4;
  auto load_kv = [&](int j) {
    const int kv0 = j * BLOCK_N;
    load_tile<M::RS, M::LDQ * 4>(sk + (j & 1) * M::QK_BYTES + ld_q,
                                 kg + (kv0 + ld_row) * p.k_st + ld_col, p.k_st, kv0 + ld_row,
                                 p.tk, kg);
    load_tile<M::RS, M::LDV * 4>(sv + (j & 1) * M::V_BYTES + ld_v,
                                 vg + (kv0 + ld_row) * p.v_st + ld_col, p.v_st, kv0 + ld_row,
                                 p.tk, vg);
    if (tid < BLOCK_N) {  // the mask too, so that no thread waits on a plain load
      const int col = kv0 + tid;
      cp_async4(smask + ((j & 1) * BLOCK_N + tid) * 4, col < p.tk ? mg + col : mg,
                col < p.tk);
    }
    cp_async_commit();
  };

  load_tile<M::RS, M::LDQ * 4>(sq + ld_q, qg + (q0 + ld_row) * p.q_st + ld_col, p.q_st,
                               q0 + ld_row, p.tq, qg);
  cp_async_commit();
  if (n_kv > 0) load_kv(0);

  float m_i[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of the warp's 16
  float l_i[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int row_a = q0 + warp * 16 + g;  // this thread's two query rows
  const int row_b = row_a + 8;
  // this lane's fragments in a tile: Q[16w + g][ks*8 + 2t, +1],
  // K[n*8 + g][ks*8 + 2t, +1], V[kk*8 + 2t, +1][dn*8 + g]
  const float* q_lane = q_s + (warp * 16 + g) * M::LDQ + 2 * t;
  const float* k_lane = k_s + g * M::LDQ + 2 * t;
  const float* v_lane = v_s + 2 * t * M::LDV + g;

  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * BLOCK_N;
    if (j + 1 < n_kv) {
      load_kv(j + 1);  // into the other buffer, freed by the last iteration's sync
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = k_lane + (j & 1) * BLOCK_N * M::LDQ;
    const float* vt = v_lane + (j & 1) * BLOCK_N * M::LDV;

    // S = Q K^T: 16 x 64 per warp, 8 tiles of m16n8, D/8 steps of k = 8;
    // in a step, thread (g, t) holds k = 2t, 2t+1 of A and of B
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 qa = *reinterpret_cast<const float2*>(q_lane + ks * 8);
      const float2 qb = *reinterpret_cast<const float2*>(q_lane + 8 * M::LDQ + ks * 8);
      uint32_t ah[4], al[4];  // A: rows g, g+8 at k 2t, then at 2t+1
      split_tf32(qa.x, ah[0], al[0]);
      split_tf32(qb.x, ah[1], al[1]);
      split_tf32(qa.y, ah[2], al[2]);
      split_tf32(qb.y, ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 kf = *reinterpret_cast<const float2*>(kt + n * 8 * M::LDQ + ks * 8);
        mma_3xtf32(s[n], ah, al, kf.x, kf.y);
      }
    }

    softmax_tile(s, acc, m_i, l_i, mask_s + (j & 1) * BLOCK_N, t, row_a, row_b, kv0, p);

    // O += P V: P is the S accumulator as it stands (row g: columns 2t,
    // 2t+1 of each score tile, in f32), V's rows 2t, 2t+1 follow
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 8; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
#pragma unroll
      for (int dn = 0; dn < NT; ++dn)
        mma_3xtf32(acc[dn], ah, al, vt[kk * 8 * M::LDV + dn * 8],
                   vt[(kk * 8 + 1) * M::LDV + dn * 8]);
    }
    __syncthreads();  // this buffer is refilled at the top of iteration j + 1
  }
  cp_async_wait<0>();
  __syncthreads();  // the Q tile is free (also when no kv tile ran)

  // epilogue: the warp writes its 16 rows of O into its rows of the Q tile,
  // then copies them out 16 bytes at a time
  const float safe_l[2] = {fmaxf(l_i[0], 1e-30f), fmaxf(l_i[1], 1e-30f)};
  float* so = q_s + warp * 16 * M::LDQ;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<float2*>(so + g * M::LDQ + n * 8 + 2 * t) =
        make_float2(acc[n][0] / safe_l[0], acc[n][1] / safe_l[0]);
    *reinterpret_cast<float2*>(so + (g + 8) * M::LDQ + n * 8 + 2 * t) =
        make_float2(acc[n][2] / safe_l[1], acc[n][3] / safe_l[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * M::CH / 32; ++i) {
    const int c = lane + i * 32;
    const int r = c / M::CH, cc = c % M::CH;
    const int row = q0 + warp * 16 + r;
    if (row < p.tq)
      *reinterpret_cast<float4*>(og + row * p.o_st + cc * 4) =
          *reinterpret_cast<const float4*>(so + r * M::LDQ + cc * 4);
  }
  write_lse(p, bh, t, m_i, safe_l, row_a, row_b);
}

// --------------------------------------------------------------- launch ----

template <typename Kernel>
int launch(Kernel kernel, size_t smem, const Params& p, int bh, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = static_cast<int64_t>(bh) * n_tiles(p.tq);  // query tile major
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_dtype(int dtype, const Params& p, int bh, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch(flash_fwd_tf32_kernel<D>, Tf32Tile<D>::SMEM, p, bh, s);
    case 1: return launch(flash_fwd_mma_kernel<D>, MmaTile<D>::SMEM, p, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, T, H, d] with element strides (batch, token, head) and
// unit stride along d; the pointers and strides are 16-byte aligned.
// mask: int32 [B, tk]; lse: f32 [B*H, tq]. dtype: 0 = float32 (split-TF32
// tensor-core kernel), 1 = bfloat16 (bf16 tensor-core kernel). Returns the
// cudaError_t of the launch (0 on success); launches on `stream` and
// allocates nothing.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                         void* out, void* lse, int B, int H, int tq, int tk, int d,
                         int64_t q_sb, int64_t q_st, int64_t q_sh,
                         int64_t k_sb, int64_t k_st, int64_t k_sh,
                         int64_t v_sb, int64_t v_st, int64_t v_sh,
                         int64_t o_sb, int64_t o_st, int64_t o_sh,
                         int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || tq <= 0 || tk < 0) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int*>(mask), out, static_cast<float*>(lse),
                 q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
                 H, tq, tk, causal, scale};
  const int bh = B * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return dispatch_dtype<32>(dtype, p, bh, s);
    case 64: return dispatch_dtype<64>(dtype, p, bh, s);
    case 128: return dispatch_dtype<128>(dtype, p, bh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
