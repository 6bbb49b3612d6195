// Flash-attention backward in f32 for Hopper (sm_90a), bound to Python
// through a plain C entry point loaded with ctypes
// (synapseml_torch/ops/attention.py). The function, its arguments and the
// dQ sum are described in flash_bwd_common.cuh.
//
// f32: flash_bwd_tf32_kernel, one launch a call (after a memset of its dQ
// counters when a head has more than one kv tile), on the tensor cores:
// mma.sync.m16n8k8 in split TF32 (flash_common.cuh: each operand split
// into a TF32 hi and lo part, three mma a step, f32 accumulators; P and dS
// split where they become operands), which keeps f32 accuracy whatever
// torch's allow_tf32 says. A block a (b*h, kv tile) of BN = 128 kv rows
// (64 at D = 128), warp w owning rows 16w..16w+15, one block an SM (192 KB
// of shared memory at D = 64). K and V arrive once; the q tiles (64 rows,
// 32 at D = 128) of Q, dO and the LSE stream through a 2-stage ring of
// 16-byte cp.async, O through one buffer (its next tile loads once delta
// is taken), each tile's copies in flight behind the last tile's products.
// Per q tile, the function's 5 products, S and dP once:
//   delta: the diagonal of O dO^T, an m16n8 tile a warp, in exactly the
//     arithmetic of dP^T (O in V's place). A query row that attends one
//     key has O = that key's V (V's split survives the f32 forward), so its
//     dP - delta is 0 as in exact arithmetic. With delta in f32 FFMA the
//     difference was the tensor cores' rounding of dP, 1.9e-4 of such a
//     slice's floor against TOL_BWD's 1e-4 (NVIDIA H100 at 700 W);
//   S^T = K Q^T and dP^T = V dO^T (A and B read by rows, k in the
//     instruction's order);
//   dV += P^T dO and dK += dS^T Q (A straight from the S^T and dP^T
//     accumulators, thread (g, t) holding k = 2t, 2t + 1 where the
//     instruction says t, t + 4; B read by columns, rows 2t and 2t + 1);
//   dQ_tile = dS K from dS^T stored to shared memory, a warp 16 q rows and
//     a slice of D.
// Every tile's rows are padded to an odd number of 16-byte chunks (D + 4
// floats), which keeps both kinds of fragment read free of bank conflicts.
// dQ is summed over the kv tiles in kv order as the bf16 kernel sums it
// (the dQ sum section), and written directly with one kv tile a head.
// Registers: 239-241 at D = 32 and 64, 255 at D = 128 with 4-12 bytes of
// spills (two builds of this code differed).
// Bound, in f32: 101.1 MB at B*H = 384, T = 128, 30.2 us at 3.35 TB/s,
// against 3 TF32 passes of the 5 products (4.03 GFLOP), 24.4 us at 495
// TFLOP/s: bytes; at B*H = 96, T = 512 operations (3 x 16.1 GFLOP, 97.6
// us). On an NVIDIA H100 80GB HBM3 at 700 W it takes 0.124 / 0.381 ms,
// 4.1x / 3.9x those bounds (CUTLASS's f32 backward through SDPA: 0.204 /
// 0.563 ms of kernels). Stalls hold it there, not issued instructions: a
// cheaper split for S, dV, dK and dQ cut a fifth of them and 2 % of the
// time; shared memory allows one block of 8 warps an SM, 2 a scheduler,
// too few to hide the latency of shared loads and mma.

#include "flash_bwd_common.cuh"

namespace {

using namespace flash;

// The f32 kernel's tiles. A block owns BN kv rows (warp w rows 16w..16w+15)
// and streams BM-row q tiles. Every tile in shared memory has rows of LD =
// D + 4 floats (dS^T: BM + 4): a row stride of an odd number of 16-byte
// chunks keeps both of the kernel's fragment reads free of bank conflicts,
// the row read (lane (g, t) at row g, column t) and the column read (rows
// 2t and 2t + 1, column g).
template <int D>
struct F32Tile {
  static constexpr int BN = D == 128 ? 64 : 128;  // kv rows a block
  static constexpr int BM = D == 128 ? 32 : 64;   // q rows a streamed tile
  static constexpr int WARPS = BN / 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + 4;                 // a tile's row, in floats
  static constexpr int LDS = BM + 4;               // a dS^T row
  static constexpr int MT = BM / 16;               // dQ: warp w computes rows 16 * (w % MT)..
  static constexpr int DC = D * MT / WARPS;        // and DC columns from DC * (w / MT)
  static constexpr int KV_FLOATS = BN * LD;
  static constexpr int Q_FLOATS = BM * LD;
  // offsets in floats: K, V, [2] stages of Q, [2] of dO, O (one buffer: its
  // next tile loads once delta is taken), dS^T, [2] LSE, delta, the ticket
  static constexpr int V_OFF = KV_FLOATS;
  static constexpr int Q_OFF = 2 * KV_FLOATS;
  static constexpr int G_OFF = Q_OFF + 2 * Q_FLOATS;
  static constexpr int O_OFF = G_OFF + 2 * Q_FLOATS;
  static constexpr int DS_OFF = O_OFF + Q_FLOATS;
  static constexpr int LSE_OFF = DS_OFF + BN * LDS;
  static constexpr int DELTA_OFF = LSE_OFF + 2 * BM;
  static constexpr size_t SMEM = (DELTA_OFF + BM) * 4 + 16;
  static constexpr int CH = D / 4;                 // 16-byte chunks a row
  static constexpr int RS = THREADS / CH;          // rows one pass of the block loads
  static_assert(WARPS * 8 == BM, "warp w takes delta of the q tile's rows 8w..8w+7");
};

// The A fragment of an m16n8k8 step from an m16n8 accumulator, split: k
// runs over the accumulator's columns, thread (g, t) holding k = 2t, 2t + 1
// where the instruction says t, t + 4 (its B fragment follows that order)
__device__ __forceinline__ void split_acc(const float (&c)[4], uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// The A fragment at `a` (this thread's element of a tile with rows of LDA
// floats): rows g and g + 8, columns t and t + 4, split
template <int LDA>
__device__ __forceinline__ void split_rows(const float* a, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(a[0], hi[0], lo[0]);
  split_tf32(a[8 * LDA], hi[1], lo[1]);
  split_tf32(a[4], hi[2], lo[2]);
  split_tf32(a[8 * LDA + 4], hi[3], lo[3]);
}

// dK and dV of one BN-row kv tile, and its shares of dQ, on mma.sync in
// split TF32 (see the top note). A block a (b*h, kv tile), taken by ticket
// when a head has more than one.
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::THREADS, 1)
flash_bwd_tf32_kernel(const BwdParams p) {
  using M = F32Tile<D>;
  constexpr int BN = M::BN, BM = M::BM, LD = M::LD, LDS = M::LDS, THREADS = M::THREADS;
  constexpr int NQ = BM / 8;     // 8-column tiles of S^T and dP^T (q), k-steps of dK and dV
  constexpr int ND = D / 8;      // 8-column tiles of dK and dV, k-steps of S^T and dP^T
  constexpr int NC = M::DC / 8;  // 8-column tiles of a warp's dQ
  extern __shared__ __align__(16) float smem_f[];
  const float* k_s = smem_f;
  const float* v_s = smem_f + M::V_OFF;
  const float* o_s = smem_f + M::O_OFF;
  float* ds_s = smem_f + M::DS_OFF;
  float* delta_s = smem_f + M::DELTA_OFF;
  int* ticket_s = reinterpret_cast<int*>(delta_s + BM);
  const uint32_t base = smem_addr(smem_f);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  if (tid == 0)
    *ticket_s = p.n_kv > 1 ? atomicAdd(p.counters + p.B * p.H * p.n_q, 1)
                           : static_cast<int>(blockIdx.x);
  __syncthreads();
  const int tile = *ticket_s;
  const int bh = tile / p.n_kv, j = tile % p.n_kv;
  const int b = bh / p.H, h = bh % p.H, kv0 = j * BN;
  const int i_first = p.causal ? kv0 / BM : 0;  // causal: q tiles before kv0 see none of it
  const int n_work = max(p.n_q - i_first, 0);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* og = static_cast<const float*>(p.out) + b * p.o_sb + h * p.o_sh;
  const float* gg = static_cast<const float*>(p.dout) + b * p.g_sb + h * p.g_sh;
  const float* lse_g = p.lse + static_cast<int64_t>(bh) * p.tq;

  // every copy is a cp.async of 16 bytes (the LSE's of 4), rows past T
  // zero: K and V once, then item w (q tile i_first + w) into stage w % 2
  // of Q, dO and the LSE and into the one O buffer, a group an item
  const int ld_row = tid / M::CH, ld_col = tid % M::CH * 4;
  const uint32_t ld_off = (ld_row * LD + ld_col) * 4;
  load_tile<M::RS, LD * 4, BN>(base + ld_off, kg + (kv0 + ld_row) * p.k_st + ld_col, p.k_st,
                               kv0 + ld_row, p.tk, kg);
  load_tile<M::RS, LD * 4, BN>(base + M::V_OFF * 4 + ld_off,
                               vg + (kv0 + ld_row) * p.v_st + ld_col, p.v_st, kv0 + ld_row, p.tk,
                               vg);
  auto load_item = [&](int w) {
    const int q0 = (i_first + w) * BM, s = w & 1;
    const int64_t r = q0 + ld_row;
    load_tile<M::RS, LD * 4, BM>(base + (M::Q_OFF + s * M::Q_FLOATS) * 4 + ld_off,
                                 qg + r * p.q_st + ld_col, p.q_st, q0 + ld_row, p.tq, qg);
    load_tile<M::RS, LD * 4, BM>(base + (M::G_OFF + s * M::Q_FLOATS) * 4 + ld_off,
                                 gg + r * p.g_st + ld_col, p.g_st, q0 + ld_row, p.tq, gg);
    load_tile<M::RS, LD * 4, BM>(base + M::O_OFF * 4 + ld_off, og + r * p.o_st + ld_col, p.o_st,
                                 q0 + ld_row, p.tq, og);
    if (tid < BM) {
      const bool ok = q0 + tid < p.tq;
      cp_async4(base + (M::LSE_OFF + s * BM + tid) * 4, ok ? lse_g + q0 + tid : lse_g, ok);
    }
    cp_async_commit();
  };
  if (n_work > 0) load_item(0);  // its group holds K and V too
  else cp_async_commit();

  // this thread's kv rows (accumulator rows g and g + 8 of the warp's 16)
  // and whether each may be attended at all
  const int r0 = warp * 16, row_a = kv0 + r0 + g, row_b = row_a + 8;
  const int* mg = p.mask + static_cast<int64_t>(b) * p.tk;
  const bool ok_a = row_a < p.tk && mg[row_a] != 0;
  const bool ok_b = row_b < p.tk && mg[row_b] != 0;
  // dQ: this warp's m tile and first column
  const int mt = warp % M::MT, c0 = warp / M::MT * M::DC;
  const float scale = p.scale;
  const int64_t hd = static_cast<int64_t>(p.H) * D;  // the outputs' token stride

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int w = 0; w < n_work; ++w) {
    const int i = i_first + w, q0 = i * BM, s = w & 1;
    const float* q_t = smem_f + M::Q_OFF + s * M::Q_FLOATS;
    const float* g_t = smem_f + M::G_OFF + s * M::Q_FLOATS;
    const float* lse_t = smem_f + M::LSE_OFF + s * BM;
    cp_async_wait<0>();
    __syncthreads();  // item w (and K, V) landed; item w - 1's reads are done

    {  // delta of the tile's rows 8w..8w+7: the diagonal of O dO^T over the
       // m16n8 tile (rows 16(w/2).., columns 8w..), computed as dP^T is
       // below with O in V's place (see the top note)
      const float* o_a = o_s + (16 * (warp / 2) + g) * LD + t;
      const float* g_b = g_t + (8 * warp + g) * LD + t;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < ND; ++ks) {
        uint32_t oh[4], ol[4];
        split_rows<LD>(o_a + 8 * ks, oh, ol);
        mma_3xtf32(c, oh, ol, g_b[8 * ks], g_b[8 * ks + 4]);
      }
      // row 16(w/2) + g + 8(e/2) is column 8w + 2t + e % 2 where e / 2 is w % 2
      if (g / 2 == t) delta_s[8 * warp + g] = c[2 * (warp % 2) + g % 2];
    }
    __syncthreads();  // delta; the O buffer is free
    if (w + 1 < n_work) load_item(w + 1);

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 kv rows x BM q columns,
    // k over D in the instruction's order (row reads of both operands)
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    const float* k_a = k_s + (r0 + g) * LD + t;
    const float* v_a = v_s + (r0 + g) * LD + t;
    const float* q_b = q_t + g * LD + t;
    const float* g_b = g_t + g * LD + t;
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) {
      uint32_t kh[4], kl[4], vh[4], vl[4];
      split_rows<LD>(k_a + 8 * ks, kh, kl);
      split_rows<LD>(v_a + 8 * ks, vh, vl);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int at = n * 8 * LD + 8 * ks;
        mma_3xtf32(st[n], kh, kl, q_b[at], q_b[at + 4]);
        mma_3xtf32(dpt[n], vh, vl, g_b[at], g_b[at + 4]);
      }
    }

    // P^T = exp(s - lse) where attended, else 0; dS^T = P^T (dP^T - delta).
    // Element e of tile n: kv row (e < 2 ? row_a : row_b), q column
    // q0 + 8n + 2t + (e & 1). dS^T also goes to shared memory, for dQ.
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int col = 8 * n + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = q0 + col + (e & 1), kv = e < 2 ? row_a : row_b;
        const bool ok = (e < 2 ? ok_a : ok_b) && q < p.tq && (!p.causal || kv <= q);
        const float lse = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
        const float pv = ok ? expf(st[n][e] * scale - lse) : 0.f;
        st[n][e] = pv;
        dpt[n][e] = pv * (dpt[n][e] - dl);
      }
      *reinterpret_cast<float2*>(ds_s + (r0 + g) * LDS + col) = make_float2(dpt[n][0], dpt[n][1]);
      *reinterpret_cast<float2*>(ds_s + (r0 + g + 8) * LDS + col) =
          make_float2(dpt[n][2], dpt[n][3]);
    }

    // dV += P^T dO and dK += dS^T Q: k over the tile's q rows, A straight
    // from the S^T and dP^T accumulators, B column reads of dO and Q (rows
    // 8kk + 2t and + 1, column 8n + g)
    const float* g_c = g_t + 2 * t * LD + g;
    const float* q_c = q_t + 2 * t * LD + g;
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split_acc(st[kk], ph, pl);
      split_acc(dpt[kk], sh, sl);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int at = kk * 8 * LD + n * 8;
        mma_3xtf32(dv[n], ph, pl, g_c[at], g_c[at + LD]);
        mma_3xtf32(dk[n], sh, sl, q_c[at], q_c[at + LD]);
      }
    }
    __syncthreads();  // every warp's dS^T

    // this warp's share of dQ_tile = dS K: rows 16mt.., columns c0..c0+DC-1,
    // k over the BN kv rows (A from dS^T and B from K, both column reads)
    float dq[NC][4];
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
    const float* ds_a = ds_s + 2 * t * LDS + 16 * mt + g;
    const float* k_c = k_s + 2 * t * LD + c0 + g;
#pragma unroll
    for (int ks = 0; ks < BN / 8; ++ks) {
      const float* a = ds_a + ks * 8 * LDS;
      uint32_t ah[4], al[4];
      split_tf32(a[0], ah[0], al[0]);    // q row g, kv row 2t
      split_tf32(a[8], ah[1], al[1]);    // q row g + 8
      split_tf32(a[LDS], ah[2], al[2]);  // kv row 2t + 1
      split_tf32(a[LDS + 8], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int at = ks * 8 * LD + n * 8;
        mma_3xtf32(dq[n], ah, al, k_c[at], k_c[at + LD]);
      }
    }

    // the tile's dQ summed over the head's kv tiles in kv order (dQ sum)
    if (p.n_kv > 1) {
      const int last = p.causal ? min(p.n_kv - 1, (q0 + BM - 1) / BN) : p.n_kv - 1;
      const int64_t slot = static_cast<int64_t>(bh) * p.n_q + i;
      float4* acc = reinterpret_cast<float4*>(p.dq_acc) + slot * NC * THREADS + tid;
      if (j > 0) {
        if (tid == 0) wait_count(p.counters + slot, j);
        __syncthreads();
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const float4 before = __ldcg(acc + n * THREADS);
          dq[n][0] = before.x + dq[n][0];
          dq[n][1] = before.y + dq[n][1];
          dq[n][2] = before.z + dq[n][2];
          dq[n][3] = before.w + dq[n][3];
        }
      }
      if (j != last) {
#pragma unroll
        for (int n = 0; n < NC; ++n)
          __stcg(acc + n * THREADS, make_float4(dq[n][0], dq[n][1], dq[n][2], dq[n][3]));
        __syncthreads();
        if (tid == 0) count_release(p.counters + slot);
        continue;
      }
    }
    // the tile's dQ, times the scale: rows q0 + 16mt + g (+ 8), columns
    // c0 + 8n + 2t (+ 1) of the contiguous [B, tq, H, D] output
    float* dqg = static_cast<float*>(p.dq) + (static_cast<int64_t>(b) * p.tq * p.H + h) * D;
    const int qa = q0 + 16 * mt + g, qb = qa + 8;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = c0 + 8 * n + 2 * t;
      if (qa < p.tq)
        *reinterpret_cast<float2*>(dqg + qa * hd + col) =
            make_float2(dq[n][0] * scale, dq[n][1] * scale);
      if (qb < p.tq)
        *reinterpret_cast<float2*>(dqg + qb * hd + col) =
            make_float2(dq[n][2] * scale, dq[n][3] * scale);
    }
  }
  cp_async_wait<0>();  // K and V, when no q tile waited for them

  // dK (times the scale) and dV of this thread's rows
  const int64_t o_b = (static_cast<int64_t>(b) * p.tk * p.H + h) * D;
  float* dkg = static_cast<float*>(p.dk) + o_b;
  float* dvg = static_cast<float*>(p.dv) + o_b;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    if (row_a < p.tk) {
      *reinterpret_cast<float2*>(dkg + row_a * hd + col) =
          make_float2(dk[n][0] * scale, dk[n][1] * scale);
      *reinterpret_cast<float2*>(dvg + row_a * hd + col) = make_float2(dv[n][0], dv[n][1]);
    }
    if (row_b < p.tk) {
      *reinterpret_cast<float2*>(dkg + row_b * hd + col) =
          make_float2(dk[n][2] * scale, dk[n][3] * scale);
      *reinterpret_cast<float2*>(dvg + row_b * hd + col) = make_float2(dv[n][2], dv[n][3]);
    }
  }
}

// --------------------------------------------------------------- launch ----

// The scratch of one call (see the dQ sum in flash_bwd_common.cuh), from
// the kernel's tiles
template <int D>
Scratch scratch_of(int64_t bh, int tq, int tk) {
  using M = F32Tile<D>;
  return dq_scratch(bh, (tq + M::BM - 1) / M::BM, (tk + M::BN - 1) / M::BN, M::BM, D);
}

template <int D>
int run_tf32(BwdParams p, void* scratch, cudaStream_t s) {
  using M = F32Tile<D>;
  const int64_t bh = static_cast<int64_t>(p.B) * p.H;
  if (p.tk == 0)  // no key: dq is 0 (dk and dv are empty)
    return (int)cudaMemsetAsync(p.dq, 0, static_cast<size_t>(bh) * p.tq * D * 4, s);
  const Scratch sc = scratch_of<D>(bh, p.tq, p.tk);
  unsigned char* sp = static_cast<unsigned char*>(scratch);
  p.n_q = (p.tq + M::BM - 1) / M::BM;
  p.n_kv = (p.tk + M::BN - 1) / M::BN;
  p.counters = reinterpret_cast<int*>(sp);
  p.dq_acc = reinterpret_cast<float*>(sp + sc.acc);
  static int cache[64] = {};
  int sms = 0, err;
  if ((err = prepare_once(flash_bwd_tf32_kernel<D>, M::SMEM, cache, &sms))) return err;
  if (sc.n_counters > 0 &&
      (err = (int)cudaMemsetAsync(p.counters, 0, sc.n_counters * sizeof(int), s)))
    return err;
  const int64_t blocks = bh * p.n_kv;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  flash_bwd_tf32_kernel<D><<<static_cast<unsigned>(blocks), M::THREADS, M::SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of scratch flash_bwd needs for this shape: with more than one kv
// tile a head, the dQ counters and partial sums, else nothing. At least 16.
extern "C" long long flash_bwd_scratch_bytes(int B, int H, int tq, int tk, int d) {
  const int64_t bh = static_cast<int64_t>(B) * H;
  Scratch sc{0, 0, 0};
  switch (d) {
    case 32: sc = scratch_of<32>(bh, tq, tk); break;
    case 64: sc = scratch_of<64>(bh, tq, tk); break;
    case 128: sc = scratch_of<128>(bh, tq, tk); break;
  }
  return sc.total > 16 ? sc.total : 16;
}

// q, k, v, out, dout: f32 [B, T, H, d] with element strides (batch, token,
// head) and unit stride along d; the pointers and strides are 16-byte
// aligned. mask: int32 [B, tk]; lse: f32 [B*H, tq] from flash_fwd; scratch:
// flash_bwd_scratch_bytes() bytes, 16-byte aligned; dq, dk, dv: contiguous
// [B, T, H, d]. One launch of flash_bwd_tf32_kernel, after a memset of its
// dQ counters when a head has more than one of its kv tiles. Returns the
// cudaError_t of the first launch that failed (0 on success);
// launches on `stream` and allocates nothing.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* mask,
                         const void* out, const void* dout, const void* lse, void* scratch,
                         void* dq, void* dk, void* dv, int B, int H, int tq, int tk, int d,
                         int64_t q_sb, int64_t q_st, int64_t q_sh,
                         int64_t k_sb, int64_t k_st, int64_t k_sh,
                         int64_t v_sb, int64_t v_st, int64_t v_sh,
                         int64_t o_sb, int64_t o_st, int64_t o_sh,
                         int64_t g_sb, int64_t g_st, int64_t g_sh,
                         int causal, float scale, void* stream) {
  if (bad_dims(B, H, tq, tk)) return (int)cudaErrorInvalidValue;
  const BwdParams p{q, k, v, out, dout, static_cast<const int*>(mask),
                    static_cast<const float*>(lse), dq, dk, dv,
                    q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh,
                    g_sb, g_st, g_sh, B, H, tq, tk, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return run_tf32<32>(p, scratch, s);
    case 64: return run_tf32<64>(p, scratch, s);
    case 128: return run_tf32<128>(p, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
