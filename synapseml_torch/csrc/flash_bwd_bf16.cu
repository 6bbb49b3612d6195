// Flash-attention backward in bf16 for Hopper (sm_90a), bound to Python
// through a plain C entry point loaded with ctypes
// (synapseml_torch/ops/attention.py). The function, its arguments and the
// dQ sum are described in flash_bwd_common.cuh.
//
// bf16: flash_bwd_wgmma_kernel, one launch a call (after a memset of its
// dQ counters when a head has more than one 128-row kv tile), no float
// atomics, so a second launch (or a CUDA graph's replay) is bitwise the
// first. 256 threads, two warpgroups; a kv tile of 128 rows, warpgroup w
// owning rows 64w..64w+63. TMA brings K and V (double-buffered up to
// D = 64, so a block's next tile loads during this one) and streams the q
// tiles, 64 rows each of Q, dO and O, through a 2-stage ring completed on
// mbarriers, from tensor maps built on the host from the views' own
// strides. Per q tile, 5 products on wgmma m64nNk16 (bf16 in, f32
// accumulators in registers):
//   S^T = K Q^T and dP^T = V dO^T (A and B K-major in shared memory), and
//     meanwhile delta = rowsum(O dO) of the tile's rows from the O and dO
//     tiles already in shared memory (no pass of its own), and the LSE;
//   dV += P^T dO and dK += dS^T Q (A = P^T, dS^T straight from the S^T and
//     dP^T accumulators as bf16 register fragments; B = dO, Q read
//     MN-major, transposed by the descriptor);
//   dQ_tile = dS K (dS^T stored to a 128-byte-swizzled shared tile and read
//     as an MN-major A; B = K MN-major), warpgroup w computing columns
//     w*D/2.. of it over all 128 kv rows.
// dQ, dK and dV leave through TMA stores from swizzled shared tiles (dK
// and dV from the tile's own K and V buffers), rows past T clipped. Grid:
// with one kv tile a head (T <= 128, BERT's training shape) one block an
// SM walks tiles blockIdx.x, + gridDim.x, ... and writes dQ directly.
// Otherwise a block a (b*h, kv tile), tiles handed out by a ticket (an
// atomic counter, so a block waits only on blocks already running), and
// dQ summed in a fixed order through an f32 scratch: kv tile j waits until
// its q tile's counter reads j, adds the sum of tiles 0..j-1 (read during
// its own dQ product) to its share and stores it, and the last kv tile
// converts it to bf16 and writes dQ; under causal, q tiles wholly before
// the kv tile are skipped. Chosen by measurement over a thread-block
// cluster summing the kv tiles' partials in rank order through
// distributed shared memory: at B*H = 96, T = 512 the cluster version
// took 0.194 ms against 0.123 on an H100 at 700 W (clusters of 4
// one-block-an-SM blocks ran in 4 waves on 124 SMs instead of 3 on 132,
// and their barriers paired every q tile), and it would have needed a
// second dispatch past 8 tiles.
// Registers: 180 / 236 / 255 at D = 32 / 64 / 128 (one block an SM), no
// spills: at D = 128, where dK and dV alone take 128 a thread, S^T and dP^T
// are computed 16 q columns a pass and the dQ sum is read after dQ's
// product, and K and V have one buffer.
//
// Bound on this card. At BERT-base training shapes (B*H = 384, T = 128,
// D = 64) the function reads q, k, v, O and dO and writes dq, dk and dv:
// about 50.3 MB in bf16, 15.0 us at 3.35 TB/s, against 5 products of
// 0.805 GFLOP, 4.1 us at 989 TFLOP/s: bound by bytes. Each tile is read
// once (one kv tile a head, so Q, dO and O once too) and each output
// written once, by TMA, with the next tile's loads in flight behind the
// products. At B*H = 96, T = 512 it is bound by operations (16.1 GFLOP,
// 16.3 us): S and dP are computed once, so a (q tile, kv tile) pair costs
// the function's 5 products, on wgmma (the only way to the tensor cores'
// full rate) from swizzled tiles that need no ldmatrix.

#include <cuda.h>

#include "flash_bwd_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

// The bf16 kernel's tiles. A block owns BN kv rows at a time (two
// warpgroups of 64) and streams BM-row q tiles. A [rows, D] tile is NB
// column blocks of `rows` SW-byte rows each (COLS bf16 columns a row),
// swizzled as TMA writes and reads it: SW = 64 at D = 32, else 128.
template <int D>
struct Bf16Tile {
  static constexpr int BN = 128;                // kv rows a tile
  static constexpr int BM = 64;                 // q rows a streamed tile
  static constexpr int THREADS = 256;           // two warpgroups
  static constexpr int QC = D == 128 ? 16 : 64; // q columns of S^T and dP^T a pass (registers)
  static constexpr int KVB = D == 128 ? 1 : 2;  // K/V buffers: the next kv tile's comes early
  // at D = 128 (dK and dV take 128 registers a thread) the dQ sum before
  // this tile's is read after dQ's product, not during it
  static constexpr bool LEAN = D == 128;
  static constexpr int SW = D == 32 ? 64 : 128;
  static constexpr int COLS = SW / 2;
  static constexpr int NB = D / COLS;
  static constexpr uint64_t LAYOUT = SW == 128 ? hopper::SWIZZLE_128B : hopper::SWIZZLE_64B;
  static constexpr int KV_BYTES = BN * D * 2;   // K or V (or, at a tile's end, dK or dV)
  static constexpr int Q_BYTES = BM * D * 2;    // Q, dO or O, one stage; a dQ tile
  static constexpr int DS_BYTES = BN * BM * 2;  // dS^T: [kv][q], 128-byte swizzled rows
  // offsets from the block's 1024-byte-aligned base, after K's KVB buffers
  // (from 0) and V's
  static constexpr int Q_OFF = 2 * KVB * KV_BYTES;     // [2] stages each of Q, dO, O
  static constexpr int G_OFF = Q_OFF + 2 * Q_BYTES;
  static constexpr int O_OFF = G_OFF + 2 * Q_BYTES;
  static constexpr int DS_OFF = O_OFF + 2 * Q_BYTES;
  static constexpr int DQ_OFF = DS_OFF + DS_BYTES;     // the dQ tile on its way out
  static constexpr int LSE_OFF = DQ_OFF + Q_BYTES;     // [64] LSE, then [64] delta
  static constexpr int BAR_OFF = LSE_OFF + 2 * BM * 4; // kv[2], full[2], then the ticket
  static constexpr size_t SMEM = BAR_OFF + 40 + 1024;  // + room to align the base
  static constexpr uint32_t KV_TX = 2 * KV_BYTES;
  static constexpr uint32_t STAGE_TX = 3 * Q_BYTES;

  // byte offset of (row, column pair col/2) in a [rows, D] tile: 16-byte
  // chunks XORed with address bits 7.. as the swizzle does
  static __device__ __forceinline__ uint32_t at(int rows, int row, int col) {
    const int cb = col / COLS, chunk = col % COLS / 8;
    const int row_off = row * SW;
    return cb * rows * SW + row_off + ((chunk ^ ((row_off >> 7) & (SW / 16 - 1))) << 4) +
           col % 8 * 2;
  }
};

struct Bf16Params {
  // [D, T, H, B] views with boxes (COLS, rows, 1, 1): the inputs, then the
  // contiguous outputs
  CUtensorMap map_q, map_k, map_v, map_g, map_o, map_dq, map_dk, map_dv;
  const int* mask;      // [B, tk]
  const float* lse;     // [B*H, tq]
  float* dq_acc;        // n_kv > 1: [B*H][n_q][D/16][256][4] dQ partial sums
  int* counters;        // n_kv > 1: [B*H][n_q] kv tiles summed, then the ticket
  int B, H, tq, tk, causal, n_q, n_kv;
  float scale;
};

// dK and dV of 128-row kv tiles, and their shares of dQ. With one kv tile
// a head, a block walks tiles blockIdx.x, + gridDim.x, ... (one block an
// SM), each next tile's K, V and first q tiles loading during the last.
// With more, a block takes one tile by ticket.
template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ Bf16Params p) {
  using namespace hopper;
  using M = Bf16Tile<D>;
  constexpr int BN = M::BN, BM = M::BM, QC = M::QC, KVB = M::KVB;
  constexpr int SW = M::SW, COLS = M::COLS, NB = M::NB;
  constexpr uint32_t SBO = 8 * SW;  // 8-row groups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw);
  const uint32_t sq = base + M::Q_OFF, sg = base + M::G_OFF, so = base + M::O_OFF;
  const uint32_t sds = base + M::DS_OFF, sdq = base + M::DQ_OFF;
  const uint32_t bar_kv = base + M::BAR_OFF, bar_full = bar_kv + 16;  // + 8 * buffer or stage
  unsigned char* ds_ptr = base_ptr + M::DS_OFF;
  unsigned char* dq_ptr = base_ptr + M::DQ_OFF;
  float* lse_s = reinterpret_cast<float*>(base_ptr + M::LSE_OFF);
  float* delta_s = lse_s + BM;
  int* ticket_s = reinterpret_cast<int*>(base_ptr + M::BAR_OFF + 32);

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, c4 = lane % 4;
  const int tq = p.tq, H = p.H, n_kv = p.n_kv, n_tiles = p.B * H * n_kv;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, 1);
    mbar_init(bar_full, 1);
    mbar_init(bar_full + 8, 1);
    mbar_fence_init();
    // with several kv tiles a head, blocks wait on lower kv tiles of their
    // head: a ticket hands out tiles in the order blocks start
    *ticket_s = n_kv > 1 ? atomicAdd(p.counters + p.B * p.H * p.n_q, 1) : 0;
  }
  __syncthreads();
  // this block's tiles: first + t * stride for t < n_mine, each with
  // n_work q tiles (n_kv == 1: all of them)
  const int first = n_kv > 1 ? *ticket_s : static_cast<int>(blockIdx.x);
  const int stride = n_kv > 1 ? n_tiles : static_cast<int>(gridDim.x);
  const int n_mine = first < n_tiles ? (n_tiles - first + stride - 1) / stride : 0;
  const int j0 = first % n_kv;  // the kv tile (the same for every tile a block walks)
  const int i_first = p.causal ? j0 * BN / BM : 0;  // causal: q tiles before kv0 see none of it
  const int n_work = p.n_q - i_first;
  const int n_items = n_mine * n_work;

  // thread 0 starts every copy: tile t's K and V into buffer t % KVB, item
  // w (the k-th q tile of tile t = w / n_work) into stage w % 2, and the
  // dQ, dK and dV tiles out
  const CUtensorMap* map_q = &p.map_q;
  const CUtensorMap* map_g = &p.map_g;
  const CUtensorMap* map_o = &p.map_o;
  const CUtensorMap* map_k = &p.map_k;
  const CUtensorMap* map_v = &p.map_v;
  const CUtensorMap* map_dq = &p.map_dq;
  const int n_per_b = H * n_kv;
  auto load_kv = [&](int t) {
    const int tile = first + t * stride, kb = t % KVB;
    const int b = tile / n_per_b, h = tile / n_kv % H, kv0 = tile % n_kv * BN;
    const uint32_t bar = bar_kv + 8 * kb, sk = base + kb * M::KV_BYTES;
    mbar_expect_tx(bar, M::KV_TX);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      tma_load_4d(sk + cb * BN * SW, map_k, bar, cb * COLS, kv0, h, b);
      tma_load_4d(sk + KVB * M::KV_BYTES + cb * BN * SW, map_v, bar, cb * COLS, kv0, h, b);
    }
  };
  auto load_item = [&](int w) {
    const int tile = first + w / n_work * stride, i = i_first + w % n_work, s = w & 1;
    const int b = tile / n_per_b, h = tile / n_kv % H;
    const uint32_t bar = bar_full + 8 * s;
    mbar_expect_tx(bar, M::STAGE_TX);
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      const uint32_t off = s * M::Q_BYTES + cb * BM * SW;
      tma_load_4d(sq + off, map_q, bar, cb * COLS, i * BM, h, b);
      tma_load_4d(sg + off, map_g, bar, cb * COLS, i * BM, h, b);
      tma_load_4d(so + off, map_o, bar, cb * COLS, i * BM, h, b);
    }
  };
  // thread 0: a tile whose K and V wait for their buffer (the second
  // buffer's first tile waits until the first tile's loads are out)
  int kv_pending = KVB == 2 && n_mine > 1 ? 1 : -1;
  if (tid == 0) {
    if (n_mine > 0) load_kv(0);
    for (int w = 0; w < 2 && w < n_items; ++w) load_item(w);
  }

  // delta: 4 threads a q row, 16-byte chunks of O and dO at the same
  // physical offsets (the swizzle pairs them alike), rotated by row so the
  // 8 rows of a warp hit distinct banks
  const int d_row = tid / 4, d_sub = tid % 4;
  constexpr int CPR = SW / 16;  // 16-byte chunks a swizzled row
  const int r_a = wg * 64 + warp * 16 + g;  // this thread's accumulator rows r_a, r_a + 8
  const float scale = p.scale, scale2 = scale * LOG2E;
  // K-major operands: this warpgroup's 64 rows of K and V; MN-major K for
  // dQ: this warpgroup's D/2 columns
  const uint32_t a_rows = wg * 64 * SW;
  const uint32_t k_half = (wg * D / 2) / COLS * BN * SW + (wg * D / 2) % COLS * 2;

  int w = 0;  // items done
  for (int t = 0; t < n_mine; ++t) {
    const int tile = first + t * stride, kb = t % KVB;
    const int bh = tile / n_kv, j = tile % n_kv;
    const int b = bh / H, h = bh % H, kv0 = j * BN;
    const uint32_t sk = base + kb * M::KV_BYTES, sv = sk + KVB * M::KV_BYTES;
    // this thread's two kv rows and whether each may be attended at all
    const int row_a = kv0 + r_a, row_b = row_a + 8;
    const int* mg = p.mask + static_cast<int64_t>(b) * p.tk;
    const bool ok_a = row_a < p.tk && mg[row_a] != 0;
    const bool ok_b = row_b < p.tk && mg[row_b] != 0;
    // the LSE of the next q tile's rows, one a thread of the first 64,
    // loaded a tile ahead of its use
    const float* lse_g = p.lse + static_cast<int64_t>(bh) * tq;
    auto lse_of = [&](int k) {
      const int q = (i_first + k) * BM + tid;
      return tid < BM && k < n_work && q < tq ? lse_g[q] : 0.f;
    };
    float lse_next = lse_of(0);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) dk[n] = dv[n] = 0.f;
    mbar_wait(bar_kv + 8 * kb, (t / KVB) & 1);

    for (int k = 0; k < n_work; ++k, ++w) {
      const int i = i_first + k, q0 = i * BM, s = w & 1;
      const uint32_t sq_s = sq + s * M::Q_BYTES, sg_s = sg + s * M::Q_BYTES;
      mbar_wait(bar_full + 8 * s, (w >> 1) & 1);
      uint32_t pa[QC / 16][4], sa[QC / 16][4];  // live until the wgmmas reading them end

#pragma unroll
      for (int pc = 0; pc < BM / QC; ++pc) {
        // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x QC q columns a warpgroup
        float st[QC / 2], dpt[QC / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = ks * 16 / COLS, in_row = ks * 16 % COLS * 2;
          wgmma_ss<QC, 0, 0>(
              st, smem_desc(sk + off * BN * SW + a_rows + in_row, 16, SBO, M::LAYOUT),
              smem_desc(sq_s + off * BM * SW + pc * QC * SW + in_row, 16, SBO, M::LAYOUT),
              ks > 0);
        }
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = ks * 16 / COLS, in_row = ks * 16 % COLS * 2;
          wgmma_ss<QC, 0, 0>(
              dpt, smem_desc(sv + off * BN * SW + a_rows + in_row, 16, SBO, M::LAYOUT),
              smem_desc(sg_s + off * BM * SW + pc * QC * SW + in_row, 16, SBO, M::LAYOUT),
              ks > 0);
        }
        wgmma_commit();

        if (pc == 0) {  // meanwhile: delta of the tile's rows, and their LSE
          const unsigned char* o_t = base_ptr + M::O_OFF + s * M::Q_BYTES;
          const unsigned char* g_t = base_ptr + M::G_OFF + s * M::Q_BYTES;
          float acc = 0.f;
#pragma unroll
          for (int u = 0; u < D / 32; ++u) {
            const int c = d_sub + 4 * u;
            const int off = c / CPR * BM * SW + d_row * SW + ((c % CPR) ^ (d_row % CPR)) * 16;
            const uint4 o4 = *reinterpret_cast<const uint4*>(o_t + off);
            const uint4 g4 = *reinterpret_cast<const uint4*>(g_t + off);
            const bf16* o = reinterpret_cast<const bf16*>(&o4);
            const bf16* gr = reinterpret_cast<const bf16*>(&g4);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc = fmaf(__bfloat162float(o[e]), __bfloat162float(gr[e]), acc);
          }
          acc += __shfl_xor_sync(FULL, acc, 1);
          acc += __shfl_xor_sync(FULL, acc, 2);
          if (d_sub == 0) delta_s[d_row] = acc;
          if (tid < BM) lse_s[tid] = lse_next;
          lse_next = lse_of(k + 1);
          __syncthreads();  // LSE and delta
        }
        wgmma_wait<0>();  // also the last pass's dV and dK
        fence_regs(st);
        fence_regs(dpt);
        fence_regs(pa);
        fence_regs(sa);

        // P^T = exp(s - lse) where attended, else 0; dS^T = P^T (dP^T - delta).
        // Element e of 8-column chunk n: kv row (e < 2 ? row_a : row_b), q
        // column q0 + pc*QC + 8n + 2*c4 + (e & 1).
#pragma unroll
        for (int n = 0; n < QC / 8; ++n) {
          const int col = pc * QC + n * 8 + 2 * c4;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q0 + col + (e & 1), kv = e < 2 ? row_a : row_b;
            const bool ok = (e < 2 ? ok_a : ok_b) && q < tq && (!p.causal || kv <= q);
            const float lse = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
            const float pv = ok ? exp2f(st[4 * n + e] * scale2 - lse * LOG2E) : 0.f;
            st[4 * n + e] = pv;
            dpt[4 * n + e] = pv * (dpt[4 * n + e] - dl);
          }
        }
        // as bf16 A fragments, k = q columns pc*QC + 16kk..16kk+15
#pragma unroll
        for (int kk = 0; kk < QC / 16; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
            sa[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
          }

        // dV += P^T dO and dK += dS^T Q: k over the pass's q rows, B MN-major
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QC / 16; ++kk)
          wgmma_rs<D, 1>(dv, pa[kk],
                         smem_desc(sg_s + (pc * QC + kk * 16) * SW, BM * SW, SBO, M::LAYOUT), 1);
#pragma unroll
        for (int kk = 0; kk < QC / 16; ++kk)
          wgmma_rs<D, 1>(dk, sa[kk],
                         smem_desc(sq_s + (pc * QC + kk * 16) * SW, BM * SW, SBO, M::LAYOUT), 1);
        wgmma_commit();

        // dS^T into the [kv][q] tile (128-byte rows, 16-byte chunk n of row
        // r at chunk n ^ (r % 8)), 4 bytes a column pair; r % 8 == g
#pragma unroll
        for (int n = 0; n < QC / 8; ++n) {
          const int chunk = (((pc * QC / 8 + n) ^ g) << 4) + 4 * c4;
          *reinterpret_cast<uint32_t*>(ds_ptr + r_a * 128 + chunk) = sa[n / 2][(n & 1) * 2];
          *reinterpret_cast<uint32_t*>(ds_ptr + (r_a + 8) * 128 + chunk) =
              sa[n / 2][(n & 1) * 2 + 1];
        }
      }
      fence_async_shared();
      // dQ of the tile is summed over the kv tiles of the head in kv order
      // (see the top note): the sum of tiles 0..j-1 is read while this
      // tile's share is computed (at D = 128, after it)
      const int last = p.causal ? min(n_kv - 1, (q0 + BM - 1) / BN) : n_kv - 1;
      const int64_t slot = static_cast<int64_t>(bh) * p.n_q + i;
      float4* acc = reinterpret_cast<float4*>(p.dq_acc) + slot * (D / 16) * M::THREADS + tid;
      if (j > 0 && tid == 0) wait_count(p.counters + slot, j);
      __syncthreads();  // both warpgroups' dS^T (and the sum before this tile's)
      float4 before[D / 16];
      if (!M::LEAN && j > 0) {
#pragma unroll
        for (int r4 = 0; r4 < D / 16; ++r4) before[r4] = __ldcg(acc + r4 * M::THREADS);
      }

      // this warpgroup's D/2 columns of dQ_tile = dS K, k over the 128 kv rows
      float dq[D / 4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_ss<D / 2, 1, 1>(dq, smem_desc(sds + kk * 16 * 128, 16, 1024, SWIZZLE_128B),
                              smem_desc(sk + k_half + kk * 16 * SW, BN * SW, SBO, M::LAYOUT),
                              kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(sa);
      // the last dQ tile (and dK, dV) left their buffers before any thread
      // passes the barrier and writes this tile's dQ into the staging tile
      if (tid == 0) bulk_wait_read<0>();
      __syncthreads();  // stage w % 2 and the dS^T tile are free
      if (tid == 0) {
        if (kv_pending >= 0) {
          load_kv(kv_pending);
          kv_pending = -1;
        }
        if (w + 2 < n_items) load_item(w + 2);
      }

      if (j > 0) {  // the sum of kv tiles 0..j-1, plus this tile's share
        if constexpr (M::LEAN) {
#pragma unroll
          for (int r4 = 0; r4 < D / 16; ++r4) before[r4] = __ldcg(acc + r4 * M::THREADS);
        }
#pragma unroll
        for (int r4 = 0; r4 < D / 16; ++r4) {
          dq[4 * r4] = before[r4].x + dq[4 * r4];
          dq[4 * r4 + 1] = before[r4].y + dq[4 * r4 + 1];
          dq[4 * r4 + 2] = before[r4].z + dq[4 * r4 + 2];
          dq[4 * r4 + 3] = before[r4].w + dq[4 * r4 + 3];
        }
      }
      // the last kv tile writes the tile's dQ: rows q0 + 16*warp + g (+ 8),
      // columns wg*D/2 + 8n + 2*c4 (+ 1), times the scale
      if (j == last) {
        const int ca = wg * D / 2 + 2 * c4;
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {
          *reinterpret_cast<uint32_t*>(dq_ptr + M::at(BM, warp * 16 + g, ca + 8 * n)) =
              pack_bf16(dq[4 * n] * scale, dq[4 * n + 1] * scale);
          *reinterpret_cast<uint32_t*>(dq_ptr + M::at(BM, warp * 16 + g + 8, ca + 8 * n)) =
              pack_bf16(dq[4 * n + 2] * scale, dq[4 * n + 3] * scale);
        }
        fence_async_shared();
        __syncthreads();
        if (tid == 0) {
#pragma unroll
          for (int cb = 0; cb < NB; ++cb)
            tma_store_4d(map_dq, sdq + cb * BM * SW, cb * COLS, q0, h, b);
          bulk_commit();
        }
      } else {
#pragma unroll
        for (int r4 = 0; r4 < D / 16; ++r4)
          __stcg(acc + r4 * M::THREADS,
                 make_float4(dq[4 * r4], dq[4 * r4 + 1], dq[4 * r4 + 2], dq[4 * r4 + 3]));
        __syncthreads();
        if (tid == 0) count_release(p.counters + slot);  // the block's stores, then its count
      }
    }

    // dK (times scale) and dV into this tile's K and V buffers (free once
    // its last dQ product is done), then out
    unsigned char* dk_ptr = base_ptr + kb * M::KV_BYTES;
    unsigned char* dv_ptr = dk_ptr + KVB * M::KV_BYTES;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * c4;
      const uint32_t at_a = M::at(BN, r_a, col), at_b = M::at(BN, r_a + 8, col);
      *reinterpret_cast<uint32_t*>(dk_ptr + at_a) =
          pack_bf16(dk[4 * n] * scale, dk[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(dk_ptr + at_b) =
          pack_bf16(dk[4 * n + 2] * scale, dk[4 * n + 3] * scale);
      *reinterpret_cast<uint32_t*>(dv_ptr + at_a) = pack_bf16(dv[4 * n], dv[4 * n + 1]);
      *reinterpret_cast<uint32_t*>(dv_ptr + at_b) = pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
    }
    fence_async_shared();
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        tma_store_4d(&p.map_dk, sk + cb * BN * SW, cb * COLS, kv0, h, b);
        tma_store_4d(&p.map_dv, sv + cb * BN * SW, cb * COLS, kv0, h, b);
      }
      bulk_commit();
      // tile t + KVB's K and V go into this buffer once the stores have read
      // it: at once with one buffer, else after the next q tile
      if (t + KVB < n_mine) {
        if (KVB == 1) {
          bulk_wait_read<0>();
          load_kv(t + 1);
        } else {
          kv_pending = t + KVB;
        }
      }
    }
  }
  if (tid == 0) bulk_wait_read<0>();  // the shared memory stays until the stores read it
}

// --------------------------------------------------------------- launch ----

// The scratch of one call (see the dQ sum in flash_bwd_common.cuh), from
// the kernel's tiles
template <int D>
Scratch scratch_of(int64_t bh, int tq, int tk) {
  using M = Bf16Tile<D>;
  return dq_scratch(bh, (tq + M::BM - 1) / M::BM, (tk + M::BN - 1) / M::BN, M::BM, D);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has loaded (no
// link against libcuda), looked up once
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// returned when cuTensorMapEncodeTiled refuses a view (no CUDA error is this large)
constexpr int ERR_TENSOR_MAP = 100000;

// A [B, T, H, D] bf16 view (element strides sb, st, sh; 0 for a dim of
// size 1) as a 4-d tensor map [D, T, H, B] with boxes of (COLS, rows, 1, 1),
// swizzled for wgmma; rows past T read as zeros. A zero stride on a dim
// longer than 1 (a broadcast view) is refused: TMA steps by it.
template <int D>
int encode_view(CUtensorMap* map, const void* ptr, int B, int T, int H, int64_t sb, int64_t st,
                int64_t sh, int rows) {
  using M = Bf16Tile<D>;
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return ERR_TENSOR_MAP;
  if ((st == 0 && T > 1) || (sh == 0 && H > 1) || (sb == 0 && B > 1))
    return ERR_TENSOR_MAP + static_cast<int>(CUDA_ERROR_INVALID_VALUE);
  // a size-1 dim's stride is never stepped: any multiple of 16 bytes does
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(T > 1 ? st * 2 : static_cast<int64_t>(H) * D * 2),
      static_cast<cuuint64_t>(H > 1 ? sh * 2 : D * 2),
      static_cast<cuuint64_t>(B > 1 ? sb * 2 : static_cast<int64_t>(T) * H * D * 2)};
  const cuuint32_t box[4] = {M::COLS, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        M::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + static_cast<int>(r);
}

template <int D>
int run_bf16(const BwdParams& p, void* scratch, cudaStream_t s) {
  using M = Bf16Tile<D>;
  const int bh = p.B * p.H;
  if (p.tk == 0)  // no key: dq is 0 (dk and dv are empty)
    return (int)cudaMemsetAsync(p.dq, 0, static_cast<size_t>(bh) * p.tq * D * 2, s);
  const Scratch sc = scratch_of<D>(bh, p.tq, p.tk);
  unsigned char* sp = static_cast<unsigned char*>(scratch);
  Bf16Params bp;
  bp.mask = p.mask;
  bp.lse = p.lse;
  bp.counters = reinterpret_cast<int*>(sp);
  bp.dq_acc = reinterpret_cast<float*>(sp + sc.acc);
  bp.B = p.B;
  bp.H = p.H;
  bp.tq = p.tq;
  bp.tk = p.tk;
  bp.causal = p.causal;
  bp.n_q = n_tiles(p.tq);
  bp.n_kv = (p.tk + M::BN - 1) / M::BN;
  bp.scale = p.scale;
  const int64_t hd = static_cast<int64_t>(p.H) * D;  // the outputs' token stride
  int err;
  if ((err = encode_view<D>(&bp.map_q, p.q, p.B, p.tq, p.H, p.q_sb, p.q_st, p.q_sh, M::BM)) ||
      (err = encode_view<D>(&bp.map_k, p.k, p.B, p.tk, p.H, p.k_sb, p.k_st, p.k_sh, M::BN)) ||
      (err = encode_view<D>(&bp.map_v, p.v, p.B, p.tk, p.H, p.v_sb, p.v_st, p.v_sh, M::BN)) ||
      (err = encode_view<D>(&bp.map_g, p.dout, p.B, p.tq, p.H, p.g_sb, p.g_st, p.g_sh, M::BM)) ||
      (err = encode_view<D>(&bp.map_o, p.out, p.B, p.tq, p.H, p.o_sb, p.o_st, p.o_sh, M::BM)) ||
      (err = encode_view<D>(&bp.map_dq, p.dq, p.B, p.tq, p.H, p.tq * hd, hd, D, M::BM)) ||
      (err = encode_view<D>(&bp.map_dk, p.dk, p.B, p.tk, p.H, p.tk * hd, hd, D, M::BN)) ||
      (err = encode_view<D>(&bp.map_dv, p.dv, p.B, p.tk, p.H, p.tk * hd, hd, D, M::BN)))
    return err;
  if (sc.n_counters > 0 &&
      (err = (int)cudaMemsetAsync(bp.counters, 0, sc.n_counters * sizeof(int), s)))
    return err;

  static int cache[64] = {};
  int sms = 0;
  if ((err = prepare_once(flash_bwd_wgmma_kernel<D>, M::SMEM, cache, &sms))) return err;
  // one kv tile a head: one block an SM walks the tiles; else a block a tile
  int64_t blocks = static_cast<int64_t>(bh) * bp.n_kv;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (bp.n_kv == 1 && blocks > sms) blocks = sms;
  flash_bwd_wgmma_kernel<D><<<static_cast<unsigned>(blocks), M::THREADS, M::SMEM, s>>>(bp);
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

// q, k, v, out, dout: bf16 [B, T, H, d] with element strides (batch, token,
// head) and unit stride along d; the pointers and strides are 16-byte
// aligned. mask: int32 [B, tk]; lse: f32 [B*H, tq] from flash_fwd; scratch:
// flash_bwd_scratch_bytes() bytes, 16-byte aligned; dq, dk, dv: contiguous
// [B, T, H, d]. One launch of flash_bwd_wgmma_kernel, after a memset of its
// dQ counters when a head has more than one of its kv tiles. Returns the
// cudaError_t of the first launch that failed, or ERR_TENSOR_MAP plus the
// CUresult when a view cannot be described to TMA (0 on success);
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
    case 32: return run_bf16<32>(p, scratch, s);
    case 64: return run_bf16<64>(p, scratch, s);
    case 128: return run_bf16<128>(p, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
