// The flash-attention backward's host interface and what its two kernels
// share: flash_bwd_bf16.cu (flash_bwd_wgmma_kernel) and flash_bwd_f32.cu
// (flash_bwd_tf32_kernel) each build into a library of their own, with the
// same C entry points (flash_bwd, flash_bwd_scratch_bytes), and
// synapseml_torch/ops/attention.py loads the one of the inputs' dtype. Both
// replace synapseml_tpu/ops/attention.py::_flash_core_bwd, the backward
// that jax.custom_vjp gives the Pallas forward. That one is XLA (lax.scan
// over kv blocks for dq, over q blocks for dk and dv), not a Pallas kernel;
// it is a kernel here because what defines flash attention is memory,
// O(T * block) and never the [T, T] score matrix, and a plain PyTorch loop
// over block pairs would take thousands of launches a training step. Same
// function, given the forward's output O and its natural-log LSE:
//   * delta_i = sum_d f32(O_id) * f32(dO_id) (in f32, the split TF32 of dP);
//   * P is recomputed as exp(s - lse) with s = (q . k) * scale in f32,
//     gated to 0 where the mask (or, when causal, kv > q) removes the entry,
//     as _flash_core_bwd's `s <= -5e29` gate: a fully masked row and a
//     padded key get exactly zero gradient;
//   * dV += P^T dO with P rounded to dO's type; dP = dO V^T;
//     dS = P * (dP - delta); dQ += scale * dS K and dK += scale * dS^T Q with
//     dS rounded to the input type; every product accumulates in f32.
//   * q, k, v, O, dO: [B, T, H, D] with any (batch, token, head) element
//     strides, D innermost, 16-byte aligned; mask: int32 [B, tk]; lse: f32
//     [B*H, tq]; dq, dk, dv: contiguous [B, T, H, D] in the input type;
//     scratch: flash_bwd_scratch_bytes() bytes the caller allocates.
//
// Here: the entry point's parameters, the dQ sum in kv order that both
// kernels use, its scratch, and the once-per-device kernel set-up.
// Header-only and included by one source of each library, so everything
// is inline.

#pragma once

#include "flash_common.cuh"

namespace flash {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const int* mask;    // [B, tk]
  const float* lse;   // [B*H, tq]
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
  // the f32 kernel's tiles and its dQ sum (see dq_scratch), set by run_tf32
  int n_q, n_kv;
  float* dq_acc;
  int* counters;
};

// ------------------------------------------------------------- dQ sum ----
// Both kernels sum a q tile's dQ over the kv tiles of its head in kv order,
// without float atomics, so a second launch (or a CUDA graph's replay) is
// bitwise the first. With more than one kv tile a head, a block takes its
// kv tile by ticket (an atomic counter after the q tiles' counters, so a
// block waits only on blocks already running). Kv tile j of a head waits
// until its q tile's counter reads j, adds the sum of tiles 0..j-1 from the
// scratch to its own share and stores it back (then counts), or, as the
// last kv tile that sees the q tile, writes dQ. Each thread keeps its own
// float4s of a q tile's partial sum, float4 r of thread x at r * THREADS + x.

// spins (thread 0 of a block) until *c == want; traps after about 2^32
// clock cycles rather than hang the card
__device__ __forceinline__ void wait_count(const int* c, int want) {
  long long start = 0;
  for (;;) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(c) : "memory");
    if (v == want) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 32)) __trap();
    __nanosleep(64);
  }
}

// thread 0, after a barrier that follows the block's partial-sum stores:
// the stores, then one more kv tile counted (release)
__device__ __forceinline__ void count_release(int* c) {
  __threadfence();
  atomicAdd(c, 1);
}

// The scratch of the dQ sum, in bytes: none with one kv tile a head; else
// the counters ([B*H][n_q], then the ticket) and the partial sums from
// `acc` on ([B*H][n_q][q_rows * d] floats).
struct Scratch {
  int64_t acc, total;
  int n_counters;
};

inline Scratch dq_scratch(int64_t bh, int64_t n_q, int64_t n_kv, int q_rows, int d) {
  Scratch s{0, 0, 0};
  if (n_kv > 1) {
    s.n_counters = static_cast<int>(bh * n_q + 1);
    s.acc = (s.n_counters * 4 + 15) / 16 * 16;
    s.total = s.acc + bh * n_q * q_rows * d * 4;
  }
  return s;
}

// The kernel's shared-memory limit raised to `smem` and the device's SM
// count read into *sms, once per device (`cache`, the caller's): no host
// call per launch, and none while a CUDA graph captures a later one
template <typename Kernel>
int prepare_once(Kernel kernel, size_t smem, int (&cache)[64], int* sms) {
  int dev = 0, err;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if (dev < 64 && cache[dev] != 0) {
    *sms = cache[dev];
    return 0;
  }
  if ((err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem)) ||
      (err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)))
    return err;
  if (dev < 64) cache[dev] = *sms;
  return 0;
}

// The C entry point's checks, shared by both libraries' flash_bwd
inline bool bad_dims(int B, int H, int tq, int tk) { return B <= 0 || H <= 0 || tq <= 0 || tk < 0; }

}  // namespace flash
