"""Where flash_bwd_wgmma_kernel's blocks spend their time, on the card.

    python3 scripts/flash_bwd_trace.py        # from the root of a checkout, on a CUDA host

Copies synapseml_torch/csrc/flash_bwd_bf16.cu into build/flash_bwd_trace/ with a
%globaltimer stamp (thread 0 of each block) at fixed points: the block's
start, its first K and V, and for each of its first 8 q tiles the tile's
arrival, the end of S^T, dP^T and delta, the end of the other products, and
the end of its dQ sum and store; then the block's end. Compiles the copy
with nvcc, runs the bf16 backward through it at the BERT-base training
shape (B*H = 384, T = 128, D = 64) and at B*H = 96, T = 512, and prints
medians over the blocks in microseconds. The stamps add a few stores a q
tile; time the kernel itself with chip_smoke.py.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())  # the checkout's chip_smoke and synapseml_torch

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from synapseml_torch.ops import _build  # noqa: E402
from synapseml_torch.ops import attention as att  # noqa: E402

SLOTS = 36  # a block's stamps: 0 start, 1 first K/V, 2 + 4k + (0..3) q tile k, 34 end; 35 SM
STAMP = ('#define STAMP(e) do { if (threadIdx.x == 0 && (e) < 35) { unsigned long long t_; '
         'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
         'g_stamps[blockIdx.x * 36 + (e)] = t_; } } while (0)\n')
# (marker in flash_bwd_bf16.cu, code to insert, insert after the marker?)
POINTS = [
    ('#include "hopper.cuh"\n', '\n__device__ unsigned long long g_stamps[8192 * 36];\n' + STAMP,
     True),
    ('  if (tid == 0) {\n    mbar_init(bar_kv, 1);',
     '  STAMP(0);\n  if (tid == 0) { unsigned sm_; asm volatile("mov.u32 %0, %%smid;" : "=r"(sm_));'
     ' g_stamps[blockIdx.x * 36 + 35] = sm_; }\n', False),
    ('    mbar_wait(bar_kv + 8 * kb, (t / KVB) & 1);\n', '    if (t == 0) STAMP(1);\n', True),
    ('      mbar_wait(bar_full + 8 * s, (w >> 1) & 1);\n', '      if (w < 8) STAMP(2 + 4 * w);\n',
     True),
    ('        fence_regs(dpt);\n', '        if (w < 8 && pc == 0) STAMP(3 + 4 * w);\n', True),
    ('        if (w + 2 < n_items) load_item(w + 2);\n      }\n',
     '      if (w < 8) STAMP(4 + 4 * w);\n', True),
    ("    }\n\n    // dK (times scale) and dV into this tile's K and V buffers",
     '      if (w < 8) STAMP(5 + 4 * w);\n', False),
    ('  if (tid == 0) bulk_wait_read<0>();  // the shared memory stays until the stores read it\n',
     '  STAMP(34);\n', True),
]
READ = '''
extern "C" int flash_bwd_stamps_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, (size_t)n * 8);
}
extern "C" int flash_bwd_stamps_clear() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_stamps);
  return (int)cudaMemset(p, 0, sizeof(unsigned long long) * 8192 * 36);
}
'''


def build() -> ctypes.CDLL:
    src = (_build.CSRC / "flash_bwd_bf16.cu").read_text()
    for marker, code, after in POINTS:
        if marker not in src:
            raise RuntimeError(f"flash_bwd_bf16.cu no longer has the stamp point {marker!r}")
        at = src.index(marker) + (len(marker) if after else 0)
        src = src[:at] + code + src[at:]
    out = Path("build/flash_bwd_trace")
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_bwd_trace.cu").write_text(src + READ)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                    str(out / "libflash_bwd_trace.so"), str(out / "flash_bwd_trace.cu")],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(out / "libflash_bwd_trace.so"))


def trace(lib, device, BH: int, Tt: int) -> None:
    scale = 1.0 / c.D ** 0.5
    q, k, v = c._inputs(BH, Tt, Tt, c.D, torch.bfloat16, device, seed=7)
    mask = c._padding_mask(BH, Tt, device, seed=7)
    out, lse = att.flash_attention_fwd(q, k, v, mask, False, scale)
    dout = torch.randn(out.shape, device=device).to(torch.bfloat16)
    args = (q, k, v, mask, out, lse, dout, False, scale)
    for _ in range(3):
        att.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    lib.flash_bwd_stamps_clear()
    torch.cuda._sleep(c.SPIN)  # the call queued whole behind a spin, as device_ms times it
    att.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    n_kv = -(-Tt // 128)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = BH * n_kv if n_kv > 1 else min(BH, sms)
    buf = (ctypes.c_ulonglong * (blocks * SLOTS))()
    lib.flash_bwd_stamps_read(buf, blocks * SLOTS)
    a = np.array(buf, dtype=np.int64).reshape(blocks, SLOTS)
    rel = (a[:, :35] - a[:, 0].min()) / 1e3
    rel[a[:, :35] == 0] = np.nan
    start, first_kv, end = rel[:, 0], rel[:, 1], rel[:, 34]
    print(f"[trace] bf16 B*H={BH} T={Tt} D={c.D}: {blocks} blocks on {len(set(a[:, 35]))} SMs, "
          f"last block ends at {np.nanmax(end):.2f} us; a block's life {np.nanmedian(end - start):.2f} "
          f"us (median), its first K/V after {np.nanmedian(first_kv - start):.2f} us; block starts "
          f"at quantiles 0/.25/.5/.75/1: {np.round(np.quantile(start, [0, .25, .5, .75, 1]), 2)} us",
          flush=True)
    items = min(8, -(-Tt // 64) * (1 if n_kv > 1 else -(-BH // sms)))
    for w in range(items):
        arrive, sdp, rest, dq = (rel[:, 2 + 4 * w + e] for e in range(4))
        prev = first_kv if w == 0 else rel[:, 5 + 4 * (w - 1)]
        print(f"[trace]   q tile {w}: waits {np.nanmedian(arrive - prev):.2f}, S^T/dP^T/delta "
              f"{np.nanmedian(sdp - arrive):.2f}, P/dS/dV/dK/dQ products "
              f"{np.nanmedian(rest - sdp):.2f}, dQ sum and store {np.nanmedian(dq - rest):.2f}",
              flush=True)
    last = rel[:, 5 + 4 * (items - 1)]
    print(f"[trace]   last q tile to the block's end: {np.nanmedian(end - last):.2f}", flush=True)


def main() -> None:
    lib = build()
    _build._libs["flash_bwd_bf16"] = lib  # the bf16 wrapper launches the stamped copy
    card, device = c.phase_device()
    trace(lib, device, c.B * c.H, c.T)
    trace(lib, device, c.LONG_B * c.H, c.LONG_T)


if __name__ == "__main__":
    main()
