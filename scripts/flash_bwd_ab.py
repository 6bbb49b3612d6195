"""Device time of flash_attention_bwd in the checkout this is run from.

    python3 scripts/flash_bwd_ab.py TAG        # from the root of a checkout, on a CUDA host

Builds the checkout's kernels, then times flash_attention_bwd (bfloat16 and
float32) at the BERT-base training shape (B*H = 384, T = 128, D = 64) and
at B*H = 96, T = 512, three times each with chip_smoke.device_ms, and
prints one line a shape with TAG and the card. To compare two versions of
the kernel, run it from both checkouts in turns (A, B, B, A), back to back
on one card.
"""

import os
import sys

sys.path.insert(0, os.getcwd())  # the checkout's chip_smoke and synapseml_torch

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from synapseml_torch.ops import attention as att  # noqa: E402


def main(tag: str) -> None:
    card, device = c.phase_device()
    for dtype in (torch.bfloat16, torch.float32):
        for Bt, Tt in ((c.B, c.T), (c.LONG_B, c.LONG_T)):
            BH = Bt * c.H
            scale = 1.0 / c.D ** 0.5
            q, k, v = c._inputs(BH, Tt, Tt, c.D, dtype, device, seed=7)
            mask = c._padding_mask(BH, Tt, device, seed=7)
            out, lse = att.flash_attention_fwd(q, k, v, mask, False, scale)
            g = torch.Generator(device=device).manual_seed(8)
            dout = torch.randn(out.shape, generator=g, device=device).to(dtype)
            args = (q, k, v, mask, out, lse, dout, False, scale)
            ms = [c.device_ms(lambda: att.flash_attention_bwd(*args)) for _ in range(3)]
            print(f"[ab] {tag} flash_attention_bwd {c.KERNEL_NAMES[dtype]} B*H={BH} T={Tt} "
                  f"D={c.D}: " + " / ".join(f"{x:.4f}" for x in ms) + f" ms | {card}",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "checkout")
