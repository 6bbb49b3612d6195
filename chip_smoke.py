"""Chip check of the PyTorch/CUDA port (synapseml_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card (an H100;
the kernels are built for sm_90a). Phases, each of which raises on failure:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles every kernel under synapseml_torch/csrc/ with nvcc;
3. kernels: holds each kernel against its plain PyTorch version on the
   card (BERT-base shapes in bf16 and f32, with a padding mask, causal and
   not; unaligned T and D; fully masked rows exactly 0);
4. main path: DeepTextModel scoring with BERT-base (random weights from a
   seed) through attn_impl='flash': the kernel must launch 12 times per
   batch, every score must be finite and the scores must agree with the
   einsum path on the card and, on a small input, with the CPU path (the
   kernel's plain version) that the CPU tests hold to the JAX package;
   then a profile of one batch by kernel group;
5. times: each kernel beside its bound, its plain version and the one
   PyTorch call that computes the same function.

The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from synapseml_torch import DataFrame
from synapseml_torch.core import batching as cb
from synapseml_torch.models.convert_jax import bert_state_dict_from_flax, init_flax_bert_params
from synapseml_torch.models.nets.bert import bert_base
from synapseml_torch.models.text import DeepTextModel
from synapseml_torch.models.tokenizer import HashingTokenizer
from synapseml_torch.ops import _build
from synapseml_torch.ops import attention as att

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, non-TF32 f32
TOL_OUT = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
TOL_LSE = 1e-4

# BERT-base scoring: batch 32, 12 heads, 128 tokens, head dim 64
B, H, T, D = 32, 12, 128, 64
N_TEXTS, N_PARTS, N_REQUESTS = 200, 3, 3


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, warmup=5, iters=30) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> tuple[str, torch.device]:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return card, torch.device("cuda:0")


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} of {len(_build.sources())} kernel source(s) compiled in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _inputs(BH, Tq, Tk, Dp, dtype, device, seed, true_d=None):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((BH, t, Dp), generator=g, device=device).to(dtype)
               for t in (Tq, Tk, Tk))
    if true_d is not None and true_d < Dp:  # D padded up to the kernel's head dim
        for x in (q, k, v):
            x[..., true_d:] = 0
    return q, k, v


def _padding_mask(BH, Tk, device, seed, empty_rows=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    lengths = torch.randint(1, Tk + 1, (BH,), generator=g)
    mask = (torch.arange(Tk)[None, :] < lengths[:, None]).to(torch.int32)
    mask[:empty_rows] = 0
    return mask.to(device)


def phase_kernels(device) -> float:
    """Kernel against its plain version on the same inputs; returns the max
    |out difference| at the main path's shape (BERT-base, bf16)."""
    cases = [  # name, BH, Tq, Tk, Dp, true D, dtype, causal, empty mask rows
        ("bert-base bf16", B * H, T, T, D, D, torch.bfloat16, False, 0),
        ("bert-base f32", B * H, T, T, D, D, torch.float32, False, 0),
        ("bert-base bf16 causal", B * H, T, T, D, D, torch.bfloat16, True, 0),
        ("bert-base f32 causal", B * H, T, T, D, D, torch.float32, True, 0),
        ("unaligned T=50 D=24 f32 causal", 24, 50, 50, 32, 24, torch.float32, True, 0),
        ("unaligned T=50 D=24 bf16", 24, 50, 50, 32, 24, torch.bfloat16, False, 0),
        ("T=200 D=128 bf16 causal", 16, 200, 200, 128, 128, torch.bfloat16, True, 0),
        ("fully masked rows f32", 48, T, T, D, D, torch.float32, False, 8),
        ("fully masked rows bf16", 48, T, T, D, D, torch.bfloat16, True, 8),
    ]
    main_err = None
    for i, (name, BH, Tq, Tk, Dp, true_d, dtype, causal, empty) in enumerate(cases):
        q, k, v = _inputs(BH, Tq, Tk, Dp, dtype, device, seed=i, true_d=true_d)
        mask = _padding_mask(BH, Tk, device, seed=i, empty_rows=empty)
        scale = 1.0 / true_d ** 0.5
        out, lse = att.flash_attention_fwd(q, k, v, mask, causal, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = att.flash_attention_fwd_plain(q, k, v, mask, causal, scale)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        log(f"[kernel] flash_fwd {name}: max|dout| {err_out:.3e} (tol {TOL_OUT[dtype]:g}), "
            f"max|dlse| {err_lse:.3e} (tol {TOL_LSE:g})")
        if not (err_out <= TOL_OUT[dtype] and err_lse <= TOL_LSE):
            raise AssertionError(f"flash_fwd disagrees with its plain version on {name}")
        if not bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"flash_fwd gave non-finite values on {name}")
        if empty and out[:empty].abs().max().item() != 0.0:
            raise AssertionError(f"fully masked rows are not exactly 0 on {name}")
        if i == 0:
            main_err = err_out

    # the public [B, T, H, D] face: T and D padding, scale at the true D
    g = torch.Generator(device=device).manual_seed(99)
    q, k, v = (torch.randn((2, 50, 4, 24), generator=g, device=device) for _ in range(3))
    kv_mask = torch.rand((2, 50), generator=g, device=device) > 0.2
    err = (att.flash_attention(q, k, v, kv_mask, causal=True)
           - att.reference_attention(q, k, v, kv_mask, causal=True)).abs().max().item()
    log(f"[kernel] flash_attention [B,T,H,D]=[2,50,4,24] causal vs reference_attention: "
        f"max|d| {err:.3e} (tol 2e-5)")
    if not err <= 2e-5:
        raise AssertionError("flash_attention disagrees with reference_attention")
    return main_err


def _texts(n: int, n_parts: int, seed: int) -> list[str]:
    """Texts of up to 300 words (most truncate to 128 tokens) in all but the
    last partition, short ones (under 40 words) in the last, so that the
    padded length varies by partition."""
    rs = np.random.default_rng(seed)
    words = ("the a film plot acting score music scene story actor director great good "
             "bad awful boring moving long short slow fast funny sad dark bright not very "
             "really quite well badly never always").split()
    n_short = n - round((n_parts - 1) * n / n_parts)  # DataFrame.repartition's last slice
    lengths = np.concatenate([rs.integers(3, 300, n - n_short), rs.integers(3, 40, n_short)])
    return [" ".join(rs.choice(words, size=int(m))) for m in lengths]


def phase_main_path(device, card: str) -> dict:
    cfg = bert_base()  # hidden 768, 12 layers, 12 heads, MLP 3072; bf16 compute, f32 params
    t0 = time.perf_counter()
    params = bert_state_dict_from_flax(init_flax_bert_params(cfg, num_classes=2, seed=0))
    log(f"[main] BERT-base weights from seed 0: {sum(a.size for a in params.values()):,} "
        f"params in {time.perf_counter() - t0:.1f} s")
    tok = HashingTokenizer(vocab_size=cfg.vocab_size)
    model = DeepTextModel(model_params=params, arch_config=cfg,
                          tokenizer_config=tok.to_config(),
                          checkpoint="bert-base", num_classes=2, batch_size=32,
                          max_token_len=128, attn_impl="flash", device=str(device))
    df = DataFrame.from_rows([{"text": t} for t in _texts(N_TEXTS, N_PARTS, seed=0)],
                             num_partitions=N_PARTS)
    bucketer = cb.default_bucketer()
    slices = [list(bucketer.slices(len(p["text"]), 32)) for p in df.partitions]
    batches = sum(len(s) for s in slices)
    log(f"[main] {N_TEXTS} texts in {N_PARTS} partitions: padded length by partition "
        f"{[tok(list(p['text']), max_len=128)['input_ids'].shape[1] for p in df.partitions]}, "
        f"(rows, bucket) per batch {[[(e - s, b) for s, e, b in sl] for sl in slices]}")
    t0 = time.perf_counter()
    model.transform(df)  # builds the module, moves the weights, warms the libraries
    log(f"[main] first request (module build + warm-up) {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    att.flash_attention_fwd.launches = 0
    seconds, out = [], None
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        out = model.transform(df)
        seconds.append(time.perf_counter() - t0)
    launches = att.flash_attention_fwd.launches
    want = cfg.n_layers * batches * N_REQUESTS
    log(f"[main] flash_fwd launches {launches} over {N_REQUESTS} requests of {batches} "
        f"batches (want 12 x {batches * N_REQUESTS} = {want})")
    if launches != want:
        raise AssertionError(f"flash_fwd launched {launches} times, want {want}")

    enc = model._tok(list(df.partitions[0]["text"][:32]), max_len=128)
    ms_batch = cuda_ms(lambda: model._score(enc["input_ids"], enc["attention_mask"]),
                       warmup=3, iters=20)
    rows_s = N_TEXTS / statistics.median(seconds)
    log(f"[main] transform {N_TEXTS} rows x {N_PARTS} partitions: median "
        f"{statistics.median(seconds) * 1e3:.1f} ms/request ({rows_s:.1f} rows/s), "
        f"{ms_batch:.3f} ms per batch of 32 x 128 tokens, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    flash_scores = np.stack(list(out.collect_column("scores")))
    if flash_scores.shape != (N_TEXTS, 2) or not np.isfinite(flash_scores).all():
        raise AssertionError(f"scores not finite of shape ({N_TEXTS}, 2)")

    model.set(attn_impl="einsum")
    before = att.flash_attention_fwd.launches
    einsum_scores = np.stack(list(model.transform(df).collect_column("scores")))
    if att.flash_attention_fwd.launches != before:
        raise AssertionError("the einsum path launched the flash kernel")
    diff = float(np.abs(flash_scores - einsum_scores).max())
    agree = float(np.mean(flash_scores.argmax(-1) == einsum_scores.argmax(-1)))
    log(f"[main] flash vs einsum on the card: max|dprob| {diff:.3e} (tol 3e-2), "
        f"predictions agree on {agree:.4f} of rows (want >= 0.99)")
    if not (diff <= 3e-2 and agree >= 0.99):
        raise AssertionError("flash and einsum scores disagree")

    # a small input through the CPU path (the kernel's plain version, CPU
    # matmuls), the one the CPU tests hold to the JAX package
    small = DataFrame.from_rows([{"text": t} for t in df.partitions[0]["text"][:8]])
    cpu_scores = np.stack(list(model.copy({"device": "cpu", "attn_impl": "flash"})
                               .transform(small).collect_column("scores")))
    cpu_diff = float(np.abs(cpu_scores - flash_scores[:8]).max())
    log(f"[main] card (flash kernel) vs CPU (plain version) on 8 rows: max|dprob| "
        f"{cpu_diff:.3e} (tol 3e-2)")
    if not cpu_diff <= 3e-2:
        raise AssertionError("the card's scores disagree with the CPU path's")

    model.set(attn_impl="flash")
    _profile_batch(model, enc)
    return {"launches": launches, "rows_s": rows_s, "ms_batch": ms_batch}


_KERNEL_GROUPS = (("flash_fwd kernel", ("flash_fwd",)),  # matched in lower case
                  ("matmul", ("nvjet", "gemm", "cutlass", "sm90_")),
                  ("layer norm", ("layer_norm",)),
                  ("dtype casts and copies", ("copy", "memcpy")),
                  ("gelu", ("gelu",)))


def _profile_batch(model, enc, n=5) -> None:
    """Where the device time of one BERT-base batch goes: device kernels by
    group, the top kernels, and the share of the wall time the card is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model._score(enc["input_ids"], enc["attention_mask"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            model._score(enc["input_ids"], enc["attention_mask"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [(e.self_device_time_total / n / 1e3, e.count // n, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(k[0] for k in kernels)
    if not busy:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] one batch of 32 x 128: {wall_ms:.3f} ms wall, {busy:.3f} ms of device "
        f"kernels ({100 * busy / wall_ms:.1f}% busy, {100 - 100 * busy / wall_ms:.1f}% idle)")
    groups = {name: 0.0 for name, _ in _KERNEL_GROUPS}
    groups["other"] = 0.0
    for ms, _, key in kernels:
        name = next((g for g, pats in _KERNEL_GROUPS if any(p in key.lower() for p in pats)),
                    "other")
        groups[name] += ms
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] group {name}: {ms:.4f} ms/batch ({100 * ms / busy:.1f}% of device time)")
    for ms, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"[profile] {100 * ms / busy:5.1f}%  {ms:8.4f} ms/batch  {count:4d}/batch  {key[:90]}")


def phase_times(device, card: str, launches: int, max_err: float) -> list[dict]:
    BH = B * H
    dtype = torch.bfloat16
    q, k, v = _inputs(BH, T, T, D, dtype, device, seed=0)
    mask = _padding_mask(BH, T, device, seed=0)
    scale = 1.0 / D ** 0.5
    ms = cuda_ms(lambda: att.flash_attention_fwd(q, k, v, mask, False, scale))
    plain_ms = cuda_ms(lambda: att.flash_attention_fwd_plain(q, k, v, mask, False, scale))
    q4, k4, v4 = (x.view(B, H, T, D) for x in (q, k, v))
    bool_mask = mask.view(B, H, 1, T).bool()
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bool_mask))
    elt = torch.finfo(dtype).bits // 8
    n_bytes = 4 * BH * T * D * elt + 2 * BH * T * 4  # q, k, v, out; mask, lse
    flops = 2 * 2 * BH * T * T * D                   # QK^T and PV, every tile
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    log(f"[times] flash_fwd bf16 [B*H={BH}, T={T}, D={D}]: kernel {ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
        f"plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms | {card}")
    return [{"name": "flash_fwd", "route": "cuda", "source": "synapseml_torch/csrc/flash_fwd.cu",
             "replaces": "synapseml_tpu/ops/attention.py:63", "launches": launches,
             "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms}]


def main() -> None:
    card, device = phase_device()
    phase_build()
    max_err = phase_kernels(device)
    main_path = phase_main_path(device, card)
    kernels = phase_times(device, card, main_path["launches"], max_err)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
