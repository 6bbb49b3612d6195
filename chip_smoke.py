"""Chip check of the PyTorch/CUDA port (synapseml_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card (an H100;
the kernels are built for sm_90a). Phases, each of which raises on failure:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for matmuls and convolutions;
2. build: compiles every kernel source under synapseml_torch/csrc/ with
   nvcc, one process each, all at once, keeps each kernel's registers and
   spills, and requires in the SASS of the backward at every head dim
   HGMMA (wgmma) in the bf16 kernel (flash_bwd_bf16.cu), HMMA on TF32
   operands (and fewer FFMA than HMMA) in the f32 kernel (flash_bwd_f32.cu),
   and no other kernel in either library;
3. kernels: holds each kernel against its plain PyTorch version on the
   card: flash attention (the bf16 tensor-core kernel and the f32 one in
   split TF32) at BERT-base shapes, with a padding mask, causal and not,
   unaligned T and D, T=200 at D=128, fully masked rows exactly 0, a second
   launch bitwise equal to the first, and from strided [B, T, H, D]
   projection views (BERT-base, and T=50 D=32); one flash_attention call
   from the views runs at most 2 device kernels (the mask cast and the
   kernel); the flash backward (bf16 on wgmma, f32 on mma.sync in split
   TF32) against its plain version, each (batch, head) slice of dq, dk and
   dv to its own scale, at BERT-base training shapes and at T=512, B=8,
   causal and not, T=50 at D=32, T=200 at D=128, T=300 at D=32 and T=1100
   (dQ summed over 3 and 9 kv tiles), in both dtypes, with fully masked
   rows (dq, dk, dv exactly 0) and padded keys (dk, dv exactly 0), a
   second launch bitwise equal; one call in each dtype at BERT-base and at
   T=512 captured in a CUDA graph and replayed twice, bitwise the eager
   call, the capture counted as one launch; autograd through
   flash_attention against
   reference_attention in f32 (D=40 through the zero pad too), and from
   projection views against the plain forward and backward on copies;
   and the GBDT histogram kernel, each case bitwise equal to its plain
   version and to a second launch: the Higgs shape at widths 1, 4 and 32,
   64 / 1024 / 300 bins, uint8 and int32 bins, rows outside the level, N
   not tile-aligned, width 128 (more segments than a block's tile), 40
   features, 10000 bins (a node split over tiles), N = 1 and N = 0, a feature whose rows all fall in one bin, the final totals
   (every row in one node too), the per-tree scale and scratch passed in
   against the scale computed inside, and one level launch running at most
   2 device operations; the per-tree scale pass equal to its plain
   version; segment_histogram against a float64 segment sum;
4. main path 1: DeepTextModel scoring with BERT-base (random weights from
   a seed) through attn_impl='flash': the bf16 kernel must launch 12 times
   per batch, every score must be finite and the scores must agree with
   the einsum path on the card and, on a small input, with the CPU path
   (the kernel's plain version) that the CPU tests hold to the JAX package;
   one request in f32 compute goes through the f32 kernel (12 launches per
   batch) and must agree with the f32 einsum path; then a profile of one
   batch by kernel group, in bf16 and in f32 compute;
5. main path 2: LightGBMClassifier(histogram_impl='pallas') fit on the
   Higgs-1M shape (1e6 x 28, 100 iterations, 31 leaves, 255 bins) through
   a DataFrame: the histogram kernel must launch once per level and once
   per tree for the final level's totals, its scale pass once per tree;
   the forest's sha256 digest is printed; a second fit must give a
   bitwise-identical forest, transform scores 100,000 held-out rows (AUC);
   the 'segment' backend must grow the same first tree within 2e-3 AUC,
   and a small fit on the CPU (the kernel's plain version) the same splits
   as on the card; then a profile of one boosting iteration;
6. main path 3: DeepTextClassifier fine-tuning BERT-base (hidden 768, 12
   layers, 12 heads, MLP 3072; f32 params, bf16 compute) on 960 texts that
   fill 128 tokens, batch 32, 48 optimizer steps, with einsum attention and
   then with attn_impl='flash' (the same data and seed; first, reported,
   whether _foreach_div and _foreach_mul with a 0-d tensor scalar, as the
   optimizer takes its per-step scalars, equal their Python-float forms
   bitwise), each three times:
   the stage's own fit, which runs chunks of 8 steps as CUDA graphs
   (Trainer.train_steps_scan: an eager warm-up chunk, one capture, four
   replays), then twice the eager per-step loop (the stage's trainer, data
   and init through fit_arrays with scan_chunk=1). Every step's loss
   finite, every parameter moved, one capture a fit; each leaf of the
   graph fit bitwise the eager fit's except where the two eager fits
   already differ (there within 1e-6); the flash fits launch the forward and
   backward kernels 12 times a step each, replayed steps included, and a
   profiled replay names each 96 times; flash's first loss and gradient
   norm are within 1e-2 of einsum's; each graph-fitted model's transform
   through attn_impl='flash' (the bf16 kernel 12 times a batch) against
   attn_impl='einsum' within main path 1's tolerances; a save -> load round
   trip bitwise; for graph and eager, samples/s, the median step in device
   time (a chunk's ms / 8 for the graphs), peak memory, MFU and the busy
   share of a profiled chunk or step, and a profile by kernel group;
   then bert-tiny in f32 compute (TF32 off), einsum and flash, 6 steps on
   the CPU and on the card from the same init and data, per step and as
   two graph chunks of 3, losses within 1e-4 of the CPU's and the graph
   run bitwise the eager one as above;
7. long-T step: BERT-base, batch 8 x 512 random ids (the second shape of
   benchmarks/attn_backends.py), 8 steps with einsum and with flash from
   one init: the median step in device time and the peak memory of each,
   each layer's gradient at the init within 2e-2 of einsum's, step 1's
   loss and gradient norm within 1e-2; then 4 flash steps in f32 compute
   (TF32 off) from the same init through the f32 kernels, its median step,
   peak memory and the flash backward's share of one profiled step, step
   1's loss within 1e-2 of the bf16 flash run's;
8. main path 4: ONNXModel(device='cuda') scoring 520 random 3 x 224 x 224
   images (3 partitions of 216, 176 and 128 rows, mini_batch_size 64: full
   rungs, and partial chunks padded to rungs of 32 and 64) with a
   torchvision-layout ResNet-50 (full width and depth, weights and
   BatchNorm statistics from seed 0) exported by torch.onnx.export
   (TorchScript, under an onnx stand-in backed by the port's codec), with
   softmax and argmax columns: logits within 1e-5 of the torch module on
   the card in f32, argmax equal wherever the top two logits differ by
   more than 1e-3, 4 images through the port on the CPU within 1e-4 of the
   card, a second transform bitwise the first, CompiledCache misses equal
   to the rungs used and none on the second transform, no kernel of the
   port's launched, and the graph sliced at its Flatten output giving the
   2048-wide features of the module's avgpool within 1e-5; a control
   batch with TF32 allowed must exceed both limits; then images/s,
   device ms a batch of 64 beside the torch module's, the input copy, peak
   memory, and a profile of one batch by group; and ImageFeaturizer on
   that export cut at its Flatten output, over raw images of varied sizes,
   against the module's avgpool features of the same preprocessing within
   1e-5 (part of main path 5);
9. main path 5, vision: (a) ViT-B/16 fine-tuning at full width and depth
   (batch 64 at 224 x 224, 197 tokens, 1000 classes, weights from seed 0,
   TrainerConfig(learning_rate=1e-4, total_steps=1000) as
   benchmarks/vit_finetune.py), with attn_impl='flash' and then einsum,
   each as two chunks of 16 steps through Trainer.train_steps_scan (an
   eager warm-up, then a capture and its replay) and twice as the eager
   per-step loop: the graph run bitwise the eager one leaf by leaf but
   where two eager runs differ, the flash kernels 12 times a step forward
   and backward, replayed steps included, step 1's loss and gradient norm
   flash against einsum within 3e-2; the median step in device time (a
   replay of the 16-step graph), samples/s, MFU, peak memory, the busy
   share of a profiled replay and its device time by group; (b) the flash
   forward and backward at the ViT-B/16 shape (B*H = 768, T = 197, D = 64,
   no mask), bf16 and f32, against their plain versions under the limits
   of phase 3 and bitwise on a second launch, then in device time beside
   scaled_dot_product_attention, the plain version and the bound; (c)
   DeepVisionClassifier(backbone='vit_b16') and (backbone='resnet50', the
   BatchNorm path) fitting 16 steps at batch 32 as the stage's graph fit,
   the ResNet also twice eagerly (parameters and running statistics
   bitwise but where the two eager fits differ), each fitted model
   scoring 256 images twice (bitwise, one CompiledCache callable a
   bucket) and 4 in f32 compute on the card and on the CPU within 1e-4;
10. times: each kernel beside its bound, its plain version and the one
   PyTorch call that computes the same function (device time, with the
   host's enqueue hidden behind a spin kernel; the library call's device
   kernels named from the profiler); flash_attention from the projection
   views beside the permute-and-call path it replaced; the histogram
   kernel at each shape of one tree and its scale pass, and one call of
   each with its host enqueue; the flash backward at both training shapes
   beside the backward of scaled_dot_product_attention, with its device
   kernels by name and count and both kernels' registers and spills.

The line before the last is a JSON object with the kernels' numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.machinery
import importlib.util
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from synapseml_torch import DataFrame
from synapseml_torch.core import batching as cb
from synapseml_torch.image import ImageTransformer
from synapseml_torch.models.convert_jax import (bert_state_dict_from_flax, init_flax_bert_params,
                                                init_flax_vit_params, vit_state_dict_from_flax)
from synapseml_torch.models.nets.bert import bert_base
from synapseml_torch.models.nets.resnet import resnet50
from synapseml_torch.models.nets.vit import ViTClassifier, vit_b16
from synapseml_torch.models import text as text_stage
from synapseml_torch.models import trainer as trainer_mod
from synapseml_torch.models import vision as vision_stage
from synapseml_torch.models.text import DeepTextClassifier, DeepTextModel
from synapseml_torch.models.tokenizer import HashingTokenizer
from synapseml_torch.models.vision import DeepVisionClassifier
from synapseml_torch.onnx import ImageFeaturizer, ONNXModel
from synapseml_torch.onnx.featurizer import IMAGENET_MEANS, IMAGENET_STDS
from synapseml_torch.onnx import proto as onnx_proto
from synapseml_torch.ops import _build
from synapseml_torch.ops import attention as att

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
# The card's fastest route at each type's accuracy, dense tensor cores:
# bf16 products at 989 TFLOP/s; f32 as three TF32 products (split TF32,
# as the f32 kernel computes) at 495 TFLOP/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
MMA_PASSES = {torch.bfloat16: 1, torch.float32: 3}
TOL_OUT = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
TOL_LSE = 1e-4
KERNEL_NAMES = att._KERNEL_NAMES  # dtype -> key of flash_attention_fwd.launches

# BERT-base scoring: batch 32, 12 heads, 128 tokens, head dim 64
B, H, T, D = 32, 12, 128, 64
N_TEXTS, N_PARTS, N_REQUESTS = 200, 3, 3


def log(*parts):
    print(*parts, flush=True)


def cuda_ms(fn, warmup=5, iters=30, spin_cycles=0) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs, by CUDA events.

    With ``spin_cycles``, each run is queued behind a spin kernel of that
    many clock cycles, long enough for the host to enqueue all of ``fn``:
    the events then time the device work alone, without the host's Python
    and launch overhead (which they include otherwise, the device being
    idle when ``fn`` is called)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


SPIN = 10_000_000  # clock cycles, about 5 ms: longer than any timed call's enqueue


def device_ms(fn, warmup=5, iters=30) -> float:
    return cuda_ms(fn, warmup, iters, spin_cycles=SPIN)


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


PTXAS: dict[str, dict] = {}  # kernel (mangled name) -> registers and spill bytes, from the build


def phase_build():
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} of {len(_build.sources())} kernel source(s) compiled in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    spills = []
    for name, out in logs.items():
        fn = "?"
        for line in out.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                fn = entry.group(1)
            elif "registers" in line or "spill" in line:
                log(f"[build] {name} {fn}: {line.strip()}")
                found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                regs = re.search(r"Used (\d+) registers", line)
                if found:
                    PTXAS.setdefault(fn, {})["spill_bytes"] = tuple(map(int, found.groups()))
                    if "flash_" in fn and found.groups() != ("0", "0"):
                        spills.append(fn)
                if regs:
                    PTXAS.setdefault(fn, {})["registers"] = int(regs.group(1))
    log(f"[build] flash kernels with register spills: {spills or 'none'}")
    _check_sass()


def _check_sass() -> None:
    """The backward kernels' SASS (cuobjdump of each built library) at every
    head dim: HGMMA, the warpgroup tensor-core instruction, in the bf16
    kernel; HMMA on TF32 operands in the f32 kernel, with fewer FFMA than
    HMMA (a product loop on the CUDA cores would outnumber them); and no
    other kernel in either library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for dtype, name in att._BWD_SOURCES.items():
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        fn = None
        for line in sass.splitlines():
            head = re.search(r"Function : (\S+)", line)
            if head:
                fn = (name, head.group(1))
                counts[fn] = {"HGMMA": 0, "HMMA.TF32": 0, "FFMA": 0}
            elif fn:
                op = re.search(r"\b(HGMMA|HMMA|FFMA)\S*", line)
                if op and (op.group(1) != "HMMA" or "TF32" in op.group(0)):
                    counts[fn]["HMMA.TF32" if op.group(1) == "HMMA" else op.group(1)] += 1
    bf16 = {f: c["HGMMA"] for (lib, f), c in counts.items()
            if lib == "flash_bwd_bf16" and "flash_bwd_wgmma_kernel" in f}
    f32 = {f: c for (lib, f), c in counts.items()
           if lib == "flash_bwd_f32" and "flash_bwd_tf32_kernel" in f}
    others = [f"{lib}: {f}" for lib, f in counts if f not in bf16 and f not in f32]
    log(f"[build] HGMMA instructions in the SASS of flash_bwd_wgmma_kernel: {bf16}")
    log(f"[build] HMMA (TF32) and FFMA instructions in the SASS of flash_bwd_tf32_kernel: "
        f"{ {f: (c['HMMA.TF32'], c['FFMA']) for f, c in f32.items()} }; other kernels: "
        f"{others or 'none'}")
    if not (len(bf16) == len(att.HEAD_DIMS) and all(bf16.values())):
        raise AssertionError("flash_bwd_wgmma_kernel's SASS has no HGMMA at some head dim")
    if not (len(f32) == len(att.HEAD_DIMS) and not others
            and all(c["FFMA"] < c["HMMA.TF32"] for c in f32.values())):
        raise AssertionError("flash_bwd_tf32_kernel is not on the tensor cores at every head "
                             "dim, or another kernel is in flash_bwd_bf16 or flash_bwd_f32")


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


def _to_bh(x):
    """[B, T, H, D] -> a contiguous [B*H, T, D] copy."""
    B_, T_, H_, D_ = x.shape
    return x.permute(0, 2, 1, 3).reshape(B_ * H_, T_, D_).contiguous()


def _projection_views(Bv, Tv, Hv, Dv, dtype, device, seed):
    """q, k, v as the model cuts them: [B, T, H, D] views of one
    [B, T, 3*H*D] projection (none of them contiguous)."""
    g = torch.Generator(device=device).manual_seed(seed)
    proj = torch.randn((Bv, Tv, 3 * Hv * Dv), generator=g, device=device).to(dtype)
    return [x.unflatten(-1, (Hv, Dv)) for x in proj.split(Hv * Dv, dim=-1)]


def _check_views(name, Bv, Tv, Hv, Dv, dtype, device, seed, causal) -> None:
    """flash_attention on projection views against the plain version on
    [B*H, T, D] copies, and against a second launch (bitwise)."""
    q, k, v = _projection_views(Bv, Tv, Hv, Dv, dtype, device, seed)
    mask = _padding_mask(Bv, Tv, device, seed)
    out = att.flash_attention(q, k, v, mask.bool(), causal=causal)
    again = att.flash_attention(q, k, v, mask.bool(), causal=causal)
    torch.cuda.synchronize()
    ref, _ = att._plain_bthd(att.flash_attention_fwd_plain, q, k, v, mask, causal,
                             1.0 / Dv ** 0.5)
    err = (out.float() - ref.float()).abs().max().item()
    same = torch.equal(out, again)
    log(f"[kernel] flash_attention {name} from [B,T,H,D]=[{Bv},{Tv},{Hv},{Dv}] projection "
        f"views: max|dout| {err:.3e} (tol {TOL_OUT[dtype]:g}), two launches bitwise equal: "
        f"{same}")
    if not (err <= TOL_OUT[dtype] and same and out.is_contiguous()):
        raise AssertionError(f"flash_attention from views disagrees on {name}")


PROFILE_TRIES = 3  # profiler sessions for a measurement that recorded nothing


def _device_kernels(fn, n=3) -> list[tuple[str, int, float, int, float]]:
    """(name, count per call, device ms per call, launches recorded, ms
    recorded over ``n``) of the device kernels a call of ``fn`` runs, from
    the profiler over ``n`` calls after a warm-up call. Late in a long
    process a session can miss some of the calls' kernels, so a kernel's
    count a call is its recorded launches over ``n`` rounded up (each call
    is taken to launch it a whole number of times) and its time a call is
    its mean over the launches recorded times that count; the last two
    fields are what was recorded, to check that against. A session that
    recorded no device kernel at all measured nothing: it is taken again,
    up to PROFILE_TRIES sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = [(e.key, -(-e.count // n),
                e.self_device_time_total / e.count * -(-e.count // n) / 1e3,
                e.count, e.self_device_time_total / n / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if out:
            return out
        log(f"[profile] session {attempt + 1} recorded no device kernel; profiling again")
    return []


def _count_view_call_kernels(device) -> None:
    """Device kernels of one flash_attention call on BERT-base projection
    views with a bool padding mask: at most the mask cast and the kernel."""
    q, k, v = _projection_views(B, T, H, D, torch.bfloat16, device, seed=11)
    mask = _padding_mask(B, T, device, seed=11).bool()
    kernels = _device_kernels(lambda: att.flash_attention(q, k, v, mask))
    n = sum(c for _, c, *_ in kernels)
    log(f"[kernel] one flash_attention call on BERT-base projection views: {n} device "
        f"kernel(s) {[key[:60] for key, *_ in kernels]} (want at most 2)")
    if not (n <= 2 and any("flash_fwd" in key for key, *_ in kernels)):
        raise AssertionError("flash_attention from views ran more than the mask cast and "
                             "the kernel")


def phase_kernels(device) -> dict:
    """Kernel against its plain version on the same inputs; returns the max
    |out difference| at the main path's shape (BERT-base) by kernel."""
    cases = [  # name, BH, Tq, Tk, Dp, true D, dtype, causal, empty mask rows
        ("bert-base bf16", B * H, T, T, D, D, torch.bfloat16, False, 0),
        ("bert-base f32", B * H, T, T, D, D, torch.float32, False, 0),
        ("bert-base bf16 causal", B * H, T, T, D, D, torch.bfloat16, True, 0),
        ("bert-base f32 causal", B * H, T, T, D, D, torch.float32, True, 0),
        ("unaligned T=50 D=24 f32 causal", 24, 50, 50, 32, 24, torch.float32, True, 0),
        ("unaligned T=50 D=24 bf16", 24, 50, 50, 32, 24, torch.bfloat16, False, 0),
        ("T=200 D=128 bf16 causal", 16, 200, 200, 128, 128, torch.bfloat16, True, 0),
        ("T=200 D=128 f32 causal", 16, 200, 200, 128, 128, torch.float32, True, 0),
        ("fully masked rows f32", 48, T, T, D, D, torch.float32, False, 8),
        ("fully masked rows bf16", 48, T, T, D, D, torch.bfloat16, True, 8),
    ]
    main_err = {}
    for i, (name, BH, Tq, Tk, Dp, true_d, dtype, causal, empty) in enumerate(cases):
        q, k, v = _inputs(BH, Tq, Tk, Dp, dtype, device, seed=i, true_d=true_d)
        mask = _padding_mask(BH, Tk, device, seed=i, empty_rows=empty)
        scale = 1.0 / true_d ** 0.5
        out, lse = att.flash_attention_fwd(q, k, v, mask, causal, scale)
        out2, lse2 = att.flash_attention_fwd(q, k, v, mask, causal, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = att.flash_attention_fwd_plain(q, k, v, mask, causal, scale)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        same = torch.equal(out, out2) and torch.equal(lse, lse2)
        log(f"[kernel] flash_fwd {name}: max|dout| {err_out:.3e} (tol {TOL_OUT[dtype]:g}), "
            f"max|dlse| {err_lse:.3e} (tol {TOL_LSE:g}), two launches bitwise equal: {same}")
        if not (err_out <= TOL_OUT[dtype] and err_lse <= TOL_LSE):
            raise AssertionError(f"flash_fwd disagrees with its plain version on {name}")
        if not same:
            raise AssertionError(f"flash_fwd is not deterministic on {name}")
        if not bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"flash_fwd gave non-finite values on {name}")
        if empty and out[:empty].abs().max().item() != 0.0:
            raise AssertionError(f"fully masked rows are not exactly 0 on {name}")
        if i < 2:  # BERT-base, bf16 then f32
            main_err[KERNEL_NAMES[dtype]] = err_out

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

    for dtype in (torch.bfloat16, torch.float32):
        tag = KERNEL_NAMES[dtype]
        _check_views(f"bert-base {tag}", B, T, H, D, dtype, device, seed=21, causal=False)
        _check_views(f"ragged {tag} causal", 4, 50, 6, 32, dtype, device, seed=22, causal=True)
    _count_view_call_kernels(device)
    main_err.update(_bwd_kernel_cases(device))
    return main_err


# ---------------- the backward kernel against its plain version ----------------

# _bwd_err's limits. bf16 outputs round at 2^-9, and dS rounds to bf16
# before two of the products (a P that differs in its last f32 bit can round
# dS the other way); f32 sums in another order than the plain version, and
# the dq and dk of a length-1 row are 0 in exact arithmetic (dS = dP - delta
# cancels), so they hold rounding only and meet the floor.
# tests/test_torch_flash_bwd.py holds the limits: the plain version summed in
# another order passes within half of each, and one that drops delta, or
# whose dq, dk or dv is 5 % off, fails
TOL_BWD = {torch.float32: 1e-4, torch.bfloat16: 1.5e-2}
BWD_FLOOR = 1e-2  # of a tensor's max |plain|: the least scale a slice is held to
LONG_B, LONG_T = 8, 512  # the long-T training shape of benchmarks/attn_backends.py:27
# |g_flash - g_einsum| over |g_einsum| for each layer's gradient at the init
# (the embeddings, each encoder layer, the head), BERT-base bf16 compute
TOL_INIT_GRAD = 2e-2


def _bwd_err(got, want) -> float:
    """The worst, over the pairs of [B*H, T, D] gradients and over their
    B*H slices, of max |got - want| in a slice over max |want| in it (at
    least BWD_FLOOR of the tensor's max |want|). Each slice is held to its
    own scale: with random padding lengths the dv of a length-1 row is some
    100 times the typical entry, and a limit on the whole tensor's scale
    would pass errors of 10 % elsewhere."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float().flatten(1), b.float().flatten(1)
        scale = b.abs().amax(dim=1)
        floor = max(BWD_FLOOR * scale.max().item(), 1e-30)
        worst = max(worst, ((a - b).abs().amax(dim=1) / scale.clamp_min(floor)).max().item())
    return worst


def _bwd_case(name, q, k, v, mask, causal, scale, empty, seed) -> float:
    """flash_attention_bwd (the kernel) on [BH, T, D] against
    flash_attention_bwd_plain on the same inputs (the kernel forward's out
    and LSE, a random dout), a second launch bitwise, finite values, and
    exact zeros for the ``empty`` fully masked rows and for padded keys.
    Returns the max |difference|."""
    out, lse = att.flash_attention_fwd(q, k, v, mask, causal, scale)
    g = torch.Generator(device=q.device).manual_seed(seed)
    dout = torch.randn(out.shape, generator=g, device=q.device).to(q.dtype)
    got = att.flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, scale)
    again = att.flash_attention_bwd(q, k, v, mask, out, lse, dout, causal, scale)
    torch.cuda.synchronize()
    want = att.flash_attention_bwd_plain(q, k, v, mask, out, lse, dout, causal, scale)
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
    rel = _bwd_err(got, want)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(x.float()).all()) for x in got)
    padded = (mask == 0)[..., None]
    zeros = (all(x[:empty].abs().max().item() == 0.0 for x in got) if empty else True) and all(
        x.float().abs().masked_fill(~padded, 0).max().item() == 0.0 for x in got[1:])
    log(f"[kernel] flash_bwd {name}: max|d(dq,dk,dv)| {err:.3e}; worst slice's over its "
        f"max|plain| {rel:.3e} "
        f"(tol {TOL_BWD[q.dtype]:g}), two launches bitwise equal: {same}, finite: {finite}, "
        f"fully masked rows ({empty}) and padded keys exactly 0: {zeros}")
    if not (rel <= TOL_BWD[q.dtype] and same and finite and zeros):
        raise AssertionError(f"flash_bwd disagrees with its plain version on {name}")
    return err


def _check_grads(name, q, k, v, kv_mask, causal, want_fn, tol) -> None:
    """Gradients of sum(out * dout) through flash_attention (the kernels)
    against those through ``want_fn`` on the same leaves."""
    g = torch.Generator(device=q.device).manual_seed(5)
    dout = torch.randn(q.shape[:3] + v.shape[-1:], generator=g, device=q.device).to(q.dtype)
    grads = []
    for fn in (att.flash_attention, want_fn):
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves, kv_mask, causal=causal).backward(dout)
        grads.append([_to_bh(x.grad) for x in leaves])
    torch.cuda.synchronize()
    rel = _bwd_err(*grads)
    log(f"[kernel] flash_attention {name}: autograd through the kernels vs "
        f"{getattr(want_fn, '__name__', 'plain')}: worst [b, h] slice's max|d grad| over its "
        f"max|grad| {rel:.3e} "
        f"(tol {tol:g})")
    if not rel <= tol:
        raise AssertionError(f"flash_attention gradients disagree on {name}")


def _plain_on_copies(q, k, v, kv_mask, causal: bool = False):
    """flash_attention through the plain forward and backward on [B*H, T, D]
    copies, with the plain backward as its gradient: the oracle for the
    gradients from projection views."""
    scale = 1.0 / q.shape[-1] ** 0.5
    mask = kv_mask.to(torch.int32)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            out, lse = att._plain_bthd(att.flash_attention_fwd_plain, q, k, v, mask, causal,
                                       scale)
            ctx.save_for_backward(q, k, v, out, lse)
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            return att._plain_bthd(att.flash_attention_bwd_plain, q, k, v, mask, out, lse, dout,
                                   causal, scale)

    return Plain.apply(q, k, v)


def _check_graph_capture(BH, Tc, dtype, device) -> None:
    """One flash_attention_bwd call captured in a CUDA graph (as a captured
    training step will hold it) and replayed twice: each replay bitwise the
    eager call's gradients, and the capture counted as one launch (a replay
    runs the kernels without the wrapper)."""
    tag = KERNEL_NAMES[dtype]
    scale = 1.0 / D ** 0.5
    q, k, v = _inputs(BH, Tc, Tc, D, dtype, device, seed=130)
    mask = _padding_mask(BH, Tc, device, seed=130)
    out, lse = att.flash_attention_fwd(q, k, v, mask, False, scale)
    g = torch.Generator(device=device).manual_seed(131)
    dout = torch.randn(out.shape, generator=g, device=device).to(dtype)
    args = (q, k, v, mask, out, lse, dout, False, scale)
    eager = att.flash_attention_bwd(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a warm-up off the capturing stream, as torch advises
        att.flash_attention_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = att.flash_attention_bwd.launches[tag]
    with torch.cuda.graph(graph):
        captured = att.flash_attention_bwd(*args)
    counted = att.flash_attention_bwd.launches[tag] - before
    same = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same.append(all(torch.equal(a, b) for a, b in zip(captured, eager)))
    log(f"[kernel] flash_bwd {tag} [B*H={BH}, T={Tc}, D={D}] in a CUDA graph: two replays "
        f"bitwise the eager call: {same}, launches counted by the capture: {counted} (want 1)")
    if not (all(same) and counted == 1):
        raise AssertionError(f"the {tag} flash backward captured in a CUDA graph differs from "
                             "the eager call")
    del graph


def _check_broadcast_views(device) -> None:
    """Gradients through flash_attention with k and v of one head expanded
    over the heads and a dout broadcast over the batch (zero strides on
    dims longer than 1, which the bf16 backward copies before its tensor
    maps), against the plain forward and backward on copies, and bitwise
    on a second run."""
    Bc = 4
    for dtype in (torch.bfloat16, torch.float32):
        tag = KERNEL_NAMES[dtype]
        g = torch.Generator(device=device).manual_seed(140)
        q0 = torch.randn((Bc, T, H, D), generator=g, device=device).to(dtype)
        k0, v0 = (torch.randn((Bc, T, 1, D), generator=g, device=device).to(dtype)
                  for _ in range(2))
        dout = torch.randn((1, T, H, D), generator=g, device=device).to(dtype).expand(
            Bc, T, H, D)
        kv_mask = _padding_mask(Bc, T, device, seed=140).bool()
        runs = []
        for fn in (att.flash_attention, att.flash_attention, _plain_on_copies):
            leaves = [x.clone().requires_grad_() for x in (q0, k0, v0)]
            q, k, v = leaves[0], *(x.expand(Bc, T, H, D) for x in leaves[1:])
            fn(q, k, v, kv_mask, causal=False).backward(dout)
            runs.append([_to_bh(x.grad) for x in leaves])
        torch.cuda.synchronize()
        rel = _bwd_err(runs[0], runs[2])
        same = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
        log(f"[kernel] flash_attention {tag} [B,T,H,D]=[{Bc},{T},{H},{D}], k and v expanded "
            f"over heads, dout broadcast over the batch: gradients vs the plain forward and "
            f"backward on copies: worst slice's max|d| over its max|grad| {rel:.3e} "
            f"(tol {TOL_BWD[dtype]:g}), bitwise equal on a second run: {same}")
        if not (rel <= TOL_BWD[dtype] and same):
            raise AssertionError(f"the flash backward from broadcast views disagrees on {tag}")


def _bwd_kernel_cases(device) -> dict:
    """The backward kernel against its plain version on the card; returns
    the max |difference| at BERT-base training shapes by dtype."""
    cases = [  # name, BH, T, D, dtype, causal, fully masked rows
        ("bert-base bf16", B * H, T, D, torch.bfloat16, False, 8),
        ("bert-base f32", B * H, T, D, torch.float32, False, 8),
        ("bert-base bf16 causal", B * H, T, D, torch.bfloat16, True, 0),
        ("bert-base f32 causal", B * H, T, D, torch.float32, True, 0),
        ("T=512 bf16", LONG_B * H, LONG_T, D, torch.bfloat16, False, 4),
        ("T=512 f32", LONG_B * H, LONG_T, D, torch.float32, False, 4),
        ("T=512 bf16 causal", LONG_B * H, LONG_T, D, torch.bfloat16, True, 0),
        ("unaligned T=50 D=32 bf16 causal", 24, 50, 32, torch.bfloat16, True, 0),
        ("unaligned T=50 D=32 f32", 24, 50, 32, torch.float32, False, 2),
        ("T=200 D=128 bf16", 16, 200, 128, torch.bfloat16, False, 2),
        ("T=200 D=128 bf16 causal", 16, 200, 128, torch.bfloat16, True, 0),
        ("T=200 D=128 f32 causal", 16, 200, 128, torch.float32, True, 0),
        # dQ summed over three 128-row kv tiles at the narrowest head dim, and
        # over nine
        ("T=300 D=32 bf16", 24, 300, 32, torch.bfloat16, False, 2),
        ("T=1100 bf16 causal", 4, 1100, D, torch.bfloat16, True, 0),
        # and in f32 (128-row kv tiles; 64 at D = 128, so T=200 above sums four)
        ("T=300 D=32 f32", 24, 300, 32, torch.float32, False, 2),
        ("T=1100 f32 causal", 4, 1100, D, torch.float32, True, 0),
    ]
    main_err = {}
    for i, (name, BH, Tc, Dc, dtype, causal, empty) in enumerate(cases):
        q, k, v = _inputs(BH, Tc, Tc, Dc, dtype, device, seed=100 + i)
        mask = _padding_mask(BH, Tc, device, seed=100 + i, empty_rows=empty)
        err = _bwd_case(name, q, k, v, mask, causal, 1.0 / Dc ** 0.5, empty, seed=i)
        if i < 2:
            main_err[f"bwd_{KERNEL_NAMES[dtype]}"] = err
    for dtype in (torch.bfloat16, torch.float32):
        for Bc, Tc in ((B, T), (LONG_B, LONG_T)):
            _check_graph_capture(Bc * H, Tc, dtype, device)
    _check_broadcast_views(device)

    # the public face, f32, against autograd through reference_attention (no
    # fully masked row: there the two differ by design): BERT-base heads
    # with a padding mask, and D = 40 through the zero pad, causal
    g = torch.Generator(device=device).manual_seed(98)
    q, k, v = (torch.randn((4, T, H, D), generator=g, device=device) for _ in range(3))
    _check_grads("[B,T,H,D]=[4,128,12,64] f32", q, k, v, _padding_mask(4, T, device, 98).bool(),
                 False, att.reference_attention, TOL_BWD[torch.float32])
    q, k, v = (torch.randn((2, 50, 4, 40), generator=g, device=device) for _ in range(3))
    _check_grads("[B,T,H,D]=[2,50,4,40] f32 causal (D padded to 64)", q, k, v,
                 torch.rand((2, 50), generator=g, device=device) > 0.2, True,
                 att.reference_attention, TOL_BWD[torch.float32])
    # strided projection views: the gradient reaches the projection, against
    # the plain forward and backward on copies, and bitwise on a second run
    for dtype in (torch.bfloat16, torch.float32):
        tag = KERNEL_NAMES[dtype]
        proj0 = torch.cat(_projection_views(B, T, H, D, dtype, device, seed=23), dim=2)
        kv_mask = _padding_mask(B, T, device, seed=23).bool()
        runs = []
        for fn in (att.flash_attention, att.flash_attention, _plain_on_copies):
            proj = proj0.reshape(B, T, 3 * H * D).clone().requires_grad_()
            views = [x.unflatten(-1, (H, D)) for x in proj.split(H * D, dim=-1)]
            fn(*views, kv_mask, causal=False).float().square().sum().backward()
            runs.append(proj.grad)
        torch.cuda.synchronize()
        # the projection's gradient cut back into dq, dk and dv, [B*H, T, D]
        got, want = ([_to_bh(x) for x in g.unflatten(-1, (3, H, D)).unbind(2)]
                     for g in (runs[0], runs[2]))
        rel = _bwd_err(got, want)
        same = torch.equal(runs[0], runs[1])
        log(f"[kernel] flash_attention {tag} from BERT-base projection views: the "
            f"projection's gradient vs the plain forward and backward on copies: worst [b, h] "
            f"slice's max|d| over its max|grad| {rel:.3e} (tol {TOL_BWD[dtype]:g}), bitwise "
            f"equal on a second run: {same}")
        if not (rel <= TOL_BWD[dtype] and same):
            raise AssertionError(f"the flash backward from views disagrees on {tag}")
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

    # f32 compute: the same weights through the f32 kernel
    model32 = model.copy({"arch_config": dataclasses.replace(cfg, dtype=torch.float32)})
    model32.transform(df.limit(32))  # builds the module

    torch.cuda.reset_peak_memory_stats()
    att.flash_attention_fwd.launches = dict.fromkeys(att.flash_attention_fwd.launches, 0)
    seconds, out = [], None
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        out = model.transform(df)
        seconds.append(time.perf_counter() - t0)
    out32 = model32.transform(df)
    launches = dict(att.flash_attention_fwd.launches)
    want = {"bf16": cfg.n_layers * batches * N_REQUESTS, "f32": cfg.n_layers * batches}
    log(f"[main] flash_fwd launches {launches} over {N_REQUESTS} bf16 requests and one f32 "
        f"request of {batches} batches (want 12 per batch: {want})")
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
    before = dict(att.flash_attention_fwd.launches)
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

    f32_scores = np.stack(list(out32.collect_column("scores")))
    einsum32 = np.stack(list(model32.copy({"attn_impl": "einsum"}).transform(df)
                             .collect_column("scores")))
    diff32 = float(np.abs(f32_scores - einsum32).max())
    log(f"[main] f32 compute, flash (f32 kernel) vs einsum on the card: max|dprob| "
        f"{diff32:.3e} (tol 1e-3); vs the bf16 flash scores {np.abs(f32_scores - flash_scores).max():.3e}")
    if not (np.isfinite(f32_scores).all() and diff32 <= 1e-3):
        raise AssertionError("f32 flash and einsum scores disagree")

    model.set(attn_impl="flash")
    _profile_batch(model, enc, "bf16")
    _profile_batch(model32, enc, "f32")
    return {"launches": launches, "rows_s": rows_s, "ms_batch": ms_batch}


_KERNEL_GROUPS = (("flash_fwd kernel", ("flash_fwd",)),  # matched in lower case
                  ("matmul", ("nvjet", "gemm", "cutlass", "sm90_")),
                  ("layer norm", ("layer_norm",)),
                  ("dtype casts and copies", ("copy", "memcpy")),
                  ("gelu", ("gelu",)))


def _profile_batch(model, enc, tag: str, n=5) -> None:
    """Where the device time of one BERT-base batch in ``tag`` compute goes:
    device kernels by group, the top kernels, and the share of the wall time
    the card is busy."""
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
    log(f"[profile] one {tag} batch of 32 x 128: {wall_ms:.3f} ms wall, {busy:.3f} ms of "
        f"device kernels ({100 * busy / wall_ms:.1f}% busy, "
        f"{100 - 100 * busy / wall_ms:.1f}% idle)")
    groups = {name: 0.0 for name, _ in _KERNEL_GROUPS}
    groups["other"] = 0.0
    for ms, _, key in kernels:
        name = next((g for g, pats in _KERNEL_GROUPS if any(p in key.lower() for p in pats)),
                    "other")
        groups[name] += ms
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {tag} group {name}: {ms:.4f} ms/batch ({100 * ms / busy:.1f}% of "
            f"device time)")
    for ms, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"[profile] {tag} {100 * ms / busy:5.1f}%  {ms:8.4f} ms/batch  {count:4d}/batch  "
            f"{key[:90]}")


def phase_times(device, card: str, launches: dict, max_err: dict) -> list[dict]:
    """Each flash kernel at BERT-base shapes beside its bound, its plain
    version and scaled_dot_product_attention, in device time; then
    flash_attention from the projection views beside the permute-and-call
    path it replaced (rebuilt here as a yardstick; the port no longer has it)."""
    BH = B * H
    scale = 1.0 / D ** 0.5
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = KERNEL_NAMES[dtype]
        q, k, v = _inputs(BH, T, T, D, dtype, device, seed=0)
        mask = _padding_mask(BH, T, device, seed=0)
        q4, k4, v4 = (x.view(B, H, T, D) for x in (q, k, v))
        bool_mask = mask.view(B, H, 1, T).bool()
        kernel = lambda: att.flash_attention_fwd(q, k, v, mask, False, scale)  # noqa: E731
        plain = lambda: att.flash_attention_fwd_plain(q, k, v, mask, False, scale)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=bool_mask)  # noqa: E731
        # in turns, kernel and library twice, so a drift between them shows
        ms, library_ms, ms2, library_ms2 = (device_ms(f) for f in (kernel, sdpa, kernel, sdpa))
        plain_ms = device_ms(plain, warmup=2, iters=10)
        call_ms = cuda_ms(kernel)  # one call as the host sees it, enqueue included
        sdpa_kernels = [key[:80] for key, *_ in _device_kernels(sdpa)]
        elt = torch.finfo(dtype).bits // 8
        n_bytes = 4 * BH * T * D * elt + 2 * BH * T * 4  # q, k, v, out; mask, lse
        flops = 2 * 2 * BH * T * T * D                   # QK^T and PV, every tile
        passes = MMA_PASSES[dtype]
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = passes * flops / PEAK_FLOPS[dtype] * 1e3
        bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        log(f"[times] flash_fwd {tag} [B*H={BH}, T={T}, D={D}]: kernel {ms:.4f} / {ms2:.4f} ms "
            f"(device time, two turns; one call with its host enqueue {call_ms:.4f} ms), bound "
            f"{bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB = {t_bytes:.4f} ms; "
            f"{passes} x {flops / 1e9:.2f} GFLOP at {PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s = "
            f"{t_ops:.4f} ms), plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{library_ms:.4f} / {library_ms2:.4f} ms, its device kernels {sdpa_kernels} | {card}")
        rows.append({"name": f"flash_fwd_{tag}", "route": "cuda",
                     "source": "synapseml_torch/csrc/flash_fwd.cu",
                     "replaces": "synapseml_tpu/ops/attention.py:63",
                     "launches": launches[tag], "max_abs_err": max_err[tag],
                     "ms": statistics.median([ms, ms2]), "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": statistics.median([library_ms, library_ms2])})

    q, k, v = _projection_views(B, T, H, D, torch.bfloat16, device, seed=0)
    bool_kv = _padding_mask(B, T, device, seed=0).bool()

    def from_views():
        return att.flash_attention(q, k, v, bool_kv).reshape(B, T, H * D)

    def permute_and_call():  # how flash_attention called the kernel before: a yardstick
        m = bool_kv.to(torch.int32)[:, None, :].expand(B, H, T).reshape(B * H, T).contiguous()
        out, _ = att.flash_attention_fwd(_to_bh(q), _to_bh(k), _to_bh(v), m, False, scale)
        return out.reshape(B, H, T, D).permute(0, 2, 1, 3).reshape(B, T, H * D)

    if not torch.equal(from_views(), permute_and_call()):
        raise AssertionError("flash_attention from views differs from the permute-and-call path")
    t = [device_ms(f) for f in (permute_and_call, from_views, from_views, permute_and_call)]
    log(f"[times] flash_attention bf16 at BERT-base from projection views: "
        f"{t[1]:.4f} / {t[2]:.4f} ms; the permute-and-call path it replaced: {t[0]:.4f} / "
        f"{t[3]:.4f} ms (device time, in turns) | {card}")
    return rows + _bwd_times(device, card, launches, max_err)


def _bwd_times(device, card: str, launches: dict, max_err: dict) -> list[dict]:
    """The backward kernel at the BERT-base training shape and at T = 512,
    B = 8 (benchmarks/attn_backends.py:27), in both dtypes, beside its bound,
    its plain version and the backward of scaled_dot_product_attention with
    the same mask (its device kernels named and summed from the profiler),
    all in device time. The JSON rows are the BERT-base shape's."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        tag = KERNEL_NAMES[dtype]
        for i, (Bt, Tt) in enumerate(((B, T), (LONG_B, LONG_T))):
            BH = Bt * H
            scale = 1.0 / D ** 0.5
            q, k, v = _inputs(BH, Tt, Tt, D, dtype, device, seed=7)
            mask = _padding_mask(BH, Tt, device, seed=7)
            out, lse = att.flash_attention_fwd(q, k, v, mask, False, scale)
            g = torch.Generator(device=device).manual_seed(8)
            dout = torch.randn(out.shape, generator=g, device=device).to(dtype)
            args = (q, k, v, mask, out, lse, dout, False, scale)
            leaves = [x.view(Bt, H, Tt, D).detach().requires_grad_() for x in (q, k, v)]
            sdpa_out = F.scaled_dot_product_attention(*leaves,
                                                      attn_mask=mask.view(Bt, H, 1, Tt).bool())
            dout4 = dout.view(Bt, H, Tt, D)

            def kernel():
                return att.flash_attention_bwd(*args)

            def sdpa_bwd():
                return torch.autograd.grad(sdpa_out, leaves, dout4, retain_graph=True)

            ms, sdpa_ms, ms2, sdpa_ms2 = (device_ms(f)
                                          for f in (kernel, sdpa_bwd, kernel, sdpa_bwd))
            plain_ms = device_ms(lambda: att.flash_attention_bwd_plain(*args), warmup=2, iters=10)
            call_ms = cuda_ms(kernel)
            own = _device_kernels(kernel, n=10)
            log(f"[times] flash_bwd {tag} [B*H={BH}, T={Tt}, D={D}]: its device kernels a call "
                f"(name, count, device ms): "
                f"{[(key[:60], n, round(t, 4)) for key, n, t, *_ in own]}")
            sdpa_kernels = _device_kernels(sdpa_bwd, n=10)
            library_ms = sum(ms for _, _, ms, *_ in sdpa_kernels)
            library_kernels = [key[:80] for key, *_ in sdpa_kernels]
            recorded = [(key[:50], rec, c, round(t, 4), round(raw, 4))
                        for key, c, t, rec, raw in sdpa_kernels]
            log(f"[times] flash_bwd {tag} [B*H={BH}, T={Tt}, D={D}]: "
                f"scaled_dot_product_attention's backward kernels over 10 calls (name, launches "
                f"recorded, counted a call, ms a call from the mean a launch, ms recorded over "
                f"10): {recorded}; summed {library_ms:.4f} ms, recorded over 10 "
                f"{sum(raw for *_, raw in sdpa_kernels):.4f} ms")
            elt = torch.finfo(dtype).bits // 8
            # q, k, v, out, dout read and dq, dk, dv written; the mask and LSE
            n_bytes = 8 * BH * Tt * D * elt + 2 * BH * Tt * 4
            flops = 5 * 2 * BH * Tt * Tt * D  # S, dP, dV, dQ, dK: every tile
            passes = MMA_PASSES[dtype]
            t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = passes * flops / PEAK_FLOPS[dtype] * 1e3
            bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            log(f"[times] flash_bwd {tag} [B*H={BH}, T={Tt}, D={D}]: kernel {ms:.4f} / {ms2:.4f} "
                f"ms (device time, two turns, its {sum(n for _, n, *_ in own)} kernels; one call "
                f"with its host enqueue "
                f"{call_ms:.4f} ms; {statistics.median([ms, ms2]) / bound_ms:.2f}x the bound), "
                f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB = {t_bytes:.4f} ms; "
                f"{passes} x {flops / 1e9:.2f} GFLOP at {PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s = "
                f"{t_ops:.4f} ms), plain {plain_ms:.4f} ms, scaled_dot_product_attention's "
                f"backward {sdpa_ms:.4f} / {sdpa_ms2:.4f} ms in device time, its device kernels "
                f"summed {library_ms:.4f} ms: {library_kernels} | {card}")
            if i == 0:
                rows.append({"name": f"flash_bwd_{tag}", "route": "cuda",
                             "source": f"synapseml_torch/csrc/{att._BWD_SOURCES[dtype]}.cu",
                             "replaces": "synapseml_tpu/ops/attention.py:183",
                             "launches": launches[f"bwd_{tag}"],
                             "max_abs_err": max_err[f"bwd_{tag}"],
                             "ms": statistics.median([ms, ms2]), "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": library_ms})
            del leaves, sdpa_out
    for kernel in ("flash_bwd_wgmma_kernel", "flash_bwd_tf32_kernel"):
        by_d = sorted([(int(re.search(r"ILi(\d+)E", fn).group(1)), v)
                       for fn, v in PTXAS.items() if kernel in fn], key=lambda dv: dv[0])
        log(f"[times] {kernel} registers and spill bytes (stores, loads) by head dim: "
            + (", ".join(f"D={d}: {v.get('registers')} registers, {v.get('spill_bytes')}"
                         for d, v in by_d) or "not compiled in this process"))
    return rows


# ---------------- main path 3: BERT-base fine-tuning ----------------

# 48 steps, cut from 64 so that main path 4 fits the script's time
FT_ARCH, FT_ROWS, FT_STEPS, FT_BATCH, FT_LEN = "bert-base", 960, 48, 32, 128
FT_CHUNK = 8  # the stage's scan_chunk (fit_arrays' default): steps a captured graph runs
FT_WARMUP = 5  # eager steps left out of the step time (first calls, allocator warm-up)
# graph chunks left out of the step time: the warm-up chunk (eager, on a side
# stream) and the chunk that captures; the profiled chunk is left out too
FT_GRAPH_SKIP = 2
FT_PROFILE_AT = 4  # the chunk profiled (0-based), or the next if its profile lost records
FT_LR = 1e-4
# a leaf on which two eager fits from one seed differ is held to the eager
# fit within this, not bitwise
TOL_SPREAD = 1e-6
_POSITIVE = ("great", "good", "moving", "bright", "funny", "well", "fast")
_NEGATIVE = ("bad", "awful", "boring", "dark", "slow", "sad", "badly")
TINY_STEPS, TINY_CHUNK, TINY_TOL = 6, 3, 1e-4  # bert-tiny f32, CPU against the card
LONG_STEPS, LONG_WARMUP = 8, 2  # the long-T step: steps run, first steps left out
LONG_F32_STEPS = 4  # the long-T step in f32 compute (the f32 flash kernels)


def _labelled_texts(n: int, seed: int, n_words=(150, 300)) -> list[dict]:
    """Texts long enough to fill 128 tokens, labelled 1 when the words that
    fit hold more positive than negative words: a learnable task."""
    rs = np.random.default_rng(seed)
    words = ("the a film plot acting score music scene story actor director not very "
             "really quite never always long short").split() + list(_POSITIVE + _NEGATIVE)
    rows = []
    for m in rs.integers(n_words[0], n_words[1], n):
        w = list(rs.choice(words, size=int(m)))
        kept = w[:FT_LEN - 1]  # after the CLS token
        label = int(sum(x in _POSITIVE for x in kept) > sum(x in _NEGATIVE for x in kept))
        rows.append({"text": " ".join(w), "label": label})
    return rows


class _StepTimer:
    """Wraps Trainer.train_step for one fit: CUDA events around each step
    (the device time from the step's first kernel to its last, idle gaps
    included), each step's loss and gradient norm tensors, and the last
    (trainer, state, batch)
    for the profile. Restores the method on exit."""

    def __init__(self):
        self.events, self.losses, self.grad_norms, self.last = [], [], [], None

    def __enter__(self):
        orig = self._orig = trainer_mod.Trainer.train_step
        timer = self

        def timed(trainer, state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = orig(trainer, state, batch)
            end.record()
            timer.events.append((start, end))
            timer.losses.append(metrics["loss"])
            timer.grad_norms.append(metrics["grad_norm"])
            timer.last = (trainer, state, batch)
            return state, metrics

        trainer_mod.Trainer.train_step = timed
        return self

    def __exit__(self, *exc):
        trainer_mod.Trainer.train_step = self._orig

    def step_ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _flash_named(kernels) -> tuple[int, int]:
    """(forward, backward) flash kernels a profile recorded, by name."""
    return (sum(n for _, n, key in kernels if "flash_fwd" in key),
            sum(n for _, n, key in kernels if "flash_bwd" in key))


class _ChunkTimer:
    """Wraps Trainer.train_steps_scan for one fit, as _StepTimer wraps
    train_step: CUDA events around each chunk (its host-to-card copies and
    its graph replay; the first chunk of a key is its eager warm-up, the
    second also captures), each chunk's losses and gradient norms, and a
    profile of chunk ``profile_at`` (a replay): its wall time, its device
    kernels by group and the flash kernels by name, which must number
    ``want_flash`` (forward, backward). The profiler starts tracing in a
    warm-up cycle before the chunk, whose records it drops (without one a
    profile missed a replay's first step on one H100). A
    profile that still lost records (no kernel, or fewer flash kernels
    than the chunk launched) measured less than ran: the next chunk is
    profiled in its place. Restores the method on exit."""

    def __init__(self, profile_at: int | None = None, want_flash=(0, 0)):
        self.events, self.losses, self.grad_norms = [], [], []
        self.profile_at, self.want_flash, self.profile = profile_at, want_flash, None
        self.short = []  # (forward, backward) of profiles that lost records

    def __enter__(self):
        orig = self._orig = trainer_mod.Trainer.train_steps_scan
        timer = self

        def timed(trainer, state, stacked):
            if len(timer.events) == timer.profile_at:
                state, metrics = timer._profiled(orig, trainer, state, stacked)
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, metrics = orig(trainer, state, stacked)
                end.record()
                timer.events.append((start, end))
            timer.losses.append(metrics["loss"])
            timer.grad_norms.append(metrics["grad_norm"])
            return state, metrics

        trainer_mod.Trainer.train_steps_scan = timed
        return self

    def _profiled(self, orig, trainer, state, stacked):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, schedule

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            torch.cuda._sleep(SPIN // 10)  # work for the warm-up cycle to trace
            torch.cuda.synchronize()
            prof.step()  # the active cycle; it ends when the block does
            t0 = time.perf_counter()
            state, metrics = orig(trainer, state, stacked)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the active cycle's own span is recorded on the card too: not a kernel
        kernels = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")]
        self.events.append(None)
        if kernels and _flash_named(kernels) == tuple(self.want_flash):
            self.profile = {"wall_ms": wall_ms, "kernels": kernels}
        else:
            self.short.append(_flash_named(kernels) if kernels else None)
            log(f"[profile] the profile of chunk {self.profile_at + 1} recorded "
                f"{_flash_named(kernels) if kernels else 'no'} flash kernels of "
                f"{tuple(self.want_flash)} (of {len(kernels)} kernel names); profiling the next")
            self.profile_at += 1
        return state, metrics

    def __exit__(self, *exc):
        trainer_mod.Trainer.train_steps_scan = self._orig

    def chunk_ms(self) -> list[float | None]:
        torch.cuda.synchronize()
        return [e[0].elapsed_time(e[1]) if e else None for e in self.events]


def _zero_flash_counts() -> None:
    att.flash_attention_fwd.launches = dict.fromkeys(att.flash_attention_fwd.launches, 0)
    att.flash_attention_bwd.launches = dict.fromkeys(att.flash_attention_bwd.launches, 0)


def _flash_counts() -> dict:
    return {"fwd": dict(att.flash_attention_fwd.launches),
            "bwd": dict(att.flash_attention_bwd.launches)}


def _stage(device, attn_impl: str) -> DeepTextClassifier:
    return DeepTextClassifier(checkpoint=FT_ARCH, num_classes=2, batch_size=FT_BATCH,
                              max_token_len=FT_LEN, max_steps=FT_STEPS, learning_rate=FT_LR,
                              seed=0, attn_impl=attn_impl, device=str(device))


def _fit_numbers(tag: str, attn_impl: str, step_ms: float, peak_gib: float, n_params: int,
                 card: str, how: str) -> dict:
    tokens = FT_BATCH * FT_LEN
    flops = 6 * n_params * tokens
    mfu = flops / (step_ms / 1e3) / 989e12
    log(f"[train] {attn_impl} {tag}: median step {step_ms:.3f} ms in device time ({how}) = "
        f"{FT_BATCH / step_ms * 1e3:.1f} samples/s; 6ND = {flops / 1e12:.3f} TFLOP a step "
        f"({n_params:,} params x {tokens} tokens) = MFU {mfu:.4f} of 989 TFLOP/s bf16 dense; "
        f"peak device memory {peak_gib:.2f} GiB | {card}")
    return {"step_ms": step_ms, "samples_s": FT_BATCH / step_ms * 1e3, "mfu": mfu,
            "peak_gib": peak_gib}


def _graph_fine_tune(df, device, card: str, attn_impl: str) -> dict:
    """The stage's own fit (fit_arrays at its default scan_chunk: CUDA
    graphs of FT_CHUNK steps) at full width and depth, the flash launch
    counts set to 0 just before it and read just after: every step's loss
    finite, every parameter moved, one capture for the fit's one key; the
    chunks' times, peak memory, MFU, and the profile of the last chunk."""
    stage = _stage(device, attn_impl)
    cache = cb.get_compiled_cache()
    misses0 = cache.miss_count("train_steps_scan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_flash = bert_base().n_layers * FT_CHUNK if attn_impl == "flash" else 0
    timer = _ChunkTimer(profile_at=FT_PROFILE_AT, want_flash=(n_flash, n_flash))
    _zero_flash_counts()
    t0 = time.perf_counter()
    with timer:
        model = stage.fit(df)
    fit_s = time.perf_counter() - t0
    launches = _flash_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    captures = cache.miss_count("train_steps_scan") - misses0
    chunks = timer.chunk_ms()
    losses = torch.cat(timer.losses).float().cpu().numpy()
    if (len(chunks) != FT_STEPS // FT_CHUNK or not np.isfinite(losses).all()
            or timer.profile is None):
        raise AssertionError(f"{attn_impl} graph fit: {len(chunks)} chunks, losses "
                             f"{losses.tolist()}, a profile {timer.profile is not None}: want "
                             f"{FT_STEPS // FT_CHUNK} chunks of finite losses and a profile")
    cfg = model.get("arch_config")
    init = text_stage._init_params(cfg, 2, 0)
    params = model.get("model_params")
    still = [k for k in params if np.array_equal(params[k], init[k])]
    log(f"[train] {attn_impl} graph fit: per-step loss {np.round(losses, 4).tolist()} (all "
        f"finite); parameters that did not move: {still or 'none'}; captures "
        f"{captures:g} (want 1: one key, batch {FT_BATCH} x {FT_LEN}, K = {FT_CHUNK}, phase 0); "
        f"flash launches over the fit {launches}; CompiledCache {cache.stats()}")
    if still or captures != 1:
        raise AssertionError(f"{attn_impl} graph fit: parameters did not move ({still}) or "
                             f"{captures} captures")
    n_params = sum(a.size for a in params.values())
    _check_train_metrics(model.get("train_metrics"), n_params, attn_impl)
    timed = [c for c in chunks[FT_GRAPH_SKIP:] if c is not None]  # None: profiled
    step_ms = statistics.median(timed) / FT_CHUNK
    log(f"[train] {attn_impl} graph fit: {fit_s:.2f} s on the host clock (init, tokenization "
        f"and {FT_STEPS} steps); chunks of {FT_CHUNK} steps in device time "
        f"{[round(c, 3) if c else 'profiled' for c in chunks]} ms (the first the eager warm-up, "
        f"the second with the capture) | {card}")
    out = _fit_numbers("graph", attn_impl, step_ms, peak_gib, n_params, card,
                       f"the unprofiled chunks from {FT_GRAPH_SKIP + 1} on, ms / {FT_CHUNK}: "
                       f"{len(timed)} chunks, min {min(timed) / FT_CHUNK:.3f}, max "
                       f"{max(timed) / FT_CHUNK:.3f}")
    prof = timer.profile
    busy = sum(k[0] for k in prof["kernels"])
    n_fwd, n_bwd = _flash_named(prof["kernels"])
    log(f"[profile] one replayed {attn_impl} chunk of {FT_CHUNK} steps: {prof['wall_ms']:.3f} ms "
        f"wall, {busy:.3f} ms of device kernels ({100 * busy / prof['wall_ms']:.1f}% busy, "
        f"{100 - 100 * busy / prof['wall_ms']:.1f}% idle under the profiler), "
        f"{sum(k[1] for k in prof['kernels'])} device kernels; flash forward kernels "
        f"{n_fwd}, backward {n_bwd} (earlier profiles that lost records: "
        f"{timer.short or 'none'}) | {card}")
    _log_groups(prof["kernels"], busy, f"{attn_impl} graph chunk", FT_CHUNK)
    out.update(model=model, losses=losses, launches=launches, captures=captures,
               busy=busy / prof["wall_ms"], prof_flash=(n_fwd, n_bwd),
               grad_norm1=float(timer.grad_norms[0][0]))
    return out


def _check_train_metrics(entries: list[dict], n_params: int, attn_impl: str) -> None:
    """The stage's ``train_metrics`` after a graph fit: a window where
    Trainer.fit's log rule closes one (``log_every`` 50, steps counted a
    chunk at a time), the last at FT_STEPS, each with an MFU, and tokens over
    samples FT_LEN (the meter counts a chunk's K x B samples)."""
    want, logged = [], 0
    for done in range(FT_CHUNK, FT_STEPS + 1, FT_CHUNK):
        if done - logged >= 50 or done >= FT_STEPS:
            want.append(done)
            logged = done
    per_sample = [e["model_tflops_per_sec"] * 1e12 / e["samples_per_sec"] / (6 * n_params)
                  for e in entries]
    log(f"[train] {attn_impl} graph fit: train_metrics {json.dumps(entries)} (host clock, "
        f"first chunks included); window steps {[e['step'] for e in entries]} (want {want}), "
        f"tokens a sample {per_sample} (want {FT_LEN})")
    if ([e["step"] for e in entries] != want or not all("mfu" in e for e in entries)
            or not np.allclose(per_sample, FT_LEN, rtol=1e-9, atol=0)):
        raise AssertionError(f"{attn_impl} graph fit: train_metrics {entries}: want windows at "
                             f"{want}, each with an mfu and {FT_LEN} tokens a sample")


def _eager_fine_tune(df, device, card: str, attn_impl: str, timed: bool = True) -> dict:
    """The eager baseline: the stage's own trainer, data, init and keywords
    (``_fit_plan``) through fit_arrays with scan_chunk=1, the per-step loop;
    with ``timed``, CUDA events around each step and peak memory."""
    trainer, data, kw, _, _ = _stage(device, attn_impl)._fit_plan(df)
    timer = _StepTimer()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    with timer:
        state = trainer_mod.fit_arrays(trainer, data, scan_chunk=1, **kw)
    launches = _flash_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    params = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
    out = {"params": params, "launches": launches}
    if not timed:
        return out
    steps = timer.step_ms()
    losses = torch.stack(timer.losses).float().cpu().numpy()
    if len(steps) != FT_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{attn_impl} eager fit: {len(steps)} steps, losses "
                             f"{losses.tolist()}: want {FT_STEPS} finite losses")
    step_ms = statistics.median(steps[FT_WARMUP:])
    out.update(_fit_numbers("eager", attn_impl, step_ms, peak_gib,
                            sum(a.size for a in params.values()), card,
                            f"steps {FT_WARMUP + 1}-{FT_STEPS}, min "
                            f"{min(steps[FT_WARMUP:]):.3f}, max {max(steps[FT_WARMUP:]):.3f}; "
                            f"first step {steps[0]:.3f}"))
    out.update(timer=timer, losses=losses, grad_norm1=float(timer.grad_norms[0]))
    return out


def _graph_against_eager(graph: dict, eager: dict, eager2: dict, tag: str) -> list[str]:
    """Each leaf of the graph fit bitwise equal to the eager fit's, except
    the leaves on which two eager fits from one seed already differ (held
    within TOL_SPREAD); returns those."""
    spread = [k for k in eager if not np.array_equal(eager[k], eager2[k])]
    off = {k: float(np.abs(graph[k].astype(np.float64) - eager[k]).max())
           for k in eager if not np.array_equal(graph[k], eager[k])}
    log(f"{tag} graph fit against the eager fit: {len(eager) - len(off)} of {len(eager)} "
        f"parameters bitwise equal; differing {({k: f'{v:.3e}' for k, v in off.items()}) or 'none'}; "
        f"the leaves on which two eager fits from one seed differ (max |d| within "
        f"{TOL_SPREAD:g} allowed there): "
        f"{({k: f'{np.abs(eager[k] - eager2[k]).max():.3e}' for k in spread}) or 'none'}")
    bad = [k for k, v in off.items() if k not in spread or v > TOL_SPREAD]
    if bad:
        raise AssertionError(f"{tag} the graph fit differs from the eager fit on {bad}")
    return spread


def _score_flash_vs_einsum(model, score_df, batches: int,
                          tag: str) -> tuple[np.ndarray, dict]:
    """The fitted model's scores through the flash kernel (12 forward
    launches a batch, no backward), against einsum on the card; the scores
    and the flash launches they took."""
    _zero_flash_counts()
    flash_scores = np.stack(list(model.copy({"attn_impl": "flash"}).transform(score_df)
                                 .collect_column("scores")))
    launches = _flash_counts()
    n_layers = model.get("arch_config").n_layers
    want = {"fwd": {"bf16": n_layers * batches, "f32": 0}, "bwd": {"bf16": 0, "f32": 0}}
    log(f"[train] {tag} model, flash launches over one request of {batches} batches: "
        f"{launches} (want {n_layers} forward per batch: {want})")
    if launches != want:
        raise AssertionError(f"{tag}: flash launched {launches} times, want {want}")
    einsum_scores = np.stack(list(model.copy({"attn_impl": "einsum"}).transform(score_df)
                                  .collect_column("scores")))
    diff = float(np.abs(flash_scores - einsum_scores).max())
    agree = float(np.mean(flash_scores.argmax(-1) == einsum_scores.argmax(-1)))
    log(f"[train] {tag} model, flash vs einsum on the card: max|dprob| {diff:.3e} (tol "
        f"3e-2), predictions agree on {agree:.4f} of rows (want >= 0.99); scores finite: "
        f"{bool(np.isfinite(flash_scores).all())}")
    if not (np.isfinite(flash_scores).all() and diff <= 3e-2 and agree >= 0.99):
        raise AssertionError(f"{tag}: the fitted model's flash and einsum scores disagree")
    return flash_scores, launches


# flash against einsum at step 1 (same init, same batch, bf16 compute): the
# loss (forward only), and the global norm of the raw gradients, which only
# a right backward keeps within a bf16 rounding of einsum's
TOL_STEP1_LOSS, TOL_STEP1_GRAD_NORM = 1e-2, 1e-2


def _check_step1(loss_fl, loss_ein, gn_fl, gn_ein, tag: str, tol_loss=TOL_STEP1_LOSS,
                 tol_norm=TOL_STEP1_GRAD_NORM) -> None:
    d_loss = abs(float(loss_fl) - float(loss_ein))
    d_norm = abs(float(gn_fl) - float(gn_ein)) / float(gn_ein)
    log(f"{tag} step 1 (same init, same batch, before any update): flash loss "
        f"{float(loss_fl):.6f}, einsum {float(loss_ein):.6f}, |d| {d_loss:.3e} (tol "
        f"{tol_loss:g}); gradient norm flash {float(gn_fl):.6f}, einsum "
        f"{float(gn_ein):.6f}, |d| over einsum's {d_norm:.3e} (tol {tol_norm:g})")
    if not (d_loss <= tol_loss and d_norm <= tol_norm):
        raise AssertionError(f"{tag} the flash step 1 disagrees with einsum's")


def _free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


class _InitOnce:
    """Within a phase, ``text._init_params`` (the JAX initialisers drawn
    with numpy: seconds of host time at BERT-base) computed once per
    (config, classes, seed) and handed to every fit that asks, the stage's
    own included; the fits only read it. Restores the function on exit."""

    def __enter__(self):
        orig = self._orig = text_stage._init_params
        memo = {}

        def once(cfg, num_classes, seed):
            key = (cfg, num_classes, seed)
            if key not in memo:
                memo[key] = orig(cfg, num_classes, seed)
            return memo[key]

        text_stage._init_params = once
        return self

    def __exit__(self, *exc):
        text_stage._init_params = self._orig


def _fine_tune_pair(df, device, card: str, attn_impl: str, n_layers: int) -> dict:
    """The graph fit (the stage's default), then the eager baseline twice
    (the second fit shows which leaves two eager fits from one seed already
    differ on), each from the same seed, data and init: the graph fit
    against the eager fit leaf by leaf, and the flash launches of each."""
    graph = _graph_fine_tune(df, device, card, attn_impl)
    _free_card()
    eager = _eager_fine_tune(df, device, card, attn_impl)
    _free_card()
    eager2 = _eager_fine_tune(df, device, card, attn_impl, timed=False)
    _free_card()
    tag = f"[train] {attn_impl}:"
    _graph_against_eager(graph["model"].get("model_params"), eager["params"], eager2["params"],
                         tag)
    d_loss = float(np.abs(graph["losses"] - eager["losses"]).max())
    log(f"{tag} per-step losses of the graph fit against the eager fit: max |d| {d_loss:.3e}")
    n = n_layers * FT_STEPS if attn_impl == "flash" else 0
    want = {"fwd": {"bf16": n, "f32": 0}, "bwd": {"bf16": n, "f32": 0}}
    n_chunk = n_layers * FT_CHUNK if attn_impl == "flash" else 0
    log(f"{tag} flash launches: graph fit {graph['launches']}, eager fit {eager['launches']} "
        f"(want {want}: {n_layers} forward and {n_layers} backward a step, replayed steps "
        f"included); in the profiled replay {graph['prof_flash']} forward and backward "
        f"kernels (want {n_chunk} each)")
    if not (graph["launches"] == eager["launches"] == eager2["launches"] == want
            and graph["prof_flash"] == (n_chunk, n_chunk)):
        raise AssertionError(f"{tag} flash launched {graph['launches']} / {eager['launches']}"
                             f" / profiled {graph['prof_flash']}, want {want}")
    log(f"[train] {attn_impl} graph vs eager: median step {graph['step_ms']:.3f} vs "
        f"{eager['step_ms']:.3f} ms, {graph['samples_s']:.1f} vs {eager['samples_s']:.1f} "
        f"samples/s, MFU {graph['mfu']:.4f} vs {eager['mfu']:.4f}, peak device memory "
        f"{graph['peak_gib']:.2f} vs {eager['peak_gib']:.2f} GiB; busy share of one profiled "
        f"graph chunk {100 * graph['busy']:.1f}% | {card}")
    return {"graph": graph, "eager": eager}


def _check_tensor_scalars(device) -> bool:
    """The optimizer's per-step scalars are 0-d device tensors (a graph reads
    each replay's from its table): torch._foreach_div and _foreach_mul with
    such a tensor against the same value as a Python float, on the card, on
    leaves of BERT-base's shapes, for values like a step's -lr, bias
    corrections and accumulation divisor. Reported, not required: eager and
    graph steps both take the tensor overloads."""
    g = torch.Generator(device=device).manual_seed(150)
    xs = [torch.randn(shape, generator=g, device=device) for shape in ((30522, 768), (768,),
                                                                     (3072, 768), (2, 768))]
    values = [-np.float32(1e-4) * np.float32(0.37), np.float32(1) - np.float32(0.9) ** 7,
              np.float32(1) - np.float32(0.999) ** 7, np.float32(2)]
    found = {}
    for op in (torch._foreach_div, torch._foreach_mul):
        pairs = [(a, b) for v in values
                 for a, b in zip(op(xs, torch.tensor(v, device=device)), op(xs, float(v)))]
        found[op.__name__] = (all(torch.equal(a, b) for a, b in pairs),
                              max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                                  for a, b in pairs))
    log(f"[train] the optimizer's tensor scalars: a 0-d float32 tensor against a Python float "
        f"on the card, {len(values)} values on BERT-base-shaped leaves: "
        + ", ".join(f"{name} bitwise equal {same} (largest relative difference {rel:.3e})"
                    for name, (same, rel) in found.items()))
    return all(same for same, _ in found.values())


def phase_train_main(device, card: str) -> dict:
    """DeepTextClassifier fine-tuning at full width and depth, with einsum
    attention and then with attn_impl='flash' (the flash forward and
    backward kernels) on the same data and seed: the stage's fit through
    CUDA graphs against the eager per-step loop; each graph-fitted
    model's scoring through the flash kernel."""
    rows = _labelled_texts(FT_ROWS, seed=0)
    df = DataFrame.from_rows(rows, num_partitions=2)
    log(f"[train] {FT_ARCH} fine-tune: {FT_ROWS} texts ({np.mean([r['label'] for r in rows]):.3f} "
        f"positive), batch {FT_BATCH} x {FT_LEN} tokens, {FT_STEPS} steps, lr {FT_LR} "
        f"(linear warm-up {max(FT_STEPS // 10, 1)} steps, then linear decay), bf16 compute; "
        f"einsum attention, then flash; each through CUDA graphs of {FT_CHUNK} steps (the "
        f"stage's fit) and through the eager per-step loop")
    score_df = DataFrame.from_rows([{"text": t} for t in _texts(N_TEXTS, N_PARTS, seed=1)],
                                   num_partitions=N_PARTS)
    bucketer = cb.default_bucketer()
    batches = sum(len(list(bucketer.slices(len(p["text"]), FT_BATCH)))
                  for p in score_df.partitions)
    n_layers = bert_base().n_layers
    _check_tensor_scalars(device)
    with _InitOnce():
        return _train_main(df, score_df, batches, n_layers, device, card)


def _train_main(df, score_df, batches: int, n_layers: int, device, card: str) -> dict:
    """phase_train_main's fits, checks and profiles, on its data."""
    ein = _fine_tune_pair(df, device, card, "einsum", n_layers)
    flash_scores, ein_scoring = _score_flash_vs_einsum(ein["graph"]["model"], score_df, batches,
                                                       "einsum-fitted")

    import tempfile

    with tempfile.TemporaryDirectory(dir=".") as tmp:
        ein["graph"]["model"].copy({"attn_impl": "flash"}).save(f"{tmp}/m")
        loaded = DeepTextModel.load(f"{tmp}/m")
        again = np.stack(list(loaded.transform(score_df).collect_column("scores")))
    same = np.array_equal(again, flash_scores)
    log(f"[train] save -> load round trip: scores bitwise equal: {same}")
    if not same:
        raise AssertionError("the loaded model scores differently")
    del loaded  # its module holds the weights on the card
    timer = ein["eager"]["timer"]
    _profile_train_step(*timer.last, card, ein["eager"]["step_ms"], "einsum eager")
    _host_step_parts(*timer.last, card, "einsum eager")
    timer.last = None  # frees the einsum module before the flash fits' peak memory
    _free_card()

    fl = _fine_tune_pair(df, device, card, "flash", n_layers)
    for kind in ("graph", "eager"):
        _check_step1(fl[kind]["losses"][0], ein[kind]["losses"][0], fl[kind]["grad_norm1"],
                     ein[kind]["grad_norm1"], f"[train] {kind}")
    _, fl_scoring = _score_flash_vs_einsum(fl["graph"]["model"], score_df, batches,
                                           "flash-fitted")
    log("[train] main path 3 (BERT-base, batch 32 x 128, bf16): " + "; ".join(
        f"{impl} {kind} {r[kind]['samples_s']:.1f} samples/s, median step "
        f"{r[kind]['step_ms']:.3f} ms, MFU {r[kind]['mfu']:.4f}, peak {r[kind]['peak_gib']:.2f} GiB"
        for impl, r in (("einsum", ein), ("flash", fl)) for kind in ("eager", "graph"))
        + f"; busy share of a graph chunk einsum {100 * ein['graph']['busy']:.1f}%, flash "
        f"{100 * fl['graph']['busy']:.1f}% | {card}")
    timer = fl["eager"]["timer"]
    _profile_train_step(*timer.last, card, fl["eager"]["step_ms"], "flash eager")
    _host_step_parts(*timer.last, card, "flash eager")
    timer.last = None
    # flash launches on this path, as counted: the flash fits (graph and the
    # eager baseline; the second eager fit is a check) and both graph-fitted
    # models' scoring
    runs = (fl["graph"]["launches"], fl["eager"]["launches"], ein_scoring, fl_scoring)
    return {"launches": {k: sum(r["fwd"][k] for r in runs) for k in ("bf16", "f32")},
            "bwd_launches": {k: sum(r["bwd"][k] for r in runs) for k in ("bf16", "f32")},
            **{f"{k}_{impl}_{kind}": r[kind][k] for impl, r in (("einsum", ein), ("flash", fl))
               for kind in ("eager", "graph") for k in ("step_ms", "samples_s", "mfu", "peak_gib")}}


_TRAIN_GROUPS = (("flash_fwd kernel", ("flash_fwd",)),  # matched in lower case
                 ("flash_bwd kernels", ("flash_bwd",)),
                 ("matmul", ("nvjet", "gemm", "cutlass", "sm90_", "cublas")),
                 ("optimizer elementwise (foreach)", ("multi_tensor", "foreach")),
                 ("embedding backward", ("embedding", "segment", "krn_partial",
                                         "compute_grad_weight", "sum_and_scatter",
                                         "radix", "sort")),
                 ("layer norm", ("layer_norm",)),
                 ("softmax", ("softmax",)),
                 ("gelu", ("gelu",)),
                 ("dtype casts and copies", ("copy", "memcpy")),
                 ("reductions", ("reduce",)),
                 ("other elementwise", ("elementwise", "vectorized")))


def _profile_train_step(trainer, state, batch, card: str, step_ms: float, tag: str, n=3,
                        what=f"BERT-base bf16, batch {FT_BATCH} x {FT_LEN}") -> dict:
    """Where the device time of one BERT-base optimizer step (``what``) goes
    (forward, backward, optimizer), by kernel group, the share of its wall
    time the card is busy under the profiler, and the device time over the
    unprofiled median step (``step_ms``). Returns ms a step by group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step():
        trainer.train_step(state, batch)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [(e.self_device_time_total / n / 1e3, e.count // n, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(k[0] for k in kernels)
    if not busy:
        log("[profile] the profiler recorded no device time")
        return {}
    log(f"[profile] one {tag} optimizer step, {what}: "
        f"{wall_ms:.3f} ms wall, {busy:.3f} ms of device kernels ({100 * busy / wall_ms:.1f}% "
        f"busy, {100 - 100 * busy / wall_ms:.1f}% idle under the profiler; "
        f"{100 * busy / step_ms:.1f}% of the unprofiled {step_ms:.3f} ms median step), "
        f"{sum(k[1] for k in kernels)} device kernels | {card}")
    return _log_groups(kernels, busy, tag, 1)


def _log_groups(kernels, busy: float, tag: str, steps: int) -> dict:
    """Device time by kernel group (``_TRAIN_GROUPS``) and the top kernels,
    from ``(ms, count, name)`` over ``steps`` steps; returns ms a step by
    group."""
    groups = {name: 0.0 for name, _ in _TRAIN_GROUPS}
    groups["other"] = 0.0
    for ms, _, key in kernels:
        name = next((g for g, pats in _TRAIN_GROUPS if any(p in key.lower() for p in pats)),
                    "other")
        groups[name] += ms / steps
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] {tag} step group {name}: {ms:.4f} ms/step ({100 * ms * steps / busy:.1f}% "
            f"of device time)")
    for ms, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"[profile] {tag} step {100 * ms / busy:5.1f}%  {ms / steps:8.4f} ms/step  "
            f"{count / steps:6.1f}/step  {key[:200]}")
    return groups


def _host_step_parts(trainer, state, batch, card: str, tag: str, n=3) -> None:
    """The host's side of an optimizer step, no profiler and no sync inside:
    the time to enqueue the batch copy, the forward, the backward and the
    optimizer."""
    parts = {"batch to the card": 0.0, "forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    params = list(state.params.values())
    torch.cuda.synchronize()
    for _ in range(n):
        t0 = time.perf_counter()
        dev_batch = trainer._to_device(batch)
        t1 = time.perf_counter()
        for p in params:
            p.grad = None
        loss, _ = trainer.default_loss(dev_batch)
        t2 = time.perf_counter()
        loss.backward()
        t3 = time.perf_counter()
        trainer._tx.update([p.grad for p in params], state.opt_state, params)
        t4 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k] += dt * 1e3 / n
    torch.cuda.synchronize()
    log(f"[profile] host time of a {tag} step, no profiler: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + f" (sum {sum(parts.values()):.3f} ms) | {card}")


def phase_train_cpu_card(device) -> dict:
    """bert-tiny in f32 compute (TF32 off), the same init and batches on the
    CPU and on the card, with einsum attention and with attn_impl='flash'
    (on the card the f32 flash forward and backward kernels, on the CPU their
    plain versions). On the card: the per-step loop twice, and the chunked
    fit (two chunks of TINY_CHUNK steps: the eager warm-up, then a capture
    and its replay), then the chunked fit again on that trainer, its first
    state kept alive. Per-step losses within TINY_TOL of the CPU's; the graph
    run's final parameters bitwise equal to the eager run's but where two
    eager runs differ (there within TOL_SPREAD); the second graph fit on one
    trainer bitwise the first, one capture each. Returns the flash kernels'
    launches on the card's flash runs (the eager one and the graph one)."""
    from synapseml_torch.data import MemorySource
    from synapseml_torch.models.nets.bert import BertClassifier, bert_tiny

    tok = HashingTokenizer(vocab_size=1024)
    rows = _labelled_texts(8 * TINY_STEPS, seed=2, n_words=(5, 60))
    data = {**tok([r["text"] for r in rows], max_len=64),
            "labels": np.array([r["label"] for r in rows], np.int32)}
    total = {"fwd": {"bf16": 0, "f32": 0}, "bwd": {"bf16": 0, "f32": 0}}
    cache = cb.get_compiled_cache()
    for attn_impl in ("einsum", "flash"):
        cfg = bert_tiny(vocab_size=1024, dtype=torch.float32, attn_impl=attn_impl)
        init = text_stage._init_params(cfg, 2, seed=3)
        losses, params, launches, captures = {}, {}, {}, {}
        kept = None  # the graph run's trainer and state, alive through the refit
        for run, dev in (("cpu", "cpu"), ("eager", device), ("eager2", device),
                         ("graph", device), ("refit", device)):
            if run == "refit":  # a second fit on the graph run's trainer
                trainer = kept[0]
            else:
                trainer = trainer_mod.Trainer(
                    BertClassifier(cfg, 2),
                    trainer_mod.TrainerConfig(learning_rate=1e-3, total_steps=TINY_STEPS,
                                              warmup_steps=1, lr_schedule="linear"), device=dev)
            graphs = run in ("graph", "refit")
            seen, timer = [], _ChunkTimer()
            misses0 = cache.miss_count("train_steps_scan")
            _zero_flash_counts()
            with timer:
                state = trainer_mod.fit_source(
                    trainer, MemorySource(data), batch_size=8, total_steps=TINY_STEPS, seed=0,
                    init_params=init, scan_chunk=TINY_CHUNK,
                    callback=None if graphs else (lambda i, m: seen.append(float(m["loss"]))))
            if graphs:
                seen = torch.cat(timer.losses).cpu().numpy().tolist()
                captures[run] = cache.miss_count("train_steps_scan") - misses0
                if len(timer.losses) != TINY_STEPS // TINY_CHUNK:
                    raise AssertionError(f"bert-tiny {attn_impl}: {len(timer.losses)} chunks")
            losses[run] = np.array(seen)
            params[run] = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
            launches[run] = _flash_counts()
            if run == "graph":
                kept = (trainer, state)
            else:
                trainer.release_graphs()
            del trainer, state
        del kept
        cpu = losses["cpu"]
        err = {run: float(np.abs(cpu - losses[run]).max()) for run in ("eager", "graph")}
        log(f"[train] bert-tiny f32 {attn_impl}, {TINY_STEPS} steps from one init: CPU losses "
            f"{np.round(cpu, 6).tolist()}, card {np.round(losses['eager'], 6).tolist()} (per "
            f"step), {np.round(losses['graph'], 6).tolist()} (graphs of {TINY_CHUNK}); max|d| "
            f"from the CPU {err['eager']:.3e} / {err['graph']:.3e} (tol {TINY_TOL:g}); flash "
            f"launches on the card {launches['eager']} / {launches['graph']}")
        if not (all(len(losses[r]) == TINY_STEPS for r in losses)
                and max(err.values()) <= TINY_TOL):
            raise AssertionError(f"the card's bert-tiny {attn_impl} losses disagree with the "
                                 "CPU's")
        _graph_against_eager(params["graph"], params["eager"], params["eager2"],
                             f"[train] bert-tiny f32 {attn_impl}:")
        # the refit: init_state moved the module's tensors and made new moments
        # while the first fit's state stayed alive; its graphs must go with it
        off = [k for k in params["graph"] if not np.array_equal(params["refit"][k],
                                                                 params["graph"][k])]
        same_losses = np.array_equal(losses["refit"], losses["graph"])
        log(f"[train] bert-tiny f32 {attn_impl}: a second graph fit on the same trainer (the "
            f"first fit's state kept) against the first fit on a fresh trainer: losses bitwise "
            f"equal {same_losses}, parameters differing {off or 'none'} (of "
            f"{len(params['graph'])}); "
            f"captures {captures['graph']:g} and {captures['refit']:g} (want 1 each)")
        if off or not same_losses or captures != {"graph": 1, "refit": 1}:
            raise AssertionError(f"bert-tiny {attn_impl}: the second fit on one trainer differs "
                                 f"from a fresh trainer's ({off}, losses equal {same_losses}) "
                                 f"or captured {captures}")
        n = cfg.n_layers * TINY_STEPS if attn_impl == "flash" else 0
        want = {"fwd": {"bf16": 0, "f32": n}, "bwd": {"bf16": 0, "f32": n}}
        if not all(launches[r] == want for r in ("eager", "eager2", "graph", "refit")):
            raise AssertionError(f"bert-tiny {attn_impl} on the card launched {launches}, "
                                 f"want {want} a run")
        for d in total:
            for k in total[d]:
                total[d][k] += launches["eager"][d][k] + launches["graph"][d][k]
    return total


def phase_train_long(device, card: str) -> dict:
    """The long-T training shape of benchmarks/attn_backends.py:27: BERT-base,
    batch 8 x 512 tokens of random ids with a full mask, a Trainer at lr
    5e-5, LONG_STEPS steps on one batch with einsum and then with flash from
    the same init: the median step in device time and the peak memory of
    each; step 1's loss and gradient norm as in main path 3, and before it,
    each layer's gradient at the init (one forward and backward outside the
    timed steps) within TOL_INIT_GRAD of einsum's. Then flash in f32
    compute (TF32 off for matmuls), LONG_F32_STEPS steps from the same init:
    its median step, peak memory and the flash backward group of one
    profiled step; step 1's loss within TOL_STEP1_LOSS of the bf16 flash
    run's."""
    from synapseml_torch.models.nets.bert import BertClassifier

    cfg0 = bert_base()
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, cfg0.vocab_size, (LONG_B, LONG_T)).astype(np.int32),
             "attention_mask": np.ones((LONG_B, LONG_T), np.int32),
             "labels": rng.integers(0, 2, (LONG_B,)).astype(np.int32)}
    init = text_stage._init_params(cfg0, 2, 0)
    out, grads0 = {}, {}
    runs = (("einsum", "einsum", cfg0.dtype, LONG_STEPS), ("flash", "flash", cfg0.dtype, LONG_STEPS),
            ("flash f32", "flash", torch.float32, LONG_F32_STEPS))
    for tag, attn_impl, dtype, n_steps in runs:
        cfg = dataclasses.replace(cfg0, attn_impl=attn_impl, dtype=dtype)
        with torch.device("meta"):
            module = BertClassifier(cfg, 2)
        trainer = trainer_mod.Trainer(module.to_empty(device="cpu"),
                                      trainer_mod.TrainerConfig(learning_rate=5e-5,
                                                                total_steps=1000),
                                      device=device)
        state = trainer.init_state(init_params=init)
        if dtype == cfg0.dtype:
            loss0, _ = trainer.default_loss(trainer._to_device(batch))
            loss0.backward()
            grads0[tag] = {name: p.grad.float().cpu() for name, p in state.params.items()
                           if p.grad is not None}
            for p in state.params.values():
                p.grad = None
            del loss0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_flash_counts()
        events, losses, grad_norms = [], [], []
        for _ in range(n_steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = trainer.train_step(state, batch)
            end.record()
            events.append((start, end))
            losses.append(metrics["loss"])
            grad_norms.append(metrics["grad_norm"])
        torch.cuda.synchronize()
        launches = _flash_counts()
        steps = [s.elapsed_time(e) for s, e in events]
        losses = torch.stack(losses).float().cpu().numpy()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = cfg.n_layers * n_steps
        want = {"fwd": {"bf16": 0, "f32": 0}, "bwd": {"bf16": 0, "f32": 0}}
        if attn_impl == "flash":
            want = {d: {**want[d], KERNEL_NAMES[dtype]: n} for d in want}
        step_ms = statistics.median(steps[LONG_WARMUP:])
        log(f"[long] {tag}, BERT-base batch {LONG_B} x {LONG_T}: median step "
            f"{step_ms:.3f} ms in device time over steps {LONG_WARMUP + 1}-{n_steps} (first "
            f"{steps[0]:.3f}), {LONG_B * LONG_T / step_ms * 1e3:,.0f} tokens/s, peak device "
            f"memory {peak:.2f} GiB; losses {np.round(losses, 4).tolist()}; flash launches "
            f"{launches} (want {want}) | {card}")
        if not (np.isfinite(losses).all() and launches == want):
            raise AssertionError(f"the long-T {tag} steps failed")
        out[tag] = {"step_ms": step_ms, "peak_gib": peak, "loss1": float(losses[0]),
                    "grad_norm1": float(grad_norms[0]), "launches": launches}
        if dtype == torch.float32:
            groups = _profile_train_step(trainer, state, batch, card, step_ms, tag, n=1,
                                         what=f"BERT-base f32 (TF32 off), batch {LONG_B} x "
                                              f"{LONG_T}")
            out[tag]["bwd_group_ms"] = groups.get("flash_bwd kernels")
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    ein, fl = grads0["einsum"], grads0["flash"]
    # held by layer, not by parameter: at the init the deep layers' query and
    # key gradients are orders of magnitude below their value weights'
    # (near-uniform attention over near-equal hidden states), and there
    # delta's rounding (from O in bf16, as in the JAX backward) leaves a
    # rank-1 term of their size in flash's
    groups: dict[str, list[str]] = {}
    for name in ein:
        group = re.match(r"encoder\.layers\.\d+|[^.]+", name).group(0)
        groups.setdefault(group, []).append(name)

    def rel(names):
        return (sum(float((fl[n] - ein[n]).norm()) ** 2 for n in names)
                / sum(float(ein[n].norm()) ** 2 for n in names)) ** 0.5

    by_group = {g: rel(names) for g, names in groups.items()}
    worst = max(by_group, key=by_group.get)
    qk = {n: rel([n]) for n in ein if re.search(r"attn[.][qk][.]weight", n)}
    qk_worst = max(qk, key=qk.get)
    diff = (fl[qk_worst] - ein[qk_worst]).double()
    v_name = re.sub(r"attn[.][qk][.]", "attn.v.", qk_worst)
    log(f"[long] gradients at the init, flash vs einsum, |g_flash - g_einsum| over "
        f"|g_einsum|: all {rel(list(ein)):.3e}; by layer, the worst {by_group[worst]:.3e} "
        f"({worst}; tol {TOL_INIT_GRAD:g}), "
        + ", ".join(f"{g} {v:.2e}" for g, v in by_group.items())
        + f"; query and key weights alone (not held) from {min(qk.values()):.2e} to "
        f"{qk[qk_worst]:.2e} ({qk_worst}: |g_einsum| {float(ein[qk_worst].norm()):.3e}, its "
        f"layer's value weight's {float(ein[v_name].norm()):.3e}; the difference's largest "
        f"singular value over its Frobenius norm "
        f"{float(torch.linalg.matrix_norm(diff, ord=2) / diff.norm()):.3f}, 1 = rank 1)")
    if not (fl.keys() == ein.keys() and by_group[worst] <= TOL_INIT_GRAD):
        raise AssertionError("the long-T flash gradients at the init disagree with einsum's")
    _check_step1(out["flash"]["loss1"], out["einsum"]["loss1"], out["flash"]["grad_norm1"],
                 out["einsum"]["grad_norm1"], "[long]")
    log(f"[long] flash vs einsum step {out['flash']['step_ms']:.3f} vs "
        f"{out['einsum']['step_ms']:.3f} ms, peak {out['flash']['peak_gib']:.2f} vs "
        f"{out['einsum']['peak_gib']:.2f} GiB | {card}")
    f32, d_loss = out["flash f32"], abs(out["flash f32"]["loss1"] - out["flash"]["loss1"])
    log(f"[long] flash f32: step {f32['step_ms']:.3f} ms, peak {f32['peak_gib']:.2f} GiB, the flash "
        f"backward group of one profiled step {f32['bwd_group_ms']} ms; step 1's loss "
        f"{f32['loss1']:.6f} against the bf16 flash run's {out['flash']['loss1']:.6f}, |d| "
        f"{d_loss:.3e} (tol {TOL_STEP1_LOSS:g}) | {card}")
    if not d_loss <= TOL_STEP1_LOSS:
        raise AssertionError("the long-T f32 flash step 1 disagrees with the bf16 flash run's")
    return out


# ---------------- GBDT: LightGBM training and scoring ----------------

# the repo's GBDT configuration: benchmarks/gbdt_higgs1m.py:16-21,54-58
HIGGS_N, HIGGS_TEST, HIGGS_F = 1_000_000, 100_000, 28
HIGGS_PARAMS = dict(objective="binary", num_iterations=100, learning_rate=0.1,
                    num_leaves=31, max_bin=255)


def higgs_data(n: int, n_test: int, f: int, seed: int = 0):
    """The Higgs-1M shape as gbdt_higgs1m.py makes it: float32 features from
    a seed, labels from a sparse linear logit with noise."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n + n_test, f)).astype(np.float32)
    w = rng.normal(size=f)
    w[f // 2:] = 0
    logits = X @ w * 0.5 + rng.normal(size=n + n_test) * 0.5
    return X, (logits > 0).astype(np.float32)


def auc(y: np.ndarray, p: np.ndarray) -> float:
    """Mann-Whitney AUC with average tied ranks, as gbdt_higgs1m.py:74-77."""
    from scipy.stats import rankdata

    ranks = rankdata(p)
    n1 = y.sum()
    n0 = len(y) - n1
    return float((ranks[y == 1].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def _hist_inputs(n, nf, width, num_bins, bin_dtype, device, seed, outside=True):
    """Level-histogram inputs on the card: random bins, grad ~ N(0,1), hess in
    (0, 0.25], presence 0/1 (1 for 90 %), and nodes of the level at base
    width - 1; with ``outside``, a fifth of the rows sit in nodes outside it."""
    g = torch.Generator(device=device).manual_seed(seed)
    bins = torch.randint(0, num_bins, (n, nf), generator=g, device=device).to(bin_dtype)
    grad = torch.randn(n, generator=g, device=device)
    hess = torch.rand(n, generator=g, device=device) * 0.25
    presence = (torch.rand(n, generator=g, device=device) < 0.9).float()
    hi = 2 * width + width // 2 if outside else 2 * width - 1
    node = torch.randint(width - 1, hi, (n,), generator=g, device=device).to(torch.int32)
    if outside:
        node[: n // 10] = 0  # an ancestor: outside the level
    return bins, grad, hess, presence, node


def _hist_case(hist, name, args, scale=None, scratch=None) -> float:
    """One histogram launch against its plain version and a second launch,
    both bitwise; returns max |difference| (0)."""
    got = hist.fixed_point_histogram(*args, scale=scale, scratch=scratch)
    again = hist.fixed_point_histogram(*args, scale=scale, scratch=scratch)
    torch.cuda.synchronize()
    want = hist.fixed_point_histogram_plain(*args)
    err = (got - want).abs().max().item() if want.numel() else 0.0
    same, same2 = torch.equal(got, want), torch.equal(got, again)
    log(f"[kernel] gbdt_hist {name}: bitwise equal to the plain version: {same}, to a second "
        f"launch: {same2} (max|d| {err:.3e})")
    if not (same and same2):
        raise AssertionError(f"gbdt_hist disagrees with its plain version or itself on {name}")
    return err


def phase_gbdt_kernels(device) -> dict:
    """The histogram kernel against its plain version and against itself,
    bitwise, and the per-tree scale pass against its plain version; returns
    the max |difference| at the main path's shapes by kernel."""
    from synapseml_torch.gbdt import hist

    cases = [  # name, N, F, width, num_bins, bin dtype
        ("higgs width 1 u8", HIGGS_N, HIGGS_F, 1, 256, torch.uint8),
        ("higgs width 4 u8", HIGGS_N, HIGGS_F, 4, 256, torch.uint8),
        ("higgs width 32 u8", HIGGS_N, HIGGS_F, 32, 256, torch.uint8),
        ("width 32, 64 bins u8, N not tile-aligned", 300_007, 28, 32, 64, torch.uint8),
        ("width 4, 256 bins i32", 200_003, 13, 4, 256, torch.int32),
        ("width 8, 1024 bins i32", 100_001, 5, 8, 1024, torch.int32),
        ("width 128, 256 bins u8 (more segments than a tile)", 500_000, 28, 128, 256,
         torch.uint8),
        ("width 4, 300 bins i32", 200_000, 7, 4, 300, torch.int32),
        ("width 2, F=40 u8 (two feature groups)", 100_000, 40, 2, 256, torch.uint8),
        ("width 2, 10000 bins i32 (a node split over tiles)", 100_000, 3, 2, 10_000,
         torch.int32),
        ("N=1", 1, HIGGS_F, 1, 256, torch.uint8),
        ("N=0", 0, HIGGS_F, 2, 256, torch.uint8),
    ]
    main_err = 0.0
    scale_err = 0
    for i, (name, n, nf, width, nb, dt) in enumerate(cases):
        bins, grad, hess, presence, node = (
            t[:n].contiguous() for t in _hist_inputs(max(n, 1), nf, width, nb, dt, device, seed=i))
        args = (bins, grad, hess, presence, node, width - 1, width, nb)
        err = _hist_case(hist, f"{name} (N={n}, F={nf})", args)
        if i < 3:
            main_err = max(main_err, err)
        scale = hist.fixed_point_scales(grad, hess, presence)
        torch.cuda.synchronize()
        want_scale = hist.fixed_point_scales_plain(grad, hess, presence)
        scale_err = max(scale_err, (scale - want_scale).abs().max().item())
        if not torch.equal(scale, want_scale):
            raise AssertionError(f"fixed_point_scales disagrees with its plain version on {name}")
        if i == 2:  # the tree's scale and scratch passed in, as grow_tree does
            tree = hist.fixed_point_tree(grad, hess, presence, nf, 6, nb)
            passed = hist.fixed_point_histogram(*args, *tree)
            torch.cuda.synchronize()
            same = torch.equal(passed, hist.fixed_point_histogram(*args))
            log(f"[kernel] gbdt_hist {name} with the per-tree scale and scratch passed in: "
                f"bitwise equal to the scale computed inside: {same}; scratch left zeroed: "
                f"{not bool(tree.scratch.any())}")
            if not (same and not tree.scratch.any()):
                raise AssertionError("the per-tree scale path differs from the per-call one")
            main_err = max(main_err, _hist_case(
                hist, "node totals width 64", (None, grad, hess, presence, node, 63, 64, 1),
                *tree))
            one = torch.full_like(node, 70)
            _hist_case(hist, "node totals, every row in one node",
                       (None, grad, hess, presence, one, 63, 64, 1))
            skew = bins.clone()
            skew[:, 3] = 7  # a feature whose rows all fall in one bin
            _hist_case(hist, "width 32, feature 3 in one bin",
                       (skew, grad, hess, presence, node, 31, 32, nb))
            ops = _device_kernels(lambda: hist.fixed_point_histogram(*args, *tree))
            n_ops = sum(c for _, c, *_ in ops)
            log(f"[kernel] one level launch with the tree's scale and scratch: {n_ops} device "
                f"operation(s) {[key[:60] for key, *_ in ops]} (want at most 2)")
            if not (1 <= n_ops <= 2 and any("gbdt_hist_kernel" in k for k, *_ in ops)):
                raise AssertionError("a level launch ran more than two device operations")
    log("[kernel] fixed_point_scales equal to its plain version in every case")

    rs = np.random.default_rng(7)  # the shapes of tests/test_gbdt.py:973
    for n, wb in [(513, 130), (2048, 512), (100, 31 * 8)]:
        seg = torch.from_numpy(rs.integers(-2, wb + 5, n).astype(np.int32)).to(device)
        data = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32)).to(device)
        got = hist.segment_histogram(seg, data, wb)
        keep = (seg >= 0) & (seg < wb)
        ref = torch.zeros((wb, 3), dtype=torch.float64, device=device).index_add_(
            0, seg[keep].long(), data[keep].double())
        err = (got.double() - ref).abs().max().item()
        log(f"[kernel] gbdt_hist segment_histogram N={n}, {wb} segments, ids out of "
            f"range dropped: max|d| vs float64 segment sum {err:.3e} (tol 1e-5)")
        if not err <= 1e-5:
            raise AssertionError("segment_histogram disagrees with the segment sum")
    return {"gbdt_hist": main_err, "gbdt_hist_scale": float(scale_err)}


def forest_digest(booster) -> str:
    """sha256 of a forest's split features, thresholds (one to one with the
    threshold bins through the bin mapper) and leaf values, tree by tree."""
    h = hashlib.sha256()
    for name in ("feature", "threshold_value", "leaf_value"):
        h.update(np.ascontiguousarray(getattr(booster, name)).tobytes())
    return h.hexdigest()


def _same_forest(a, b) -> bool:
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("feature", "threshold_value", "leaf_value", "gain", "cover",
                         "init_score"))


def phase_gbdt_main(device, card: str) -> dict:
    """LightGBMClassifier on the Higgs-1M shape through the kernel: two fits
    (bitwise equal), held-out scoring, the 'segment' backend beside it, and a
    small fit on the CPU (the kernel's plain version) beside the card's."""
    from synapseml_torch import DataFrame as DF
    from synapseml_torch.gbdt import LightGBMClassifier, hist
    from synapseml_torch.gbdt.trees import derive_max_depth

    X, y = higgs_data(HIGGS_N, HIGGS_TEST, HIGGS_F)
    train = DF.from_dict({"features": X[:HIGGS_N], "label": y[:HIGGS_N]})
    test = DF.from_dict({"features": X[HIGGS_N:]})
    est = LightGBMClassifier(histogram_impl="pallas", device=str(device), **HIGGS_PARAMS)
    depth = derive_max_depth(-1, HIGGS_PARAMS["num_leaves"])
    n_iter = HIGGS_PARAMS["num_iterations"]

    torch.cuda.reset_peak_memory_stats()
    hist.fixed_point_histogram.launches = 0
    hist.fixed_point_scales.launches = 0
    t0 = time.perf_counter()
    model = est.fit(train)
    fit_s = time.perf_counter() - t0
    launches = hist.fixed_point_histogram.launches
    scale_launches = hist.fixed_point_scales.launches
    want = n_iter * (depth + 1)  # one per level, and one for the final level's totals
    measures = model.get_train_measures()
    log(f"[gbdt] fit {HIGGS_N} x {HIGGS_F}, {n_iter} iterations, depth {depth}: {fit_s:.2f} s "
        f"({HIGGS_N * n_iter / fit_s:,.0f} row-iterations/s; binning "
        f"{measures['binning_ms']:.0f} ms, training {measures['training_ms']:.0f} ms), "
        f"gbdt_hist launches {launches} (want {n_iter} x {depth + 1} = {want}), scale "
        f"launches {scale_launches} (want one a tree: {n_iter}), "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    if launches != want or scale_launches != n_iter:
        raise AssertionError(f"gbdt_hist launched {launches} times and its scale pass "
                             f"{scale_launches}, want {want} and {n_iter}")
    booster = model.get_booster()
    if not np.isfinite(booster.leaf_value).all():
        raise AssertionError("non-finite leaf values")
    log(f"[gbdt] forest digest (sha256 of every tree's features, thresholds and leaf "
        f"values): {forest_digest(booster)}")

    second = est.fit(train).get_booster()
    same = _same_forest(booster, second)
    log(f"[gbdt] a second fit gives a bitwise-identical forest: {same}")
    if not same:
        raise AssertionError("two fits of the kernel path differ")

    model.transform(test.limit(1000))  # the trees' first copy to the card
    t0 = time.perf_counter()
    out = model.transform(test)
    score_s = time.perf_counter() - t0
    prob = np.stack(list(out.collect_column("probability")))[:, 1]
    if prob.shape != (HIGGS_TEST,) or not np.isfinite(prob).all():
        raise AssertionError(f"probabilities not finite of shape ({HIGGS_TEST},)")
    held_out_auc = auc(y[HIGGS_N:], prob)
    log(f"[gbdt] transform {HIGGS_TEST} held-out rows: {score_s * 1e3:.1f} ms "
        f"({HIGGS_TEST / score_s:,.0f} rows/s), AUC {held_out_auc:.5f}")

    t0 = time.perf_counter()
    seg_model = est.copy({"histogram_impl": "segment"}).fit(train)
    seg_s = time.perf_counter() - t0
    seg_b = seg_model.get_booster()
    seg_prob = np.stack(list(seg_model.transform(test).collect_column("probability")))[:, 1]
    seg_auc = auc(y[HIGGS_N:], seg_prob)
    first_same = (np.array_equal(seg_b.feature[0], booster.feature[0])
                  and np.array_equal(seg_b.threshold_value[0], booster.threshold_value[0]))
    log(f"[gbdt] 'segment' backend on the card: fit {seg_s:.2f} s, AUC {seg_auc:.5f} "
        f"(|dAUC| {abs(seg_auc - held_out_auc):.2e}, tol 2e-3), same first tree: {first_same}")
    if not (first_same and abs(seg_auc - held_out_auc) <= 2e-3):
        raise AssertionError("the 'segment' fit disagrees with the kernel's")

    small = DF.from_dict({"features": X[:20_000], "label": y[:20_000]})
    small_est = est.copy({"num_iterations": 10})
    on_card = small_est.fit(small).get_booster()
    on_cpu = small_est.copy({"device": "cpu"}).fit(small).get_booster()
    same_split = np.array_equal(on_card.feature, on_cpu.feature)
    log(f"[gbdt] 20000 rows, 10 iterations, card (kernel) vs CPU (plain version): same "
        f"split features in every tree: {same_split}, max|d leaf| "
        f"{np.abs(on_card.leaf_value - on_cpu.leaf_value).max():.3e}")
    if not same_split:
        raise AssertionError("the card's forest splits differently from the CPU's")

    _profile_gbdt_iteration(booster, X[:HIGGS_N], y[:HIGGS_N], device, depth)
    return {"launches": launches, "scale_launches": scale_launches, "fit_s": fit_s,
            "auc": held_out_auc}


_GBDT_GROUPS = (("gbdt_hist kernel", ("gbdt_hist_kernel", "gbdt_scale_kernel")),
                ("memset", ("memset",)),
                ("gather / index / scatter", ("gather", "index", "scatter")),
                ("sort / scan", ("sort", "scan", "radix")),
                ("reduce", ("reduce",)),
                ("elementwise", ("elementwise", "vectorized", "fill")))


def _profile_gbdt_iteration(booster, X, y, device, depth, n=3) -> None:
    """Where the device time of one boosting iteration at the Higgs shape
    goes: the iteration's device work (grad/hess, one tree, the score
    update) by kernel group, and the share of its wall time the card is busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from synapseml_torch.gbdt import objectives, trees

    mapper = booster.bin_mapper
    bins = torch.from_numpy(mapper.transform(X)).to(device)
    yd = torch.from_numpy(y).to(device)
    o = objectives.get_objective("binary")
    scores = o.init_score(yd).reshape(1, 1).repeat(len(y), 1)
    presence = torch.ones(len(y), device=device)
    fmask = torch.ones(X.shape[1], dtype=torch.bool, device=device)
    cfg = trees.GrowthConfig(max_depth=depth, num_leaves=31, num_bins=mapper.num_bins,
                             lambda_l1=0.0, lambda_l2=0.0, learning_rate=0.1,
                             min_data_in_leaf=20, min_sum_hessian=1e-3,
                             min_gain_to_split=0.0, hist_impl="pallas")

    def iteration():
        g, h = o.grad_hess(scores, yd)
        tree = trees.grow_tree(bins, g.contiguous(), h.contiguous(), presence, cfg, fmask)
        scores[:, 0] += trees.traverse_binned(bins, tree, depth)

    iteration()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            iteration()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [(e.self_device_time_total / n / 1e3, e.count // n, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(k[0] for k in kernels)
    if not busy:
        log("[profile] the profiler recorded no device time")
        return
    log(f"[profile] one boosting iteration at {len(y)} x {X.shape[1]}: {wall_ms:.3f} ms wall, "
        f"{busy:.3f} ms of device kernels ({100 * busy / wall_ms:.1f}% busy, "
        f"{100 - 100 * busy / wall_ms:.1f}% idle), "
        f"{sum(k[1] for k in kernels)} device kernels")
    groups = {name: 0.0 for name, _ in _GBDT_GROUPS}
    groups["other"] = 0.0
    for ms, _, key in kernels:
        name = next((g for g, pats in _GBDT_GROUPS if any(p in key.lower() for p in pats)),
                    "other")
        groups[name] += ms
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] group {name}: {ms:.4f} ms/iteration ({100 * ms / busy:.1f}% of device time)")
    for ms, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"[profile] {100 * ms / busy:5.1f}%  {ms:8.4f} ms/iteration  {count:4d}/iteration  "
            f"{key[:90]}")


def phase_gbdt_times(device, card: str, launches: dict, max_err: dict) -> list[dict]:
    """The kernel at each shape one tree of the main path gives it (levels of
    width 1..32, then the final level's totals at width 64), called as
    grow_tree calls it (the tree's scale and scratch passed in), beside its
    bound, its plain version and one index_add_ on precomputed flat ids, all
    in device time; ``call_ms`` is one call as the host sees it, its enqueue
    included. Then the per-tree scale pass. The JSON rows carry the mean per
    level launch over the 7 shapes, and the scale pass."""
    from synapseml_torch.gbdt import hist

    n, nf, nb = HIGGS_N, HIGGS_F, 256
    depth = 6
    keys = ("ms", "ms2", "plain_ms", "library_ms", "library_ms2", "call_ms")
    tot = dict.fromkeys(keys, 0.0)
    tot_bytes = 0
    shapes = [(2 ** d, nb, nf) for d in range(depth)] + [(2 ** depth, 1, 1)]
    for width, b, f in shapes:
        bins, grad, hess, presence, node = _hist_inputs(n, nf, width, nb, torch.uint8,
                                                        device, seed=width, outside=False)
        kbins = bins if b > 1 else None
        args = (kbins, grad, hess, presence, node, width - 1, width, b)
        tree = hist.fixed_point_tree(grad, hess, presence, nf, depth, nb)
        rel = (node - (width - 1)).long()
        data = torch.stack([grad, hess, presence], 1)
        if kbins is None:
            ids, flat_data = rel, data
        else:
            ids = ((rel[:, None] * f + torch.arange(f, device=device)) * b + bins.long()).reshape(-1)
            flat_data = data.repeat_interleave(f, dim=0)

        def kernel():
            return hist.fixed_point_histogram(*args, *tree)

        def library():
            return torch.zeros((width * f * b, 3), device=device).index_add_(0, ids, flat_data)

        t = dict(zip(("ms", "library_ms", "ms2", "library_ms2"),
                     (device_ms(fn) for fn in (kernel, library, kernel, library))))
        t["plain_ms"] = device_ms(lambda: hist.fixed_point_histogram_plain(*args),
                                  warmup=1, iters=5)
        t["call_ms"] = cuda_ms(kernel)
        n_bytes = (n * f if kbins is not None else 0) + 4 * n * 4 + width * f * b * 3 * 4
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        what = f"level width {width}" if kbins is not None else f"final totals width {width}"
        log(f"[times] gbdt_hist {what} [N={n}, F={f}, B={b}]: kernel {t['ms']:.4f} / "
            f"{t['ms2']:.4f} ms (device time, two turns; one call with its host enqueue "
            f"{t['call_ms']:.4f} ms), bound {bound:.4f} ms (bytes: {n_bytes / 1e6:.1f} MB), "
            f"plain {t['plain_ms']:.4f} ms, index_add_ {t['library_ms']:.4f} / "
            f"{t['library_ms2']:.4f} ms | {card}")
        for k in keys:
            tot[k] += t[k]
        tot_bytes += n_bytes

    grad, hess, presence = _hist_inputs(n, 1, 1, 2, torch.uint8, device, seed=0)[1:4]
    scale_ms = device_ms(lambda: hist.fixed_point_scales(grad, hess, presence))
    scale_plain_ms = device_ms(lambda: hist.fixed_point_scales_plain(grad, hess, presence),
                               warmup=1, iters=5)
    scale_call_ms = cuda_ms(lambda: hist.fixed_point_scales(grad, hess, presence))
    scale_bytes = 3 * n * 4 + 8 * 4  # grad, hess, presence; the int32 [8] buffer
    scale_bound = scale_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[times] gbdt_hist scale pass [N={n}]: {scale_ms:.4f} ms (device time, zero fill and "
        f"kernel; one call with its host enqueue {scale_call_ms:.4f} ms), bound "
        f"{scale_bound:.4f} ms (bytes: {scale_bytes / 1e6:.1f} MB), plain "
        f"{scale_plain_ms:.4f} ms | {card}")
    k = len(shapes)
    tree_ms = statistics.median([tot["ms"], tot["ms2"]]) + scale_ms
    tree_bound = (tot_bytes + scale_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"[times] gbdt_hist one tree ({k} launches and the scale pass): kernel {tree_ms:.4f} ms "
        f"(device time; {tree_ms / tree_bound:.2f}x the bound), bound {tree_bound:.4f} ms, "
        f"plain {tot['plain_ms'] + scale_plain_ms:.4f} ms, index_add_ "
        f"{statistics.median([tot['library_ms'], tot['library_ms2']]):.4f} ms, one call each "
        f"with its host enqueue {tot['call_ms'] + scale_call_ms:.4f} ms | {card}")
    source = "synapseml_torch/csrc/gbdt_hist.cu"
    replaces = "synapseml_tpu/gbdt/pallas_hist.py:35"
    return [{"name": "gbdt_hist", "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches["gbdt_hist"], "max_abs_err": max_err["gbdt_hist"],
             "ms": statistics.median([tot["ms"], tot["ms2"]]) / k, "plain_ms": tot["plain_ms"] / k,
             "bound_ms": tot_bytes / k / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "library_ms": statistics.median([tot["library_ms"], tot["library_ms2"]]) / k},
            {"name": "gbdt_hist_scale", "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches["gbdt_hist_scale"], "max_abs_err": max_err["gbdt_hist_scale"],
             "ms": scale_ms, "plain_ms": scale_plain_ms, "bound_ms": scale_bound,
             "bound_by": "bytes", "library_ms": None}]


# ---------------------------------------------------------------------------
# main path 4: ONNXModel scoring a torch-exported ResNet-50
# ---------------------------------------------------------------------------

ONNX_PARTS = (216, 176, 128)  # 520 images: 3x64 + 24 (a rung of 32), 2x64 + 48 (64), 2x64
ONNX_BATCH = 64               # mini_batch_size, the JAX stage's default
# logits and features against the torch module, both strict f32 on the card:
# tighter than tests/test_onnx_resnet.py's full-size 1e-3, so that a path
# that let TF32 into its convolutions fails (the control in phase_onnx)
ONNX_TOL = 1e-5
ONNX_TIE = 1e-3               # argmax is compared where the top two logits differ by more
ONNX_CPU_N, ONNX_CPU_TOL = 4, 1e-4
_ONNX_GROUPS = (("pooling", ("pool",)),  # matched in lower case, first match wins
                ("convolutions", ("fprop", "conv", "implicit", "winograd", "fft", "flip_filter",
                                  "cf32")),  # cf32: the complex products of cuDNN's FFT algorithm
                ("matmul (fc)", ("gemm", "nvjet", "cutlass", "cublas")),
                ("host-to-device copies", ("htod",)),
                ("device-to-host copies", ("dtoh",)),
                ("elementwise", ("elementwise", "vectorized", "relu", "add", "softmax",
                                 "argmax", "reduce")))


class _Bottleneck(torch.nn.Module):
    def __init__(self, cin, width, stride=1, downsample=None):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + idt)


class _ResNet50(torch.nn.Module):
    """torchvision's ResNet-50 layout: (3, 4, 6, 3) bottlenecks, width 64,
    1000 classes, the layer names of tests/_torch_resnet.py."""

    def __init__(self, layers=(3, 4, 6, 3), num_classes=1000, width0=64):
        super().__init__()
        nn = torch.nn
        self.conv1 = nn.Conv2d(3, width0, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(width0)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin, stages = width0, []
        for i, n in enumerate(layers):
            width, stride = width0 * 2 ** i, 1 if i == 0 else 2
            down = nn.Sequential(nn.Conv2d(cin, width * 4, 1, stride, bias=False),
                                 nn.BatchNorm2d(width * 4))
            blocks = [_Bottleneck(cin, width, stride, down)]
            cin = width * 4
            blocks += [_Bottleneck(cin, width) for _ in range(n - 1)]
            stages.append(nn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3, self.layer4 = stages
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.fc = nn.Linear(cin, num_classes)

    def features(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return self.avgpool(x).flatten(1)

    def forward(self, x):
        return self.fc(self.features(x))


def _resnet50(seed: int) -> torch.nn.Module:
    """ResNet-50 with torch's initialisers from ``seed``, and BatchNorm's
    scale, shift and running statistics drawn from it too, so that the
    exporter's folded conv biases are not zero."""
    torch.manual_seed(seed)
    model = _ResNet50()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo, hi in ((m.weight, 0.5, 1.5), (m.bias, -0.1, 0.1),
                                  (m.running_mean, -0.1, 0.1), (m.running_var, 0.5, 1.5)):
                    t.uniform_(lo, hi, generator=gen)
    return model.eval()


def _export_onnx(model, example) -> bytes:
    """``torch.onnx.export`` (the TorchScript exporter) with an ``onnx``
    stand-in backed by the port's codec: the exporter loads its own output
    back only to look for custom onnxscript functions, of which a convnet
    has none. The stand-in has a real module spec (a spec-less module in
    sys.modules breaks a later ``find_spec("onnx")``) and leaves
    sys.modules as it found it."""
    class _Loaded:
        def __init__(self, data):
            self.graph, self.functions = onnx_proto.parse_model(data).graph, []

    stand_in = importlib.util.module_from_spec(importlib.machinery.ModuleSpec("onnx", None))
    stand_in.load_model_from_string = _Loaded
    saved = sys.modules.get("onnx")
    sys.modules["onnx"] = stand_in
    try:
        buf = io.BytesIO()
        torch.onnx.export(model, example, buf, dynamo=False, input_names=["input"],
                          output_names=["logits"],
                          dynamic_axes={"input": {0: "N"}, "logits": {0: "N"}})
    finally:
        if saved is None:
            sys.modules.pop("onnx", None)
        else:
            sys.modules["onnx"] = saved
    return buf.getvalue()


def _onnx_column(df, col) -> np.ndarray:
    return np.concatenate([p[col] for p in df.partitions], axis=0)


def _port_kernel_counts() -> dict:
    from synapseml_torch.gbdt import hist

    return {**{f"flash_{k}": sum(v.values()) for k, v in _flash_counts().items()},
            "gbdt_hist": hist.fixed_point_histogram.launches,
            "gbdt_hist_scale": hist.fixed_point_scales.launches}


def _zero_port_kernel_counts() -> None:
    from synapseml_torch.gbdt import hist

    _zero_flash_counts()
    hist.fixed_point_histogram.launches = hist.fixed_point_scales.launches = 0


def _profile_onnx_batch(fn, card: str, n=3) -> dict:
    """Where the device time of one scored batch of 64 goes (its input copy,
    the graph, the post-columns, the copy back), by group, and the share of
    its wall time the card is busy under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        # late in a long process a session can miss some launches: each
        # operation's time a batch is its mean over the launches recorded
        # times its launches a batch (recorded over n, rounded up)
        kernels = [(e.self_device_time_total / e.count * -(-e.count // n) / 1e3,
                    -(-e.count // n), e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if kernels:
            break
        log(f"[profile] session {attempt + 1} recorded no device kernel; profiling again")
    busy = sum(k[0] for k in kernels)
    if not busy:
        raise AssertionError("the profiler recorded no device time for an ONNX batch")
    groups = {name: 0.0 for name, _ in _ONNX_GROUPS}
    groups["other"] = 0.0
    for ms, _, key in kernels:
        name = next((g for g, pats in _ONNX_GROUPS if any(p in key.lower() for p in pats)),
                    "other")
        groups[name] += ms
    log(f"[profile] onnx one ResNet-50 batch of {ONNX_BATCH} (transform of one partition): "
        f"{wall_ms:.3f} ms wall, {busy:.3f} ms of device time ({100 * busy / wall_ms:.1f}% "
        f"busy, {100 - 100 * busy / wall_ms:.1f}% idle), "
        f"{sum(k[1] for k in kernels)} device operations | {card}")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] onnx group {name}: {ms:.4f} ms/batch ({100 * ms / busy:.1f}% of device "
            f"time)")
    for ms, count, key in sorted(kernels, reverse=True)[:12]:
        log(f"[profile] onnx {100 * ms / busy:5.1f}%  {ms:8.4f} ms/batch  {count:4d}/batch  "
            f"{key[:160]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy": busy / wall_ms, "groups": groups}


FEAT_PARTS = (20, 12)  # raw images of 230-330 pixels a side through ImageFeaturizer


def _check_image_featurizer(model, data: bytes, flat: str, device, card: str) -> float:
    """Main path 5 (c): ImageFeaturizer(device='cuda') on the ResNet-50
    export cut at its Flatten output, over raw images of varied sizes
    (resize of the short side to 256, center crop 224, ImageNet
    normalisation on the host), against the torch module's avgpool features
    of the same preprocessing (this package's ImageTransformer) on the card,
    both strict f32: within ONNX_TOL."""
    rs = np.random.default_rng(3)
    parts = []
    for n in FEAT_PARTS:
        col = np.empty(n, dtype=object)
        col[:] = [rs.integers(0, 256, size=(int(rs.integers(230, 330)),
                                            int(rs.integers(230, 330)), 3)).astype(np.float32)
                  for _ in range(n)]
        parts.append({"image": col})
    df = DataFrame(parts)
    feat = ImageFeaturizer(input_col="image", output_col="features", feature_tensor_name=flat,
                           mini_batch_size=ONNX_BATCH, device=str(device)).set(model_payload=data)
    _zero_port_kernel_counts()
    t0 = time.perf_counter()
    got = _onnx_column(feat.transform(df), "features")
    secs = time.perf_counter() - t0
    counts = _port_kernel_counts()
    it = (ImageTransformer(input_col="image", output_col="x")
          .resize(size=256, keep_aspect_ratio=True).center_crop(224, 224)
          .normalize(means=IMAGENET_MEANS, stds=IMAGENET_STDS, color_scale_factor=1 / 255.0))
    x = _onnx_column(it.transform(df), "x")
    with torch.inference_mode():
        want = model.features(torch.from_numpy(x).to(device)).cpu().numpy()
    err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    log(f"[vision] ImageFeaturizer on the ResNet-50 export cut at {flat!r}: {sum(FEAT_PARTS)} "
        f"raw images in {len(FEAT_PARTS)} partitions, {secs:.3f} s host clock "
        f"(preprocessing included); features {got.shape} against the torch module's avgpool "
        f"output: max |diff| {err:.3e} (limit {ONNX_TOL}); the port's kernels launched: "
        f"{counts} | {card}")
    if err > ONNX_TOL or any(counts.values()):
        raise AssertionError("ImageFeaturizer's features disagree with the torch module's")
    return err


def phase_onnx(device, card: str) -> dict:
    """Main path 4: ``ONNXModel(device='cuda').transform`` scores 520
    random 3 x 224 x 224 images with a torch-exported ResNet-50 (full width
    and depth, weights from seed 0) over 3 partitions at mini_batch_size 64,
    with softmax and argmax columns, and holds the result to the torch
    module on the card, to the port on the CPU, to itself on a second
    transform, and its features (the graph sliced at the Flatten output) to
    the module's."""
    model = _resnet50(seed=0)
    t0 = time.perf_counter()
    data = _export_onnx(model, torch.zeros(1, 3, 224, 224))
    export_s = time.perf_counter() - t0
    graph = onnx_proto.parse_model(data).graph
    ops = {}
    for node in graph.node:
        ops[node.op_type] = ops.get(node.op_type, 0) + 1
    log(f"[onnx] ResNet-50 exported by torch {torch.__version__}'s TorchScript exporter: "
        f"{len(data)} bytes, {len(graph.initializer)} initializers, {len(graph.node)} nodes "
        f"{ops}, in {export_s:.2f} s")
    n = sum(ONNX_PARTS)
    x = np.random.default_rng(0).standard_normal((n, 3, 224, 224), dtype=np.float32)

    model = model.to(device)
    want, want_feat = [], []
    with torch.inference_mode():
        for s in range(0, n, ONNX_BATCH):
            feat = model.features(torch.from_numpy(x[s:s + ONNX_BATCH]).to(device))
            want_feat.append(feat.cpu().numpy())
            want.append(model.fc(feat).cpu().numpy())
    want, want_feat = np.concatenate(want), np.concatenate(want_feat)
    log(f"[onnx] the torch module's logits on the card: max |logit| {np.abs(want).max():.4f}, "
        f"std {want.std():.4f}")

    kw = dict(mini_batch_size=ONNX_BATCH, feed_dict={"input": "image"},
              fetch_dict={"logits": "logits"}, softmax_dict={"logits": "probs"},
              argmax_dict={"logits": "prediction"})
    stage = ONNXModel(model_bytes=data, device=str(device), **kw)
    t0 = time.perf_counter()
    conv = stage.converted
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    conv.weights_on(device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    log(f"[onnx] parse + convert {len(data) / 1e6:.1f} MB: {convert_s:.3f} s host; weights "
        f"to the card once: {upload_s:.3f} s")

    parts, at = [], 0
    for size in ONNX_PARTS:
        parts.append({"image": x[at:at + size], "row": np.arange(at, at + size)})
        at += size
    df = DataFrame(parts)
    rungs = sorted({b for size in ONNX_PARTS
                    for *_, b in cb.default_bucketer().slices(size, ONNX_BATCH)})
    cache = cb.get_compiled_cache()
    misses0 = cache.miss_count("onnx_model")
    _zero_port_kernel_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out1 = stage.transform(df)
    first_s = time.perf_counter() - t0
    misses = cache.miss_count("onnx_model") - misses0
    t0 = time.perf_counter()
    out2 = stage.transform(df)
    second_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _port_kernel_counts()
    log(f"[onnx] transform of {n} images: {first_s:.3f} s first ({n / first_s:.1f} images/s), "
        f"{second_s:.3f} s second ({n / second_s:.1f} images/s, host clock); peak device "
        f"memory {peak_gib:.3f} GiB | {card}")
    log(f"[onnx] CompiledCache misses: {misses:.0f} on the first transform (rungs used "
        f"{rungs}), {cache.miss_count('onnx_model') - misses0 - misses:.0f} on the second; "
        f"the port's kernels launched on this path: {counts}")
    if misses != len(rungs) or cache.miss_count("onnx_model") - misses0 != len(rungs):
        raise AssertionError("ONNXModel did not take one callable per rung from CompiledCache")
    if any(counts.values()):
        raise AssertionError(f"the ONNX path launched a kernel of the port's: {counts}")

    logits = _onnx_column(out1, "logits")
    err = float(np.abs(logits - want).max())
    top2 = np.sort(want, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > ONNX_TIE
    pred = _onnx_column(out1, "prediction")
    probs = _onnx_column(out1, "probs")
    agree = int((pred[clear] == want.argmax(-1)[clear]).sum())
    log(f"[onnx] logits against the torch module: max |diff| {err:.3e} (limit {ONNX_TOL}); "
        f"argmax equal on {agree} of the {int(clear.sum())} images whose top two logits "
        f"differ by more than {ONNX_TIE} ({n} images); rows sum of probs within "
        f"{np.abs(probs.sum(-1) - 1).max():.2e} of 1")
    if not (logits.shape == (n, 1000) and np.isfinite(logits).all() and err <= ONNX_TOL):
        raise AssertionError("ONNXModel's ResNet-50 logits disagree with the torch module")
    if agree != int(clear.sum()) or pred.dtype != np.int32:
        raise AssertionError("ONNXModel's argmax disagrees with the torch module's")
    if not (np.isfinite(probs).all() and np.abs(probs.sum(-1) - 1).max() <= 1e-5):
        raise AssertionError("ONNXModel's softmax column is not a distribution")
    if not (_onnx_column(out1, "row") == np.arange(n)).all():
        raise AssertionError("ONNXModel lost the rows' order")
    same = all(np.array_equal(p[c], q[c]) for p, q in zip(out1.partitions, out2.partitions)
               for c in p)
    log(f"[onnx] a second transform bitwise the first: {same}")
    if not same:
        raise AssertionError("a second ONNXModel transform differs from the first")

    cpu = ONNXModel(model_bytes=data, device="cpu", **kw)
    got_cpu = _onnx_column(cpu.transform(DataFrame([{"image": x[:ONNX_CPU_N]}])), "logits")
    err_cpu = float(np.abs(got_cpu - logits[:ONNX_CPU_N]).max())
    log(f"[onnx] {ONNX_CPU_N} images through the port on the CPU against the card: max |diff| "
        f"{err_cpu:.3e} (limit {ONNX_CPU_TOL})")
    if err_cpu > ONNX_CPU_TOL:
        raise AssertionError("ONNXModel on the CPU disagrees with the card")

    flat = next(node.output[0] for node in graph.node if node.op_type == "Flatten")
    feat_stage = ONNXModel(model_bytes=data, device=str(device), mini_batch_size=ONNX_BATCH,
                           feed_dict={"input": "image"}, fetch_dict={"features": flat})
    sliced = feat_stage.slice_at_outputs([flat])
    feats = _onnx_column(sliced.transform(df), "features")
    err_feat = float(np.abs(feats - want_feat).max())
    log(f"[onnx] slice_at_outputs([{flat!r}]): features {feats.shape} (max |feature| "
        f"{np.abs(want_feat).max():.4f}), max |diff| from the module's avgpool output "
        f"{err_feat:.3e} (limit {ONNX_TOL})")
    if feats.shape != want_feat.shape or err_feat > ONNX_TOL:
        raise AssertionError("the sliced ResNet-50's features disagree with the module's")

    xb = x[:ONNX_BATCH]
    xb_dev = torch.from_numpy(xb).to(device)
    # the control: one batch through both graphs with TF32 allowed in the
    # convolutions and matmuls must fail the limits, else they could not
    # tell a TF32 path from the strict f32 one
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            tf32 = conv.run({"input": xb_dev}, device)["logits"].cpu().numpy()
            tf32_feat = sliced.converted.run({"input": xb_dev}, device)[flat].cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    ctl = float(np.abs(tf32 - want[:ONNX_BATCH]).max())
    ctl_feat = float(np.abs(tf32_feat - want_feat[:ONNX_BATCH]).max())
    log(f"[onnx] control, one batch of {ONNX_BATCH} with TF32 allowed: max |diff| from the "
        f"module's f32 logits {ctl:.3e}, features {ctl_feat:.3e} (each must exceed the limit "
        f"{ONNX_TOL}) | {card}")
    if not (ctl > ONNX_TOL and ctl_feat > ONNX_TOL):
        raise AssertionError("the ONNX limits pass a TF32 run: they cannot tell it from f32")

    def graph_batch():
        with torch.inference_mode():
            conv.run({"input": xb_dev}, device)

    def module_batch():
        with torch.inference_mode():
            model(xb_dev)

    batch_ms = device_ms(graph_batch, warmup=3, iters=20)
    module_ms = device_ms(module_batch, warmup=3, iters=20)
    copy_ms = cuda_ms(lambda: torch.from_numpy(xb).to(device), warmup=3, iters=20)
    log(f"[onnx] a full batch of {ONNX_BATCH}: graph {batch_ms:.3f} ms device time "
        f"({1e3 * ONNX_BATCH / batch_ms:.1f} images/s), the torch module (BatchNorm unfolded) "
        f"{module_ms:.3f} ms; one batch's input copy ({xb.nbytes / 1e6:.1f} MB, pageable) "
        f"{copy_ms:.3f} ms ({xb.nbytes / copy_ms / 1e6:.2f} GB/s) | {card}")
    one = DataFrame([{"image": xb}])
    prof = _profile_onnx_batch(lambda: stage.transform(one), card)
    feat_err = _check_image_featurizer(model, data, flat, device, card)
    del model, conv, xb_dev
    _free_card()
    return {"images_s": n / second_s, "images_s_first": n / first_s, "batch_ms": batch_ms,
            "module_ms": module_ms, "copy_ms": copy_ms, "peak_gib": peak_gib,
            "convert_s": convert_s, "upload_s": upload_s, "export_s": export_s,
            "busy": prof["busy"], "max_abs_err": err, "max_abs_err_feat": err_feat,
            "tf32_err": ctl, "tf32_err_feat": ctl_feat, "launches": counts,
            "featurizer_err": feat_err}


# ---------------- main path 5: vision ----------------

# ViT-B/16 fine-tuning as benchmarks/vit_finetune.py:16-27 runs it: batch 64
# at 224 x 224, 1000 classes, TrainerConfig(learning_rate=1e-4,
# total_steps=1000), chunks of 16 steps through Trainer.train_steps_scan
VIT_B, VIT_HW, VIT_CLASSES, VIT_PATCH = 64, 224, 1000, 16
VIT_K = 16
VIT_CHUNKS = 2  # a fit's chunks: the eager warm-up, then the capture and its replay
VIT_POOL = 4    # distinct random batches, cycled over a chunk's steps
VIT_LR, VIT_TOTAL = 1e-4, 1000
VIT_EAGER_SKIP = 3  # eager steps left out of the step time
VIT_REPLAYS = 3     # timed replays of a fitted chunk graph
# flash against einsum at step 1 of ViT-B/16 (loss, and the gradient norm
# relative to einsum's): the limit of main path 3's scores (3e-2)
TOL_VIT_STEP1 = 3e-2
# the flash kernels at the ViT-B/16 shape: B*H = 64 x 12, 197 tokens, no mask
VIT_H, VIT_T, VIT_D = 12, 1 + (VIT_HW // VIT_PATCH) ** 2, 64
VIT_BH = VIT_B * VIT_H
# the stages: DeepVisionClassifier fits of a few steps at batch 32 (the
# stage's default), then each fitted model scores the images of STAGE_PARTS
STAGE_ROWS, STAGE_STEPS, STAGE_BATCH = 256, 16, 32
STAGE_PARTS = (150, 106)  # images scored a fitted model, by partition: 4 x 32 + 22, 3 x 32 + 10
VISION_CPU_N, VISION_CPU_TOL = 4, 1e-4  # f32 scores, the card against the port on the CPU


class _GraphRecorder:
    """Keeps the _ChunkGraph that a fit replays, for timing and profiling its
    replay after the fit. Restores the method on exit."""

    def __init__(self):
        self.runner = None

    def __enter__(self):
        orig = self._orig = trainer_mod._ChunkGraph.__call__
        rec = self

        def call(runner, *args, **kwargs):
            rec.runner = runner
            return orig(runner, *args, **kwargs)

        trainer_mod._ChunkGraph.__call__ = call
        return self

    def __exit__(self, *exc):
        trainer_mod._ChunkGraph.__call__ = self._orig


def _vit_data(seed: int = 0):
    """VIT_POOL random batches of VIT_B images (N(0, 1) pixels) and labels
    from ``seed``, cycled over VIT_K steps; and those steps stacked."""
    rs = np.random.default_rng(seed)
    pool = [{"x": rs.standard_normal((VIT_B, VIT_HW, VIT_HW, 3), dtype=np.float32),
             "labels": rs.integers(0, VIT_CLASSES, VIT_B).astype(np.int32)}
            for _ in range(VIT_POOL)]
    batches = [pool[i % VIT_POOL] for i in range(VIT_K)]
    return batches, {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _vit_trainer(attn_impl: str, init: dict, device):
    with torch.device("meta"):
        module = ViTClassifier(vit_b16(attn_impl=attn_impl), num_classes=VIT_CLASSES,
                               patch=VIT_PATCH)
    trainer = trainer_mod.Trainer(module.to_empty(device="cpu"),
                                  trainer_mod.TrainerConfig(learning_rate=VIT_LR,
                                                            total_steps=VIT_TOTAL),
                                  device=device)
    return trainer, trainer.init_state(init_params=init)


def _profile_replay(runner, card: str, tag: str, want_flash, steps: int) -> dict:
    """One replay of a fitted chunk graph under the profiler (traced from a
    warm-up cycle before it, as _ChunkTimer does): its wall time, busy share
    and device time by group. A session that recorded no kernel, or other
    flash kernel counts than ``want_flash``, lost records: it is taken again,
    up to PROFILE_TRIES sessions."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            torch.cuda._sleep(SPIN // 10)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            runner.graph.replay()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")]
        if kernels and _flash_named(kernels) == tuple(want_flash):
            busy = sum(k[0] for k in kernels)
            log(f"[profile] one replayed {tag} chunk of {steps} steps: {wall_ms:.3f} ms wall, "
                f"{busy:.3f} ms of device kernels ({100 * busy / wall_ms:.1f}% busy, "
                f"{100 - 100 * busy / wall_ms:.1f}% idle under the profiler), "
                f"{sum(k[1] for k in kernels)} device kernels; flash forward and backward "
                f"kernels {_flash_named(kernels)} | {card}")
            groups = _log_groups(kernels, busy, tag, steps)
            return {"busy": busy / wall_ms, "groups": groups, "flash": _flash_named(kernels)}
        log(f"[profile] session {attempt + 1} of a {tag} replay recorded "
            f"{_flash_named(kernels) if kernels else 'no'} flash kernels of {tuple(want_flash)}; "
            f"profiling again")
    raise AssertionError(f"no profile of a {tag} replay recorded its kernels")


def _vit_graph_fit(init, stacked, device, card: str, attn_impl: str, n_params: int) -> dict:
    """ViT-B/16 through Trainer.train_steps_scan, VIT_CHUNKS chunks of VIT_K
    steps (an eager warm-up on the side stream, then a capture and its
    replay), the flash counts set to 0 just before and read just after; then
    the captured graph's replay timed in device time and profiled (those
    replays train on, so the parameters are read first)."""
    trainer, state = _vit_trainer(attn_impl, init, device)
    cache = cb.get_compiled_cache()
    misses0 = cache.miss_count("train_steps_scan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses, norms = [], [], []
    _zero_flash_counts()
    with _GraphRecorder() as rec:
        for _ in range(VIT_CHUNKS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = trainer.train_steps_scan(state, stacked)
            end.record()
            events.append((start, end))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
    launches = _flash_counts()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    captures = cache.miss_count("train_steps_scan") - misses0
    losses = torch.cat(losses).float().cpu().numpy()
    params = {k: v.detach().cpu().numpy() for k, v in state.params.items()}
    still = [k for k in params if np.array_equal(params[k], init[k])]
    chunk_ms = [s.elapsed_time(e) for s, e in events]
    log(f"[vision] ViT-B/16 {attn_impl} graph fit: per-step loss {np.round(losses, 4).tolist()}; "
        f"parameters that did not move: {still or 'none'}; captures {captures:g} (want 1); "
        f"chunks of {VIT_K} steps {[round(c, 3) for c in chunk_ms]} ms by CUDA events (the "
        f"eager warm-up, then the capture and its replay, host copies included); flash "
        f"launches {launches} | {card}")
    if not np.isfinite(losses).all() or still or captures != 1 or rec.runner is None:
        raise AssertionError(f"ViT-B/16 {attn_impl} graph fit: non-finite losses, parameters "
                             f"that did not move ({still}) or {captures} captures")
    # the fit's last chunk replayed the graph already: each timed replay alone
    replays = [cuda_ms(rec.runner.graph.replay, warmup=0, iters=1, spin_cycles=SPIN)
               for _ in range(VIT_REPLAYS)]
    step_ms = statistics.median(replays) / VIT_K
    n_flash = vit_b16().n_layers * VIT_K if attn_impl == "flash" else 0
    prof = _profile_replay(rec.runner, card, f"ViT-B/16 {attn_impl}", (n_flash, n_flash),
                           VIT_K)
    out = _vit_numbers(f"{attn_impl} graph", step_ms, peak_gib, n_params, card,
                       f"a replay of the {VIT_K}-step graph / {VIT_K}, median of "
                       f"{VIT_REPLAYS}: {[round(r, 3) for r in replays]} ms")
    out.update(params=params, losses=losses, launches=launches, busy=prof["busy"],
               prof_flash=prof["flash"], grad_norm1=float(norms[0][0]), groups=prof["groups"])
    trainer.release_graphs()
    del trainer, state, rec
    _free_card()
    return out


def _vit_eager_fit(init, batches, device, attn_impl: str, n_params: int, card: str,
                   timed: bool = True) -> dict:
    """The same VIT_CHUNKS x VIT_K steps through Trainer.train_step, one at a
    time, from the same init and batches, the flash counts set to 0 just
    before and read just after."""
    trainer, state = _vit_trainer(attn_impl, init, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses, norms = [], [], []
    _zero_flash_counts()
    for _ in range(VIT_CHUNKS):
        for b in batches:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = trainer.train_step(state, b)
            end.record()
            events.append((start, end))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
    launches = _flash_counts()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out = {"params": {k: v.detach().cpu().numpy() for k, v in state.params.items()},
           "launches": launches, "losses": torch.stack(losses).float().cpu().numpy(),
           "grad_norm1": float(norms[0])}
    del trainer, state
    _free_card()
    if not np.isfinite(out["losses"]).all():
        raise AssertionError(f"ViT-B/16 {attn_impl} eager fit: non-finite losses")
    if timed:
        steps = [s.elapsed_time(e) for s, e in events]
        out.update(_vit_numbers(
            f"{attn_impl} eager", statistics.median(steps[VIT_EAGER_SKIP:]), peak_gib, n_params,
            card, f"steps {VIT_EAGER_SKIP + 1}-{len(steps)} by CUDA events, host copies "
            f"included, min {min(steps[VIT_EAGER_SKIP:]):.3f}, max "
            f"{max(steps[VIT_EAGER_SKIP:]):.3f}; first step {steps[0]:.3f}"))
    return out


def _vit_numbers(tag: str, step_ms: float, peak_gib: float, n_params: int, card: str,
                 how: str) -> dict:
    tokens = VIT_B * VIT_T
    flops = 6 * n_params * tokens
    mfu = flops / (step_ms / 1e3) / 989e12
    log(f"[vision] ViT-B/16 {tag}: median step {step_ms:.3f} ms ({how}) = "
        f"{VIT_B / step_ms * 1e3:.1f} samples/s; 6ND = {flops / 1e12:.3f} TFLOP a step "
        f"({n_params:,} params x {tokens} tokens) = MFU {mfu:.4f} of 989 TFLOP/s bf16 dense; "
        f"peak device memory {peak_gib:.2f} GiB | {card}")
    return {"step_ms": step_ms, "samples_s": VIT_B / step_ms * 1e3, "mfu": mfu,
            "peak_gib": peak_gib}


def phase_vit_train(device, card: str) -> dict:
    """Main path 5 (a): ViT-B/16 at full width and depth, weights from
    init_flax_vit_params(seed=0) through the bridge, random images from seed
    0; with attn_impl='flash' (the flash forward and backward kernels at
    T = 197, no mask) and then with einsum, each as the chunk graph and twice
    as the eager per-step loop: the graph fit bitwise the eager one leaf by
    leaf (but where two eager fits differ), the flash kernels 12 times a
    step forward and backward, replayed steps included, step 1 of flash
    against einsum."""
    t0 = time.perf_counter()
    cfg = vit_b16()
    init = vit_state_dict_from_flax(init_flax_vit_params(cfg, VIT_CLASSES, VIT_PATCH, seed=0))
    n_params = sum(a.size for a in init.values())
    batches, stacked = _vit_data(seed=0)
    log(f"[vision] ViT-B/16 (hidden {cfg.hidden}, {cfg.n_layers} layers, {cfg.n_heads} heads, "
        f"MLP {cfg.mlp_dim}, patch {VIT_PATCH}, {VIT_HW} x {VIT_HW}, {VIT_CLASSES} classes): "
        f"{n_params:,} params from seed 0, {VIT_POOL} random batches of {VIT_B} in "
        f"{time.perf_counter() - t0:.1f} s; {VIT_CHUNKS} chunks of {VIT_K} steps, lr {VIT_LR}, "
        f"bf16 compute; flash, then einsum")
    runs = {}
    for attn_impl in ("flash", "einsum"):
        graph = _vit_graph_fit(init, stacked, device, card, attn_impl, n_params)
        eager = _vit_eager_fit(init, batches, device, attn_impl, n_params, card)
        eager2 = _vit_eager_fit(init, batches, device, attn_impl, n_params, card, timed=False)
        tag = f"[vision] ViT-B/16 {attn_impl}:"
        _graph_against_eager(graph["params"], eager["params"], eager2["params"], tag)
        d_loss = float(np.abs(graph["losses"] - eager["losses"]).max())
        n = cfg.n_layers * VIT_K * VIT_CHUNKS if attn_impl == "flash" else 0
        want = {"fwd": {"bf16": n, "f32": 0}, "bwd": {"bf16": n, "f32": 0}}
        log(f"{tag} per-step losses of the graph fit against the eager fit: max |d| "
            f"{d_loss:.3e}; flash launches graph {graph['launches']}, eager {eager['launches']} "
            f"(want {want}); graph vs eager: median step {graph['step_ms']:.3f} vs "
            f"{eager['step_ms']:.3f} ms, busy share of a profiled replay "
            f"{100 * graph['busy']:.1f}% | {card}")
        if not graph["launches"] == eager["launches"] == eager2["launches"] == want:
            raise AssertionError(f"{tag} flash launched {graph['launches']} / "
                                 f"{eager['launches']}, want {want}")
        runs[attn_impl] = {"graph": graph, "eager": eager}
        del eager2
    for kind in ("graph", "eager"):
        _check_step1(runs["flash"][kind]["losses"][0], runs["einsum"][kind]["losses"][0],
                     runs["flash"][kind]["grad_norm1"], runs["einsum"][kind]["grad_norm1"],
                     f"[vision] ViT-B/16 {kind}", tol_loss=TOL_VIT_STEP1,
                     tol_norm=TOL_VIT_STEP1)
    log("[vision] main path 5 (a), ViT-B/16 batch 64 x 224 x 224 (197 tokens), bf16: " + "; ".join(
        f"{impl} {kind} {r[kind]['samples_s']:.1f} samples/s, median step "
        f"{r[kind]['step_ms']:.3f} ms, MFU {r[kind]['mfu']:.4f}, peak {r[kind]['peak_gib']:.2f} GiB"
        for impl, r in runs.items() for kind in ("graph", "eager"))
        + f"; busy share of a replay flash {100 * runs['flash']['graph']['busy']:.1f}%, einsum "
        f"{100 * runs['einsum']['graph']['busy']:.1f}% | {card}")
    fl = runs["flash"]
    return {"launches": {k: fl["graph"]["launches"]["fwd"][k] + fl["eager"]["launches"]["fwd"][k]
                         for k in ("bf16", "f32")},
            "bwd_launches": {k: fl["graph"]["launches"]["bwd"][k]
                             + fl["eager"]["launches"]["bwd"][k] for k in ("bf16", "f32")},
            **{f"{k}_{impl}_{kind}": r[kind][k] for impl, r in runs.items()
               for kind in ("graph", "eager") for k in ("step_ms", "samples_s", "mfu",
                                                         "peak_gib")}}


def _vit_shape_bound(dtype, backward: bool) -> tuple[float, str, str]:
    """The least time of the flash forward (or backward) at the ViT-B/16
    shape: bytes read and written once (q, k, v, out; the backward also
    dout, dq, dk, dv; the int32 mask and the f32 LSE) over HBM_BYTES_PER_S,
    against the products of every (q, k) pair (2 for the forward, 5 for the
    backward, 2 BH T^2 D operations each) over the type's peak."""
    elt = torch.finfo(dtype).bits // 8
    n_bytes = (8 if backward else 4) * VIT_BH * VIT_T * VIT_D * elt + 2 * VIT_BH * VIT_T * 4
    flops = (5 if backward else 2) * 2 * VIT_BH * VIT_T * VIT_T * VIT_D
    passes = MMA_PASSES[dtype]
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = passes * flops / PEAK_FLOPS[dtype] * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, by, (f"{n_bytes / 1e6:.1f} MB = {t_bytes:.4f} ms; {passes} x "
                       f"{flops / 1e9:.2f} GFLOP at {PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s = "
                       f"{t_ops:.4f} ms")


def phase_vit_kernels(device, card: str) -> dict:
    """Main path 5 (b): the flash forward and backward at the ViT-B/16 shape
    (B*H = 768, T = 197, no mask; T a ragged 64-row and 128-row tile count),
    bf16 and f32, against their plain versions under the limits of the
    kernel phase and bitwise on a second launch; then each in device time
    beside scaled_dot_product_attention's forward or backward, its plain
    version and its bound."""
    scale = 1.0 / VIT_D ** 0.5
    out = {}
    for i, dtype in enumerate((torch.bfloat16, torch.float32)):
        tag = KERNEL_NAMES[dtype]
        name = f"ViT-B/16 [B*H={VIT_BH}, T={VIT_T}, D={VIT_D}] no mask {tag}"
        q, k, v = _inputs(VIT_BH, VIT_T, VIT_T, VIT_D, dtype, device, seed=160 + i)
        mask = torch.ones((VIT_BH, VIT_T), dtype=torch.int32, device=device)
        o, lse = att.flash_attention_fwd(q, k, v, mask, False, scale)
        o2, lse2 = att.flash_attention_fwd(q, k, v, mask, False, scale)
        torch.cuda.synchronize()
        ref_o, ref_lse = att.flash_attention_fwd_plain(q, k, v, mask, False, scale)
        err = (o.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        log(f"[kernel] flash_fwd {name}: max|dout| {err:.3e} (tol {TOL_OUT[dtype]:g}), "
            f"max|dlse| {err_lse:.3e} (tol {TOL_LSE:g}), two launches bitwise equal: {same}")
        if not (err <= TOL_OUT[dtype] and err_lse <= TOL_LSE and same
                and bool(torch.isfinite(o.float()).all())):
            raise AssertionError(f"flash_fwd disagrees with its plain version on {name}")
        err_bwd = _bwd_case(name, q, k, v, mask, False, scale, 0, seed=162 + i)
        out[tag] = {"fwd_err": err, "bwd_err": err_bwd}

        q4, k4, v4 = (x.view(VIT_B, VIT_H, VIT_T, VIT_D) for x in (q, k, v))
        kernel = lambda: att.flash_attention_fwd(q, k, v, mask, False, scale)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
        ms, lib_ms, ms2, lib_ms2 = (device_ms(f) for f in (kernel, sdpa, kernel, sdpa))
        plain_ms = device_ms(lambda: att.flash_attention_fwd_plain(q, k, v, mask, False, scale),
                             warmup=2, iters=10)
        bound, by, how = _vit_shape_bound(dtype, backward=False)
        log(f"[times] flash_fwd {name}: kernel {ms:.4f} / {ms2:.4f} ms (device time, two turns; "
            f"{statistics.median([ms, ms2]) / bound:.2f}x the bound), bound {bound:.4f} ms "
            f"({by}: {how}), plain {plain_ms:.4f} ms, scaled_dot_product_attention "
            f"{lib_ms:.4f} / {lib_ms2:.4f} ms, its device kernels "
            f"{[key[:80] for key, *_ in _device_kernels(sdpa)]} | {card}")
        out[tag].update(fwd_ms=statistics.median([ms, ms2]), fwd_sdpa_ms=statistics.median(
            [lib_ms, lib_ms2]), fwd_plain_ms=plain_ms, fwd_bound_ms=bound, fwd_bound_by=by)

        g = torch.Generator(device=device).manual_seed(170 + i)
        dout = torch.randn(o.shape, generator=g, device=device).to(dtype)
        args = (q, k, v, mask, o, lse, dout, False, scale)
        leaves = [x.detach().requires_grad_() for x in (q4, k4, v4)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        dout4 = dout.view(VIT_B, VIT_H, VIT_T, VIT_D)
        bwd = lambda: att.flash_attention_bwd(*args)  # noqa: E731
        sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, leaves, dout4,  # noqa: E731
                                               retain_graph=True)
        ms, lib_ms, ms2, lib_ms2 = (device_ms(f) for f in (bwd, sdpa_bwd, bwd, sdpa_bwd))
        plain_ms = device_ms(lambda: att.flash_attention_bwd_plain(*args), warmup=2, iters=10)
        sdpa_kernels = _device_kernels(sdpa_bwd, n=10)
        summed = sum(t for _, _, t, *_ in sdpa_kernels)
        bound, by, how = _vit_shape_bound(dtype, backward=True)
        log(f"[times] flash_bwd {name}: kernel {ms:.4f} / {ms2:.4f} ms (device time, two turns; "
            f"{statistics.median([ms, ms2]) / bound:.2f}x the bound), bound {bound:.4f} ms "
            f"({by}: {how}), plain {plain_ms:.4f} ms, scaled_dot_product_attention's backward "
            f"{lib_ms:.4f} / {lib_ms2:.4f} ms by CUDA events, its device kernels summed "
            f"{summed:.4f} ms: {[(key[:60], c) for key, c, *_ in sdpa_kernels]} | {card}")
        out[tag].update(bwd_ms=statistics.median([ms, ms2]), bwd_sdpa_ms=summed,
                        bwd_sdpa_events_ms=statistics.median([lib_ms, lib_ms2]),
                        bwd_plain_ms=plain_ms, bwd_bound_ms=bound, bwd_bound_by=by)
        del q, k, v, o, lse, dout, leaves, sdpa_out, q4, k4, v4, dout4
        _free_card()
    return out


class _VisionInitOnce:
    """Within a phase, ``vision._init_variables`` (the JAX initialisers drawn
    with numpy: seconds of host time at full size) computed once per
    (architecture, seed) and handed to every fit that asks; the fits only
    read it. Restores the function on exit."""

    def __enter__(self):
        orig = self._orig = vision_stage._init_variables
        memo = {}

        def once(module, seed):
            key = (type(module).__name__,
                   tuple((n, tuple(p.shape)) for n, p in module.named_parameters()), seed)
            if key not in memo:
                memo[key] = orig(module, seed)
            return memo[key]

        vision_stage._init_variables = once
        return self

    def __exit__(self, *exc):
        vision_stage._init_variables = self._orig


class _F32Backbones:
    """The stages' ViT-B/16 and ResNet-50 presets in f32 compute, for the
    check of the card's scores against the port's on the CPU: a bf16 model
    rounds differently on either device. Restores them on exit."""

    def __enter__(self):
        self._saved = dict(vision_stage._BACKBONES)
        vision_stage._BACKBONES.update({
            "vit_b16": lambda n: (ViTClassifier(vit_b16(dtype=torch.float32), num_classes=n,
                                                patch=16), False),
            "resnet50": lambda n: (resnet50(num_classes=n, dtype=torch.float32), True)})
        return self

    def __exit__(self, *exc):
        vision_stage._BACKBONES.clear()
        vision_stage._BACKBONES.update(self._saved)


def _vision_stage(backbone: str, device) -> DeepVisionClassifier:
    return DeepVisionClassifier(backbone=backbone, num_classes=VIT_CLASSES,
                                batch_size=STAGE_BATCH, max_steps=STAGE_STEPS,
                                learning_rate=1e-4, seed=0, device=str(device))


def _score_vision_model(model, df, card: str, tag: str) -> None:
    """A fitted DeepVisionModel scores ``df`` twice (the second bitwise the
    first, one CompiledCache miss a bucket, finite distributions), and a few
    images in f32 compute on the card and on the CPU within VISION_CPU_TOL."""
    cache = cb.get_compiled_cache()
    misses0 = cache.miss_count("deep_vision_model")
    t0 = time.perf_counter()
    first = np.stack(list(model.transform(df).collect_column("scores")))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = np.stack(list(model.transform(df).collect_column("scores")))
    second_s = time.perf_counter() - t0
    misses = cache.miss_count("deep_vision_model") - misses0
    n = len(first)
    buckets = {b for p in df.partitions
               for *_, b in cb.default_bucketer().slices(len(p["image"]), STAGE_BATCH)}
    same = np.array_equal(first, second)
    log(f"[vision] {tag} model scores {n} images: {first_s:.3f} s first, {second_s:.3f} s second "
        f"({n / second_s:.1f} images/s, host clock); a second transform bitwise the first: "
        f"{same}; CompiledCache misses {misses:g} (want {len(buckets)}, one a bucket); rows sum "
        f"of scores within {np.abs(first.sum(-1) - 1).max():.2e} of 1 | {card}")
    if not (same and first.shape == (n, VIT_CLASSES) and np.isfinite(first).all()
            and np.abs(first.sum(-1) - 1).max() <= 1e-3 and misses == len(buckets)):
        raise AssertionError(f"{tag}: the fitted model's scores are not repeatable "
                             "distributions, or it took other callables than one a bucket")
    small = DataFrame([{"image": df.partitions[0]["image"][:VISION_CPU_N]}])
    with _F32Backbones():
        card32 = np.stack(list(model.copy({"device": str(model.get("device"))})
                               .transform(small).collect_column("scores")))
        cpu32 = np.stack(list(model.copy({"device": "cpu"}).transform(small)
                              .collect_column("scores")))
    err = float(np.abs(card32 - cpu32).max())
    log(f"[vision] {tag} model in f32 compute, {VISION_CPU_N} images on the card against the "
        f"port on the CPU: max|dprob| {err:.3e} (limit {VISION_CPU_TOL}); against its bf16 "
        f"scores {np.abs(card32 - first[:VISION_CPU_N]).max():.3e}")
    if err > VISION_CPU_TOL:
        raise AssertionError(f"{tag}: the card's scores disagree with the CPU's")


def phase_vision_stages(device, card: str) -> dict:
    """Main path 5 (c): DeepVisionClassifier(backbone='vit_b16') fits
    STAGE_STEPS steps (einsum, the stage's own attention), and
    DeepVisionClassifier(backbone='resnet50') the same steps through the
    BatchNorm path: as the stage's graph fit and twice as the eager loop,
    the graph fit's parameters and running statistics bitwise the eager
    one's but where two eager fits differ (there within TOL_SPREAD); each
    fitted model scores the sum(STAGE_PARTS) images of two partitions."""
    rs = np.random.default_rng(2)
    images = rs.standard_normal((STAGE_ROWS, VIT_HW, VIT_HW, 3), dtype=np.float32)
    labels = rs.integers(0, VIT_CLASSES, STAGE_ROWS).astype(np.int32)
    df = DataFrame.from_dict({"image": images, "label": labels}, num_partitions=2)
    score_df = DataFrame([{"image": images[:STAGE_PARTS[0]]},
                          {"image": images[STAGE_PARTS[0]:sum(STAGE_PARTS)]}])
    out = {}
    with _VisionInitOnce():
        for backbone in ("vit_b16", "resnet50"):
            stage = _vision_stage(backbone, device)
            cache = cb.get_compiled_cache()
            misses0 = cache.miss_count("train_steps_scan")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_flash_counts()
            t0 = time.perf_counter()
            model = stage.fit(df)
            fit_s = time.perf_counter() - t0
            launches = _flash_counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            captures = cache.miss_count("train_steps_scan") - misses0
            (metrics,) = model.get("train_metrics")
            params = model.get("model_params")
            stats = model.get("batch_stats")
            module, _ = vision_stage._build_module(backbone, VIT_CLASSES)
            init, init_stats = vision_stage._init_variables(module, 0)
            still = [k for k in params if np.array_equal(params[k], init[k])]
            moved = (sorted(k for k in stats if not np.array_equal(stats[k], init_stats[k]))
                     if stats is not None else [])
            log(f"[vision] DeepVisionClassifier(backbone={backbone!r}) graph fit of "
                f"{STAGE_STEPS} steps at batch {STAGE_BATCH}: {fit_s:.2f} s host clock, "
                f"train_metrics {json.dumps(metrics)}, captures {captures:g} (want 1), "
                f"parameters that did not move: {still or 'none'}, running statistics moved: "
                f"{len(moved)} of {len(stats or {})}, flash launches {launches} (want none: "
                f"einsum), peak device memory {peak_gib:.2f} GiB | {card}")
            flat = {"fwd": {"bf16": 0, "f32": 0}, "bwd": {"bf16": 0, "f32": 0}}
            if (not np.isfinite(metrics["loss"]) or metrics["step"] != STAGE_STEPS or still
                    or captures != 1 or launches != flat
                    or (stats is not None and len(moved) != len(stats))):
                raise AssertionError(f"DeepVisionClassifier({backbone}) graph fit failed its "
                                     "checks")
            if stats is not None:  # the BatchNorm path against the eager loop
                eager = []
                for _ in range(2):
                    trainer, data, kw = stage._fit_plan(df)
                    state = trainer_mod.fit_arrays(trainer, data, scan_chunk=1, **kw)
                    eager.append({k: v.detach().cpu().numpy() for k, v in
                                  {**state.params, **state.batch_stats}.items()})
                    del trainer, state
                    _free_card()
                spread = _graph_against_eager({**params, **stats}, eager[0], eager[1],
                                              f"[vision] {backbone} (parameters and running "
                                              "statistics):")
                out[f"{backbone}_spread"] = spread
            _score_vision_model(model, score_df, card, backbone)
            out[backbone] = {"fit_s": fit_s, "peak_gib": peak_gib}
            del model, module
            _free_card()
    return out


def main() -> None:
    t0 = time.perf_counter()

    def done(phase):
        log(f"[phase] {phase} done at {time.perf_counter() - t0:.1f} s")

    card, device = phase_device()
    phase_build()
    done("build")
    max_err = phase_kernels(device)
    done("kernels")
    hist_err = phase_gbdt_kernels(device)
    done("gbdt kernels")
    main_path = phase_main_path(device, card)
    done("main path 1")
    gbdt = phase_gbdt_main(device, card)
    done("main path 2")
    train = phase_train_main(device, card)
    done("main path 3")
    tiny = phase_train_cpu_card(device)
    done("bert-tiny, CPU against the card")
    long_t = phase_train_long(device, card)
    done("long-T step")
    phase_onnx(device, card)
    done("main path 4")
    vit = phase_vit_train(device, card)
    done("main path 5 (a), ViT-B/16 fine-tuning")
    phase_vit_kernels(device, card)
    done("main path 5 (b), the flash kernels at the ViT shape")
    phase_vision_stages(device, card)
    done("main path 5 (c), the vision stages")
    # the flash kernels' launches on the paths, each counted from 0 just
    # before it ran: scoring (path 1), fine-tuning through flash and both
    # fitted models' scoring (path 3), bert-tiny f32 through flash on the
    # card, the long-T flash steps in bf16 and in f32, and ViT-B/16
    # fine-tuning through flash (path 5)
    paths = (train, vit, {"launches": tiny["fwd"], "bwd_launches": tiny["bwd"]},
             *({"launches": long_t[tag]["launches"]["fwd"],
                "bwd_launches": long_t[tag]["launches"]["bwd"]} for tag in ("flash", "flash f32")))
    launches = {k: v + sum(p["launches"][k] for p in paths)
                for k, v in main_path["launches"].items()}
    launches.update({f"bwd_{k}": sum(p["bwd_launches"][k] for p in paths)
                     for k in ("bf16", "f32")})
    kernels = phase_times(device, card, launches, max_err)
    kernels += phase_gbdt_times(device, card, {"gbdt_hist": gbdt["launches"],
                                               "gbdt_hist_scale": gbdt["scale_launches"]},
                                hist_err)
    done("times")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
