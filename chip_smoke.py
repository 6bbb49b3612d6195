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
   2 device operations; main path 9's shapes: 136 features (720,000 rows)
   at widths 1, 16 and 32, a goss-shaped presence (about 28 % of rows, the
   sampled ones amplified), and lambdarank gradients with the tree's scale
   passed in; the per-tree scale pass equal to its plain version;
   segment_histogram against a float64 segment sum;
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
10. main path 6, Llama-2-7B batch inference (synapseml_tpu's
   llama2_7b() at full width and depth, f32 weights from
   init_llama_params(seed=0) on the card, bf16 compute, the hashing
   tokenizer at vocab 32000): (a) HuggingFaceCausalLM(batch_size=8,
   prompt_bucket=64, max_new_tokens=32) over 16 prompts in 2 partitions,
   dense then paged, each transform twice and bitwise the first, one
   CompiledCache callable a rung and none on the repeat; dense against
   paged tokens reported; prefill ms, ms a decode step (CUDA events) beside
   the byte bound, a profiled step by group, peak memory; the mixed stream
   of benchmarks/llama_decode.py (seed 0, 32 requests) through
   run-to-completion batches of 8 and PagedDecodeEngine (8 slots), tokens/s
   and TTFT; (b) the same weights in f32 compute (TF32 off), dense and
   paged greedy tokens on 4 prompts over 3 rungs, identical up to each
   row's first top-2 margin under 1e-3, at least 48 tokens compared; (c)
   llama_tiny in f32 on the card and the CPU under the same rule, sampling
   with top-k / top-p bitwise on a second run and inside the top-k support;
   no kernel of the port's launched on the path;
11. main path 7, pretrained checkpoint directories: HuggingFace-layout
   directories (config.json, safetensors under HF key names) written here
   from seeded numpy weights into a temporary directory removed at the end:
   BERT-base BertForSequenceClassification, ViT-B/16, ResNet-50 in
   microsoft/resnet-* naming and GPT-2 small (tied head) at full size in
   F32, Llama-2-7B at full width with 4 of its 32 layers in F16 over two
   shards. (a) every tensor read back bitwise by the package's own reader
   (F32, F16 and I64, across shards), each directory's load timed from the
   disk (host seconds, GB/s), the Llama load's peak host memory; a BF16
   file read back bitwise, a tokenizer-less directory with tokenizer=None
   and an oversized tokenizer vocab refused; (b) DeepTextClassifier(checkpoint=<BERT-base
   dir>, attn_impl='flash') as the stage's graph fit of 24 steps at batch
   32 x 128, bitwise the preset path's fit from the same mapped weights, the
   flash forward and backward 12 times a step, the fitted model scoring
   through the flash kernel and round-tripping save -> load bitwise; (c)
   DeepVisionClassifier from the ViT-B/16 and the ResNet-50 directories:
   the module the directory builds within 1e-5 of the preset module on the
   same weights (f32 logits), a 16-step graph fit (the ResNet from the
   checkpoint's BatchNorm statistics) and scoring as main path 5 (c); (d)
   HuggingFaceCausalLM from the Llama directory (dense and paged) and from
   the GPT-2 directory (dense; paged refused, as by the JAX engine): bf16
   transforms twice, bitwise, tokens/s; f32 card tokens against the CPU's
   under the margin rule, at least 48 compared; (e)
   HuggingFaceSentenceEmbedder(model_name=<BERT-base dir>) in f32: a second
   transform bitwise, one CompiledCache callable a (bucket, seq_len), 16
   rows within 1e-4 of the CPU, rows/s;
12. main path 8, Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1's published
   config through the port's llama_config_from_hf: full width, 8 of its 32
   layers; dropless scatter MoE, 8 experts, top-2): (a) f32 weights from
   init_llama_params(seed=0) on the card, first in f32 compute (TF32 off):
   dense generate and PagedDecodeEngine greedy tokens identical up to each
   row's first top-2 margin under 1e-3, at least 48 compared; then
   load_llama in bf16 compute (the f32 draw dropped once loaded): dense
   generate over 16 prompts in batches of 8 (prompt bucket 64, 32 new
   tokens) and the paged engine, each twice and bitwise the first; prefill
   ms, ms a decode step in the loop and in device time beside its byte
   bound, a profiled step by group (routing its own group), peak memory,
   path 6's mixed stream through the paged engine (tokens/s, TTFT); (b) a
   Mixtral HuggingFace directory at full width with 1 layer in BF16 over
   two shards (layer 0's experts split across them), drawn on the card and
   read back bitwise; its load from the disk in GB/s and its peak host
   memory, held to the mapped files plus one layer's stacked experts;
   HuggingFaceCausalLM(model_name=<dir>) dense and paged, bf16 transforms
   twice, bitwise, tokens/s; f32 card tokens against the port on the CPU
   under the margin rule; (d) no kernel of the port's launched on (a) and
   (b); (c) bert_tiny with 4 experts, top-2, through the flash kernels and
   the port's Trainer with moe_aux_weight 0.01 and 0, for the einsum and
   the scatter dispatch: 8 eager steps against train_steps_scan in chunks
   of 4 (a warm-up, then one capture replayed), losses and every leaf
   bitwise equal, the flash forward and backward once a layer a step, the
   aux term raising the first loss;
13. main path 9, LightGBM's surface through the histogram kernel (each
   fit through a DataFrame stage with histogram_impl='pallas' on the card,
   data from numpy seed 0): (a) LightGBMRanker at the MSLR-WEB10K shape
   (6000 query groups of 40-200 documents, about 720,000 rows, 136
   features, relevance 0-4 about half 0, from a hidden score) with
   LightGBM's examples/lambdarank/train.conf parameters (100 trees, 31
   leaves, 255 bins, min_data_in_leaf 50, min_sum_hessian 5.0): one level
   launch a level and one scale pass a tree, a second fit bitwise, held-out
   NDCG@5 over 1000 groups above a random ranking's, a 20-group slice with
   the same splits on the CPU and the card, fit seconds and peak memory;
   (b) Higgs-1M, 50 iterations in goss, dart, rf and gbdt with bagging and
   feature_fraction: each fit bitwise a second fit, every tree's sampled
   rows within 4 sigma of their expected fraction (goss's from each
   iteration's gradients, ties at the cut included), exactly k_feat
   features offered a tree, held-out AUC within limits of the bagged
   gbdt's, rf's score the init plus the mean of its trees; (c) Higgs-1M
   with 4 columns cut to 32 categories and a non-monotone category effect,
   through categorical_slot_indexes: AUC above the numerical fit's, save ->
   load bitwise, model.txt -> ImportedBooster within 1e-6, SHAP additivity
   1e-4; (d) train_booster_from_source over a 250,000-row Higgs-width CSV
   (cut from 1e6: the host writes and parses it) in 5 byte-range shards
   and 8 spill chunks, under 3 injected read faults (retried and
   counted), held-out AUC within 2e-3 of the in-memory 'segment' fit on
   the rows read back, and a 20,000-row jsonl file; (e) continued training
   of (b)'s gbdt booster through model_string, its 50 trees bitwise kept;
   the histogram kernel's launches counted against the trees grown; then
   the level launch at the ranker's shape in device time;
14. main path 10, ONNXModel over the reference's whole ONNX opset (no
   kernel of the port's launched on it, counted from 0 before it): (a) an
   ORT-fused BERT-base in the form ONNX Runtime's transformer optimizer
   writes (EmbedLayerNormalization, then Attention, the output projection,
   SkipLayerNormalization, MatMul + BiasGelu, MatMul,
   SkipLayerNormalization a layer; main path 1's weights from seed 0)
   scoring 512 rows of main path 1's lengths in batches of 32 x 128, a
   second transform bitwise, its last hidden states within 1e-4 of the
   port's own BERT encoder on the card in strict f32 and a TF32 control
   past that limit, rows/s, ms a batch beside the encoder's, a profile by
   group, peak memory; (b) a GPT-2-width causal decoder (vocab 50257, d
   768, 12 layers, tests/_torch_gpt.py's layout, torch's initialisers from
   seed 0) exported on the card by the TorchScript exporter (Trilu,
   GatherElements, Not and Where in it), scored at 8 x 128 and 8 x 64,
   logits within 1e-4 of the module in strict f32; (c) every op type the
   slice ported once on the card against the port on the CPU: integer,
   index, quantized, bitwise, NMS, NonZero, Compress and Unique bitwise,
   floating ones within 1e-5 of max(1, |CPU|), the random ones within 4
   sigma of their law and bitwise on a repeat; an If on a condition
   computed on the card, a Loop exiting early with a scan output, a
   bidirectional Scan and an LSTM + GRU stack at hidden 512, T 128,
   batch 32;
15. main path 11, the multi-GPU plane at one card, under an NCCL group of
   one process made here on a FileStore and destroyed at the end: (a) main
   path 3's flash fit with an AsyncCheckpointer every 16 steps, 2 kept, a
   second fit resumed from step 32 through fit_source(resume_from=), its
   params and Adam moments bitwise the uninterrupted fit's and the
   checkpointed fit bitwise a fit without, the newest payload truncated
   and demoted to step 32; bytes a checkpoint, the write's ms and GB/s,
   save()'s ms, host ms a step with and without; (b) the same fit on a
   data=1 x fsdp=1 mesh with the port's transformer rule table and ZeRO,
   bitwise the no-mesh fit, and DeepTextModel scoring with mesh_config
   bitwise the scoring without; (c) Ulysses (its flash local step) and
   ring attention on a seq axis of size 1 at BERT-base's heads, B 1, T =
   32768, bf16, the last 1000 keys padded, non-causal and causal, forward
   and backward against each other and the flash kernel called directly
   within the bf16 limits, ms, peak memory and the flash bound; (d)
   Higgs-1M with mesh_config (the histogram kernel's int64-out mode, the
   all-reduce and the conversion) bitwise main path 2's forest; at each
   level shape of one tree the int64 sums bitwise the plain version's
   (int_out) and the scale pass over 2N and 4N rows (n_total) equal to its
   plain version; one tree in the int64-out mode beside the one-process
   mode;
16. main path 12, HTTP model serving: (a) serve_pipeline on 127.0.0.1:0
   over BERT-base DeepTextModel through the flash kernel in bf16 (main
   path 1's stage between ServeTexts and ServeReplies): 512 requests of
   1-4 texts of 16-300 words from 16 client threads, micro-batched at 10
   ms, with a /admin/load by path (warmup rows) after 192 replies: every
   reply 200, no deep_text_model cache miss after the swap, the old
   pipeline's entries released, every score within main path 1's bf16
   limits of the stage's transform; /metrics parsed as Prometheus text
   with the JAX package's series, /trace holding the request's span under
   its traceparent; a registry publish that times the einsum/flash pair on
   the card and records no executables, a /admin/load by registry warmed
   up by JIT; 128 requests in continuous mode; requests/s, p50/p99 and the
   longest latency across the swap. (b) serve_llm over the paged engine at
   Llama-2-7B width, 4 of 32 layers, init_llama_params(seed=0), f32: 32
   prompts of 16-512 tokens with max_new_tokens 16-64 as 8 concurrent
   streams, each stream's tokens equal to the stage's transform under the
   margin rule; a short request after a long one finishing first; an
   X-Deadline-Ms too short for any token: 504, finish_reason deadline,
   pages freed; /admin/drain with a dead migrate_to: every live stream
   re-imported locally and ended; then the traffic in bf16 compute:
   tokens/s and time to first token;
17. times: each kernel beside its bound, its plain version and the one
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
import itertools
import json
import math
import os
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
from synapseml_torch.core import PipelineModel, Transformer
from synapseml_torch.core import batching as cb
from synapseml_torch.image import ImageTransformer
from synapseml_torch.models.convert_hf import host_tensor
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
from synapseml_torch.onnx import ImageFeaturizer, ONNXModel, convert_graph
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
    _surface_hist_cases(hist, device)
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


def _surface_hist_cases(hist, device) -> None:
    """The shapes main path 9 gives the kernel: 136 features (the ranker's
    MSLR-WEB10K width) at widths 1, 16 and 32; a goss-shaped presence
    (about 28 % of rows nonzero, their gradients amplified, the rest zero);
    and a tree whose fixed-point scale comes from lambdarank gradients, the
    scale and scratch passed in as grow_tree passes them. Each bitwise its
    plain version and its second launch."""
    from synapseml_torch.gbdt import objectives

    for i, width in enumerate((1, 16, 32)):
        args = _hist_inputs(MSLR_ROWS, MSLR_F, width, 256, torch.uint8, device, seed=40 + i)
        _hist_case(hist, f"mslr width {width} u8 (N={MSLR_ROWS}, F={MSLR_F})",
                   (*args, width - 1, width, 256))
    bins, grad, hess, presence, node = _hist_inputs(HIGGS_N, HIGGS_F, 16, 256, torch.uint8,
                                                    device, seed=43, outside=False)
    g = torch.Generator(device=device).manual_seed(44)
    keep = torch.rand(HIGGS_N, generator=g, device=device) < 0.28
    amp = torch.where(torch.rand(HIGGS_N, generator=g, device=device) < 0.2, 1.0, 8.0)
    goss = (grad * amp * keep, hess * amp * keep, keep.float())
    _hist_case(hist, f"goss presence {keep.float().mean().item():.3f} width 16 (N={HIGGS_N})",
               (bins, *goss, node, 15, 16, 256))
    # lambdarank gradients of random relevance over MSLR-shaped groups
    rs = np.random.default_rng(45)
    sizes = rs.integers(40, 201, 600)
    n = int(sizes.sum())
    gslot, gmax = objectives.pad_groups(sizes)
    scores = torch.from_numpy(rs.normal(size=n).astype(np.float32)).to(device)
    labels = torch.from_numpy(rs.integers(0, 5, n).astype(np.float32)).to(device)
    lg, lh = objectives.lambdarank_grad_hess(scores, labels, torch.from_numpy(gslot).to(device),
                                             len(sizes), gmax)
    bins, _, _, presence, node = _hist_inputs(n, MSLR_F, 8, 256, torch.uint8, device, seed=46,
                                              outside=False)
    presence = torch.ones_like(presence)
    tree = hist.fixed_point_tree(lg, lh, presence, MSLR_F, 6, 256)
    args = (bins, lg, lh, presence, node, 7, 8, 256)
    got = hist.fixed_point_histogram(*args, *tree)
    again = hist.fixed_point_histogram(*args, *tree)
    torch.cuda.synchronize()
    want = hist.fixed_point_histogram_plain(*args, scale=tree.scale)
    same, same2 = torch.equal(got, want), torch.equal(got, again)
    log(f"[kernel] gbdt_hist lambdarank gradients (600 groups, N={n}, F={MSLR_F}, width 8, "
        f"scale exponents {tree.scale.tolist()}): bitwise equal to the plain version: {same}, "
        f"to a second launch: {same2}")
    if not (same and same2):
        raise AssertionError("gbdt_hist disagrees on lambdarank gradients")


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
            "auc": held_out_auc, "digest": forest_digest(booster)}


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


def _tree_level_times(device, card: str, n: int, nf: int, depth: int = 6,
                      nb: int = 256) -> tuple[dict, int, int]:
    """The kernel at each shape one tree gives it over ``n`` rows and ``nf``
    features (levels of width 1..2^(depth-1), then the final level's totals
    at width 2^depth), called as grow_tree calls it (the tree's scale and
    scratch passed in), beside its bound, its plain version and one
    index_add_ on precomputed flat ids, all in device time; ``call_ms`` is
    one call as the host sees it, its enqueue included. Returns the sums
    over the shapes, their bytes, and the count of shapes."""
    from synapseml_torch.gbdt import hist

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
        del ids, flat_data
    return tot, tot_bytes, len(shapes)


def phase_gbdt_times(device, card: str, launches: dict, max_err: dict) -> list[dict]:
    """The kernel at each shape one tree of main path 2 gives it (levels of
    width 1..32, then the final level's totals at width 64; see
    :func:`_tree_level_times`), then the per-tree scale pass. The JSON rows
    carry the mean per level launch over the 7 shapes, and the scale pass."""
    from synapseml_torch.gbdt import hist

    n = HIGGS_N
    tot, tot_bytes, k = _tree_level_times(device, card, n, HIGGS_F)

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


def _export_onnx(model, example, input_names=("input",), dynamic_axes=None) -> bytes:
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
        torch.onnx.export(model, example, buf, dynamo=False, input_names=list(input_names),
                          output_names=["logits"],
                          dynamic_axes=dynamic_axes or {"input": {0: "N"}, "logits": {0: "N"}})
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


def _score_vision_model(model, df, card: str, tag: str, f32_params: dict | None = None) -> None:
    """A fitted DeepVisionModel scores ``df`` twice (the second bitwise the
    first, one CompiledCache miss a bucket, finite distributions), and a few
    images in f32 compute on the card and on the CPU within VISION_CPU_TOL:
    the presets patched to f32, or the model copied with ``f32_params``."""
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
        card32 = np.stack(list(model.copy({"device": str(model.get("device")), **(f32_params or {})})
                               .transform(small).collect_column("scores")))
        cpu32 = np.stack(list(model.copy({"device": "cpu", **(f32_params or {})}).transform(small)
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
                    trainer, data, kw, _ = stage._fit_plan(df)
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



# ---------------- main path 6: Llama-2-7B batch inference ----------------

# HuggingFaceCausalLM on llama2_7b() (synapseml_tpu/models/flax_nets/llama.py:24-29:
# vocab 32000, hidden 4096, 32 layers, 32 heads, MLP 11008, max_len 4096) at full
# width and depth, f32 params, bf16 compute, weights from init_llama_params(seed=0)
LLM_ROWS, LLM_PARTS = 16, 2
LLM_BATCH, LLM_BUCKET, LLM_NEW = 8, 64, 32
LLM_STREAM = 32               # requests of benchmarks/llama_decode.py's mixed stream
LLM_SLOTS, LLM_BLOCK = 8, 16
LLM_F32_LENS, LLM_F32_NEW = (12, 24, 40, 60), 16   # seq-ladder rungs 16, 32, 64
LLM_MARGIN = 1e-3             # greedy tokens are compared up to a top-2 margin under this
LLM_MIN_COMPARED = 48
LLM_TINY_LENS, LLM_TINY_NEW = (5, 9, 14, 27, 33, 50), 16
LLM_TOP_K, LLM_TOP_P, LLM_TEMP = 20, 0.9, 0.8
LLM_SPIN = 200_000_000  # clock cycles, about 100 ms: longer than a 7B step's host enqueue
_LLM_WORDS = ("the a of and to in is was for on that with as by at from it this be are "
              "model token paged cache decode prefill batch stream request page block "
              "slot layer head weight").split()

_LLM_GROUPS = (("flash kernels", ("flash_",)),  # matched in lower case, first match wins
               ("matmul", ("nvjet", "gemm", "gemv", "cutlass", "sm90_", "cublas")),
               ("K/V gather and page writes", ("index", "gather", "scatter")),
               ("softmax", ("softmax",)),
               ("dtype casts and copies", ("copy", "memcpy", "cat")),
               ("reductions", ("reduce",)),
               ("elementwise", ("elementwise", "vectorized")))


def _llm_texts(n: int, seed: int) -> list[str]:
    """Prompts of 8-60 words: 9-61 tokens with the [CLS], one bucket of 64."""
    rs = np.random.default_rng(seed)
    return [" ".join(rs.choice(_LLM_WORDS, size=int(rs.integers(8, 61)))) for _ in range(n)]


def _mixed_stream(rng, n_requests: int, vocab: int):
    """(prompt_ids, n_new) per request, as benchmarks/llama_decode.py:82-97
    draws them: prompt lengths over three seq-ladder rungs (16/32/64),
    budgets heavy-tailed (80 % of 4-24 tokens, 20 % of 48 or 64)."""
    reqs = []
    for _ in range(n_requests):
        plen = int(rng.choice([6, 12, 20, 30, 44, 56]))
        if rng.random() < 0.2:
            n_new = int(rng.choice([48, 64]))
        else:
            n_new = int(rng.choice([4, 6, 8, 12, 16, 24]))
        reqs.append((rng.integers(2, vocab, (plen,)).tolist(), n_new))
    return reqs


def _llm_ids(prompts: list, P: int, device):
    """Right-padded ``[B, P]`` ids and mask on ``device``."""
    ids = np.zeros((len(prompts), P), np.int64)
    mask = np.zeros((len(prompts), P), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
        mask[i, :len(p)] = 1
    return torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)


def _teacher_margins(model, prompts: list, generated: list) -> list[np.ndarray]:
    """Per row, the top-2 logit margin at each generated position (the
    logits that chose it), from one forward of the model over prompt +
    generated tokens; and whether each token is in that position's top-k."""
    out = []
    with torch.no_grad():
        for p, g in zip(prompts, generated):
            seq = torch.as_tensor([list(p) + list(g)], device=model.device)
            logits = model(seq)[0, len(p) - 1:len(p) - 1 + len(g)].float()
            top = torch.topk(logits, LLM_TOP_K, dim=-1)
            in_top = (top.indices == torch.as_tensor(list(g), device=model.device)[:, None])
            out.append(((top.values[:, 0] - top.values[:, 1]).cpu().numpy(),
                        in_top.any(-1).cpu().numpy()))
    return out


def _margin_rule(a: list, b: list, ma: list, mb: list, tag: str) -> int:
    """Greedy tokens of two runs, row by row, identical up to the first step
    where either run's top-2 margin is under LLM_MARGIN; returns the tokens
    compared (the steps before that one)."""
    compared = 0
    for i, (ra, rb, xa, xb) in enumerate(zip(a, b, ma, mb)):
        n = min(len(ra), len(rb))
        low = np.nonzero(np.minimum(xa[0][:n], xb[0][:n]) < LLM_MARGIN)[0]
        horizon = int(low[0]) if len(low) else n
        same = list(ra[:horizon]) == list(rb[:horizon])
        log(f"[llm] {tag} row {i}: {horizon} of {n} tokens before a margin under "
            f"{LLM_MARGIN} (least margins {np.min(xa[0][:n]):.3e} / {np.min(xb[0][:n]):.3e}), "
            f"equal there: {same}; first differing step "
            f"{next((j for j in range(n) if ra[j] != rb[j]), None)}")
        if not same:
            raise AssertionError(f"{tag}: greedy tokens differ before a near-tie (row {i})")
        compared += horizon
    return compared


def _profile_llm_step(fn, card: str, tag: str, n=3, groups=_LLM_GROUPS) -> dict:
    """Where the device time of one decode step goes, by ``groups`` (name,
    patterns), and the share of its wall time the card is busy under the
    profiler (device activity only: a 7B step runs over 2000 host
    operations)."""
    group_patterns = groups
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    kernels = []
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kernels = [(e.self_device_time_total / e.count * -(-e.count // n) / 1e3,
                    -(-e.count // n), e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if kernels:
            break
        log(f"[profile] session {attempt + 1} recorded no device kernel; profiling again")
    busy = sum(k[0] for k in kernels)
    if not busy:
        raise AssertionError(f"the profiler recorded no device time for a {tag} step")
    groups = {name: 0.0 for name, _ in group_patterns}
    groups["other"] = 0.0
    for ms, _, key in kernels:
        name = next((g for g, pats in group_patterns if any(p in key.lower() for p in pats)),
                    "other")
        groups[name] += ms
    log(f"[profile] llm {tag} decode step: {wall_ms:.3f} ms wall, {busy:.3f} ms of device "
        f"time ({100 * busy / wall_ms:.1f}% busy, {100 - 100 * busy / wall_ms:.1f}% idle), "
        f"{sum(k[1] for k in kernels)} device operations | {card}")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[profile] llm {tag} group {name}: {ms:.4f} ms/step ({100 * ms / busy:.1f}% of "
            f"device time)")
    for ms, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"[profile] llm {tag} {100 * ms / busy:5.1f}%  {ms:8.4f} ms/step  {count:4d}/step  "
            f"{key[:160]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy": busy / wall_ms, "groups": groups}


def _step_bound_ms(cfg, batch: int, kv_len: int) -> tuple[float, float]:
    """The least time of one decode step by bytes: the bf16 dense weights
    (an MoE layer's every expert: a dropless step runs all of them), the
    f32 lm_head, norms and routers read once, and ``batch`` rows of K and V
    over ``kv_len`` slots in every layer. Returns (ms, GB)."""
    hid, H, KV, D, mlp, L = (cfg.hidden, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
                             cfg.mlp_dim, cfg.n_layers)
    E = cfg.moe_experts
    dense = L * (hid * (H + 2 * KV) * D + H * D * hid + 3 * hid * mlp * max(E, 1))
    size = torch.finfo(cfg.dtype).bits // 8
    weights = dense * size + (cfg.vocab_size * hid + (2 * L + 1) * hid + L * E * hid) * 4
    kv = 2 * L * batch * KV * kv_len * D * size
    total = weights + kv
    return 1e3 * total / HBM_BYTES_PER_S, total / 1e9


def _completions(df) -> list[list[int]]:
    return [np.asarray(r).tolist() for r in df.collect_column("completions")]


def _run_stream(engine, requests) -> dict:
    """The paged arm of the mixed stream: every request submitted at once,
    slots refilled as sequences finish; per request its TTFT and tokens."""
    seqs = [engine.submit(p, n) for p, n in requests]
    t0 = time.perf_counter()
    while any(not s.done for s in seqs):
        engine.admit()
        engine.step()
    wall = time.perf_counter() - t0
    ttft = [(s.first_token_at - t0) * 1e3 for s in seqs]
    return {"wall_s": wall, "ttft_ms": ttft, "tokens": [list(s.generated) for s in seqs]}


def phase_llm_bf16(device, card: str, sd: dict) -> dict:
    """(a) Llama-2-7B in bf16 compute through HuggingFaceCausalLM, dense and
    then paged, each transform twice, and the mixed stream through both."""
    from synapseml_torch.hf import HuggingFaceCausalLM
    from synapseml_torch.models.nets.llama import generate, llama2_7b
    from synapseml_torch.models.paged_engine import PagedDecodeEngine

    cfg = llama2_7b()
    texts = _llm_texts(LLM_ROWS, seed=0)
    df = DataFrame.from_dict({"prompt": np.asarray(texts, dtype=object)},
                             num_partitions=LLM_PARTS)
    tok = HashingTokenizer(vocab_size=cfg.vocab_size)
    kw = dict(model_name="llama2-7b", model_params=sd, tokenizer=tok, batch_size=LLM_BATCH,
              prompt_bucket=LLM_BUCKET, max_new_tokens=LLM_NEW, device=str(device))
    cache = cb.get_compiled_cache()
    useful = LLM_ROWS * LLM_NEW
    out = {}
    t_part = time.perf_counter()

    # ---- dense ----
    stage = HuggingFaceCausalLM(**kw)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, _ = stage._model_and_tokenizer()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    m0 = cache.miss_count("hf_causal_lm")
    t0 = time.perf_counter()
    dense1 = stage.transform(df)
    dense_s = time.perf_counter() - t0
    m1 = cache.miss_count("hf_causal_lm") - m0
    t0 = time.perf_counter()
    dense2 = stage.transform(df)
    dense_s2 = time.perf_counter() - t0
    m2 = cache.miss_count("hf_causal_lm") - m0 - m1
    peak_dense = torch.cuda.max_memory_allocated() / 2 ** 30
    a, a2 = _completions(dense1), _completions(dense2)
    log(f"[llm] (a) dense transforms done at {time.perf_counter() - t_part:.1f} s")
    log(f"[llm] dense: model load (decoder weights cast to bf16 in place) {load_s:.3f} s; transform "
        f"of {LLM_ROWS} prompts x {LLM_NEW} tokens {dense_s:.3f} s ({useful / dense_s:.1f} "
        f"tokens/s), second {dense_s2:.3f} s ({useful / dense_s2:.1f} tokens/s); "
        f"CompiledCache misses {m1:.0f} then {m2:.0f}; peak {peak_dense:.3f} GiB | {card}")
    if not (all(len(r) == LLM_NEW for r in a) and a == a2):
        raise AssertionError("the dense transform's second run differs from its first")
    keys = {(LLM_BATCH, np.asarray(tok(list(p["prompt"]), max_len=cfg.max_len - LLM_NEW,
                                       multiple_of=LLM_BUCKET)["input_ids"]).shape[1])
            for p in df.partitions}
    if not (m1 == len(keys) and m2 == 0):
        raise AssertionError("the dense transform did not take one callable per (bucket, "
                             "prompt rung) from CompiledCache")

    enc = tok(texts[:LLM_BATCH], max_len=cfg.max_len - LLM_NEW, multiple_of=LLM_BUCKET)
    ids = torch.as_tensor(np.asarray(enc["input_ids"]), device=device).long()
    mask = torch.as_tensor(np.asarray(enc["attention_mask"]), device=device).long()
    prefill_ms = cuda_ms(lambda: generate(model, ids, 1, prompt_mask=mask), warmup=1, iters=3)
    full_ms = cuda_ms(lambda: generate(model, ids, LLM_NEW, prompt_mask=mask), warmup=0,
                      iters=1)
    loop_ms = (full_ms - prefill_ms) / (LLM_NEW - 1)
    # one decode step on its own: device time (behind a spin) and profile
    from synapseml_torch.models.nets.transformer import KVCache

    kvc = KVCache.zeros(cfg, LLM_BATCH, device)
    kv_mask = torch.ones((LLM_BATCH, cfg.max_len), dtype=torch.long, device=device)
    kvc.index = ids.shape[1]
    tok1 = ids[:, :1]
    pos = mask.sum(-1, keepdim=True)
    with torch.no_grad():
        step = lambda: model(tok1, positions=pos, attention_mask=kv_mask, cache=kvc)  # noqa: E731
        step_dev_ms = cuda_ms(step, warmup=2, iters=5, spin_cycles=LLM_SPIN)
        prof_dense = _profile_llm_step(step, card, "dense")
    log(f"[llm] (a) dense step timed and profiled at {time.perf_counter() - t_part:.1f} s")
    bound_ms, bound_gb = _step_bound_ms(cfg, LLM_BATCH, cfg.max_len)
    live_ms, _ = _step_bound_ms(cfg, LLM_BATCH, ids.shape[1] + LLM_NEW)
    log(f"[llm] dense batch of {LLM_BATCH} x {ids.shape[1]}: prefill (generate of 1 token) "
        f"{prefill_ms:.3f} ms; decode {loop_ms:.3f} ms a step in the loop (CUDA events, host "
        f"included), one step {step_dev_ms:.3f} ms of device time (behind a spin; the "
        f"profiler's kernels {prof_dense['busy_ms']:.3f} ms, "
        f"{100 * prof_dense['busy_ms'] / loop_ms:.1f}% of the loop's step); bound {bound_ms:.3f} ms "
        f"({bound_gb:.2f} GB: bf16 weights + K/V over all {cfg.max_len} slots; "
        f"{live_ms:.3f} ms over the live {ids.shape[1] + LLM_NEW}) | {card}")
    log(f"[llm] (a) dense part done at {time.perf_counter() - t_part:.1f} s")
    out["dense"] = {"tokens_s": useful / dense_s2, "prefill_ms": prefill_ms,
                    "step_ms": loop_ms, "step_dev_ms": step_dev_ms, "peak_gib": peak_dense,
                    "busy": prof_dense["busy"], "bound_ms": bound_ms, "load_s": load_s}
    del kvc, step
    _free_card()

    # ---- the mixed stream, run-to-completion batches ----
    requests = _mixed_stream(np.random.default_rng(0), LLM_STREAM, cfg.vocab_size)
    want = sum(n for _, n in requests)
    bucketer = cb.default_bucketer()
    groups = [requests[i:i + LLM_SLOTS] for i in range(0, len(requests), LLM_SLOTS)]
    ttft_rtc, rtc_tokens = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in groups:
        P = bucketer.seq_bucket_for(max(len(p) for p, _ in g), cap=cfg.max_len)
        gi, gm = _llm_ids([p for p, _ in g], P, device)
        first = generate(model, gi, 1, prompt_mask=gm).cpu()  # the group's first tokens
        ttft_rtc += [(time.perf_counter() - t0) * 1e3] * len(g)
        res = generate(model, gi, max(n for _, n in g), prompt_mask=gm).cpu().numpy()
        rtc_tokens += [res[i, P:P + n].tolist() for i, (_, n) in enumerate(g)]
        if not (res[:, P] == first.numpy()[:, P]).all():
            raise AssertionError("a group's first tokens differ between two generate calls")
    rtc_s = time.perf_counter() - t0
    log(f"[llm] mixed stream of {LLM_STREAM} requests ({want} tokens asked), run-to-completion "
        f"batches of {LLM_SLOTS}: {rtc_s:.3f} s, {want / rtc_s:.1f} useful tokens/s (each group "
        f"prefilled twice: its TTFT, then the whole generate); TTFT p50 "
        f"{np.percentile(ttft_rtc, 50):.1f} ms, p99 {np.percentile(ttft_rtc, 99):.1f} ms | {card}")
    stage.release()
    del model, dense1, dense2
    _free_card()
    log(f"[llm] (a) run-to-completion stream done at {time.perf_counter() - t_part:.1f} s")

    # ---- paged ----
    blocks = 1 + LLM_BATCH * -(-(LLM_BUCKET + LLM_NEW) // LLM_BLOCK)
    pstage = HuggingFaceCausalLM(**kw, engine="paged", kv_blocks=blocks)
    torch.cuda.reset_peak_memory_stats()
    pmodel, _ = pstage._model_and_tokenizer()
    ids_fn = ("llama_paged_prefill", "llama_paged_decode")
    p0 = {f: cache.miss_count(f) for f in ids_fn}
    t0 = time.perf_counter()
    paged1 = pstage.transform(df)
    paged_s = time.perf_counter() - t0
    p1 = {f: cache.miss_count(f) - p0[f] for f in ids_fn}
    t0 = time.perf_counter()
    paged2 = pstage.transform(df)
    paged_s2 = time.perf_counter() - t0
    p2 = {f: cache.miss_count(f) - p0[f] - p1[f] for f in ids_fn}
    peak_paged = torch.cuda.max_memory_allocated() / 2 ** 30
    b, b2 = _completions(paged1), _completions(paged2)
    eng = next(iter(pstage.__dict__["_cache_engines"].values()))
    n_rungs = len(eng.bucketer.seq_buckets_upto(eng.max_len))
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    log(f"[llm] paged ({blocks} pages of {LLM_BLOCK}): transform {paged_s:.3f} s "
        f"({useful / paged_s:.1f} tokens/s), second {paged_s2:.3f} s ({useful / paged_s2:.1f} "
        f"tokens/s); CompiledCache misses {p1} then {p2} (ladders: {n_rungs} prompt rungs, "
        f"slot rungs {eng.slot_rungs}); peak {peak_paged:.3f} GiB | {card}")
    log(f"[llm] bf16 dense against paged: {same} of {LLM_ROWS * LLM_NEW} tokens equal "
        f"({100 * same / (LLM_ROWS * LLM_NEW):.1f} %; bf16 may flip a near-tie, a report, not "
        f"a check); rows equal {sum(x == y for x, y in zip(a, b))} of {LLM_ROWS}")
    if not (all(len(r) == LLM_NEW for r in b) and b == b2):
        raise AssertionError("the paged transform's second run differs from its first")
    if not (0 < p1["llama_paged_prefill"] <= n_rungs
            and 0 < p1["llama_paged_decode"] <= len(eng.slot_rungs) and not any(p2.values())):
        raise AssertionError("the paged engine's CompiledCache misses exceed the ladders")
    pstage.release()
    del paged1, paged2, eng
    _free_card()
    log(f"[llm] (a) paged transforms done at {time.perf_counter() - t_part:.1f} s")

    # ---- the mixed stream through PagedDecodeEngine, and one profiled step ----
    need = max(-(-(len(p) + n) // LLM_BLOCK) for p, n in requests)
    engine = PagedDecodeEngine(pmodel, block_len=LLM_BLOCK, max_slots=LLM_SLOTS,
                               prefill_batch=2, n_blocks=1 + LLM_SLOTS * need)
    torch.cuda.synchronize()
    run = _run_stream(engine, requests)
    paged_tokens = run["tokens"]
    same_stream = sum(x == y for ra, rb in zip(rtc_tokens, paged_tokens)
                      for x, y in zip(ra, rb))
    log(f"[llm] mixed stream through PagedDecodeEngine.generate's loop, {LLM_SLOTS} slots: "
        f"{run['wall_s']:.3f} s, {want / run['wall_s']:.1f} useful tokens/s "
        f"({rtc_s / run['wall_s']:.2f}x the run-to-completion arm); TTFT p50 "
        f"{np.percentile(run['ttft_ms'], 50):.1f} ms, p99 "
        f"{np.percentile(run['ttft_ms'], 99):.1f} ms; {same_stream} of {want} tokens equal "
        f"to the run-to-completion arm's | {card}")
    if [len(t) for t in paged_tokens] != [n for _, n in requests]:
        raise AssertionError("the paged engine did not generate each request's budget")
    seqs = [engine.submit(p, LLM_NEW) for p in [r[0] for r in requests[:LLM_SLOTS]]]
    engine.admit()
    engine.step()
    paged_step_ms = cuda_ms(engine.step, warmup=1, iters=5)
    prof_paged = _profile_llm_step(engine.step, card, "paged")
    pbound_ms, pbound_gb = _step_bound_ms(cfg, LLM_SLOTS, eng_len := engine.max_blocks
                                          * LLM_BLOCK)
    log(f"[llm] paged decode step, {LLM_SLOTS} active: {paged_step_ms:.3f} ms (CUDA events, "
        f"host included; the profiler's kernels {prof_paged['busy_ms']:.3f} ms, "
        f"{100 * prof_paged['busy_ms'] / paged_step_ms:.1f}% of it); bound {pbound_ms:.3f} ms ({pbound_gb:.2f} GB over the {eng_len} "
        f"slots of a block table) | {card}")
    engine.abort_all()
    engine.release()
    del seqs, engine, pmodel
    _free_card()
    out["paged"] = {"tokens_s": useful / paged_s2, "step_ms": paged_step_ms,
                    "peak_gib": peak_paged, "busy": prof_paged["busy"], "bound_ms": pbound_ms,
                    "ttft_p50_ms": float(np.percentile(run["ttft_ms"], 50)),
                    "stream_tokens_s": want / run["wall_s"]}
    out["rtc"] = {"stream_tokens_s": want / rtc_s,
                  "ttft_p50_ms": float(np.percentile(ttft_rtc, 50))}
    out["equal_share"] = same / (LLM_ROWS * LLM_NEW)
    return out


def phase_llm_f32(device, card: str, sd: dict) -> int:
    """(b) The same weights in f32 compute (TF32 off): dense generate and the
    paged engine on 4 prompts over 3 prompt rungs, 16 new tokens each, held
    to each other by the margin rule."""
    from synapseml_torch.hf.causal_lm import load_llama
    from synapseml_torch.models.nets.llama import llama2_7b

    model = load_llama(llama2_7b(dtype=torch.float32), sd, device)
    compared = _f32_dense_against_paged(model, device, card, "Llama-2-7B")
    del model
    _free_card()
    return compared


def _f32_dense_against_paged(model, device, card: str, tag: str) -> int:
    """Dense generate and the paged engine on ``model`` (f32 compute) over 4
    prompts on 3 prompt rungs, 16 new tokens each, held to each other by the
    margin rule; returns the tokens compared (at least LLM_MIN_COMPARED)."""
    from synapseml_torch.models.nets.llama import generate
    from synapseml_torch.models.paged_engine import PagedDecodeEngine

    cfg = model.cfg
    rs = np.random.default_rng(1)
    prompts = [rs.integers(2, cfg.vocab_size, (n,)).tolist() for n in LLM_F32_LENS]
    ids, mask = _llm_ids(prompts, cb.default_bucketer().seq_bucket_for(max(LLM_F32_LENS)),
                         device)
    t0 = time.perf_counter()
    dense = generate(model, ids, LLM_F32_NEW, prompt_mask=mask).cpu().numpy()[:, ids.shape[1]:]
    dense_s = time.perf_counter() - t0
    _free_card()
    engine = PagedDecodeEngine(model, block_len=LLM_BLOCK, max_slots=len(prompts),
                               n_blocks=1 + len(prompts) * -(-(max(LLM_F32_LENS) + LLM_F32_NEW)
                                                            // LLM_BLOCK))
    t0 = time.perf_counter()
    paged = engine.generate(prompts, LLM_F32_NEW)
    paged_s = time.perf_counter() - t0
    engine.release()
    dense = [r.tolist() for r in dense]
    md = _teacher_margins(model, prompts, dense)
    mp = _teacher_margins(model, prompts, paged)
    log(f"[llm] f32 {tag}, TF32 off: dense generate {dense_s:.3f} s, paged "
        f"{paged_s:.3f} s; top-2 margins (dense run) "
        + "; ".join(" ".join(f"{v:.2e}" for v in m[0]) for m in md))
    compared = _margin_rule(dense, paged, md, mp, f"{tag} f32 dense against paged")
    log(f"[llm] {tag} f32 dense = paged on {compared} tokens compared (need >= "
        f"{LLM_MIN_COMPARED}) | {card}")
    if compared < LLM_MIN_COMPARED:
        raise AssertionError(f"{tag}: too few f32 tokens compared under the margin rule")
    del engine
    _free_card()
    return compared


def phase_llm_tiny(device, card: str) -> dict:
    """(c) llama_tiny in f32 on the card and on the CPU (same weights): dense
    and paged greedy held by the margin rule; sampling with top-k / top-p
    bitwise reproducible on the card, every token in the top-k support."""
    from synapseml_torch.hf.causal_lm import load_llama
    from synapseml_torch.models.convert_jax import init_llama_params
    from synapseml_torch.models.nets.llama import generate, llama_tiny
    from synapseml_torch.models.paged_engine import PagedDecodeEngine

    cfg = llama_tiny(dtype=torch.float32)
    sd = init_llama_params(cfg, seed=0, device="cpu")
    on = {d: load_llama(cfg, sd, d) for d in ("cpu", str(device))}
    rs = np.random.default_rng(2)
    prompts = [rs.integers(2, cfg.vocab_size, (n,)).tolist() for n in LLM_TINY_LENS]
    runs = {}
    for d, model in on.items():
        ids, mask = _llm_ids(prompts, 64, d)
        runs[d, "dense"] = [r.tolist() for r in
                            generate(model, ids, LLM_TINY_NEW, prompt_mask=mask).cpu().numpy()[:, 64:]]
        eng = PagedDecodeEngine(model, block_len=LLM_BLOCK, max_slots=4)
        runs[d, "paged"] = eng.generate(prompts, LLM_TINY_NEW)
        eng.release()
    card_d = str(device)
    compared = 0
    for kind in ("dense", "paged"):
        m_cpu = _teacher_margins(on["cpu"], prompts, runs["cpu", kind])
        m_card = _teacher_margins(on[card_d], prompts, runs[card_d, kind])
        compared += _margin_rule(runs["cpu", kind], runs[card_d, kind], m_cpu, m_card,
                                 f"llama_tiny {kind}, CPU against the card")
    model = on[card_d]
    ids, mask = _llm_ids(prompts, 64, device)
    samp = dict(temperature=LLM_TEMP, top_k=LLM_TOP_K, top_p=LLM_TOP_P)
    s1 = generate(model, ids, LLM_TINY_NEW, prompt_mask=mask, rng=7, **samp).cpu().numpy()
    s2 = generate(model, ids, LLM_TINY_NEW, prompt_mask=mask, rng=7, **samp).cpu().numpy()
    s3 = generate(model, ids, LLM_TINY_NEW, prompt_mask=mask, rng=8, **samp).cpu().numpy()
    engs = [PagedDecodeEngine(model, block_len=LLM_BLOCK, max_slots=4, seed=5, **samp)
            for _ in range(2)]
    e1, e2 = (e.generate(prompts, LLM_TINY_NEW, uids=range(10, 10 + len(prompts)))
              for e in engs)
    for e in engs:
        e.release()
    dense_s = [r[64:].tolist() for r in s1]
    support = [m[1] for m in _teacher_margins(model, prompts, dense_s)]
    support += [m[1] for m in _teacher_margins(model, prompts, e1)]
    n_in = int(sum(s.sum() for s in support))
    n_all = int(sum(s.size for s in support))
    log(f"[llm] llama_tiny f32, CPU against the card: {compared} greedy tokens compared; "
        f"sampling (T {LLM_TEMP}, top-k {LLM_TOP_K}, top-p {LLM_TOP_P}) on the card: dense "
        f"bitwise on a second run {np.array_equal(s1, s2)}, another seed differs "
        f"{not np.array_equal(s1, s3)}; paged bitwise {e1 == e2}; {n_in} of {n_all} sampled "
        f"tokens in the top-{LLM_TOP_K} support | {card}")
    if not (np.array_equal(s1, s2) and e1 == e2 and not np.array_equal(s1, s3)):
        raise AssertionError("sampling on the card is not reproducible for a seed")
    if n_in != n_all:
        raise AssertionError("a sampled token lies outside the top-k support")
    del on, model
    _free_card()
    return {"compared": compared}


def phase_llm(device, card: str) -> dict:
    """Main path 6: (a) Llama-2-7B bf16 through both engines, (b) f32 parity
    of the engines at full width, (c) llama_tiny card against CPU and
    sampling; no kernel of the port's may launch on the path."""
    from synapseml_torch.models.convert_jax import init_llama_params
    from synapseml_torch.models.nets.llama import llama2_7b

    t_start = time.perf_counter()
    _zero_port_kernel_counts()
    cfg = llama2_7b()
    t0 = time.perf_counter()
    sd = init_llama_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in sd.values())
    log(f"[llm] Llama-2-7B weights from init_llama_params(seed=0) on the card: {n_params} "
        f"parameters, {sum(v.numel() * v.element_size() for v in sd.values()) / 1e9:.2f} GB "
        f"f32, in {time.perf_counter() - t0:.3f} s")
    out = phase_llm_bf16(device, card, sd)
    log(f"[llm] (a) done at {time.perf_counter() - t_start:.1f} s")
    out["f32_compared"] = phase_llm_f32(device, card, sd)
    del sd
    _free_card()
    log(f"[llm] (b) done at {time.perf_counter() - t_start:.1f} s")
    out["tiny"] = phase_llm_tiny(device, card)
    counts = _port_kernel_counts()
    log(f"[llm] the port's kernels launched on main path 6: {counts} (want none)")
    if any(counts.values()):
        raise AssertionError(f"main path 6 launched a kernel of the port's: {counts}")
    out["seconds"] = time.perf_counter() - t_start
    log(f"[llm] main path 6: {out['seconds']:.1f} s of the script's clock")
    return out


# ---------------- main path 7: pretrained checkpoint directories ----------------

# Checkpoint directories in HuggingFace's layout (config.json, safetensors
# under HF key names), written here from seeded numpy weights into a
# temporary directory removed at the end: BERT-base BertForSequenceClassification,
# ViT-B/16 ViTForImageClassification, ResNet-50 in microsoft/resnet-* naming,
# GPT-2 small (tied head) in F32, one file each; Llama-2-7B at full width with
# its depth cut to CK_LLAMA_LAYERS of 32 layers, F16, in two shards.
CK_LLAMA_LAYERS = 4
CK_FIT_ROWS, CK_FIT_STEPS = 768, 24     # the BERT-base checkpoint fit: 3 chunks of 8 at batch 32
CK_SCORE_ROWS = 200                     # texts scored by the fitted model (2 partitions)
CK_EMBED_ROWS, CK_EMBED_CPU = 512, 16   # texts the embedder embeds; of them on the CPU too
CK_EMBED_TOL = 1e-4                     # f32 embeddings, the card against the CPU
CK_VISION_TOL = 1e-5                    # f32 logits, the directory's module against the preset's
CK_LLM_LENS, CK_LLM_NEW = (12, 24, 40, 60), 16  # f32 prompts (rungs 16, 32, 64), new tokens
CK_BERT = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
               intermediate_size=3072, max_position_embeddings=512, type_vocab_size=2,
               layer_norm_eps=1e-12, hidden_act="gelu")
CK_VIT = dict(image_size=224, patch_size=16, num_channels=3, hidden_size=768,
              num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072,
              layer_norm_eps=1e-12, hidden_act="gelu")
CK_RESNET = dict(embedding_size=64, hidden_sizes=[256, 512, 1024, 2048], depths=[3, 4, 6, 3],
                 layer_type="bottleneck")
CK_GPT2 = dict(vocab_size=50257, n_embd=768, n_layer=12, n_head=12, n_positions=1024,
               layer_norm_epsilon=1e-5, activation_function="gelu_new")
CK_LLAMA = dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=CK_LLAMA_LAYERS,
                num_attention_heads=32, num_key_value_heads=32, intermediate_size=11008,
                max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
                tie_word_embeddings=False)
_ST_NAMES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
             np.dtype(np.int64): "I64", torch.bfloat16: "BF16"}


def _raw_bytes(a) -> np.ndarray:
    """The little-endian bytes of an array, or of a BF16 tensor (numpy has
    no bfloat16: written from its bits)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().reshape(-1).view(np.uint8)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _same_tensor(got, want) -> bool:
    """Dtype, shape and bits equal: numpy arrays, or BF16 tensors."""
    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and got.shape == want.shape
                and torch.equal(got.view(torch.int16), want.view(torch.int16)))
    return got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)


def _write_safetensors(path: str, tensors: dict) -> int:
    """The safetensors format by hand (the package's reader is under test):
    an 8-byte little-endian header length, the JSON header padded to 8
    bytes, the raw bytes in header order. The file is synced and dropped
    from the page cache, so that a load reads the disk. Returns its bytes."""
    header, offset = {}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": _ST_NAMES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps({"__metadata__": {"format": "pt"}, **header}).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for a in tensors.values():
            f.write(_raw_bytes(a))
        f.flush()
        os.fsync(f.fileno())
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return 8 + len(raw) + offset


def _write_checkpoint(d: str, config: dict, tensors: dict, shards: int = 1) -> int:
    """``d``/config.json and model.safetensors, or ``shards`` files split in
    key order by size with model.safetensors.index.json; returns the bytes
    of the weight files."""
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    if shards == 1:
        return _write_safetensors(os.path.join(d, "model.safetensors"), tensors)
    total = sum(a.nbytes for a in tensors.values())
    groups, acc = [[] for _ in range(shards)], 0
    for name, a in tensors.items():
        groups[min(acc * shards // total, shards - 1)].append(name)
        acc += a.nbytes
    weight_map, written = {}, 0
    for i, names in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        written += _write_safetensors(os.path.join(d, fname), {k: tensors[k] for k in names})
        weight_map.update(dict.fromkeys(names, fname))
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return written


class _Draw:
    """Seeded numpy weights: N(0, 0.02) tables, Xavier-uniform Linear weights
    ``[out, in]``, small random biases, norm scales near 1, in ``dtype``."""

    def __init__(self, seed: int, dtype=np.float32):
        self.rs, self.dtype = np.random.default_rng(seed), np.dtype(dtype)

    def normal(self, *shape, std=0.02):
        x = self.rs.standard_normal(shape, dtype=np.float32)
        x *= np.float32(std)
        return x.astype(self.dtype, copy=False)

    def linear(self, n_out, n_in, *kernel):
        lim = np.float32(np.sqrt(6.0 / (n_in + n_out)))
        u = self.rs.random((n_out, n_in, *kernel), dtype=np.float32)
        u *= 2 * lim
        u -= lim
        return u.astype(self.dtype, copy=False)

    def bias(self, n):
        return self.normal(n, std=0.01)

    def scale(self, n):
        return (1 + self.normal(n, std=0.05)).astype(self.dtype, copy=False)


def _bert_checkpoint(seed: int) -> tuple[dict, dict]:
    """BertForSequenceClassification (2 labels) at CK_BERT, F32, with the
    int64 ``position_ids`` buffer older checkpoints carry."""
    c, w = CK_BERT, _Draw(seed)
    hid, mlp = c["hidden_size"], c["intermediate_size"]
    t = {"bert.embeddings.position_ids": np.arange(c["max_position_embeddings"],
                                                   dtype=np.int64)[None],
         "bert.embeddings.word_embeddings.weight": w.normal(c["vocab_size"], hid),
         "bert.embeddings.position_embeddings.weight": w.normal(c["max_position_embeddings"],
                                                                hid),
         "bert.embeddings.token_type_embeddings.weight": w.normal(c["type_vocab_size"], hid),
         "bert.embeddings.LayerNorm.weight": w.scale(hid),
         "bert.embeddings.LayerNorm.bias": w.bias(hid)}
    for i in range(c["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        for name, (n_out, n_in) in (("attention.self.query", (hid, hid)),
                                    ("attention.self.key", (hid, hid)),
                                    ("attention.self.value", (hid, hid)),
                                    ("attention.output.dense", (hid, hid)),
                                    ("intermediate.dense", (mlp, hid)),
                                    ("output.dense", (hid, mlp))):
            t[f"{p}.{name}.weight"], t[f"{p}.{name}.bias"] = w.linear(n_out, n_in), w.bias(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            t[f"{p}.{name}.weight"], t[f"{p}.{name}.bias"] = w.scale(hid), w.bias(hid)
    t["bert.pooler.dense.weight"], t["bert.pooler.dense.bias"] = w.linear(hid, hid), w.bias(hid)
    t["classifier.weight"], t["classifier.bias"] = w.linear(2, hid), w.bias(2)
    return {"model_type": "bert", "architectures": ["BertForSequenceClassification"],
            "num_labels": 2, **c}, t


def _vit_checkpoint(seed: int) -> tuple[dict, dict]:
    """ViTForImageClassification (VIT_CLASSES labels) at CK_VIT, F32."""
    c, w = CK_VIT, _Draw(seed)
    hid, mlp, p_ = c["hidden_size"], c["intermediate_size"], c["patch_size"]
    t = {"vit.embeddings.cls_token": w.normal(1, 1, hid),
         "vit.embeddings.position_embeddings": w.normal(1, 1 + (c["image_size"] // p_) ** 2, hid),
         "vit.embeddings.patch_embeddings.projection.weight": w.linear(hid, c["num_channels"],
                                                                      p_, p_),
         "vit.embeddings.patch_embeddings.projection.bias": w.bias(hid)}
    for i in range(c["num_hidden_layers"]):
        p = f"vit.encoder.layer.{i}"
        for name, (n_out, n_in) in (("attention.attention.query", (hid, hid)),
                                    ("attention.attention.key", (hid, hid)),
                                    ("attention.attention.value", (hid, hid)),
                                    ("attention.output.dense", (hid, hid)),
                                    ("intermediate.dense", (mlp, hid)),
                                    ("output.dense", (hid, mlp))):
            t[f"{p}.{name}.weight"], t[f"{p}.{name}.bias"] = w.linear(n_out, n_in), w.bias(n_out)
        for name in ("layernorm_before", "layernorm_after"):
            t[f"{p}.{name}.weight"], t[f"{p}.{name}.bias"] = w.scale(hid), w.bias(hid)
    t["vit.layernorm.weight"], t["vit.layernorm.bias"] = w.scale(hid), w.bias(hid)
    t["classifier.weight"], t["classifier.bias"] = w.linear(VIT_CLASSES, hid), w.bias(VIT_CLASSES)
    return {"model_type": "vit", "architectures": ["ViTForImageClassification"], **c}, t


def _resnet_checkpoint(seed: int) -> tuple[dict, dict]:
    """ResNetForImageClassification (VIT_CLASSES labels) at CK_RESNET in HF
    naming, F32: convolutions He-scaled, BatchNorm with running statistics
    (and the int64 num_batches_tracked each carries)."""
    c, w = CK_RESNET, _Draw(seed)
    t = {}

    def conv(name, c_out, c_in, k):
        t[f"{name}.convolution.weight"] = (w.rs.standard_normal((c_out, c_in, k, k),
                                                                dtype=np.float32)
                                           * np.float32(np.sqrt(2.0 / (c_in * k * k))))
        bn = f"{name}.normalization"
        t[f"{bn}.weight"], t[f"{bn}.bias"] = w.scale(c_out), w.bias(c_out)
        t[f"{bn}.running_mean"] = w.normal(c_out, std=0.1)
        t[f"{bn}.running_var"] = (0.5 + w.rs.random(c_out, dtype=np.float32))
        t[f"{bn}.num_batches_tracked"] = np.asarray(1000, np.int64)

    width = c["embedding_size"]
    conv("resnet.embedder.embedder", width, 3, 7)
    c_in = width
    for s, (n_blocks, out) in enumerate(zip(c["depths"], c["hidden_sizes"])):
        f = out // 4
        for j in range(n_blocks):
            p = f"resnet.encoder.stages.{s}.layers.{j}"
            if j == 0:
                conv(f"{p}.shortcut", out, c_in, 1)
            conv(f"{p}.layer.0", f, c_in, 1)
            conv(f"{p}.layer.1", f, f, 3)
            conv(f"{p}.layer.2", out, f, 1)
            c_in = out
    t["classifier.1.weight"] = w.linear(VIT_CLASSES, c_in)
    t["classifier.1.bias"] = w.bias(VIT_CLASSES)
    return {"model_type": "resnet", "architectures": ["ResNetForImageClassification"],
            "num_channels": 3, "hidden_act": "relu", "downsample_in_first_stage": False,
            **c}, t


def _gpt2_checkpoint(seed: int) -> tuple[dict, dict]:
    """GPT2LMHeadModel at CK_GPT2, F32: Conv1D weights ``[in, out]``, the
    fused c_attn, the LM head tied to wte (no lm_head tensor)."""
    c, w = CK_GPT2, _Draw(seed)
    hid = c["n_embd"]
    t = {"transformer.wte.weight": w.normal(c["vocab_size"], hid),
         "transformer.wpe.weight": w.normal(c["n_positions"], hid, std=0.01)}
    for i in range(c["n_layer"]):
        p = f"transformer.h.{i}"
        for name, (n_in, n_out) in (("attn.c_attn", (hid, 3 * hid)), ("attn.c_proj", (hid, hid)),
                                    ("mlp.c_fc", (hid, 4 * hid)), ("mlp.c_proj", (4 * hid, hid))):
            t[f"{p}.{name}.weight"] = np.ascontiguousarray(w.linear(n_out, n_in).T)
            t[f"{p}.{name}.bias"] = w.bias(n_out)
        for name in ("ln_1", "ln_2"):
            t[f"{p}.{name}.weight"], t[f"{p}.{name}.bias"] = w.scale(hid), w.bias(hid)
    t["transformer.ln_f.weight"], t["transformer.ln_f.bias"] = w.scale(hid), w.bias(hid)
    return {"model_type": "gpt2", "architectures": ["GPT2LMHeadModel"], **c}, t


def _llama_checkpoint(seed: int) -> tuple[dict, dict]:
    """LlamaForCausalLM at CK_LLAMA (no biases, an untied lm_head), F16."""
    c, w = CK_LLAMA, _Draw(seed, np.float16)
    hid, mlp = c["hidden_size"], c["intermediate_size"]
    kv = hid // c["num_attention_heads"] * c["num_key_value_heads"]
    t = {"model.embed_tokens.weight": w.normal(c["vocab_size"], hid)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        for name, (n_out, n_in) in (("self_attn.q_proj", (hid, hid)), ("self_attn.k_proj", (kv, hid)),
                                    ("self_attn.v_proj", (kv, hid)), ("self_attn.o_proj", (hid, hid)),
                                    ("mlp.gate_proj", (mlp, hid)), ("mlp.up_proj", (mlp, hid)),
                                    ("mlp.down_proj", (hid, mlp))):
            t[f"{p}.{name}.weight"] = w.linear(n_out, n_in)
        t[f"{p}.input_layernorm.weight"] = w.scale(hid)
        t[f"{p}.post_attention_layernorm.weight"] = w.scale(hid)
    t["model.norm.weight"] = w.scale(hid)
    t["lm_head.weight"] = w.normal(c["vocab_size"], hid)
    return {"model_type": "llama", "architectures": ["LlamaForCausalLM"],
            "torch_dtype": "float16", **c}, t


class _PeakRss:
    """The process's resident memory, sampled every 2 ms from
    /proc/self/statm on a thread while the block runs: (before, peak,
    after) in GiB."""

    def __init__(self):
        import threading

        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def rss(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page / 2 ** 30

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self.rss())

    def __enter__(self):
        self.before = self.peak = self.rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.after = self.rss()
        self.peak = max(self.peak, self.after)


def _drop_page_cache(d: str) -> None:
    """Drop the files of directory ``d`` from the page cache, so that a
    load reads the disk."""
    for f in os.listdir(d):
        fd = os.open(os.path.join(d, f), os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


class _Checkpoints:
    """The directories of main paths 7 and 8 under one temporary root, each
    written on first use, read back bitwise (F32, F16, BF16 and I64, across
    shards) and timed; the root goes on close."""

    def __init__(self, card: str):
        import tempfile

        self.root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        self.card, self.dirs, self.loads, self.bytes = card, {}, {}, {}

    def get(self, name: str, make, seed: int, shards: int = 1) -> str:
        if name in self.dirs:
            return self.dirs[name]
        from synapseml_torch.models.convert_hf import load_checkpoint

        t0 = time.perf_counter()
        config, tensors = make(seed)
        draw_s = time.perf_counter() - t0
        d = os.path.join(self.root, name)
        t0 = time.perf_counter()
        nbytes = _write_checkpoint(d, config, tensors, shards)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got_cfg, sd = load_checkpoint(d)
        bad = sorted(set(tensors) ^ set(sd))
        bad += [k for k in tensors if k in sd and not _same_tensor(sd[k], tensors[k])]
        check_s = time.perf_counter() - t0
        kinds = sorted({_ST_NAMES[a.dtype] for a in tensors.values()})
        log(f"[ckpt] {name}: {len(tensors)} tensors ({', '.join(kinds)}), "
            f"{nbytes / 1e9:.3f} GB in {shards} file(s): drawn {draw_s:.1f} s, written "
            f"{write_s:.1f} s; read back bitwise: {not bad and got_cfg == config} "
            f"({check_s:.1f} s){f', differing {bad[:5]}' if bad else ''}")
        if bad or got_cfg != config:
            raise AssertionError(f"{name}: the reader does not read back what was written")
        self.dirs[name] = d
        self.bytes[name] = nbytes
        del tensors, sd
        return d

    def timed_load(self, name: str, load, device) -> tuple:
        """``load(dir)`` (a ``pretrained_*`` call) and every mapped tensor's
        copy to the device, cast there to float32 as the stages cast it, from
        the disk (the files dropped from the page cache again): host seconds
        and GB/s of the weight files."""
        d = self.dirs[name]
        _drop_page_cache(d)
        t0 = time.perf_counter()
        out = load(d)
        state = out[-1] if isinstance(out[-1], dict) and "params" not in out[-1] \
            else {**out[-1]["params"], **(out[-1].get("batch_stats") or {})}
        on_card = {k: host_tensor(v).to(device) for k, v in state.items()}
        on_card = {k: t.float() if t.is_floating_point() else t for k, t in on_card.items()}
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        gbs = self.bytes[name] / 1e9 / s
        self.loads[name] = {"s": s, "gb_s": gbs}
        log(f"[ckpt] {name} loaded from disk (mapping and every tensor to the card): {s:.3f} s "
            f"host clock, {gbs:.2f} GB/s of {self.bytes[name] / 1e9:.3f} GB | {self.card}")
        del on_card
        return out

    def close(self) -> None:
        shutil.rmtree(self.root, ignore_errors=True)


def _ckpt_reader_cases(ck: _Checkpoints, device) -> None:
    """(a) A BF16 tensor read back bitwise (a torch.bfloat16 view of the
    file's bits), and what the reader refuses: a tokenizer-less directory
    with tokenizer=None (the "pass tokenizer=" ValueError, never an
    ImportError on a host without transformers), an oversized tokenizer
    vocab (the guard)."""
    from synapseml_torch.hf import HuggingFaceCausalLM
    from synapseml_torch.models import convert_hf

    path = os.path.join(ck.root, "bf16.safetensors")
    raw = json.dumps({"w": {"dtype": "BF16", "shape": [4], "data_offsets": [0, 8]}}).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw + b"\x80\x3f" * 4)
    outcomes = {}
    w = convert_hf.load_safetensors(path)["w"]
    bits = w.view(torch.int16).tolist()
    outcomes["bf16"] = f"read as {w.dtype}, bits {[hex(b) for b in bits]}"
    d = ck.dirs["bert_base"]
    try:
        convert_hf.tokenizer_for_checkpoint(None, d, CK_BERT["vocab_size"])
        outcomes["no tokenizer"] = "resolved"
    except ValueError as e:
        outcomes["no tokenizer"] = f"ValueError: {e}"
    try:
        HuggingFaceCausalLM(model_name=ck.dirs["gpt2"], device=str(device),
                            tokenizer=HashingTokenizer(vocab_size=60000))._model_and_tokenizer()
        outcomes["vocab guard"] = "accepted"
    except ValueError as e:
        outcomes["vocab guard"] = f"ValueError: {e}"
    for k, v in outcomes.items():
        log(f"[ckpt] (a) {k}: {v}")
    if not (w.dtype == torch.bfloat16 and bits == [0x3F80] * 4 and w.float().tolist() == [1.0] * 4
            and "pass tokenizer=" in outcomes["no tokenizer"]
            and "exceeds the checkpoint" in outcomes["vocab guard"]):
        raise AssertionError(f"main path 7 (a): a read or a refusal went wrong: {outcomes}")


def _ckpt_text(ck: _Checkpoints, device, card: str) -> dict:
    """(b) DeepTextClassifier(checkpoint=<BERT-base dir>, attn_impl='flash'):
    the stage's graph fit of CK_FIT_STEPS steps, bitwise the preset path's
    fit from the same mapped initial state_dict; the flash forward and
    backward 12 times a step; the fitted model scoring through the flash
    kernel and round-tripping save -> load bitwise."""
    import tempfile

    from synapseml_torch.models.convert_hf import pretrained_text_classifier

    d = ck.get("bert_base", _bert_checkpoint, seed=11)
    _, init = ck.timed_load("bert_base", lambda p: pretrained_text_classifier(p, num_classes=2),
                            device)
    tok = HashingTokenizer(vocab_size=CK_BERT["vocab_size"])
    df = DataFrame.from_rows(_labelled_texts(CK_FIT_ROWS, seed=7), num_partitions=2)
    kw = dict(num_classes=2, batch_size=FT_BATCH, max_token_len=FT_LEN, max_steps=CK_FIT_STEPS,
              learning_rate=FT_LR, seed=0, attn_impl="flash", tokenizer=tok.to_config(),
              device=str(device))

    def fit(checkpoint):
        before = _flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = DeepTextClassifier(checkpoint=checkpoint, **kw).fit(df)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        after = _flash_counts()
        return model, s, {k: after[k]["bf16"] - before[k]["bf16"] for k in after}

    model, fit_s, fit_launches = fit(d)
    layers = model.get("arch_config").n_layers  # one flash call a layer a step
    (metrics,) = model.get("train_metrics")
    params = model.get("model_params")
    moved = sum(not np.array_equal(params[k], init[k]) for k in params)
    log(f"[ckpt] (b) DeepTextClassifier(checkpoint=<BERT-base dir>, attn_impl='flash') graph fit "
        f"of {CK_FIT_STEPS} steps at batch {FT_BATCH} x {FT_LEN}: {fit_s:.2f} s host clock "
        f"({CK_FIT_STEPS * FT_BATCH / fit_s:.1f} samples/s, capture and warm-up included), "
        f"train_metrics {json.dumps(metrics)}; parameters moved {moved} of {len(params)}; "
        f"flash launches in the fit {fit_launches} (want {layers * CK_FIT_STEPS} each) | {card}")
    if not (np.isfinite(metrics["loss"]) and metrics["step"] == CK_FIT_STEPS
            and moved == len(params)
            and fit_launches == {"fwd": layers * CK_FIT_STEPS, "bwd": layers * CK_FIT_STEPS}
            and model.get("arch_config") == dataclasses.replace(
                bert_base(vocab_size=CK_BERT["vocab_size"]), attn_impl="flash")):
        raise AssertionError("main path 7 (b): the checkpoint fit failed its checks")

    # the preset path given the same mapped initial state_dict
    orig = text_stage._init_params
    text_stage._init_params = lambda cfg, num_classes, seed: init
    try:
        preset, _, _ = fit("bert-base")
        differ = [k for k in params if not np.array_equal(params[k], preset.get("model_params")[k])]
        spread = []
        if differ:  # where two preset fits already differ, held within TOL_SPREAD
            again, _, _ = fit("bert-base")
            spread = _graph_against_eager(params, preset.get("model_params"),
                                          again.get("model_params"),
                                          "[ckpt] (b) checkpoint fit against the preset fit:")
    finally:
        text_stage._init_params = orig
    log(f"[ckpt] (b) the checkpoint fit against the preset path's fit from the same mapped "
        f"init: {len(params) - len(differ)} of {len(params)} parameters bitwise equal "
        f"(differing {differ or 'none'}; two preset fits differ on {spread or 'none'})")

    score_df = DataFrame.from_rows(_labelled_texts(CK_SCORE_ROWS, seed=8), num_partitions=2)
    batches = sum(len(list(cb.default_bucketer().slices(len(p["text"]), FT_BATCH)))
                  for p in score_df.partitions)
    before = _flash_counts()["fwd"]["bf16"]
    scores = np.stack(list(model.transform(score_df).collect_column("scores")))
    score_launches = _flash_counts()["fwd"]["bf16"] - before
    with tempfile.TemporaryDirectory(dir=ck.root) as tmp:
        model.save(os.path.join(tmp, "m"))
        loaded = DeepTextModel.load(os.path.join(tmp, "m"))
        again = np.stack(list(loaded.transform(score_df).collect_column("scores")))
    same = np.array_equal(scores, again)
    log(f"[ckpt] (b) the fitted model scores {len(scores)} texts through the flash kernel: "
        f"{score_launches} forward launches (want {layers * batches}: {layers} a batch of "
        f"{batches}); "
        f"a save -> load round trip bitwise: {same} | {card}")
    if not (score_launches == layers * batches and same and np.isfinite(scores).all()):
        raise AssertionError("main path 7 (b): the fitted model's scoring failed its checks")
    del model, preset, loaded
    _free_card()
    return {"fit_s": fit_s, "samples_s": CK_FIT_STEPS * FT_BATCH / fit_s, "spread": spread}


def _ckpt_embedder(ck: _Checkpoints, device, card: str) -> dict:
    """(e) HuggingFaceSentenceEmbedder(model_name=<BERT-base dir>), f32
    (TF32 off): a second transform bitwise the first, one CompiledCache
    callable a (bucket, seq_len) and none on the repeat, CK_EMBED_CPU rows
    on the card within CK_EMBED_TOL of the port on the CPU."""
    from synapseml_torch.hf import HuggingFaceSentenceEmbedder

    d = ck.get("bert_base", _bert_checkpoint, seed=11)
    tok = HashingTokenizer(vocab_size=CK_BERT["vocab_size"])
    texts = [r["text"] for r in _labelled_texts(CK_EMBED_ROWS, seed=9, n_words=(5, 150))]
    half = CK_EMBED_ROWS // 2 + 7
    df = DataFrame([{"text": np.asarray(texts[:half], dtype=object)},
                    {"text": np.asarray(texts[half:], dtype=object)}])
    kw = dict(model_name=d, tokenizer=tok.to_config(), batch_size=FT_BATCH, max_token_len=FT_LEN)
    stage = HuggingFaceSentenceEmbedder(**kw, device=str(device))
    cache = cb.get_compiled_cache()
    m0 = cache.miss_count("hf_embedder")
    t0 = time.perf_counter()
    first = np.stack(list(stage.transform(df).collect_column("embeddings")))
    first_s = time.perf_counter() - t0
    m1 = cache.miss_count("hf_embedder") - m0
    t0 = time.perf_counter()
    second = np.stack(list(stage.transform(df).collect_column("embeddings")))
    second_s = time.perf_counter() - t0
    m2 = cache.miss_count("hf_embedder") - m0 - m1
    keys = {(b, np.asarray(tok(list(p["text"]), max_len=FT_LEN)["input_ids"]).shape[1])
            for p in df.partitions for *_, b in cb.default_bucketer().slices(len(p["text"]),
                                                                             FT_BATCH)}
    small = DataFrame.from_dict({"text": np.asarray(texts[:CK_EMBED_CPU], dtype=object)})
    cpu = np.stack(list(HuggingFaceSentenceEmbedder(**kw, device="cpu").transform(small)
                        .collect_column("embeddings")))
    err = float(np.abs(cpu - first[:CK_EMBED_CPU]).max())
    same = np.array_equal(first, second)
    log(f"[ckpt] (e) HuggingFaceSentenceEmbedder(model_name=<BERT-base dir>) f32, mean pooling: "
        f"{len(first)} texts, {first_s:.3f} s first (load included), {second_s:.3f} s second = "
        f"{len(first) / second_s:.1f} rows/s (host clock); a second transform bitwise the first: "
        f"{same}; CompiledCache misses {m1:g} then {m2:g} (want {len(keys)} then 0); "
        f"{CK_EMBED_CPU} rows against the CPU: max|d| {err:.3e} (limit {CK_EMBED_TOL}) | {card}")
    if not (same and m1 == len(keys) and m2 == 0 and err <= CK_EMBED_TOL
            and first.shape == (CK_EMBED_ROWS, CK_BERT["hidden_size"])
            and np.isfinite(first).all()):
        raise AssertionError("main path 7 (e): the embedder failed its checks")
    del stage
    _free_card()
    return {"rows_s": len(first) / second_s, "err": err}


def _ckpt_vision(ck: _Checkpoints, device, card: str) -> dict:
    """(c) DeepVisionClassifier from the ViT-B/16 and ResNet-50 directories:
    before fitting, the module the directory's arch_spec builds against the
    preset module on the same mapped weights, f32 logits (TF32 off) within
    CK_VISION_TOL; then the stage's graph fit of STAGE_STEPS steps (for the
    ResNet from the checkpoint's BatchNorm statistics), and the fitted
    model's scoring as main path 5 (c) holds it."""
    from synapseml_torch.models.convert_hf import pretrained_vision
    from synapseml_torch.models.nets.resnet import ResNet

    rs = np.random.default_rng(3)
    images = rs.standard_normal((STAGE_ROWS, VIT_HW, VIT_HW, 3), dtype=np.float32)
    labels = rs.integers(0, VIT_CLASSES, STAGE_ROWS).astype(np.int32)
    df = DataFrame.from_dict({"image": images, "label": labels}, num_partitions=2)
    score_df = DataFrame([{"image": images[:STAGE_PARTS[0]]},
                          {"image": images[STAGE_PARTS[0]:sum(STAGE_PARTS)]}])
    out = {}
    for name, make, seed in (("vit_b16", _vit_checkpoint, 21), ("resnet50", _resnet_checkpoint, 22)):
        d = ck.get(name, make, seed)
        kind, info, variables = ck.timed_load(
            name, lambda p: pretrained_vision(p, num_classes=VIT_CLASSES), device)
        state = {**variables["params"], **(variables.get("batch_stats") or {})}
        if kind == "vit":
            cfg = dataclasses.replace(info["cfg"], dtype=torch.float32)
            loaded = ViTClassifier(cfg, VIT_CLASSES, patch=info["patch"])
            preset = ViTClassifier(vit_b16(dtype=torch.float32, norm_eps=cfg.norm_eps),
                                   VIT_CLASSES, patch=VIT_PATCH)
            f32_spec = ("vit", {**info, "cfg": cfg})
        else:
            loaded = ResNet(num_classes=VIT_CLASSES, dtype=torch.float32, **info)
            preset = resnet50(num_classes=VIT_CLASSES, dtype=torch.float32)
            f32_spec = ("resnet", {**info, "dtype": torch.float32})
        x = torch.from_numpy(images[:8]).to(device)
        logits = []
        for module in (loaded, preset):
            module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
            with torch.no_grad():
                logits.append(module.to(device).eval()(x=x).cpu().numpy())
        err = float(np.abs(logits[0] - logits[1]).max())
        log(f"[ckpt] (c) {name} directory ({kind}): the module its arch_spec builds against the "
            f"{name} preset on the mapped weights, f32 logits of 8 images: max|d| {err:.3e} "
            f"(limit {CK_VISION_TOL}; logits' scale {np.abs(logits[1]).max():.3e})")
        if err > CK_VISION_TOL:
            raise AssertionError(f"main path 7 (c): the {name} directory's module disagrees")
        del loaded, preset, x
        stage = DeepVisionClassifier(backbone=d, num_classes=VIT_CLASSES, batch_size=STAGE_BATCH,
                                     max_steps=STAGE_STEPS, learning_rate=1e-4, seed=0,
                                     device=str(device))
        misses0 = cb.get_compiled_cache().miss_count("train_steps_scan")
        before = _flash_counts()
        t0 = time.perf_counter()
        model = stage.fit(df)
        fit_s = time.perf_counter() - t0
        captures = cb.get_compiled_cache().miss_count("train_steps_scan") - misses0
        (metrics,) = model.get("train_metrics")
        params, stats = model.get("model_params"), model.get("batch_stats")
        still = [k for k in params if np.array_equal(params[k], variables["params"][k])]
        moved = (sum(not np.array_equal(stats[k], variables["batch_stats"][k]) for k in stats)
                 if stats is not None else 0)
        flash = _flash_counts() != before
        log(f"[ckpt] (c) DeepVisionClassifier(backbone=<{name} dir>) graph fit of {STAGE_STEPS} "
            f"steps at batch {STAGE_BATCH}: {fit_s:.2f} s host clock ({STAGE_STEPS * STAGE_BATCH / fit_s:.1f} "
            f"images/s), train_metrics {json.dumps(metrics)}, captures {captures:g} (want 1), "
            f"parameters that did not move: {still or 'none'}, running statistics moved from the "
            f"checkpoint's: {moved} of {len(stats or {})}; flash launched: {flash} (want no: "
            f"einsum) | {card}")
        if (not np.isfinite(metrics["loss"]) or metrics["step"] != STAGE_STEPS or still
                or captures != 1 or flash or model.get("arch_spec")[0] != kind
                or (stats is not None and moved != len(stats))):
            raise AssertionError(f"main path 7 (c): the {name} directory's fit failed its checks")
        _score_vision_model(model, score_df, card, f"{name} directory",
                            f32_params={"arch_spec": f32_spec})
        out[name] = {"fit_s": fit_s, "logit_err": err}
        del model, stage
        _free_card()
    return out


def _ckpt_llm(ck: _Checkpoints, device, card: str) -> dict:
    """(d) HuggingFaceCausalLM from the Llama directory (full width, depth
    cut, F16 in two shards), dense and paged, and from the GPT-2 directory
    (dense; the paged engine takes the RoPE family only, in both packages):
    bf16 transforms twice, bitwise; f32 (TF32 off) card tokens against the
    CPU's under the margin rule. The Llama load's host memory is read."""
    from synapseml_torch.hf import HuggingFaceCausalLM
    from synapseml_torch.hf.causal_lm import load_llama
    from synapseml_torch.models.convert_hf import pretrained_causal_lm

    out = {}
    texts = _llm_texts(LLM_ROWS, seed=4)
    df = DataFrame.from_dict({"prompt": np.asarray(texts, dtype=object)}, num_partitions=LLM_PARTS)
    useful = LLM_ROWS * LLM_NEW
    for name, make, seed, shards, vocab in (
            ("llama", _llama_checkpoint, 31, 2, CK_LLAMA["vocab_size"]),
            ("gpt2", _gpt2_checkpoint, 32, 1, CK_GPT2["vocab_size"])):
        d = ck.get(name, make, seed, shards)
        if name == "llama":  # the load's host memory: the mapped files, cast on the card
            _free_card()
            gc.collect()
            with _PeakRss() as rss:
                t0 = time.perf_counter()
                cfg, sd = pretrained_causal_lm(d)
                model = load_llama(cfg, sd, device)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t0
                sd_gb = sum(v.nbytes for v in sd.values()) / 2 ** 30
                del model, sd
                gc.collect()
            log(f"[ckpt] (d) Llama directory through pretrained_causal_lm + load_llama: "
                f"{load_s:.3f} s (the files in the page cache); host RSS {rss.before:.2f} GiB "
                f"before, peak {rss.peak:.2f} GiB (+{rss.peak - rss.before:.2f} GiB against the "
                f"mapped files' {ck.bytes[name] / 2 ** 30:.2f} GiB, the mapped state_dict's "
                f"{sd_gb:.2f}), {rss.after:.2f} GiB after | {card}")
            out["rss_peak_gib"], out["rss_delta_gib"] = rss.peak, rss.peak - rss.before
            _free_card()
        ck.timed_load(name, pretrained_causal_lm, device)
        tok = HashingTokenizer(vocab_size=vocab)
        kw = dict(model_name=d, tokenizer=tok.to_config(), batch_size=LLM_BATCH,
                  prompt_bucket=LLM_BUCKET, max_new_tokens=LLM_NEW, device=str(device))
        runs = {}
        for engine in ("dense", "paged"):
            stage = HuggingFaceCausalLM(**kw, engine=engine)
            if name == "gpt2" and engine == "paged":
                try:
                    stage.transform(df)
                    refused = None
                except ValueError as e:
                    refused = str(e)
                stage.release()
                log(f"[ckpt] (d) gpt2 paged: refused ({refused}), as the JAX engine refuses it")
                if not (refused and "paged engine supports" in refused):
                    raise AssertionError("main path 7 (d): the paged engine took GPT-2")
                continue
            t0 = time.perf_counter()
            first = _completions(stage.transform(df))
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            second = _completions(stage.transform(df))
            second_s = time.perf_counter() - t0
            runs[engine] = first
            same = first == second
            log(f"[ckpt] (d) {name} {engine} bf16: {LLM_ROWS} prompts x {LLM_NEW} tokens, "
                f"{first_s:.3f} s first (load included), {second_s:.3f} s second = "
                f"{useful / second_s:.1f} tokens/s (host clock); second bitwise the first: {same} "
                f"| {card}")
            if not (same and all(len(r) == LLM_NEW for r in first)):
                raise AssertionError(f"main path 7 (d): {name} {engine} is not repeatable")
            out[f"{name}_{engine}_tokens_s"] = useful / second_s
            stage.release()
            del stage
            _free_card()
        if "paged" in runs:
            eq = sum(x == y for a, b in zip(runs["dense"], runs["paged"]) for x, y in zip(a, b))
            log(f"[ckpt] (d) {name} bf16 dense against paged: {eq} of {useful} tokens equal "
                f"(a report: bf16 may flip a near-tie)")
        # f32, TF32 off: the card against the port on the CPU
        out[f"{name}_f32_compared"] = _f32_card_against_cpu(
            d, seed, vocab, device, card, f"(d) {name}", paged=name == "llama")
        _free_card()
    return out


def _f32_card_against_cpu(d: str, seed: int, vocab: int, device, card: str, tag: str,
                          paged: bool) -> dict:
    """A causal-LM directory in f32 compute (TF32 off): dense generate on the
    card and on the CPU (the port's), and with ``paged`` the paged engine on
    the card, over CK_LLM_LENS prompts; the card's tokens held to the CPU's
    by the margin rule, at least LLM_MIN_COMPARED each. Returns the tokens
    compared by engine."""
    from synapseml_torch.hf.causal_lm import load_llama
    from synapseml_torch.models.convert_hf import pretrained_causal_lm
    from synapseml_torch.models.nets.llama import generate
    from synapseml_torch.models.paged_engine import PagedDecodeEngine

    cfg32, sd = pretrained_causal_lm(d, dtype=torch.float32)
    rs = np.random.default_rng(seed)
    prompts = [rs.integers(2, vocab, (n,)).tolist() for n in CK_LLM_LENS]
    P = cb.default_bucketer().seq_bucket_for(max(CK_LLM_LENS))
    gen, models = {}, {}
    for where, dev in (("card", str(device)), ("cpu", "cpu")):
        models[where] = m = load_llama(cfg32, sd, dev)
        ids, mask = _llm_ids(prompts, P, dev)
        t0 = time.perf_counter()
        gen[where, "dense"] = [r.tolist() for r in generate(
            m, ids, CK_LLM_NEW, prompt_mask=mask).cpu().numpy()[:, P:]]
        gen_s = time.perf_counter() - t0
        log(f"[ckpt] {tag} f32 dense generate on the {where}: {gen_s:.3f} s")
    if paged:
        eng = PagedDecodeEngine(models["card"], block_len=LLM_BLOCK, max_slots=len(prompts))
        gen["card", "paged"] = eng.generate(prompts, CK_LLM_NEW)
        eng.release()
    m_cpu = _teacher_margins(models["cpu"], prompts, gen["cpu", "dense"])
    compared = {}
    for (where, engine), toks in gen.items():
        if where == "cpu":
            continue
        m_card = _teacher_margins(models[where], prompts, toks)
        compared[engine] = _margin_rule(gen["cpu", "dense"], toks, m_cpu, m_card,
                                        f"{tag} f32 {engine} on the card against the CPU")
    log(f"[ckpt] {tag} f32, the card against the CPU: tokens compared {compared} "
        f"(need >= {LLM_MIN_COMPARED} each) | {card}")
    if min(compared.values()) < LLM_MIN_COMPARED:
        raise AssertionError(f"{tag}: too few f32 tokens compared")
    del models, sd
    return compared


def phase_pretrained(device, card: str) -> dict:
    """Main path 7: HuggingFace checkpoint directories written here (seeded),
    through (a) the reader and its refusals, (b) DeepTextClassifier's
    checkpoint fit and scoring through the flash kernels, (e) the sentence
    embedder, (c) the vision stages, (d) HuggingFaceCausalLM; the flash
    launches counted from 0 just before the path and read after it."""
    t_start = time.perf_counter()
    _zero_port_kernel_counts()
    ck = _Checkpoints(card)
    out = {}
    try:
        out["text"] = _ckpt_text(ck, device, card)
        log(f"[ckpt] (b) done at {time.perf_counter() - t_start:.1f} s")
        out["embed"] = _ckpt_embedder(ck, device, card)
        log(f"[ckpt] (e) done at {time.perf_counter() - t_start:.1f} s")
        out["vision"] = _ckpt_vision(ck, device, card)
        log(f"[ckpt] (c) done at {time.perf_counter() - t_start:.1f} s")
        out["llm"] = _ckpt_llm(ck, device, card)
        log(f"[ckpt] (d) done at {time.perf_counter() - t_start:.1f} s")
        _ckpt_reader_cases(ck, device)
    finally:
        ck.close()
    counts = _port_kernel_counts()
    flash = _flash_counts()
    log(f"[ckpt] the port's kernels launched on main path 7: {counts}; loads "
        f"{json.dumps({k: {m: round(v, 3) for m, v in x.items()} for k, x in ck.loads.items()})}")
    if counts["gbdt_hist"] or counts["gbdt_hist_scale"] or not counts["flash_fwd"]:
        raise AssertionError(f"main path 7 launched other kernels than the flash ones, or no "
                             f"flash forward: {counts}")
    out["launches"], out["bwd_launches"] = flash["fwd"], flash["bwd"]
    out["loads"] = ck.loads
    out["seconds"] = time.perf_counter() - t_start
    log(f"[ckpt] main path 7: {out['seconds']:.1f} s of the script's clock")
    return out


# ---------------- main path 8: Mixtral-8x7B ----------------

# mistralai/Mixtral-8x7B-v0.1's published config.json: vocab 32000, hidden
# 4096, 32 heads, 8 KV heads, MLP 14336, 8 experts, top-2, rope theta 1e6,
# max_len 32768 (the fields the mappings read, as published)
MX_CONFIG = {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
             "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
             "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
             "num_local_experts": 8, "num_experts_per_tok": 2, "hidden_act": "silu",
             "max_position_embeddings": 32768, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
             "sliding_window": None, "tie_word_embeddings": False,
             "router_aux_loss_coef": 0.02, "output_router_logits": False,
             "torch_dtype": "bfloat16"}
# the depth cut: 32 layers are 93 GB of bf16, more than the card's 80 GB; 8
# layers are 23.2 GB of bf16 decoder weights (47.5 GB while in f32)
MX_LAYERS = 8
MX_DIR_LAYERS = 1    # the BF16 directory of (b): 3.4 GB over two shards
MX_RSS_SLACK_GIB = 1.0  # a load's host memory past the mapped files and one layer's experts
MX_TRAIN_STEPS, MX_TRAIN_CHUNK, MX_TRAIN_BATCH = 8, 4, 8  # (c): an eager chunk, then a graph
MX_TRAIN_CF = 1.0  # (c)'s capacity factor: an imbalanced batch drops assignments

_MOE_GROUPS = (("flash kernels", ("flash_",)),  # matched in lower case, first match wins
               ("routing (sort, top-k, cumsum)", ("sort", "topk", "cumsum", "scan")),
               ("matmul", ("nvjet", "gemm", "gemv", "cutlass", "sm90_", "cublas")),
               ("gathers and scatters (K/V, dispatch, combine)",
                ("index", "gather", "scatter")),
               ("softmax", ("softmax",)),
               ("dtype casts and copies", ("copy", "memcpy", "cat")),
               ("reductions", ("reduce",)),
               ("elementwise", ("elementwise", "vectorized")))


def _mx_prompts(cfg, seed: int):
    """LLM_ROWS prompts of path 6's kind through the hashing tokenizer at
    vocab 32000: the padded ``[n, 64]`` ids and mask, and each prompt's real
    token ids."""
    tok = HashingTokenizer(vocab_size=cfg.vocab_size)
    enc = tok(_llm_texts(LLM_ROWS, seed=seed), max_len=cfg.max_len - LLM_NEW,
              multiple_of=LLM_BUCKET)
    ids, mask = np.asarray(enc["input_ids"]), np.asarray(enc["attention_mask"])
    return ids, mask, [r[m > 0].tolist() for r, m in zip(ids, mask)]


def _mx_bf16(model, device, card: str) -> dict:
    """(a) bf16 compute: dense generate over the prompts in batches of 8 and
    the paged engine (8 slots), each run twice and bitwise the first; the
    dense batch's prefill, its decode step in the loop, in device time
    (behind a spin) and profiled by group beside its byte bound; peak
    memory; path 6's mixed stream through the paged engine."""
    from synapseml_torch.models.nets.llama import generate
    from synapseml_torch.models.nets.transformer import KVCache
    from synapseml_torch.models.paged_engine import PagedDecodeEngine

    cfg = model.cfg
    ids_np, mask_np, prompts = _mx_prompts(cfg, seed=5)
    P = ids_np.shape[1]
    batches = [(torch.from_numpy(ids_np[i:i + LLM_BATCH]).long().to(device),
                torch.from_numpy(mask_np[i:i + LLM_BATCH]).long().to(device))
               for i in range(0, LLM_ROWS, LLM_BATCH)]
    useful = LLM_ROWS * LLM_NEW
    out = {}

    def dense_run():
        return [r.tolist() for ids, mask in batches
                for r in generate(model, ids, LLM_NEW, prompt_mask=mask).cpu().numpy()[:, P:]]

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense1 = dense_run()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense2 = dense_run()
    dense_s = time.perf_counter() - t0
    peak_dense = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[moe] (a) dense generate, {LLM_ROWS} prompts x {LLM_NEW} tokens in batches of "
        f"{LLM_BATCH} (prompt bucket {P}, a KV cache of {cfg.max_len} slots): {first_s:.3f} s, "
        f"second {dense_s:.3f} s = {useful / dense_s:.1f} tokens/s; second bitwise the first: "
        f"{dense1 == dense2}; peak {peak_dense:.3f} GiB | {card}")
    if not (dense1 == dense2 and all(len(r) == LLM_NEW for r in dense1)):
        raise AssertionError("main path 8 (a): the dense run is not repeatable")

    blocks = 1 + LLM_SLOTS * -(-(LLM_BUCKET + LLM_NEW) // LLM_BLOCK)
    torch.cuda.reset_peak_memory_stats()
    runs, times = [], []
    for _ in range(2):
        engine = PagedDecodeEngine(model, block_len=LLM_BLOCK, max_slots=LLM_SLOTS,
                                   n_blocks=blocks)
        t0 = time.perf_counter()
        runs.append(engine.generate(prompts, LLM_NEW))
        times.append(time.perf_counter() - t0)
        engine.release()
        del engine
    peak_paged = torch.cuda.max_memory_allocated() / 2 ** 30
    same = sum(x == y for a, b in zip(dense1, runs[0]) for x, y in zip(a, b))
    log(f"[moe] (a) PagedDecodeEngine ({LLM_SLOTS} slots, {blocks} pages of {LLM_BLOCK}): "
        f"{times[0]:.3f} s, second {times[1]:.3f} s = {useful / times[1]:.1f} tokens/s; second "
        f"bitwise the first: {runs[0] == runs[1]}; peak {peak_paged:.3f} GiB | {card}")
    log(f"[moe] (a) bf16 dense against paged: {same} of {useful} tokens equal "
        f"({100 * same / useful:.1f} %; bf16 may flip a near-tie, a report, not a check); rows "
        f"equal {sum(a == b for a, b in zip(dense1, runs[0]))} of {LLM_ROWS}")
    if not (runs[0] == runs[1] and all(len(r) == LLM_NEW for r in runs[0])):
        raise AssertionError("main path 8 (a): the paged run is not repeatable")
    _free_card()

    ids, mask = batches[0]
    prefill_ms = cuda_ms(lambda: generate(model, ids, 1, prompt_mask=mask), warmup=1, iters=3)
    full_ms = cuda_ms(lambda: generate(model, ids, LLM_NEW, prompt_mask=mask), warmup=0,
                      iters=1)
    loop_ms = (full_ms - prefill_ms) / (LLM_NEW - 1)
    kvc = KVCache.zeros(cfg, LLM_BATCH, device)
    kv_mask = torch.ones((LLM_BATCH, cfg.max_len), dtype=torch.long, device=device)
    kvc.index = P
    tok1, pos = ids[:, :1], mask.sum(-1, keepdim=True)
    with torch.no_grad():
        step = lambda: model(tok1, positions=pos, attention_mask=kv_mask, cache=kvc)  # noqa: E731
        step_dev_ms = cuda_ms(step, warmup=2, iters=5, spin_cycles=LLM_SPIN)
        prof = _profile_llm_step(step, card, "Mixtral dense", groups=_MOE_GROUPS)
    bound_ms, bound_gb = _step_bound_ms(cfg, LLM_BATCH, cfg.max_len)
    live_ms, _ = _step_bound_ms(cfg, LLM_BATCH, P + LLM_NEW)
    log(f"[moe] (a) dense batch of {LLM_BATCH} x {P}: prefill (generate of 1 token) "
        f"{prefill_ms:.3f} ms; decode {loop_ms:.3f} ms a step in the loop (CUDA events, host "
        f"included), one step {step_dev_ms:.3f} ms of device time (behind a spin; the "
        f"profiler's kernels {prof['busy_ms']:.3f} ms); bound {bound_ms:.3f} ms ({bound_gb:.2f} "
        f"GB: bf16 attention and all {cfg.moe_experts} experts' weights, f32 routers, norms and "
        f"lm_head, K/V over all {cfg.max_len} slots; {live_ms:.3f} ms over the live "
        f"{P + LLM_NEW}) | {card}")
    out.update(tokens_s=useful / dense_s, paged_tokens_s=useful / times[1],
               prefill_ms=prefill_ms, step_ms=loop_ms, step_dev_ms=step_dev_ms,
               bound_ms=bound_ms, busy=prof["busy"], peak_gib=max(peak_dense, peak_paged),
               equal_share=same / useful)
    del kvc, step
    _free_card()

    requests = _mixed_stream(np.random.default_rng(0), LLM_STREAM, cfg.vocab_size)
    want = sum(n for _, n in requests)
    need = max(-(-(len(p) + n) // LLM_BLOCK) for p, n in requests)
    engine = PagedDecodeEngine(model, block_len=LLM_BLOCK, max_slots=LLM_SLOTS,
                               prefill_batch=2, n_blocks=1 + LLM_SLOTS * need)
    torch.cuda.synchronize()
    run = _run_stream(engine, requests)
    engine.release()
    del engine
    log(f"[moe] (a) mixed stream of {LLM_STREAM} requests ({want} tokens asked) through "
        f"PagedDecodeEngine, {LLM_SLOTS} slots: {run['wall_s']:.3f} s, "
        f"{want / run['wall_s']:.1f} useful tokens/s; TTFT p50 "
        f"{np.percentile(run['ttft_ms'], 50):.1f} ms, p99 {np.percentile(run['ttft_ms'], 99):.1f} "
        f"ms | {card}")
    if [len(t) for t in run["tokens"]] != [n for _, n in requests]:
        raise AssertionError("main path 8 (a): the paged engine did not generate each budget")
    out.update(stream_tokens_s=want / run["wall_s"],
               ttft_p50_ms=float(np.percentile(run["ttft_ms"], 50)))
    _free_card()
    return out


def _mx_engines(device, card: str) -> dict:
    """(a) Mixtral-8x7B at full width, MX_LAYERS of its 32 layers, weights
    from init_llama_params(seed=0) on the card (f32): first f32 compute
    (TF32 off) on the draw itself (nothing copied), dense against paged
    under the margin rule; then load_llama in bf16 compute (attention and experts cast on the
    card, routers, norms, embedding and lm_head kept f32), the f32 draw
    dropped once loaded, and the bf16 engines."""
    from synapseml_torch.hf.causal_lm import load_llama
    from synapseml_torch.models.convert_hf import llama_config_from_hf
    from synapseml_torch.models.convert_jax import init_llama_params

    cfg = llama_config_from_hf({**MX_CONFIG, "num_hidden_layers": MX_LAYERS})
    c = MX_CONFIG
    if not (cfg.moe_experts, cfg.moe_top_k, cfg.moe_dispatch, cfg.moe_capacity_factor,
            cfg.kv_heads, cfg.max_len, cfg.rope_theta) == (
                8, 2, "scatter", 4.0, c["num_key_value_heads"], c["max_position_embeddings"],
                c["rope_theta"]):
        raise AssertionError(f"main path 8: the Mixtral config maps to {cfg}")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = init_llama_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in sd.values())
    experts = sum(v.numel() for k, v in sd.items() if ".mlp.w_" in k)
    decoder = sum(v.numel() for k, v in sd.items() if k.startswith("decoder.layers.")
                  and ".router." not in k and "norm" not in k)
    log(f"[moe] (a) Mixtral-8x7B, {MX_LAYERS} of 32 layers at full width, from "
        f"init_llama_params(seed=0) on the card: {n_params} parameters ({experts} in experts), "
        f"{sum(v.numel() * v.element_size() for v in sd.values()) / 1e9:.2f} GB f32, in "
        f"{time.perf_counter() - t0:.3f} s; {2 * decoder / 1e9:.2f} GB of bf16 decoder weights "
        f"once cast")
    out = {"n_params": n_params}
    model32 = load_llama(cfg32, sd, device)  # the draw's own tensors: nothing copied
    out["f32_compared"] = _f32_dense_against_paged(model32, device, card, "Mixtral-8x7B")
    del model32
    _free_card()
    t0 = time.perf_counter()
    model = load_llama(cfg, sd, device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del sd
    _free_card()
    log(f"[moe] (a) load_llama in bf16 compute: {load_s:.3f} s (casts on the card); peak "
        f"{load_peak:.3f} GiB with the f32 draw, {torch.cuda.memory_allocated() / 2 ** 30:.3f} "
        f"GiB once it is dropped | {card}")
    out.update(_mx_bf16(model, device, card))
    out["load_s"] = load_s
    del model
    _free_card()
    return out


def _mixtral_checkpoint(seed: int, device, layers: int = MX_DIR_LAYERS) -> tuple[dict, dict]:
    """MixtralForCausalLM at MX_CONFIG's width with ``layers`` layers, BF16,
    drawn on the card from a seeded generator and brought to the host, in the
    published checkpoint's key order (so that a two-shard split falls inside
    a layer's experts, as the published index splits them): N(0, 0.02)
    tables, Xavier-uniform Linear weights, norm scales near 1; no biases."""
    c = MX_CONFIG
    hid, mlp, E = c["hidden_size"], c["intermediate_size"], c["num_local_experts"]
    kv = hid // c["num_attention_heads"] * c["num_key_value_heads"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(*shape, std=0.02):
        return (torch.empty(shape, device=device).normal_(0.0, std, generator=gen)
                .to(torch.bfloat16).cpu())

    def linear(n_out, n_in):
        lim = math.sqrt(6.0 / (n_in + n_out))
        return (torch.empty((n_out, n_in), device=device).uniform_(-lim, lim, generator=gen)
                .to(torch.bfloat16).cpu())

    def scale(n):
        return (1 + torch.empty(n, device=device).normal_(0.0, 0.05, generator=gen)).to(
            torch.bfloat16).cpu()

    t = {"model.embed_tokens.weight": normal(c["vocab_size"], hid)}
    for i in range(layers):
        p = f"model.layers.{i}"
        t[f"{p}.block_sparse_moe.gate.weight"] = linear(E, hid)
        for e in range(E):
            ex = f"{p}.block_sparse_moe.experts.{e}"
            t[f"{ex}.w1.weight"], t[f"{ex}.w2.weight"] = linear(mlp, hid), linear(hid, mlp)
            t[f"{ex}.w3.weight"] = linear(mlp, hid)
        t[f"{p}.input_layernorm.weight"] = scale(hid)
        t[f"{p}.post_attention_layernorm.weight"] = scale(hid)
        for name, n_out in (("k_proj", kv), ("o_proj", hid), ("q_proj", hid), ("v_proj", kv)):
            t[f"{p}.self_attn.{name}.weight"] = linear(n_out, hid)
    t["model.norm.weight"] = scale(hid)
    t["lm_head.weight"] = normal(c["vocab_size"], hid)
    return {**c, "num_hidden_layers": layers}, t


def _mx_directory(device, card: str) -> dict:
    """(b) A BF16 Mixtral directory at full width, MX_DIR_LAYERS layer, in
    two shards: every tensor read back bitwise; the load from the disk
    (pretrained_causal_lm + load_llama) in GB/s and its peak host memory,
    held to the mapped files plus one layer's stacked experts (BF16 is not
    widened on the host); HuggingFaceCausalLM(model_name=<dir>) dense and
    paged, bf16 transforms twice, bitwise, tokens/s; f32 card tokens against
    the port on the CPU under the margin rule."""
    from synapseml_torch.hf import HuggingFaceCausalLM
    from synapseml_torch.hf.causal_lm import load_llama
    from synapseml_torch.models.convert_hf import pretrained_causal_lm

    ck = _Checkpoints(card)
    out = {}
    try:
        d = ck.get("mixtral", lambda seed: _mixtral_checkpoint(seed, device), 41, shards=2)
        with open(os.path.join(d, "model.safetensors.index.json")) as f:
            shard_of = json.load(f)["weight_map"]
        split = sorted({shard_of[f"model.layers.0.block_sparse_moe.experts.{e}.w1.weight"]
                        for e in range(MX_CONFIG["num_local_experts"])})
        log(f"[moe] (b) layer 0's experts lie in {split}")
        if len(split) != 2:
            raise AssertionError("main path 8 (b): the experts are not split across the shards")
        _drop_page_cache(d)
        _free_card()
        gc.collect()
        with _PeakRss() as rss:
            t0 = time.perf_counter()
            cfg, sd = pretrained_causal_lm(d)
            model = load_llama(cfg, sd, device)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            stacked = sum(v.nbytes for k, v in sd.items() if ".mlp.w_" in k) / 2 ** 30
            kinds = {str(v.dtype) for v in sd.values()}
            del model, sd
            gc.collect()
        mapped = ck.bytes["mixtral"] / 2 ** 30
        delta = rss.peak - rss.before
        gbs = ck.bytes["mixtral"] / 1e9 / load_s
        log(f"[moe] (b) the BF16 directory from the disk through pretrained_causal_lm + "
            f"load_llama: {load_s:.3f} s, {gbs:.2f} GB/s of {ck.bytes['mixtral'] / 1e9:.3f} GB; "
            f"the mapped state_dict's dtypes {sorted(kinds)}; host RSS {rss.before:.2f} GiB "
            f"before, peak {rss.peak:.2f} GiB (+{delta:.2f} GiB against the mapped files' "
            f"{mapped:.2f} GiB and the stacked experts' {stacked:.2f} GiB), {rss.after:.2f} "
            f"GiB after | {card}")
        if kinds != {"torch.bfloat16"} or delta > mapped + stacked + MX_RSS_SLACK_GIB:
            raise AssertionError("main path 8 (b): the BF16 load widened on the host or held "
                                 "more than the mapped files and one layer's experts")
        out.update(load_s=load_s, load_gb_s=gbs, rss_delta_gib=delta, mapped_gib=mapped,
                   stacked_gib=stacked)
        _free_card()
        texts = _llm_texts(LLM_ROWS, seed=6)
        df = DataFrame.from_dict({"prompt": np.asarray(texts, dtype=object)},
                                 num_partitions=LLM_PARTS)
        useful = LLM_ROWS * LLM_NEW
        kw = dict(model_name=d, tokenizer=HashingTokenizer(vocab_size=32000).to_config(),
                  batch_size=LLM_BATCH, prompt_bucket=LLM_BUCKET, max_new_tokens=LLM_NEW,
                  device=str(device))
        runs = {}
        for engine, extra in (("dense", {}), ("paged", {"kv_blocks": 1 + LLM_BATCH * -(
                -(LLM_BUCKET + LLM_NEW) // LLM_BLOCK)})):
            stage = HuggingFaceCausalLM(**kw, engine=engine, **extra)
            t0 = time.perf_counter()
            first = _completions(stage.transform(df))
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            second = _completions(stage.transform(df))
            second_s = time.perf_counter() - t0
            runs[engine] = first
            log(f"[moe] (b) HuggingFaceCausalLM(model_name=<Mixtral dir>, engine={engine!r}) "
                f"bf16: {LLM_ROWS} prompts x {LLM_NEW} tokens, {first_s:.3f} s first (load "
                f"included), {second_s:.3f} s second = {useful / second_s:.1f} tokens/s; second "
                f"bitwise the first: {first == second} | {card}")
            if not (first == second and all(len(r) == LLM_NEW for r in first)):
                raise AssertionError(f"main path 8 (b): the {engine} stage is not repeatable")
            out[f"{engine}_tokens_s"] = useful / second_s
            stage.release()
            del stage
            _free_card()
        eq = sum(x == y for a, b in zip(runs["dense"], runs["paged"]) for x, y in zip(a, b))
        log(f"[moe] (b) bf16 dense against paged: {eq} of {useful} tokens equal (a report)")
        out["f32_compared"] = _f32_card_against_cpu(d, 41, 32000, device, card,
                                                    "(b) mixtral", paged=True)
    finally:
        ck.close()
    _free_card()
    return out


def _moe_train(device, card: str) -> dict:
    """(c) bert_tiny with 4 experts, top-2, capacity factor MX_TRAIN_CF,
    attn_impl='flash' (bf16), through the port's Trainer with moe_aux_weight
    0.01 and 0, for each dispatch:
    MX_TRAIN_STEPS eager steps, and train_steps_scan in chunks of
    MX_TRAIN_CHUNK (the eager warm-up chunk, then one captured graph
    replayed) from the same init and batches: losses and every leaf bitwise
    equal, one capture, the flash forward and backward once a layer a step in
    each run; the first loss with the aux term above the loss without.
    Returns the flash launches of every run."""
    from synapseml_torch.models.nets.bert import BertClassifier, bert_tiny

    tok = HashingTokenizer(vocab_size=1024)
    rows = _labelled_texts(MX_TRAIN_BATCH * MX_TRAIN_STEPS, seed=6, n_words=(5, 60))
    enc = tok([r["text"] for r in rows], max_len=64)
    data = {"input_ids": np.asarray(enc["input_ids"], np.int32),
            "attention_mask": np.asarray(enc["attention_mask"], np.int32),
            "labels": np.array([r["label"] for r in rows], np.int32)}
    batches = [{k: v[i:i + MX_TRAIN_BATCH] for k, v in data.items()}
               for i in range(0, len(rows), MX_TRAIN_BATCH)]
    cache = cb.get_compiled_cache()
    total = {"fwd": {"bf16": 0, "f32": 0}, "bwd": {"bf16": 0, "f32": 0}}
    for dispatch in ("einsum", "scatter"):
        cfg = bert_tiny(vocab_size=1024, moe_experts=4, moe_top_k=2, moe_dispatch=dispatch,
                        moe_capacity_factor=MX_TRAIN_CF, attn_impl="flash")
        init = text_stage._init_params(cfg, 2, seed=3)
        first = {}
        for weight in (0.01, 0.0):
            losses, params, launches, captures = {}, {}, {}, None
            for run in ("eager", "graph"):
                trainer = trainer_mod.Trainer(
                    BertClassifier(cfg, 2),
                    trainer_mod.TrainerConfig(learning_rate=1e-3, total_steps=MX_TRAIN_STEPS,
                                              moe_aux_weight=weight), device=device)
                state = trainer.init_state(init_params=init)
                _zero_flash_counts()
                if run == "eager":
                    seen = [trainer.train_step(state, b)[1]["loss"] for b in batches]
                else:
                    m0, seen = cache.miss_count("train_steps_scan"), []
                    for c in range(0, MX_TRAIN_STEPS, MX_TRAIN_CHUNK):
                        chunk = batches[c:c + MX_TRAIN_CHUNK]
                        state, m = trainer.train_steps_scan(
                            state, {k: np.stack([b[k] for b in chunk]) for k in chunk[0]})
                        seen += list(m["loss"])
                    captures = cache.miss_count("train_steps_scan") - m0
                losses[run] = torch.stack(seen).cpu()
                params[run] = {k: v.detach().cpu() for k, v in state.params.items()}
                launches[run] = _flash_counts()
                trainer.release_graphs()
                del trainer, state
            off = [k for k in params["eager"] if not torch.equal(params["eager"][k],
                                                                  params["graph"][k])]
            same_losses = torch.equal(losses["eager"], losses["graph"])
            n = cfg.n_layers * MX_TRAIN_STEPS
            want = {"fwd": {"bf16": n, "f32": 0}, "bwd": {"bf16": n, "f32": 0}}
            log(f"[moe] (c) bert_tiny MoE (4 experts, top-2, {dispatch}) through flash, "
                f"moe_aux_weight {weight}: losses {np.round(losses['eager'].numpy(), 5).tolist()}; "
                f"the graph run (chunks of {MX_TRAIN_CHUNK}: a warm-up, then {captures:g} capture "
                f"replayed) against {MX_TRAIN_STEPS} eager steps: losses bitwise {same_losses}, "
                f"{len(params['eager']) - len(off)} of {len(params['eager'])} leaves bitwise "
                f"equal; flash launches {launches['eager']} / {launches['graph']} | {card}")
            if off or not same_losses or captures != 1:
                raise AssertionError(f"main path 8 (c): the MoE graph run differs from the eager "
                                     f"steps on {off} (losses equal {same_losses}) or captured "
                                     f"{captures}")
            if not all(launches[r] == want for r in launches):
                raise AssertionError(f"main path 8 (c): flash launches {launches}, want {want} "
                                     f"a run")
            for d in total:
                for k in total[d]:
                    total[d][k] += launches["eager"][d][k] + launches["graph"][d][k]
            first[weight] = float(losses["eager"][0])
        log(f"[moe] (c) {dispatch}: first loss with moe_aux_weight 0.01 {first[0.01]:.6f}, "
            f"with 0 {first[0.0]:.6f}")
        if not first[0.01] > first[0.0]:
            raise AssertionError("main path 8 (c): the aux loss did not raise the loss")
    return total


def phase_moe(device, card: str) -> dict:
    """Main path 8: (a) Mixtral-8x7B at full width through both decode
    engines, (b) a BF16 Mixtral directory through HuggingFaceCausalLM, (d)
    no kernel of the port's launched on (a) and (b), (c) an MoE encoder
    trained through the flash kernels, eagerly and as graphs."""
    t_start = time.perf_counter()
    _zero_port_kernel_counts()
    out = {"engines": _mx_engines(device, card)}
    log(f"[moe] (a) done at {time.perf_counter() - t_start:.1f} s")
    out["directory"] = _mx_directory(device, card)
    log(f"[moe] (b) done at {time.perf_counter() - t_start:.1f} s")
    counts = _port_kernel_counts()
    log(f"[moe] (d) the port's kernels launched on (a) and (b): {counts} (want none)")
    if any(counts.values()):
        raise AssertionError(f"main path 8 (a)-(b) launched a kernel of the port's: {counts}")
    launches = _moe_train(device, card)
    log(f"[moe] (c) done at {time.perf_counter() - t_start:.1f} s")
    out["launches"], out["bwd_launches"] = launches["fwd"], launches["bwd"]
    out["seconds"] = time.perf_counter() - t_start
    log(f"[moe] main path 8: {out['seconds']:.1f} s of the script's clock")
    return out


# ---------------------------------------------------------------------------
# main path 9: LightGBM's surface (ranker, sampling modes, categorical,
# out-of-core, continued training) through the histogram kernel
# ---------------------------------------------------------------------------

# MSLR-WEB10K's shape (Fold1's training part: three fifths of 1,200,192
# documents over 10,000 queries): 136 features, relevance 0-4 skewed to 0
MSLR_GROUPS, MSLR_TEST_GROUPS, MSLR_SIZES, MSLR_F = 6000, 1000, (40, 200), 136
MSLR_ROWS = 720_000  # the kernel cases' row count (6000 groups of mean size 120)
MSLR_SLICE = 20      # groups of the CPU-against-card fit
# LightGBM's examples/lambdarank/train.conf
MSLR_PARAMS = dict(num_iterations=100, learning_rate=0.1, num_leaves=31, max_bin=255,
                   min_data_in_leaf=50, min_sum_hessian_in_leaf=5.0, eval_at=[1, 3, 5])
MSLR_NDCG_MARGIN = 0.5  # NDCG@5 over a random ranking's, held out (run 1: 0.869 vs 0.134)
SURFACE_ITERS = 50
SURFACE_MODES = {  # (b): Higgs-1M in each sampling mode
    "goss": dict(boosting_type="goss", top_rate=0.2, other_rate=0.1),
    "dart": dict(boosting_type="dart", drop_rate=0.1),
    "rf": dict(boosting_type="rf", bagging_fraction=0.632, bagging_freq=1,
               feature_fraction=0.8),
    "gbdt": dict(bagging_fraction=0.8, bagging_freq=5, feature_fraction=0.8),
}
SURFACE_AUC_DROP = {"goss": 0.01, "dart": 0.03, "rf": 0.08}  # below gbdt's, at most
CAT_COLS, CAT_CODES = (0, 1, 2, 3), 32
OOC_ROWS, OOC_JSONL_ROWS, OOC_ITERS, OOC_CHUNK = 250_000, 20_000, 30, 32_768
OOC_AUC_TOL = 2e-3
CONTINUE_ITERS = 20


def mslr_data(n_groups: int, seed: int = 0):
    """MSLR-WEB10K-shaped ranking data: group sizes uniform in 40-200,
    float32 features, relevance 0-4 cut from a hidden score (a sparse
    linear term, a per-query offset and noise) at the quantiles 0.5, 0.75,
    0.9 and 0.97, so about half the documents are irrelevant."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(MSLR_SIZES[0], MSLR_SIZES[1] + 1, n_groups)
    n = int(sizes.sum())
    X = rng.standard_normal((n, MSLR_F), dtype=np.float32)
    w = rng.normal(size=MSLR_F) * (rng.random(MSLR_F) < 0.25)
    gid = np.repeat(np.arange(n_groups), sizes)
    hidden = X @ w + rng.normal(size=n_groups)[gid] * 0.5 + rng.normal(size=n)
    rel = np.digitize(hidden, np.quantile(hidden, [0.5, 0.75, 0.9, 0.97])).astype(np.float32)
    return X, rel, gid, sizes


def _ndcg(scores: np.ndarray, rel: np.ndarray, sizes: np.ndarray, k: int, device) -> float:
    from synapseml_torch.gbdt import objectives

    gslot, gmax = objectives.pad_groups(sizes)
    return float(objectives.ndcg_at_k(torch.from_numpy(np.ascontiguousarray(scores, np.float32)).to(device),
                                      torch.from_numpy(rel).to(device),
                                      torch.from_numpy(gslot).to(device), len(sizes), gmax, k=k))


def _hist_counts() -> tuple[int, int]:
    from synapseml_torch.gbdt import hist

    return hist.fixed_point_histogram.launches, hist.fixed_point_scales.launches


class _Trees:
    """The trees the card grew in main path 9, for the launch count: one
    level launch a level (and one for the final totals) and one scale pass
    a tree."""

    def __init__(self, depth: int):
        self.depth, self.trees = depth, 0

    def add(self, booster, prefix: int = 0) -> None:
        self.trees += (booster.num_iterations - prefix) * booster.num_model_out


def _surface_ranker(device, card: str, grown: _Trees) -> dict:
    """(a) LightGBMRanker(histogram_impl='pallas') at the MSLR-WEB10K shape."""
    from synapseml_torch import DataFrame as DF
    from synapseml_torch.gbdt import LightGBMRanker

    X, rel, gid, sizes = mslr_data(MSLR_GROUPS + MSLR_TEST_GROUPS)
    tr = gid < MSLR_GROUPS
    n_tr = int(tr.sum())
    train = DF.from_dict({"features": X[tr], "label": rel[tr], "group": gid[tr]})
    est = LightGBMRanker(histogram_impl="pallas", device=str(device), **MSLR_PARAMS)
    torch.cuda.reset_peak_memory_stats()
    before = _hist_counts()
    t0 = time.perf_counter()
    model = est.fit(train)
    fit_s = time.perf_counter() - t0
    launches, scales = (a - b for a, b in zip(_hist_counts(), before))
    booster = model.get_booster()
    grown.add(booster)
    m = model.get_train_measures()
    want = booster.num_iterations * (grown.depth + 1)
    log(f"[surface] (a) LightGBMRanker {MSLR_GROUPS} groups, {n_tr} x {MSLR_F}, "
        f"{booster.num_iterations} trees: fit {fit_s:.2f} s (binning {m['binning_ms']:.0f} ms, "
        f"training {m['training_ms']:.0f} ms), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, gbdt_hist launches {launches} "
        f"(want {want}), scale passes {scales} (want {booster.num_iterations}) | {card}")
    if launches != want or scales != booster.num_iterations:
        raise AssertionError("the ranker's fit launched the histogram kernel off its count")
    if not np.isfinite(booster.leaf_value).all():
        raise AssertionError("the ranker grew non-finite leaves")
    second = est.fit(train).get_booster()
    grown.add(second)
    same = _same_forest(booster, second)
    log(f"[surface] (a) a second ranker fit is bitwise the first: {same}")
    if not same:
        raise AssertionError("two ranker fits differ")

    te = ~tr
    te_sizes = sizes[MSLR_GROUPS:]
    scores = booster.raw_score(X[te], device=device)[:, 0]
    rand = np.random.default_rng(1).normal(size=int(te.sum()))
    ndcg = {k: _ndcg(scores, rel[te], te_sizes, k, device) for k in (1, 3, 5)}
    rnd = {k: _ndcg(rand, rel[te], te_sizes, k, device) for k in (1, 3, 5)}
    log(f"[surface] (a) held out {MSLR_TEST_GROUPS} groups: NDCG@1/3/5 "
        f"{ndcg[1]:.4f} / {ndcg[3]:.4f} / {ndcg[5]:.4f} against a random ranking's "
        f"{rnd[1]:.4f} / {rnd[3]:.4f} / {rnd[5]:.4f} (want NDCG@5 above it by "
        f"{MSLR_NDCG_MARGIN})")
    if not ndcg[5] > rnd[5] + MSLR_NDCG_MARGIN:
        raise AssertionError("the ranker ranks no better than chance")

    sl = gid < MSLR_SLICE
    small = DF.from_dict({"features": X[sl], "label": rel[sl], "group": gid[sl]})
    small_est = est.copy({"num_iterations": 10, "min_data_in_leaf": 20,
                          "min_sum_hessian_in_leaf": 1e-3})
    on_card = small_est.fit(small).get_booster()
    grown.add(on_card)
    on_cpu = small_est.copy({"device": "cpu"}).fit(small).get_booster()
    same_split = np.array_equal(on_card.feature, on_cpu.feature)
    log(f"[surface] (a) {MSLR_SLICE} groups ({int(sl.sum())} rows), 10 trees, card (kernel) vs "
        f"CPU (plain version): same split features in every tree: {same_split}, max|d leaf| "
        f"{np.abs(on_card.leaf_value - on_cpu.leaf_value).max():.3e}")
    if not same_split:
        raise AssertionError("the ranker's card forest splits differently from the CPU's")
    return {"fit_s": fit_s, "ndcg": ndcg, "rows": n_tr}


def _root_fraction_ok(booster, n: int, p_of_tree) -> tuple[float, float]:
    """Each tree's root cover (the rows it saw) over n against its expected
    fraction within 4 standard deviations; returns the widest miss in
    standard deviations and the mean fraction."""
    worst, fracs = 0.0, booster.cover[:, 0, 0] / n
    for t, frac in enumerate(fracs):
        p, trials = p_of_tree(t)
        if p is None:
            continue
        sigma = np.sqrt(p * (1 - p) / trials) * trials / n
        worst = max(worst, abs(frac - ((n - trials) / n + p * trials / n)) / sigma)
    return worst, float(fracs.mean())


def _surface_modes(device, card: str, grown: _Trees, X, y) -> dict:
    """(b) Higgs-1M, 50 iterations in each sampling mode, each fit twice."""
    from synapseml_torch import DataFrame as DF
    from synapseml_torch.gbdt import LightGBMClassifier
    from synapseml_torch.gbdt import booster as tbooster

    n = HIGGS_N
    train = DF.from_dict({"features": X[:n], "label": y[:n]})
    base = dict(HIGGS_PARAMS, num_iterations=SURFACE_ITERS)
    offered = []
    features = tbooster._Sampler.features

    def recording(self, it):
        mask = features(self, it)
        offered.append(mask)
        return mask

    out = {}
    for mode, kw in SURFACE_MODES.items():
        est = LightGBMClassifier(histogram_impl="pallas", device=str(device), **base, **kw)
        offered.clear()
        tbooster._Sampler.features = recording
        try:
            t0 = time.perf_counter()
            model = est.fit(train)
            fit_s = time.perf_counter() - t0
        finally:
            tbooster._Sampler.features = features
        k_offered = sorted({int(m.sum()) for m in offered})
        b = model.get_booster()
        grown.add(b)
        second = est.fit(train).get_booster()
        grown.add(second)
        same = _same_forest(b, second)
        prob = b.predict(X[n:], device=device)
        auc_ = auc(y[n:], prob) if np.isfinite(prob).all() else float("nan")
        if mode == "goss":
            # expected rows a tree: the top_rate rows by |g| (more where |g|
            # ties at the cut), plus other_rate of the rest, from each
            # iteration's scores
            def p_of_tree(t):
                if t == 0:
                    return None, n
                s = torch.from_numpy(b.raw_score(X[:n], num_iterations=t, device=device)[:, 0])
                g = (torch.sigmoid(s) - torch.from_numpy(y[:n])).abs()
                k_top = int(round(kw["top_rate"] * n))
                tops = int((g >= torch.sort(g).values[n - k_top]).sum())
                return kw["other_rate"], n - tops
        elif "bagging_fraction" in kw:
            def p_of_tree(t, f=kw["bagging_fraction"]):
                return f, n
        else:
            def p_of_tree(t):
                return None, n
        worst, mean_frac = _root_fraction_ok(b, n, p_of_tree)
        k_feat = max(1, int(round(HIGGS_F * kw.get("feature_fraction", 1.0))))
        log(f"[surface] (b) {mode} {kw}: fit {fit_s:.2f} s, a second fit bitwise: {same}, "
            f"held-out AUC {auc_:.5f}, rows a tree {mean_frac:.4f} of {n} (widest miss of the "
            f"expected fraction {worst:.2f} sigma, limit 4), features offered a tree "
            f"{k_offered} (want [{k_feat}]) | {card}")
        if not (same and np.isfinite(auc_) and worst <= 4.0 and k_offered == [k_feat]):
            raise AssertionError(f"the {mode} fit failed a check")
        out[mode] = {"booster": b, "auc": auc_, "fit_s": fit_s}
    for mode, drop in SURFACE_AUC_DROP.items():
        d = out["gbdt"]["auc"] - out[mode]["auc"]
        log(f"[surface] (b) {mode} AUC {out[mode]['auc']:.5f} against the bagged gbdt's "
            f"{out['gbdt']['auc']:.5f}: {d:+.5f} below (limit {drop})")
        if d > drop:
            raise AssertionError(f"{mode}'s held-out AUC falls too far below gbdt's")
    rf = out["rf"]["booster"]
    summed = tbooster.Booster(rf.feature, rf.threshold_value, rf.leaf_value, rf.gain,
                              max_depth=rf.max_depth, num_model_out=1, objective=rf.objective,
                              init_score=rf.init_score, num_features=rf.num_features,
                              device=str(device))
    x = X[n:n + 10_000]
    avg, tot = rf.raw_score(x, device=device), summed.raw_score(x, device=device)
    err = np.abs(avg - (rf.init_score + (tot - rf.init_score) / rf.num_iterations)).max()
    log(f"[surface] (b) rf scores are the init plus the mean of its {rf.num_iterations} trees: "
        f"max|d| {err:.2e} (tol 1e-5); probabilities in [{rf.predict(x, device=device).min():.3f}, "
        f"{rf.predict(x, device=device).max():.3f}]")
    if not (rf.average_output and err <= 1e-5):
        raise AssertionError("rf's output is not averaged")
    return out


def _cat_higgs(seed: int = 0):
    """Higgs-1M with CAT_COLS quantised to CAT_CODES integer categories
    each (at the training rows' quantiles), and a label term that depends
    on category membership non-monotonically (a random effect a code)."""
    rng = np.random.default_rng(seed)
    n, f = HIGGS_N + HIGGS_TEST, HIGGS_F
    X = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=f)
    w[f // 2:] = 0
    logits = X @ w * 0.5 + rng.normal(size=n) * 0.5
    effect = rng.normal(size=(len(CAT_COLS), CAT_CODES))
    for i, j in enumerate(CAT_COLS):
        cuts = np.quantile(X[:HIGGS_N, j], np.linspace(0, 1, CAT_CODES + 1)[1:-1])
        code = np.searchsorted(cuts, X[:, j])
        X[:, j] = code
        logits = logits + effect[i, code]
    return X, (logits > 0).astype(np.float32)


def _surface_categorical(device, card: str, grown: _Trees, tmp: str) -> dict:
    """(c) categorical columns through categorical_slot_indexes."""
    from synapseml_torch import DataFrame as DF
    from synapseml_torch.gbdt import (Booster, LightGBMClassifier, parse_lightgbm_string,
                                      to_lightgbm_string)

    X, y = _cat_higgs()
    n = HIGGS_N
    train = DF.from_dict({"features": X[:n], "label": y[:n]})
    kw = dict(HIGGS_PARAMS, num_iterations=SURFACE_ITERS, histogram_impl="pallas",
              device=str(device))
    t0 = time.perf_counter()
    cat_model = LightGBMClassifier(categorical_slot_indexes=list(CAT_COLS), **kw).fit(train)
    cat_s = time.perf_counter() - t0
    num_model = LightGBMClassifier(**kw).fit(train)
    cat_b, num_b = cat_model.get_booster(), num_model.get_booster()
    grown.add(cat_b)
    grown.add(num_b)
    test = X[n:]
    cat_auc = auc(y[n:], cat_b.predict(test, device=device))
    num_auc = auc(y[n:], num_b.predict(test, device=device))
    n_cat_nodes = int(cat_b.cat_mask.any(-1).sum())
    log(f"[surface] (c) {len(CAT_COLS)} columns of {CAT_CODES} categories: categorical fit "
        f"{cat_s:.2f} s, {n_cat_nodes} categorical splits, held-out AUC {cat_auc:.5f} against "
        f"{num_auc:.5f} fitted as numerical | {card}")
    if not cat_auc > num_auc:
        raise AssertionError("the categorical fit does not beat the numerical one")
    cat_b.save(os.path.join(tmp, "cat_booster"))
    loaded = Booster.load(os.path.join(tmp, "cat_booster"), device=str(device))
    raw = cat_b.raw_score(test, device=device)
    same = np.array_equal(loaded.raw_score(test, device=device), raw)
    imported = parse_lightgbm_string(to_lightgbm_string(cat_b))
    # the export folds the init score into each class's first tree, so the
    # import rounds once more: held to 1e-6 of the score's magnitude
    imp_err = float((np.abs(imported.raw_score(test, device=device) - raw)
                     / np.maximum(np.abs(raw), 1.0)).max())
    contrib = cat_b.predict_contrib(test[:200])
    shap_err = float(np.abs(contrib.sum(-1) - raw[:200]).max())
    log(f"[surface] (c) save -> load scores bitwise: {same}; model.txt -> ImportedBooster "
        f"max|d| / max(|score|, 1) {imp_err:.2e} (tol 1e-6); SHAP rows sum to the raw score within "
        f"{shap_err:.2e} (tol 1e-4)")
    if not (same and imp_err <= 1e-6 and shap_err <= 1e-4):
        raise AssertionError("a categorical booster's round trip or SHAP failed")
    return {"auc": cat_auc, "num_auc": num_auc}


def _surface_out_of_core(device, card: str, tmp: str, X, y) -> dict:
    """(d) train_booster_from_source over Higgs-width CSV byte-range shards
    (cut to OOC_ROWS rows) under injected read faults, and a jsonl file."""
    from synapseml_torch.core import FaultSpec, inject_faults
    from synapseml_torch.core.resilience import RetryPolicy, resilience_measures
    from synapseml_torch.data import ShardedSource
    from synapseml_torch.gbdt import train_booster, train_booster_from_source

    n = OOC_ROWS
    path = os.path.join(tmp, "higgs.csv")
    t0 = time.perf_counter()
    names = [f"f{j}" for j in range(HIGGS_F)]
    with open(path, "w") as f:
        f.write(",".join(names) + ",label\n")
        np.savetxt(f, np.column_stack([X[:n], y[:n]]), delimiter=",",
                   fmt=["%.7f"] * HIGGS_F + ["%d"])
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    retry = RetryPolicy(backoffs_ms=(1, 1, 1), jitter=False)
    src = ShardedSource.csv(path, shard_bytes=size // 5 + 1, retry_policy=retry)
    read = [cols for _, cols in src.iter_shards()]
    rows = sum(len(c["label"]) for c in read)
    Xr = np.column_stack([np.concatenate([c[k] for c in read]) for k in names]).astype(np.float32)
    yr = np.concatenate([c["label"] for c in read]).astype(np.float32)
    kw = dict(objective="binary", num_iterations=OOC_ITERS, learning_rate=0.1, num_leaves=31,
              max_depth=6, max_bin=255)
    retries0 = resilience_measures("data").to_dict()["retry_count"]
    t0 = time.perf_counter()
    with inject_faults([FaultSpec("connection_error", times=3, planes=("data",))]) as plan:
        streamed = train_booster_from_source(src, label_col="label", feature_cols=names,
                                             chunk_rows=OOC_CHUNK, device=str(device), **kw)
    stream_s = time.perf_counter() - t0
    retries = resilience_measures("data").to_dict()["retry_count"] - retries0
    in_mem = train_booster(Xr, yr, histogram_impl="segment", device=str(device), **kw)
    s_auc = auc(y[HIGGS_N:], streamed.predict(X[HIGGS_N:], device=device))
    m_auc = auc(y[HIGGS_N:], in_mem.predict(X[HIGGS_N:], device=device))
    chunks = -(-n // OOC_CHUNK) + src.num_shards
    log(f"[surface] (d) out-of-core: {rows} rows read back of {n} written ({size / 1e6:.1f} MB "
        f"CSV, written in {write_s:.1f} s), {src.num_shards} byte-range shards, about {chunks} "
        f"spill chunks of {OOC_CHUNK} rows; streamed fit {stream_s:.2f} s "
        f"({streamed.train_measures['stats_pass_ms']:.0f} ms stats pass, "
        f"{streamed.train_measures['binning_ms']:.0f} ms bin+spill, "
        f"{streamed.train_measures['training_ms']:.0f} ms training); injected read errors "
        f"{len(plan.injected)}, retried {retries}; held-out AUC {s_auc:.5f} against the "
        f"in-memory 'segment' fit's {m_auc:.5f} (|d| {abs(s_auc - m_auc):.2e}, tol "
        f"{OOC_AUC_TOL}) | {card}")
    if not (rows == n and src.num_shards >= 4 and n // OOC_CHUNK >= 4
            and len(plan.injected) == 3 and retries == 3
            and abs(s_auc - m_auc) <= OOC_AUC_TOL):
        raise AssertionError("the out-of-core fit failed a check")
    jpath = os.path.join(tmp, "higgs.jsonl")
    with open(jpath, "w") as f:
        for i in range(OOC_JSONL_ROWS):
            f.write(json.dumps({"feat": X[i].tolist(), "label": float(y[i])}) + "\n")
    jsrc = ShardedSource.jsonl(jpath, shard_bytes=os.path.getsize(jpath) // 4 + 1)
    jb = train_booster_from_source(jsrc, label_col="label", feature_cols=["feat"],
                                   device=str(device), **dict(kw, num_iterations=10))
    j_rows = int(jb.cover[0, 0, 0])
    log(f"[surface] (d) jsonl: {jsrc.num_shards} shards, {j_rows} rows in the first tree's "
        f"root (want {OOC_JSONL_ROWS}), held-out AUC "
        f"{auc(y[HIGGS_N:], jb.predict(X[HIGGS_N:], device=device)):.5f}")
    if j_rows != OOC_JSONL_ROWS:
        raise AssertionError("the jsonl fit lost rows")
    return {"auc": s_auc, "in_memory_auc": m_auc, "stream_s": stream_s}


def _surface_continue(device, card: str, grown: _Trees, X, y, source) -> None:
    """(e) LightGBMClassifier(model_string=...) from (b)'s gbdt booster."""
    from synapseml_torch import DataFrame as DF
    from synapseml_torch.gbdt import LightGBMClassifier

    train = DF.from_dict({"features": X[:HIGGS_N], "label": y[:HIGGS_N]})
    est = LightGBMClassifier(histogram_impl="pallas", device=str(device), model_string=source,
                             **dict(HIGGS_PARAMS, num_iterations=CONTINUE_ITERS))
    b = est.fit(train).get_booster()
    grown.add(b, prefix=source.num_iterations)
    k = source.num_iterations
    same = all(np.array_equal(getattr(b, name)[:k], getattr(source, name))
               for name in ("feature", "threshold_value", "leaf_value"))
    c_auc = auc(y[HIGGS_N:], b.predict(X[HIGGS_N:], device=device))
    log(f"[surface] (e) continued training: {b.num_iterations} trees ({k} + {CONTINUE_ITERS}), "
        f"the first {k} bitwise the source's: {same}, held-out AUC {c_auc:.5f} | {card}")
    if not (same and b.num_iterations == k + CONTINUE_ITERS and np.isfinite(c_auc)):
        raise AssertionError("continued training did not keep its source's trees")


def phase_gbdt_surface(device, card: str) -> dict:
    """Main path 9: (a) the ranker at the MSLR-WEB10K shape, (b) Higgs-1M in
    each sampling mode, (c) categorical columns, (d) out-of-core training,
    (e) continued training; then the level launch's device time at the
    ranker's 136 features. Returns the histogram kernel's launches."""
    import tempfile

    from synapseml_torch.gbdt import hist
    from synapseml_torch.gbdt.trees import derive_max_depth

    t_start = time.perf_counter()
    hist.fixed_point_histogram.launches = 0
    hist.fixed_point_scales.launches = 0
    grown = _Trees(derive_max_depth(-1, 31))
    out = {"ranker": _surface_ranker(device, card, grown)}
    log(f"[surface] (a) done at {time.perf_counter() - t_start:.1f} s")
    X, y = higgs_data(HIGGS_N, HIGGS_TEST, HIGGS_F)
    modes = _surface_modes(device, card, grown, X, y)
    log(f"[surface] (b) done at {time.perf_counter() - t_start:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gbdt_") as tmp:
        out["categorical"] = _surface_categorical(device, card, grown, tmp)
        log(f"[surface] (c) done at {time.perf_counter() - t_start:.1f} s")
        out["out_of_core"] = _surface_out_of_core(device, card, tmp, X, y)
        log(f"[surface] (d) done at {time.perf_counter() - t_start:.1f} s")
    _surface_continue(device, card, grown, X, y, modes["gbdt"]["booster"])
    launches, scales = _hist_counts()
    want = grown.trees * (grown.depth + 1)
    log(f"[surface] main path 9 launched gbdt_hist {launches} times (want {grown.trees} trees "
        f"x {grown.depth + 1} = {want}) and its scale pass {scales} (want {grown.trees})")
    if launches != want or scales != grown.trees:
        raise AssertionError("main path 9's histogram launches are off their count")
    out.update(launches=launches, scale_launches=scales)
    out["seconds"] = time.perf_counter() - t_start
    log(f"[surface] main path 9: {out['seconds']:.1f} s of the script's clock")
    tot, tot_bytes, k = _tree_level_times(device, card, out["ranker"]["rows"], MSLR_F)
    ms = statistics.median([tot["ms"], tot["ms2"]]) / k
    lib = statistics.median([tot["library_ms"], tot["library_ms2"]]) / k
    log(f"[times] gbdt_hist at the ranker's shape [N={out['ranker']['rows']}, F={MSLR_F}]: "
        f"{ms:.4f} ms a launch (mean of {k}; device time), bound "
        f"{tot_bytes / k / HBM_BYTES_PER_S * 1e3:.4f} ms by bytes, plain "
        f"{tot['plain_ms'] / k:.4f} ms, index_add_ {lib:.4f} ms | {card}")
    return out


# ---------------- main path 10: ONNX's whole opset ----------------

FUSED_ROWS, FUSED_PARTS, FUSED_BATCH, FUSED_T = 512, 4, 32, 128
# the last hidden states against the port's own BERT encoder on the same
# weights, both strict f32 on the card; a TF32 run must fail it (the control)
FUSED_TOL = 1e-4
GPT_CFG = dict(vocab=50257, d=768, layers=12, heads=12, max_len=1024)  # GPT-2 small's widths
GPT_SHAPES = ((8, 128), (8, 64))
GPT_TOL = 1e-4     # logits against the torch module, both strict f32 on the card
# the op sweep, card against the port on the CPU: integer, index, quantized,
# bitwise, detection and data-dependent outputs bitwise; floating ones within
# SWEEP_TOL of max(1, max |CPU output|); random draws within 4 sigma of their law
SWEEP_TOL = 1e-5
RNN_T, RNN_B, RNN_H = 128, 32, 512
# the op types main path 10 holds to the CPU: the reference's registry less
# the 64 ported with ONNXModel first, and the control-flow nodes the
# executor runs
ONNX_ADDED_OPS = frozenset("""
Acos Acosh AffineGrid And ArgMin Asin Asinh Atan Atanh Attention Bernoulli BiasGelu BitShift
BitwiseAnd BitwiseNot BitwiseOr BitwiseXor Ceil Celu CenterCropPad Col2Im Compress ConvTranspose
Cosh CumSum DFT DepthToSpace DequantizeLinear DynamicQuantizeLinear Elu EmbedLayerNormalization
EyeLike FastGelu Floor FusedMatMul GRU GatherElements GatherND GlobalLpPool GreaterOrEqual
GridSample GroupNormalization Hardmax InstanceNormalization IsInf IsNaN LRN LSTM LessOrEqual
LpNormalization MatMulInteger Max Mean MeanVarianceNormalization Min Mish Mod Multinomial
NegativeLogLikelihoodLoss NonMaxSuppression NonZero OneHot Or PRelu QLinearConv QLinearMatMul
QuantizeLinear QuickGelu RandomNormal RandomNormalLike RandomUniform RandomUniformLike Reciprocal
ReduceL1 ReduceL2 ReduceLogSum ReduceLogSumExp ReduceSumSquare Resize ReverseSequence RoiAlign
Round STFT ScatterElements ScatterND Selu Shrink Sign Sinh Size SkipLayerNormalization
SoftmaxCrossEntropyLoss Softplus Softsign SpaceToDepth Sum Tan ThresholdedRelu Trilu Unique Xor
If Loop Scan""".split())
_OPSET_GROUPS = (("matmul", ("gemm", "nvjet", "cutlass", "cublas", "sm90_", "dot_kernel")),
                 ("softmax", ("softmax",)),  # matched in lower case, first match wins
                 ("layer norms", ("layer_norm", "reduce", "mean", "var", "rsqrt")),
                 ("copies", ("copy", "memcpy", "cat", "index", "gather", "embedding")),
                 ("elementwise", ("elementwise", "vectorized", "gelu", "erf", "add", "mul",
                                  "where", "fill", "masked")))


def _ms_node(op, inputs, outputs, domain="", **attrs):
    return onnx_proto.NodeProto(input=list(inputs), output=list(outputs), op_type=op,
                                domain=domain,
                                attribute=[onnx_proto.AttributeProto.make(k, v)
                                           for k, v in attrs.items()])


def _fused_bert_bytes(params: dict, cfg) -> bytes:
    """BERT's encoder in the form ONNX Runtime's transformer optimizer writes
    for bert-base-uncased: EmbedLayerNormalization (word, position and
    segment tables, the 2-D mask in, its 1-D mask_index out), then a layer:
    Attention (q|k|v as one [H, 3H] weight, the mask_index), MatMul (the
    output projection, its bias in the SkipLayerNormalization that follows),
    SkipLayerNormalization, MatMul + BiasGelu, MatMul, SkipLayerNormalization
    (the down projection's bias its bias input). ``params`` is the port's
    BertClassifier state_dict; the output ``hidden`` is the encoder's last
    hidden states."""
    P = onnx_proto

    def t(name):
        return np.ascontiguousarray(np.asarray(params[name], np.float32))

    def ms(op, ins, outs, **attrs):
        return _ms_node(op, ins, outs, "com.microsoft", **attrs)

    eps = float(cfg.norm_eps)
    inits = {"word": t("embeddings.word.weight"), "pos": t("embeddings.position.weight"),
             "seg": t("embeddings.segment.weight"), "emb_g": t("embeddings.norm.weight"),
             "emb_b": t("embeddings.norm.bias")}
    nodes = [ms("EmbedLayerNormalization", ["input_ids", "segment_ids", "word", "pos", "seg",
                                            "emb_g", "emb_b", "mask"], ["h0", "mask_index"],
                epsilon=eps)]
    h = "h0"
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}."
        inits.update({
            f"qkv_w{i}": np.concatenate([t(f"{p}attn.{n}.weight").T for n in "qkv"], axis=1),
            f"qkv_b{i}": np.concatenate([t(f"{p}attn.{n}.bias") for n in "qkv"]),
            f"o_w{i}": t(f"{p}attn.o.weight").T.copy(), f"o_b{i}": t(f"{p}attn.o.bias"),
            f"g1_{i}": t(f"{p}norm1.weight"), f"b1_{i}": t(f"{p}norm1.bias"),
            f"up_w{i}": t(f"{p}mlp.up.weight").T.copy(), f"up_b{i}": t(f"{p}mlp.up.bias"),
            f"dn_w{i}": t(f"{p}mlp.down.weight").T.copy(), f"dn_b{i}": t(f"{p}mlp.down.bias"),
            f"g2_{i}": t(f"{p}norm2.weight"), f"b2_{i}": t(f"{p}norm2.bias")})
        out = "hidden" if i == cfg.n_layers - 1 else f"h{i + 1}"
        nodes += [ms("Attention", [h, f"qkv_w{i}", f"qkv_b{i}", "mask_index"], [f"ctx{i}"],
                     num_heads=cfg.n_heads),
                  _ms_node("MatMul", [f"ctx{i}", f"o_w{i}"], [f"attn{i}"]),
                  ms("SkipLayerNormalization", [f"attn{i}", h, f"g1_{i}", f"b1_{i}", f"o_b{i}"],
                     [f"x{i}"], epsilon=eps),
                  _ms_node("MatMul", [f"x{i}", f"up_w{i}"], [f"up{i}"]),
                  ms("BiasGelu", [f"up{i}", f"up_b{i}"], [f"act{i}"]),
                  _ms_node("MatMul", [f"act{i}", f"dn_w{i}"], [f"dn{i}"]),
                  ms("SkipLayerNormalization", [f"dn{i}", f"x{i}", f"g2_{i}", f"b2_{i}",
                                                f"dn_b{i}"], [out], epsilon=eps)]
        h = out
    ids = [P.ValueInfoProto(name=n, elem_type=P.INT64, dims=["N", "T"])
           for n in ("input_ids", "segment_ids", "mask")]
    g = P.GraphProto(name="bert_fused", node=nodes,
                     initializer=[P.numpy_to_tensor(np.ascontiguousarray(v), k)
                                  for k, v in inits.items()],
                     input=ids, output=[P.ValueInfoProto(name="hidden", elem_type=P.FLOAT,
                                                         dims=["N", "T", cfg.hidden])])
    return P.ModelProto(ir_version=8, producer_name="onnxruntime.transformers", graph=g,
                        opset_import=[P.OperatorSetId(version=17),
                                      P.OperatorSetId(domain="com.microsoft", version=1)]
                        ).encode()


def _native_bert_encoder(params: dict, cfg, device):
    """The port's own BERT (models/nets/bert.py) on ``params``, f32 compute,
    einsum attention: ``fn(ids, mask) -> last hidden states``."""
    from synapseml_torch.models.nets.bert import BertClassifier

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32, attn_impl="einsum")
    net = BertClassifier(cfg32)
    net.load_state_dict({k: host_tensor(v) for k, v in params.items()})
    net = net.to(device).eval()

    def fn(ids, mask):
        with torch.inference_mode():
            return net.encoder(net.embeddings(ids), mask[:, None, None, :].bool())

    return fn


def _profile_opset_batch(fn, card: str, tag: str, n=3) -> dict:
    """Device time of one batch of ``fn`` by group (_OPSET_GROUPS) and the
    card's busy share of its wall time, under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    kernels = []
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kernels = [(e.self_device_time_total / e.count * -(-e.count // n) / 1e3,
                    -(-e.count // n), e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if kernels:
            break
        log(f"[profile] session {attempt + 1} recorded no device kernel; profiling again")
    busy = sum(k[0] for k in kernels)
    if not busy:
        raise AssertionError(f"the profiler recorded no device time for {tag}")
    groups = {name: 0.0 for name, _ in _OPSET_GROUPS}
    groups["other"] = 0.0
    for ms, _, key in kernels:
        name = next((g for g, pats in _OPSET_GROUPS if any(p in key.lower() for p in pats)),
                    "other")
        groups[name] += ms
    log(f"[profile] {tag}: {wall_ms:.3f} ms wall, {busy:.3f} ms of device time "
        f"({100 * busy / wall_ms:.1f}% busy), {sum(k[1] for k in kernels)} device operations "
        f"| {card}")
    log(f"[profile] {tag} by group: " + ", ".join(
        f"{name} {ms:.4f} ms ({100 * ms / busy:.1f}%)"
        for name, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for ms, count, key in sorted(kernels, reverse=True)[:6]:
        log(f"[profile] {tag} {100 * ms / busy:5.1f}%  {ms:8.4f} ms  {count:4d}x  {key[:110]}")
    return {"wall_ms": wall_ms, "busy_ms": busy, "busy": busy / wall_ms, "groups": groups}


def _fused_bert_rows(cfg) -> DataFrame:
    """FUSED_ROWS texts as main path 1 draws them, hashed and padded to
    FUSED_T tokens (right-padded: EmbedLayerNormalization's mask_index is
    each row's length), in FUSED_PARTS partitions."""
    tok = HashingTokenizer(vocab_size=cfg.vocab_size)
    texts = _texts(FUSED_ROWS, FUSED_PARTS, seed=0)
    enc = tok(texts, max_len=FUSED_T)
    L = enc["input_ids"].shape[1]
    ids = np.zeros((FUSED_ROWS, FUSED_T), np.int64)
    mask = np.zeros((FUSED_ROWS, FUSED_T), np.int64)
    ids[:, :L], mask[:, :L] = enc["input_ids"], enc["attention_mask"]
    per = FUSED_ROWS // FUSED_PARTS
    return DataFrame([{"input_ids": ids[s:s + per], "segment_ids": np.zeros_like(ids[s:s + per]),
                       "attention_mask": mask[s:s + per]}
                      for s in range(0, FUSED_ROWS, per)])


def _onnx_fused_bert(device, card: str) -> dict:
    """Main path 10 (a): an ORT-fused BERT-base through ONNXModel, held to
    the port's own encoder on the same weights."""
    cfg = bert_base()
    t0 = time.perf_counter()
    params = bert_state_dict_from_flax(init_flax_bert_params(cfg, num_classes=2, seed=0))
    data = _fused_bert_bytes(params, cfg)
    build_s = time.perf_counter() - t0
    graph = onnx_proto.parse_model(data).graph
    ops = {}
    for n in graph.node:
        ops[n.op_type] = ops.get(n.op_type, 0) + 1
    log(f"[opset] (a) ORT-fused BERT-base from main path 1's weights (seed 0): {len(data)} "
        f"bytes, {len(graph.node)} nodes {ops}, built in {build_s:.2f} s")
    native = _native_bert_encoder(params, cfg, device)
    df = _fused_bert_rows(cfg)
    lengths = np.concatenate([p["attention_mask"].sum(1) for p in df.partitions])
    stage = ONNXModel(model_bytes=data, device=str(device), mini_batch_size=FUSED_BATCH,
                      feed_dict={"input_ids": "input_ids", "segment_ids": "segment_ids",
                                 "mask": "attention_mask"},
                      fetch_dict={"hidden": "hidden"})
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = stage.transform(df)          # converts, moves the weights, warms the libraries
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out2 = stage.transform(df)
    second_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    got = _onnx_column(out, "hidden")
    same = np.array_equal(got, _onnx_column(out2, "hidden"))
    ids = np.concatenate([p["input_ids"] for p in df.partitions])
    mask = np.concatenate([p["attention_mask"] for p in df.partitions])
    err = 0.0
    for s in range(0, FUSED_ROWS, FUSED_BATCH):
        want = native(torch.from_numpy(ids[s:s + FUSED_BATCH]).to(device),
                      torch.from_numpy(mask[s:s + FUSED_BATCH]).to(device))
        err = max(err, float((torch.from_numpy(got[s:s + FUSED_BATCH]).to(device) - want)
                             .abs().max()))
    log(f"[opset] (a) ONNXModel over {FUSED_ROWS} rows ({FUSED_PARTS} partitions, batches of "
        f"{FUSED_BATCH} x {FUSED_T}, lengths {int(lengths.min())}-{int(lengths.max())}): "
        f"{first_s:.3f} s first, {second_s:.3f} s second ({FUSED_ROWS / second_s:.1f} rows/s, "
        f"host clock), a second transform bitwise the first: {same}; peak device memory "
        f"{peak_gib:.3f} GiB | {card}")
    log(f"[opset] (a) last hidden states {got.shape} against the port's BERT encoder (f32, "
        f"einsum): max |diff| {err:.3e} (limit {FUSED_TOL})")
    if not (got.shape == (FUSED_ROWS, FUSED_T, cfg.hidden) and np.isfinite(got).all()
            and err <= FUSED_TOL and same):
        raise AssertionError("the ORT-fused BERT-base disagrees with the port's encoder")

    conv = stage.converted
    feeds = {"input_ids": torch.from_numpy(ids[:FUSED_BATCH]).to(device),
             "segment_ids": torch.zeros((FUSED_BATCH, FUSED_T), dtype=torch.int64,
                                        device=device),
             "mask": torch.from_numpy(mask[:FUSED_BATCH]).to(device)}
    want = native(feeds["input_ids"], feeds["mask"])
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            tf32 = conv.run(feeds, device)["hidden"]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    ctl = float((tf32 - want).abs().max())
    log(f"[opset] (a) control, one batch with TF32 allowed: max |diff| {ctl:.3e} (must exceed "
        f"{FUSED_TOL}) | {card}")
    if not ctl > FUSED_TOL:
        raise AssertionError("the fused BERT limit passes a TF32 run: it cannot tell it from f32")

    def graph_batch():
        with torch.inference_mode():
            conv.run(feeds, device)

    batch_ms = cuda_ms(graph_batch, warmup=3, iters=10)
    batch_dev_ms = device_ms(graph_batch, warmup=2, iters=10)
    native_ms = device_ms(lambda: native(feeds["input_ids"], feeds["mask"]), warmup=2, iters=10)
    log(f"[opset] (a) a batch of {FUSED_BATCH} x {FUSED_T}: the fused graph {batch_ms:.3f} ms "
        f"(CUDA events, host enqueue included), {batch_dev_ms:.3f} ms device time; the port's "
        f"encoder {native_ms:.3f} ms device time | {card}")
    prof = _profile_opset_batch(graph_batch, card, "opset (a) one fused BERT-base batch")
    del conv, stage, native, out, out2, got
    _free_card()
    return {"rows_s": FUSED_ROWS / second_s, "batch_ms": batch_ms, "batch_dev_ms": batch_dev_ms,
            "native_ms": native_ms, "peak_gib": peak_gib, "max_abs_err": err, "tf32_err": ctl,
            "busy": prof["busy"]}


class _CausalBlock(torch.nn.Module):
    """tests/_torch_gpt.py's CausalBlock."""

    def __init__(self, d: int, h: int):
        super().__init__()
        nn = torch.nn
        self.h, self.dk = h, d // h
        self.qkv = nn.Linear(d, 3 * d)
        self.o = nn.Linear(d, d)
        self.ln1, self.ln2 = nn.LayerNorm(d), nn.LayerNorm(d)
        self.mlp = nn.Sequential(nn.Linear(d, 4 * d), nn.GELU(), nn.Linear(4 * d, d))

    def forward(self, x):
        B, T, D = x.size(0), x.size(1), x.size(2)
        q, k, v = self.qkv(self.ln1(x)).chunk(3, dim=-1)

        def sp(t):
            return t.view(B, T, self.h, self.dk).transpose(1, 2)

        q, k, v = sp(q), sp(k), sp(v)
        att = (q @ k.transpose(-2, -1)) / math.sqrt(self.dk)
        mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
        att = att.masked_fill(~mask, float("-inf"))   # Not + Where export
        y = torch.softmax(att, dim=-1) @ v
        y = y.transpose(1, 2).reshape(B, T, D)
        x = x + self.o(y)
        return x + self.mlp(self.ln2(x))


class _TorchGPT(torch.nn.Module):
    """tests/_torch_gpt.py's TorchTinyGPT: a GPT-2-style causal decoder
    whose export holds Trilu, Not/Where and GatherElements."""

    def __init__(self, vocab: int, d: int, layers: int, heads: int, max_len: int):
        super().__init__()
        nn = torch.nn
        self.tok = nn.Embedding(vocab, d)
        self.pos = nn.Embedding(max_len, d)
        self.blocks = nn.ModuleList(_CausalBlock(d, heads) for _ in range(layers))
        self.lnf = nn.LayerNorm(d)
        self.head = nn.Linear(d, vocab, bias=False)

    def forward(self, ids, gather_idx):
        T = ids.size(1)
        x = self.tok(ids) + self.pos(torch.arange(T, device=ids.device)).unsqueeze(0)
        for b in self.blocks:
            x = b(x)
        logits = self.head(self.lnf(x))
        idx = gather_idx.unsqueeze(-1).unsqueeze(-1).expand(-1, 1, logits.size(-1))
        return torch.gather(logits, 1, idx).squeeze(1)


def _onnx_gpt_export(device, card: str) -> dict:
    """Main path 10 (b): a GPT-2-width causal decoder exported by torch on
    the card, scored through ONNXModel at two lengths, held to the module."""
    from synapseml_torch.onnx.convert import _all_op_types

    torch.manual_seed(0)
    model = _TorchGPT(**GPT_CFG).to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    B0, T0 = GPT_SHAPES[0]
    rs = np.random.default_rng(0)
    t0 = time.perf_counter()
    data = _export_onnx(model, (torch.zeros((B0, T0), dtype=torch.int64, device=device),
                                torch.zeros(B0, dtype=torch.int64, device=device)),
                        input_names=["ids", "gather_idx"],
                        dynamic_axes={"ids": {0: "N", 1: "T"}, "gather_idx": {0: "N"},
                                      "logits": {0: "N"}})
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stage = ONNXModel(model_bytes=data, device=str(device), mini_batch_size=B0,
                      feed_dict={"ids": "ids", "gather_idx": "gather_idx"},
                      fetch_dict={"logits": "logits"})
    conv = stage.converted
    convert_s = time.perf_counter() - t0
    ops = _all_op_types(conv.model.graph)
    log(f"[opset] (b) GPT-2-width decoder ({n_params:,} params, torch initialisers from seed "
        f"0) exported on the card by torch {torch.__version__}'s TorchScript exporter: "
        f"{len(data) / 1e6:.1f} MB, {len(conv.model.graph.node)} nodes, {len(ops)} op types, "
        f"export {export_s:.2f} s, parse + convert {convert_s:.2f} s (host clock)")
    if not {"Trilu", "GatherElements", "Not", "Where"} <= ops:
        raise AssertionError(f"the decoder export lacks Trilu/GatherElements/Not/Where: {ops}")
    out = {"export_s": export_s, "convert_s": convert_s, "max_abs_err": 0.0, "ms": {}}
    for B, T in GPT_SHAPES:
        ids = rs.integers(0, GPT_CFG["vocab"], (B, T)).astype(np.int64)
        gi = rs.integers(0, T, B).astype(np.int64)
        got = _onnx_column(stage.transform(DataFrame([{"ids": ids, "gather_idx": gi}])),
                           "logits")
        ids_d, gi_d = torch.from_numpy(ids).to(device), torch.from_numpy(gi).to(device)
        with torch.inference_mode():
            want = model(ids_d, gi_d).cpu().numpy()
        err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")

        def graph_batch():
            with torch.inference_mode():
                conv.run({"ids": ids_d, "gather_idx": gi_d}, device)

        ms = cuda_ms(graph_batch, warmup=2, iters=10)
        log(f"[opset] (b) {B} x {T}: logits {got.shape} (max |logit| {np.abs(want).max():.3f}) "
            f"against the torch module: max |diff| {err:.3e} (limit {GPT_TOL}); {ms:.3f} ms a "
            f"batch (CUDA events) | {card}")
        if not (np.isfinite(got).all() and err <= GPT_TOL):
            raise AssertionError(f"the GPT export's logits disagree with the module at {B} x {T}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["ms"][f"{B}x{T}"] = ms
    del model, conv, stage
    _free_card()
    return out


def _one_node(op, inputs, attrs, n_out, init, domain=""):
    """A one-node model (``inputs[i]`` an initializer when ``i`` is in
    ``init``, None an omitted input) and its feeds."""
    P = onnx_proto
    names = [f"in{i}" if a is not None else "" for i, a in enumerate(inputs)]
    present = [(i, n, np.asarray(a)) for i, (n, a) in enumerate(zip(names, inputs))
               if a is not None]
    g = P.GraphProto(
        name=op, node=[_ms_node(op, names, [f"out{j}" for j in range(n_out)], domain, **attrs)],
        initializer=[P.numpy_to_tensor(a, n) for i, n, a in present if i in init],
        input=[P.ValueInfoProto(name=n, elem_type=P._NP_TO_DTYPE[a.dtype], dims=list(a.shape))
               for i, n, a in present if i not in init],
        output=[P.ValueInfoProto(name=f"out{j}") for j in range(n_out)])
    return P.ModelProto(graph=g).encode(), {n: a for i, n, a in present if i not in init}


def _sweep_cases():
    """(op, inputs, attrs, init, n_out, exact) for every op type this slice
    ported, on small inputs from numpy seed 0."""
    rs = np.random.default_rng(0)
    I64 = np.int64

    def f(*shape, scale=1.0):
        return (rs.standard_normal(shape) * scale).astype(np.float32)

    def ints(lo, hi, shape, dtype):
        return rs.integers(lo, hi, shape).astype(dtype)

    x, y = f(8, 16, scale=3.0), f(8, 16, scale=3.0)
    u = rs.uniform(-0.9, 0.9, (8, 16)).astype(np.float32)
    img, ex = f(2, 8, 6, 10), ints(-4, 5, (6, 7), np.float32)
    a8, b8 = ints(0, 255, (16, 64), np.uint8), ints(-128, 127, (64, 24), np.int8)
    corner = rs.uniform(0, 10, (2, 40, 2))
    boxes = np.concatenate([corner, corner + rs.uniform(0.5, 3, (2, 40, 2))], -1).astype(np.float32)
    cases = [(o, [x], {}, (), 1, o in ("Floor", "Ceil", "Round", "Sign"))
             for o in ("Floor", "Ceil", "Round", "Sign", "Softplus", "Softsign", "Mish", "Tan",
                       "Atan", "Sinh", "Cosh", "Asinh")]
    cases += [(o, [u], {}, (), 1, False) for o in ("Asin", "Acos", "Atanh")]
    cases += [("Acosh", [1 + np.abs(x)], {}, (), 1, False),
              ("Reciprocal", [np.abs(x) + 0.5], {}, (), 1, False),
              ("IsNaN", [np.where(x > 2, np.nan, x).astype(np.float32)], {}, (), 1, True),
              ("IsInf", [np.where(x > 2, np.inf, np.where(x < -2, -np.inf, x)).astype(np.float32)],
               {}, (), 1, True)]
    cases += [(o, [x, y, x], {}, (), 1, True) for o in ("Min", "Max")]
    cases += [(o, [x, y, x], {}, (), 1, False) for o in ("Sum", "Mean")]
    cases += [(o, [x > 0, y > 0, x > 1], {}, (), 1, True) for o in ("And", "Or", "Xor")]
    cases += [(o, [x, y], {}, (), 1, True) for o in ("GreaterOrEqual", "LessOrEqual")]
    ia, ib = ints(0, 255, (8, 16), np.int32), ints(0, 255, (8, 16), np.int32)
    cases += [(o, [ia, ib], {}, (), 1, True) for o in ("BitwiseAnd", "BitwiseOr", "BitwiseXor")]
    cases += [("BitwiseNot", [ia], {}, (), 1, True),
              ("BitShift", [ia.astype(np.uint8), ints(0, 8, (8, 16), np.uint8)],
               {"direction": "LEFT"}, (), 1, True),
              ("Mod", [ints(-50, 50, (8, 16), I64), ints(1, 9, (8, 16), I64)], {}, (), 1, True),
              ("Mod", [x, np.abs(y) + 0.5], {"fmod": 1}, (), 1, False),
              ("PRelu", [x, f(16)], {}, (1,), 1, False),
              ("Elu", [x], {"alpha": 0.5}, (), 1, False), ("Selu", [x], {}, (), 1, False),
              ("Celu", [x], {"alpha": 2.0}, (), 1, False),
              ("ThresholdedRelu", [x], {"alpha": 1.0}, (), 1, True),
              ("Shrink", [x], {"lambd": 0.5, "bias": 0.2}, (), 1, False),
              ("CumSum", [ex, np.array(1, I64)], {"exclusive": 1, "reverse": 1}, (1,), 1, True),
              ("OneHot", [ints(-4, 6, (5, 3), I64), np.array(6, I64),
                          np.array([0.5, 9.0], np.float32)], {"axis": 1}, (1,), 1, True),
              ("ArgMin", [x], {"axis": 1}, (), 1, True)]
    cases += [(o, [x, np.array([1], I64)], {}, (1,), 1, False)
              for o in ("ReduceL1", "ReduceL2", "ReduceSumSquare", "ReduceLogSumExp")]
    cases += [("ReduceLogSum", [np.abs(x) + 0.1, np.array([0], I64)], {}, (1,), 1, False),
              ("DepthToSpace", [img], {"blocksize": 2, "mode": "CRD"}, (), 1, True),
              ("SpaceToDepth", [img], {"blocksize": 2}, (), 1, True),
              ("ReverseSequence", [f(5, 4, 3), np.array([5, 2, 1, 0], I64)], {}, (1,), 1, True),
              ("EyeLike", [x], {"k": 2}, (), 1, True), ("Size", [img], {}, (), 1, True),
              ("Hardmax", [x], {"axis": 0}, (), 1, True),
              ("LRN", [img], {"size": 3, "alpha": 2e-4, "beta": 0.6, "bias": 1.5}, (), 1, False),
              ("LpNormalization", [x], {"axis": 1, "p": 2}, (), 1, False),
              ("GlobalLpPool", [img], {"p": 2}, (), 1, False),
              ("Trilu", [f(3, 6, 6), np.array(-1, I64)], {"upper": 0}, (1,), 1, True),
              ("GatherElements", [x, ints(-16, 16, (8, 5), I64)], {"axis": 1}, (), 1, True),
              ("GatherND", [f(4, 5, 6), ints(0, 5, (4, 3, 1), I64)], {"batch_dims": 1}, (), 1,
               True),
              ("ScatterElements", [ex, ints(-7, 7, (6, 3), I64), ints(-3, 4, (6, 3), np.float32)],
               {"axis": 1, "reduction": "add"}, (), 1, True),
              ("ScatterND", [ex, np.array([[1, 2], [3, -1], [1, 2]], I64),
                             np.array([2.0, -3.0, 5.0], np.float32)], {"reduction": "max"}, (),
               1, True),
              ("ConvTranspose", [img, f(8, 3, 3, 3), f(6)],
               {"strides": [2, 2], "pads": [1, 1, 1, 1], "output_padding": [1, 1], "group": 2},
               (1, 2), 1, False),
              ("InstanceNormalization", [img, f(8), f(8)], {}, (1, 2), 1, False),
              ("Resize", [img, np.zeros(0, np.float32), None, np.array([2, 8, 11, 17], I64)],
               {"mode": "linear", "coordinate_transformation_mode": "pytorch_half_pixel"},
               (1, 3), 1, False),
              ("GroupNormalization", [img, f(8), f(8)], {"num_groups": 4}, (1, 2), 1, False),
              ("MeanVarianceNormalization", [img], {}, (), 1, False),
              ("GridSample", [img, rs.uniform(-1.2, 1.2, (2, 5, 7, 2)).astype(np.float32)],
               {"mode": "bilinear", "padding_mode": "reflection"}, (), 1, False),
              ("AffineGrid", [f(2, 2, 3), np.array([2, 8, 6, 10], I64)], {"align_corners": 1},
               (1,), 1, False),
              ("RoiAlign", [img, np.array([[1.0, 1.0, 8.0, 5.0], [0.0, 2.0, 9.5, 5.5]],
                                          np.float32), np.array([0, 1], I64)],
               {"output_height": 3, "output_width": 2, "sampling_ratio": 2, "mode": "max"}, (),
               1, False),
              ("CenterCropPad", [img, np.array([5, 12], I64)], {"axes": [2, 3]}, (1,), 1, True),
              ("Col2Im", [f(2, 18, 20), np.array([8, 10], I64), np.array([3, 3], I64)],
               {"strides": [2, 2], "pads": [1, 1, 1, 1]}, (1, 2), 1, False),
              ("AveragePool", [img], {"kernel_shape": [3, 2], "dilations": [2, 2],
                                      "pads": [1, 1, 1, 1]}, (), 1, False),
              ("QuantizeLinear", [x, np.array([0.05, 0.02] * 4, np.float32),
                                  ints(-5, 5, (8,), np.int8)], {"axis": 0}, (1, 2), 1, True),
              ("DequantizeLinear", [a8, np.float32(0.05), np.uint8(128)], {}, (1, 2), 1, True),
              ("DynamicQuantizeLinear", [x], {}, (), 3, True),
              ("MatMulInteger", [a8, b8, np.uint8(113), np.int8(-7)], {}, (), 1, True),
              ("QLinearMatMul", [a8, np.float32(0.02), np.uint8(120), ints(0, 255, (64, 24),
                                                                           np.uint8),
                                 np.float32(0.05), np.uint8(131), np.float32(0.4), np.uint8(7)],
               {}, (1, 2, 4, 5, 6, 7), 1, True),
              ("QLinearConv", [ints(0, 255, (2, 3, 9, 9), np.uint8), np.float32(0.03),
                               np.uint8(110), ints(-100, 100, (5, 3, 3, 3), np.int8),
                               rs.uniform(0.01, 0.05, 5).astype(np.float32),
                               np.zeros(5, np.int8), np.float32(0.1), np.uint8(128),
                               ints(-1000, 1000, (5,), np.int32)],
               {"pads": [1, 1, 1, 1], "strides": [2, 2]}, (3, 4, 5, 8), 1, True),
              ("NonMaxSuppression", [boxes, rs.uniform(0, 1, (2, 3, 40)).astype(np.float32),
                                     np.array([6], I64), np.float32(0.4), np.float32(0.2)], {},
               (2, 3, 4), 1, True),
              ("NonZero", [x > 1], {}, (), 1, True),
              ("Compress", [x, (y[0] > 0)], {"axis": 1}, (), 1, True),
              ("Unique", [ints(0, 9, (40,), I64)], {"sorted": 0}, (), 4, True),
              ("NegativeLogLikelihoodLoss", [np.log(rs.dirichlet(np.ones(5), 8)).astype(np.float32),
                                             ints(0, 5, (8,), I64), np.abs(f(5)) + 0.5],
               {"ignore_index": 2}, (2,), 1, False),
              ("SoftmaxCrossEntropyLoss", [x, ints(0, 16, (8,), I64)], {"reduction": "none"},
               (), 2, False),
              ("DFT", [f(4, 32, 1)], {"axis": 1, "onesided": 1}, (), 1, False),
              ("STFT", [f(2, 256), np.array(16, I64), np.hanning(64).astype(np.float32)],
               {"onesided": 1}, (1, 2), 1, False),
              ("LSTM", [f(6, 3, 5), f(2, 28, 5, scale=0.4), f(2, 28, 7, scale=0.4), f(2, 56)],
               {"direction": "bidirectional", "hidden_size": 7}, (1, 2, 3), 3, False),
              ("GRU", [f(6, 3, 5), f(1, 21, 5, scale=0.4), f(1, 21, 7, scale=0.4), f(1, 42),
                       np.array([6, 3, 1], np.int32)],
               {"linear_before_reset": 1, "hidden_size": 7}, (1, 2, 3), 2, False),
              ("FastGelu", [x, f(16)], {}, (1,), 1, False),
              ("BiasGelu", [x, f(16)], {}, (1,), 1, False),
              ("QuickGelu", [x], {"alpha": 1.702}, (), 1, False),
              ("SkipLayerNormalization", [f(2, 8, 16), f(2, 8, 16), f(16), f(16), f(16)],
               {"epsilon": 1e-12}, (2, 3, 4), 4, False),
              ("EmbedLayerNormalization", [ints(0, 30, (2, 8), I64), ints(0, 2, (2, 8), I64),
                                           f(30, 16), f(8, 16), f(2, 16), f(16), f(16),
                                           np.array([[1] * 8, [1] * 5 + [0] * 3], I64)],
               {}, (2, 3, 4, 5, 6), 3, False),
              ("FusedMatMul", [f(3, 4, 8), f(3, 5, 8)], {"transB": 1, "alpha": 0.5}, (), 1,
               False),
              ("Attention", [f(2, 8, 16), f(16, 48, scale=0.3), f(48),
                             np.array([8, 5], np.int32)], {"num_heads": 4, "unidirectional": 1},
               (1, 2), 1, False)]
    return cases


_CONTRIB = frozenset({"FastGelu", "BiasGelu", "QuickGelu", "SkipLayerNormalization",
                      "EmbedLayerNormalization", "FusedMatMul", "Attention"})


def _sweep_compare(op, got: dict, want: dict, exact: bool) -> float:
    """Max |card - CPU| of one case's outputs (raises on a mismatch)."""
    err = 0.0
    for k in want:
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{op} {k}: the card gives {g.dtype}{g.shape}, the CPU "
                                 f"{w.dtype}{w.shape}")
        if exact or w.dtype.kind in "biu":
            if not np.array_equal(g, w, equal_nan=w.dtype.kind == "f"):
                raise AssertionError(f"{op} {k}: the card is not bitwise the CPU")
            continue
        e = float(np.abs(g.astype(np.float64) - w).max()) if w.size else 0.0
        scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
        if not e <= SWEEP_TOL * scale:
            raise AssertionError(f"{op} {k}: max |card - CPU| {e:.3e} over the limit "
                                 f"{SWEEP_TOL} x {scale:.3g}")
        err = max(err, e / scale)
    return err


def _sweep_random(device, card: str) -> set:
    """The random ops on the card: each law within 4 sigma, the same seed
    twice bitwise."""
    n = 1 << 20
    covered = set()

    def run(op, inputs, **attrs):
        data, feeds = _one_node(op, inputs, attrs, 1, ())
        conv = convert_graph(data)
        a, b = (conv.run(feeds, device)["out0"] for _ in range(2))
        if a.device != device or not torch.equal(a, b):
            raise AssertionError(f"{op}: the same seed twice is not bitwise equal on the card")
        covered.add(op)
        return a.double()

    def near(tag, got, want, sigma, count):
        z = abs(got - want) / (sigma / math.sqrt(count))
        log(f"[opset] (c) {tag}: {got:.5f} against {want:.5f}, {z:.2f} sigma (limit 4)")
        if z > 4:
            raise AssertionError(f"{tag} is {z:.2f} sigma from its law")

    a = run("RandomNormal", [], shape=[n], mean=3.0, scale=2.0, seed=1.0)
    near("RandomNormal mean", float(a.mean()), 3.0, 2.0, n)
    near("RandomNormal variance", float(a.var()), 4.0, 4.0 * math.sqrt(2), n)
    u = run("RandomUniform", [], shape=[n], low=-1.0, high=5.0, seed=2.0)
    near("RandomUniform mean", float(u.mean()), 2.0, 6.0 / math.sqrt(12), n)
    if not (float(u.min()) >= -1.0 and float(u.max()) < 5.0):
        raise AssertionError("RandomUniform left [low, high)")
    zeros = np.zeros((1024, 1024), np.float32)
    near("RandomNormalLike mean", float(run("RandomNormalLike", [zeros], seed=3.0).mean()),
         0.0, 1.0, n)
    near("RandomUniformLike mean", float(run("RandomUniformLike", [zeros], seed=4.0).mean()),
         0.5, 1 / math.sqrt(12), n)
    bern = run("Bernoulli", [np.full((n,), 0.3, np.float32)], seed=5.0)
    near("Bernoulli mean", float(bern.mean()), 0.3, math.sqrt(0.21), n)
    probs = np.array([0.2, 0.5, 0.3])
    m = run("Multinomial", [np.log(np.tile(probs, (4, 1))).astype(np.float32)],
            sample_size=1 << 16, seed=6.0)
    freq = torch.bincount(m.long().reshape(-1), minlength=3).double().cpu().numpy() / m.numel()
    for c, (fc, p) in enumerate(zip(freq, probs)):
        near(f"Multinomial class {c} frequency", float(fc), p, math.sqrt(p * (1 - p)), m.numel())
    return covered


def _sweep_control_flow(device, card: str) -> dict:
    """If on a condition computed on the card, a Loop that exits early on a
    device condition with a scan output, a bidirectional Scan, and an LSTM
    + GRU stack at hidden 512, T 128, batch 32: the card against the CPU."""
    P = onnx_proto
    rs = np.random.default_rng(1)

    def vi(name, dtype=P.FLOAT, dims=()):
        return P.ValueInfoProto(name=name, elem_type=dtype, dims=list(dims))

    def model(nodes, inputs, outputs, inits=()):
        g = P.GraphProto(name="g", node=nodes, input=inputs, output=[vi(o) for o in outputs],
                         initializer=[P.numpy_to_tensor(np.asarray(v), k) for k, v in inits])
        return P.ModelProto(graph=g).encode()

    def tensor(v, k):
        return P.numpy_to_tensor(np.asarray(v), k)

    then_b = P.GraphProto(name="then", node=[_ms_node("Mul", ["x", "two"], ["yt"])],
                          initializer=[tensor(np.float32(2.0), "two")], output=[vi("yt")])
    else_b = P.GraphProto(name="else", node=[_ms_node("Concat", ["x", "x"], ["ye"], axis=0)],
                          output=[vi("ye")])
    if_model = model([_ms_node("ReduceMean", ["x"], ["m"], keepdims=0),
                      _ms_node("Greater", ["m", "zero"], ["c"]),
                      _ms_node("If", ["c"], ["y"], then_branch=then_b, else_branch=else_b)],
                     [vi("x", dims=[64])], ["y"], [("zero", np.float32(0.0))])
    body = P.GraphProto(
        name="body",
        node=[_ms_node("Cast", ["i"], ["i_f"], to=P.FLOAT),
              _ms_node("Mul", ["i_f", "w"], ["step"]),
              _ms_node("Add", ["s_in", "step"], ["s_out"]),
              _ms_node("ReduceSum", ["s_out"], ["tot"], keepdims=0),
              _ms_node("Less", ["tot", "limit"], ["cond_out"]),
              _ms_node("Identity", ["s_out"], ["y_t"])],
        input=[vi("i"), vi("cond_in"), vi("s_in")],
        output=[vi("cond_out"), vi("s_out"), vi("y_t")],
        initializer=[tensor(np.abs(rs.standard_normal(32)).astype(np.float32), "w"),
                     tensor(np.float32(400.0), "limit")])
    loop_model = model([_ms_node("Loop", ["M", "", "s0"], ["s", "ys"], body=body)],
                       [vi("M", P.INT64), vi("s0", dims=[32])], ["s", "ys"])
    scan_body = P.GraphProto(
        name="scan_body",
        node=[_ms_node("Add", ["h_in", "a_t"], ["h1"]), _ms_node("Mul", ["b_t", "k"], ["bk"]),
              _ms_node("Add", ["h1", "bk"], ["h_out"]), _ms_node("Tanh", ["h_out"], ["o_t"])],
        input=[vi("h_in"), vi("a_t"), vi("b_t")], output=[vi("h_out"), vi("o_t")],
        initializer=[tensor(np.float32(0.5), "k")])
    scan_model = model([_ms_node("Scan", ["h0", "xa", "xb"], ["h", "os"], body=scan_body,
                                 num_scan_inputs=2, scan_input_directions=[0, 1],
                                 scan_input_axes=[0, 1], scan_output_directions=[1],
                                 scan_output_axes=[1])],
                       [vi("h0", dims=[16]), vi("xa", dims=[24, 16]), vi("xb", dims=[16, 24])],
                       ["h", "os"])
    H, T, B = RNN_H, RNN_T, RNN_B
    s = 1 / math.sqrt(H)

    def w(*shape):
        return (rs.standard_normal(shape) * s).astype(np.float32)

    rnn_inits = [("lw", w(2, 4 * H, H)), ("lr", w(2, 4 * H, H)), ("lb", w(2, 8 * H)),
                 ("gw", w(1, 3 * H, 2 * H)), ("gr", w(1, 3 * H, H)), ("gb", w(1, 6 * H)),
                 ("perm_shape", np.array([T, B, 2 * H], np.int64))]
    rnn_model = model(
        [_ms_node("LSTM", ["x", "lw", "lr", "lb"], ["ly", "lh", "lc"], hidden_size=H,
                  direction="bidirectional"),
         _ms_node("Transpose", ["ly"], ["lyt"], perm=[0, 2, 1, 3]),
         _ms_node("Reshape", ["lyt", "perm_shape"], ["gx"]),
         _ms_node("GRU", ["gx", "gw", "gr", "gb"], ["gy", "gh"], hidden_size=H,
                  linear_before_reset=1)],
        [vi("x", dims=[T, B, H])], ["lh", "lc", "gy", "gh"], rnn_inits)
    graphs = [("If (condition on the card, then-branch)", if_model,
               {"x": np.abs(rs.standard_normal(64)).astype(np.float32)}),
              ("If (else-branch, another shape)", if_model,
               {"x": -np.abs(rs.standard_normal(64)).astype(np.float32)}),
              ("Loop (early exit on a device condition, scan output)", loop_model,
               {"M": np.int64(np.iinfo(np.int64).max), "s0": np.zeros(32, np.float32)}),
              ("Scan (two inputs, forward and backward)", scan_model,
               {"h0": np.zeros(16, np.float32), "xa": rs.standard_normal((24, 16), np.float32),
                "xb": rs.standard_normal((16, 24), np.float32)}),
              (f"LSTM (bidirectional) + GRU at hidden {H}, T {T}, batch {B}", rnn_model,
               {"x": rs.standard_normal((T, B, H), np.float32)})]
    out = {}
    for tag, data, feeds in graphs:
        conv = convert_graph(data)
        with torch.inference_mode():
            got = {k: v.cpu().numpy() for k, v in conv.run(feeds, device).items()}
            want = {k: v.numpy() for k, v in conv.run(feeds, "cpu").items()}
            err = _sweep_compare(tag, got, want, exact=False)
            dev_feeds = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in feeds.items()}
            ms = cuda_ms(lambda: conv.run(dev_feeds, device), warmup=1, iters=3)
        log(f"[opset] (c) {tag}: outputs {[tuple(v.shape) for v in got.values()]}, max |card - "
            f"CPU| {err:.3e} of max(1, |CPU|) (limit {SWEEP_TOL}); {ms:.3f} ms on the card "
            f"(CUDA events) | {card}")
        out[tag] = {"err": err, "ms": ms}
    return out


def _onnx_op_sweep(device, card: str) -> dict:
    """Main path 10 (c): every op type this slice ported, once on the card
    against the port on the CPU on the same inputs."""
    from synapseml_torch.onnx.convert import OP_REGISTRY

    t0 = time.perf_counter()
    covered, worst, n_exact = set(), 0.0, 0
    for op, inputs, attrs, init, n_out, exact in _sweep_cases():
        data, feeds = _one_node(op, inputs, attrs, n_out, init,
                                "com.microsoft" if op in _CONTRIB else "")
        conv = convert_graph(data)
        with torch.inference_mode():
            got = conv.run(feeds, device)
            if any(v.device != device for v in got.values()):
                raise AssertionError(f"{op}: an output left the card")
            got = {k: v.cpu().numpy() for k, v in got.items()}
            want = {k: v.numpy() for k, v in conv.run(feeds, "cpu").items()}
        worst = max(worst, _sweep_compare(op, got, want, exact))
        n_exact += exact
        covered.add(op)
    covered |= _sweep_random(device, card)
    flow = _sweep_control_flow(device, card)
    covered |= {"If", "Loop", "Scan", "LSTM", "GRU"}
    missing = sorted(ONNX_ADDED_OPS - covered)
    if missing or not ONNX_ADDED_OPS - {"If", "Loop", "Scan"} <= set(OP_REGISTRY):
        raise AssertionError(f"the sweep left out {missing}")
    secs = time.perf_counter() - t0
    log(f"[opset] (c) {len(covered & ONNX_ADDED_OPS)} of the {len(ONNX_ADDED_OPS)} op types this "
        f"slice ported ran on the card: {n_exact} single-op cases bitwise the CPU, the floating "
        f"ones within {worst:.3e} of max(1, |CPU|) (limit {SWEEP_TOL}), the random ones by law "
        f"and repeat; {secs:.1f} s | {card}")
    return {"seconds": secs, "worst": worst, "control_flow": flow}


def phase_onnx_opset(device, card: str) -> dict:
    """Main path 10: ONNXModel over the reference's whole ONNX opset: (a) an
    ORT-fused BERT-base, (b) a GPT-2-width decoder exported by torch, (c)
    every op type of the slice against the CPU; none of the port's kernels
    launched."""
    t0 = time.perf_counter()
    _zero_port_kernel_counts()
    fused = _onnx_fused_bert(device, card)
    log(f"[opset] (a) done at {time.perf_counter() - t0:.1f} s")
    gpt = _onnx_gpt_export(device, card)
    log(f"[opset] (b) done at {time.perf_counter() - t0:.1f} s")
    sweep = _onnx_op_sweep(device, card)
    counts = _port_kernel_counts()
    secs = time.perf_counter() - t0
    log(f"[opset] main path 10 launched the port's kernels {counts} (want none); {secs:.1f} s "
        f"of the script's clock (budget 90 s)")
    if any(counts.values()):
        raise AssertionError(f"main path 10 launched a kernel of the port's: {counts}")
    return {"fused": fused, "gpt": gpt, "sweep": sweep, "seconds": secs}


# ---------------- main path 11: the multi-GPU plane at one card ----------------

# (a) path 3's flash fit with checkpoints every 16 of its 48 steps, the last
# two kept, and a second fit resumed from step 32
MG_EVERY, MG_KEEP, MG_RESUME_AT = 16, 2, 32
# (c) long context at BERT-base's heads: B = 1, T = 32768, the last 1000 keys
# padded, bf16
LC_B, LC_T, LC_H, LC_D, LC_PAD = 1, 32768, 12, 64, 1000


def _state_leaves(state) -> dict:
    """A train state's params and moments by name (host tensors)."""
    out = {f"params/{k}": v.detach().cpu() for k, v in state.params.items()}
    for kind in ("mu", "nu"):
        for j, t in enumerate(getattr(state.opt_state, kind)):
            out[f"{kind}/{j}"] = t.detach().cpu()
    return out


def _differing(a: dict, b: dict) -> list[str]:
    return [k for k in a if not torch.equal(a[k], b[k])]


def _mg_fit(df, device, tag: str, checkpointer=None, resume_from=None, mesh=None,
            rules=None) -> tuple:
    """Path 3's flash fit as the stage plans it (``_fit_plan``): its
    ``fit_arrays`` call, or ``fit_source`` over the same MemorySource when
    resuming; with ``mesh`` the stage's trainer config gains ``rules`` and
    ``zero_shard``. Returns (state, host seconds, plan's cfg and tokenizer)."""
    from synapseml_torch.data.source import MemorySource

    trainer, data, kw, cfg, tok = _stage(device, "flash")._fit_plan(df)
    if mesh is not None:
        trainer = trainer_mod.Trainer(
            trainer.module, dataclasses.replace(trainer.cfg, partition_rules=rules,
                                                zero_shard=True),
            device=device, mesh=mesh)
    t0 = time.perf_counter()
    if resume_from is not None:
        n = next(iter(data.values())).shape[0]
        state = trainer_mod.fit_source(trainer, MemorySource(data), resume_from=resume_from,
                                       drop_remainder=n >= kw["batch_size"], **kw)
    else:
        state = trainer_mod.fit_arrays(trainer, data, checkpointer=checkpointer,
                                       checkpoint_every=MG_EVERY if checkpointer else 0, **kw)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    trainer.release_graphs()
    log(f"[mesh] {tag}: to step {state.step} in {fit_s:.2f} s on the host clock")
    return state, fit_s, cfg, tok


def _mg_checkpoints(df, device, card: str, tmp: str) -> dict:
    """(a): the fit with an AsyncCheckpointer, a fit resumed from step 32
    bitwise it, a torn newest step demoted; (b)'s no-mesh reference."""
    from synapseml_torch import parallel as par

    path = os.path.join(tmp, "ck")
    ck = par.AsyncCheckpointer(path, keep=MG_KEEP)
    save_s = []
    inner_save = ck.save

    def timed_save(tree, step):
        t0 = time.perf_counter()
        fut = inner_save(tree, step)
        save_s.append(time.perf_counter() - t0)
        return fut

    ck.save = timed_save
    with_ck, with_s, cfg, tok = _mg_fit(df, device, "fit with the checkpointer", checkpointer=ck)
    ck.wait()
    write_bytes, write_s = ck.last_write_bytes, ck.last_write_s
    ck.close()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(path) if n.startswith("step_"))
    log(f"[mesh] checkpoints kept {steps} (every {MG_EVERY} steps, keep {MG_KEEP}); a checkpoint "
        f"{write_bytes / 1e9:.3f} GB (params and Adam's m and v in f32, the loader cursor), "
        f"written in {write_s * 1e3:.1f} ms on the writer thread ({write_bytes / write_s / 1e9:.2f} "
        f"GB/s: the copy to pinned host memory, npz, digests); save() returned in "
        f"{[round(t * 1e3, 1) for t in save_s]} ms (the device copy enqueued, the wait for the "
        f"previous write included) | {card}")
    if steps != [2 * MG_EVERY, 3 * MG_EVERY]:
        raise AssertionError(f"checkpoint steps kept {steps}, want [32, 48]")
    resume_dir = os.path.join(tmp, "resume")
    shutil.copytree(os.path.join(path, f"step_{MG_RESUME_AT:010d}"),
                    os.path.join(resume_dir, f"step_{MG_RESUME_AT:010d}"))
    resumed, resumed_s, _, _ = _mg_fit(df, device, f"fit resumed from step {MG_RESUME_AT}",
                                       resume_from=resume_dir)
    ref, ref_s, _, _ = _mg_fit(df, device, "fit without the checkpointer")
    a, b, r = _state_leaves(with_ck), _state_leaves(resumed), _state_leaves(ref)
    off_resume, off_ck = _differing(a, b), _differing(a, r)
    log(f"[mesh] resumed fit against the uninterrupted one: {len(a) - len(off_resume)} of "
        f"{len(a)} leaves (params, m, v) bitwise; differing: {off_resume[:8] or 'none'}; the "
        f"checkpointed fit against the fit without: differing {off_ck[:8] or 'none'}")
    if off_resume or off_ck or resumed.step != with_ck.step:
        raise AssertionError(f"resume not bitwise ({off_resume[:8]}) or the checkpointer "
                             f"changed the fit ({off_ck[:8]})")
    newest = os.path.join(path, f"step_{3 * MG_EVERY:010d}", "state.npz")
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 2)
    demoted = par.latest_verified_step(path)
    restored = int(np.asarray(par.restore_checkpoint(path)["step"]))
    log(f"[mesh] the newest payload truncated: latest verified step {demoted}, restore gives "
        f"step {restored} (want {2 * MG_EVERY})")
    if demoted != 2 * MG_EVERY or restored != 2 * MG_EVERY:
        raise AssertionError("a torn newest checkpoint was not demoted")
    per_step = (with_s / FT_STEPS * 1e3, ref_s / FT_STEPS * 1e3)
    log(f"[mesh] host ms a step over the fit (tokenization, init, warm-up and capture "
        f"included): {per_step[0]:.2f} with the checkpointer, {per_step[1]:.2f} without "
        f"({3} saves of {write_bytes / 1e9:.3f} GB overlapped with the steps) | {card}")
    return {"ref": r, "ref_state": ref, "cfg": cfg, "tok": tok, "bytes": write_bytes,
            "write_s": write_s, "step_ms": per_step}


def _mg_mesh(df, score_df, device, card: str, ref: dict, cfg, tok) -> None:
    """(b): the fit on a data=1 x fsdp=1 mesh with the transformer rule
    table and ZeRO, and DeepTextModel scoring with mesh_config, each
    bitwise its no-mesh counterpart."""
    from synapseml_torch import parallel as par

    shape = par.MeshConfig(data=1, fsdp=1)
    mesh = par.create_mesh(shape)
    log(f"[mesh] {mesh} over an NCCL group of {torch.distributed.get_world_size()} process, "
        f"device mesh {mesh.device_mesh}")
    state, _, _, _ = _mg_fit(df, device, "mesh fit (rules, zero_shard)", mesh=mesh,
                             rules=par.default_transformer_rules(shape))
    got = _state_leaves(state)
    off = _differing(ref, got)
    log(f"[mesh] mesh fit against the no-mesh fit: {len(ref) - len(off)} of {len(ref)} leaves "
        f"bitwise; differing {off[:8] or 'none'}")
    if off:
        raise AssertionError(f"the mesh fit differs from the no-mesh fit on {off[:8]}")
    params = {k[len("params/"):]: v.numpy() for k, v in got.items() if k.startswith("params/")}
    model = DeepTextModel(model_params=params, arch_config=cfg, tokenizer_config=tok.to_config(),
                          num_classes=2, max_token_len=FT_LEN, batch_size=FT_BATCH,
                          attn_impl="flash", device=str(device))
    plain = np.stack(list(model.transform(score_df).collect_column("scores")))
    sharded = np.stack(list(model.copy({"mesh_config": shape}).transform(score_df)
                            .collect_column("scores")))
    same = np.array_equal(plain, sharded)
    log(f"[mesh] DeepTextModel scoring {len(plain)} rows with mesh_config: bitwise the scoring "
        f"without it: {same}")
    if not same or not np.isfinite(plain).all():
        raise AssertionError("sharded scoring differs from plain scoring")


def _lc_inputs(device, seed: int):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, dout = (torch.randn((LC_B, LC_T, LC_H, LC_D), generator=g, device=device)
                     .to(torch.bfloat16) for _ in range(4))
    mask = torch.ones((LC_B, LC_T), dtype=torch.int32, device=device)
    mask[:, LC_T - LC_PAD:] = 0
    return q, k, v, dout, mask


def _lc_run(fn, q, k, v, dout):
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(qs, ks, vs)
    out.backward(dout)
    return out.detach(), [x.grad for x in (qs, ks, vs)]


def _mg_long_context(device, card: str) -> None:
    """(c): Ulysses (its flash local step) and ring attention on a seq axis
    of size 1 at T = 32768, forward and backward, against each other and
    the flash kernel called directly."""
    from synapseml_torch import parallel as par
    from synapseml_torch.ops import ring_attention_sharded, ulysses_attention_sharded

    mesh = par.create_mesh(par.MeshConfig(data=1, seq=1))
    flops = 4 * LC_B * LC_H * LC_T * LC_T * LC_D
    bound = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    for causal in (False, True):
        q, k, v, dout, mask = _lc_inputs(device, seed=7 + causal)
        fns = {
            "ulysses": lambda a, b, c: ulysses_attention_sharded(mesh, a, b, c, kv_mask=mask,
                                                                  causal=causal),
            "ring": lambda a, b, c: ring_attention_sharded(mesh, a, b, c, kv_mask=mask,
                                                           causal=causal),
        }
        before = _flash_counts()
        ref_out, ref_grads = _lc_run(lambda a, b, c: att.flash_attention(
            a, b, c, kv_mask=mask, causal=causal), q, k, v, dout)
        # the direct call is the comparison's reference: its launches do not count
        att.flash_attention_fwd.launches, att.flash_attention_bwd.launches = (
            dict(before["fwd"]), dict(before["bwd"]))
        results = {}
        for name, fn in fns.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            results[name] = _lc_run(fn, q, k, v, dout)
            peak = torch.cuda.max_memory_allocated() / 2**30
            fwd_ms = device_ms(lambda: fn(q, k, v), warmup=1, iters=3)
            bwd_ms = device_ms(lambda: _lc_run(fn, q, k, v, dout), warmup=0, iters=3) - fwd_ms
            log(f"[mesh] {name} attention, T = {LC_T}, causal {causal}: forward {fwd_ms:.2f} ms, "
                f"backward {bwd_ms:.2f} ms (CUDA events behind a 5 ms spin: the ring's chunk "
                f"loop may outlast it), peak {peak:.2f} GiB; the flash bound "
                f"(4 H T^2 D = {flops / 1e12:.2f} TFLOP at 989 TFLOP/s) {bound:.2f} ms a "
                f"forward | {card}")
        pairs = (("ulysses", "flash", results["ulysses"], (ref_out, ref_grads)),
                 ("ring", "flash", results["ring"], (ref_out, ref_grads)),
                 ("ring", "ulysses", results["ring"], results["ulysses"]))
        for a_name, b_name, (ao, ag), (bo, bg) in pairs:
            out_err = (ao.float() - bo.float()).abs().max().item()
            grad_err = _bwd_err([g.transpose(1, 2).reshape(-1, LC_T, LC_D) for g in ag],
                                [g.transpose(1, 2).reshape(-1, LC_T, LC_D) for g in bg])
            ok = (out_err <= TOL_OUT[torch.bfloat16] and grad_err <= TOL_BWD[torch.bfloat16]
                  and torch.isfinite(ao).all().item())
            log(f"[mesh] {a_name} against {b_name} (causal {causal}): out max|d| {out_err:.3e} "
                f"(limit {TOL_OUT[torch.bfloat16]}), dq/dk/dv {grad_err:.3e} of each slice's "
                f"max (limit {TOL_BWD[torch.bfloat16]})")
            if not ok:
                raise AssertionError(f"{a_name} disagrees with {b_name} at T = {LC_T}")
        del q, k, v, dout, results, ref_out, ref_grads
        _free_card()


def _mg_gbdt(device, card: str, digest: str | None) -> None:
    """(d): Higgs-1M with mesh_config (rows over a data axis of size 1: the
    int64-out launches, the all-reduce and the conversion) bitwise main path
    2's forest (``digest``; None fits it here); the tree in the int64-out
    mode beside the one-process mode."""
    from synapseml_torch import DataFrame as DF
    from synapseml_torch import parallel as par
    from synapseml_torch.gbdt import LightGBMClassifier, hist

    X, y = higgs_data(HIGGS_N, HIGGS_TEST, HIGGS_F)
    train = DF.from_dict({"features": X[:HIGGS_N], "label": y[:HIGGS_N]})
    est = LightGBMClassifier(histogram_impl="pallas", device=str(device), **HIGGS_PARAMS)
    if digest is None:
        digest = forest_digest(est.fit(train).get_booster())
    est = est.copy({"mesh_config": par.MeshConfig(data=1)})
    t0 = time.perf_counter()
    booster = est.fit(train).get_booster()
    fit_s = time.perf_counter() - t0
    got = forest_digest(booster)
    log(f"[mesh] Higgs-1M with mesh_config (data=1): fit {fit_s:.2f} s, forest digest {got}, "
        f"main path 2's {digest}: bitwise {got == digest}")
    if got != digest:
        raise AssertionError("the data-parallel forest differs from the one-process forest")

    # the kernel against its plain version and timed: these launches are
    # not the main path's, so the counts are put back afterwards
    counted = (hist.fixed_point_histogram.launches, hist.fixed_point_scales.launches)
    mesh = par.create_mesh(par.MeshConfig(data=1))
    rows = hist.RowGroup(mesh.get_group("data"), HIGGS_N)
    depth, nb, nf, n = 6, 256, HIGGS_F, HIGGS_N
    shapes = [(2 ** d, nb, nf) for d in range(depth)] + [(2 ** depth, 1, 1)]
    tot = dict(one=0.0, int=0.0, sum=0.0, one2=0.0, int2=0.0)
    for width, b, f in shapes:
        bins, grad, hess, presence, node = _hist_inputs(n, nf, width, nb, torch.uint8, device,
                                                        seed=width, outside=False)
        kbins = bins if b > 1 else None
        args = (kbins, grad, hess, presence, node, width - 1, width, b)
        # the scale pass over a share of a data-parallel fit's rows (n_total
        # past this process's rows) against its plain version
        for n_total in (2 * n, 4 * n):
            got_s = hist.fixed_point_scales(grad, hess, presence, n_total)
            want_s = hist.fixed_point_scales_plain(grad, hess, presence, n_total)
            if not torch.equal(got_s, want_s):
                raise AssertionError(f"fixed_point_scales(n_total={n_total}) {got_s.tolist()} "
                                     f"differs from its plain version {want_s.tolist()}")
        tree = hist.fixed_point_tree(grad, hess, presence, nf, depth, nb, rows)
        sums = hist.fixed_point_histogram(*args, *tree, int_out=True)
        plain_sums = hist.fixed_point_histogram_plain(*args, scale=tree.scale, int_out=True)
        if not torch.equal(sums, plain_sums):
            raise AssertionError(f"the int64-out mode's sums differ from the plain version's "
                                 f"at width {width}")
        del plain_sums
        want = hist.fixed_point_histogram(*args, *tree)
        same = torch.equal(hist.fixed_point_convert(rows.all_reduce(sums.clone()), tree.scale),
                           want)
        if not same:
            raise AssertionError(f"int64-out mode + all-reduce + conversion differs at width "
                                 f"{width}")
        t = {"one": device_ms(lambda: hist.fixed_point_histogram(*args, *tree)),
             "int": device_ms(lambda: hist.fixed_point_histogram(*args, *tree, int_out=True)),
             "sum": device_ms(lambda: hist.fixed_point_convert(rows.all_reduce(sums),
                                                               tree.scale))}
        t["one2"] = device_ms(lambda: hist.fixed_point_histogram(*args, *tree))
        t["int2"] = device_ms(lambda: hist.fixed_point_histogram(*args, *tree, int_out=True))
        for key in tot:
            tot[key] += t[key]
    hist.fixed_point_histogram.launches, hist.fixed_point_scales.launches = counted
    log(f"[mesh] gbdt_hist one tree at Higgs-1M ({len(shapes)} launches, device time, two "
        f"turns each): one-process mode {tot['one']:.4f} / {tot['one2']:.4f} ms, int64-out mode "
        f"{tot['int']:.4f} / {tot['int2']:.4f} ms, the all-reduce over the data group (NCCL, "
        f"one process) and the conversion {tot['sum']:.4f} ms; at every shape the int64 sums "
        f"bitwise the plain version's (int_out), summed and converted bitwise the "
        f"one-process histogram, and the scale pass with n_total 2N and 4N equal to its "
        f"plain version | {card}")


def phase_multi_gpu(device, card: str, digest: str | None = None) -> dict:
    """Main path 11: the multi-GPU plane on one card, under an NCCL process
    group of one process (made here on a FileStore, destroyed at the end):
    (a) checkpoints and resume, (b) the mesh fit and sharded scoring, (c)
    long context, (d) data-parallel LightGBM against main path 2's forest
    (``digest``; None fits it in (d)). Returns the port's kernel launches
    over the path."""
    import tempfile

    import torch.distributed as dist

    rows = _labelled_texts(FT_ROWS, seed=0)
    df = DataFrame.from_rows(rows, num_partitions=2)
    score_df = DataFrame.from_rows([{"text": t} for t in _texts(N_TEXTS, N_PARTS, seed=1)],
                                   num_partitions=N_PARTS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    _zero_port_kernel_counts()
    try:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, device_id=device)
        with _InitOnce():
            ck = _mg_checkpoints(df, device, card, tmp)
            _mg_mesh(df, score_df, device, card, ck["ref"], ck["cfg"], ck["tok"])
        del ck
        _free_card()
        _mg_long_context(device, card)
        _mg_gbdt(device, card, digest)
        counts = _port_kernel_counts()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = _flash_counts()
    log(f"[mesh] main path 11's launches: flash {launches}, gbdt_hist {counts['gbdt_hist']}, "
        f"its scale pass {counts['gbdt_hist_scale']}")
    if min(sum(launches["fwd"].values()), sum(launches["bwd"].values()),
           counts["gbdt_hist"], counts["gbdt_hist_scale"]) == 0:
        raise AssertionError(f"a kernel of main path 11 was not launched: {launches}, {counts}")
    return {"launches": launches["fwd"], "bwd_launches": launches["bwd"],
            "gbdt_hist": counts["gbdt_hist"], "gbdt_hist_scale": counts["gbdt_hist_scale"]}


# ---------------- main path 12: HTTP model serving ----------------

# (a) serve_pipeline over main path 1's stage (BERT-base, bf16, flash)
SV_REQUESTS, SV_CONTINUOUS, SV_CLIENTS = 512, 128, 16
SV_SWAP_AFTER = 192      # replies before the mid-traffic /admin/load by path
SV_INTERVAL_MS = 10      # micro-batch interval
SV_TUNE_BUCKETS = (8, 32)
SV_TOL, SV_AGREE = 3e-2, 0.99  # main path 1's bf16 limits: max |dprob|, argmax agreement
SV_SERIES = ("synapseml_serving_request_duration_ms", "synapseml_serving_requests_total",
             "synapseml_serving_queue_wait_ms", "synapseml_serving_batch_rows",
             "synapseml_serving_pipeline_swaps_total", "synapseml_compile_cache_misses_total",
             "synapseml_compile_cache_hits_total", "synapseml_compile_trace_ms",
             "synapseml_compile_cache_evictions_total", "synapseml_deploy_warmup_io_ms",
             "synapseml_deploy_warmup_compile_ms", "synapseml_deploy_executables_traced_total",
             "synapseml_stage_duration_ms", "synapseml_stage_events_total")
# (b) serve_llm over the paged engine: Llama-2-7B width, SV_LLM_LAYERS of 32 layers
SV_LLM_LAYERS, SV_LLM_PROMPTS, SV_LLM_STREAMS = 4, 32, 8
SV_LLM_WORDS = (15, 511)   # prompt words: 16-512 tokens with the [CLS]
SV_LLM_NEW = (16, 64)      # max_new_tokens a request
SV_HTTP_TIMEOUT = 120.0    # every client socket's timeout


class ServeTexts(Transformer):
    """Request rows to one row per text: a body is ``{"texts": [...]}``; a
    body without text scores one empty text and is answered with an error."""

    def _transform(self, df):
        def per_part(p):
            ids, texts, bad = [], [], []
            for rid, body in zip(p["id"], p["body"]):
                got = body.get("texts") if isinstance(body, dict) else None
                ok = isinstance(got, list) and bool(got)
                for t in (got if ok else [""]):
                    ids.append(rid)
                    texts.append(str(t))
                    bad.append(not ok)
            return {"id": np.asarray(ids, dtype=object), "text": np.asarray(texts, dtype=object),
                    "bad": np.asarray(bad, dtype=bool)}

        return df.map_partitions(per_part)


class ServeReplies(Transformer):
    """Scored text rows folded back into one reply a request:
    ``{"scores": [[p0, p1], ...], "prediction": [...]}``."""

    def _transform(self, df):
        def per_part(p):
            groups: dict = {}
            for i, rid in enumerate(p["id"]):
                groups.setdefault(rid, []).append(i)
            reply = np.empty(len(groups), dtype=object)
            for j, ix in enumerate(groups.values()):
                reply[j] = ({"error": "body needs 'texts', a non-empty list"} if p["bad"][ix[0]]
                            else {"scores": [[float(x) for x in p["scores"][i]] for i in ix],
                                  "prediction": [int(p["prediction"][i]) for i in ix]})
            return {"id": np.asarray(list(groups), dtype=object), "reply": reply}

        return df.map_partitions(per_part)


def _http(base: str, method: str, path: str, body=None, headers=None,
          timeout: float = SV_HTTP_TIMEOUT) -> tuple[int, dict, bytes]:
    """One exchange on its own connection, with a socket timeout."""
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(base)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=timeout)
    try:
        data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
        conn.request(method, path, body=data, headers=dict(headers or {}))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _http_stream(base: str, body: dict, headers=None, on_first=None) -> dict:
    """A streamed request: its NDJSON records, the seconds to its first
    chunk and to its end (perf_counter stamps of the client)."""
    import http.client
    from urllib.parse import urlsplit

    parts = urlsplit(base)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=SV_HTTP_TIMEOUT)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/", body=json.dumps(body).encode(), headers=dict(headers or {}))
        resp = conn.getresponse()
        records, first = [], None
        if resp.status != 200:
            return {"status": resp.status, "records": [json.loads(resp.read() or b"null")],
                    "t0": t0, "first": None, "end": time.perf_counter()}
        while True:
            line = resp.readline()
            if not line:
                break
            if first is None:
                first = time.perf_counter()
                if on_first is not None:
                    on_first()
            records.append(json.loads(line))
        return {"status": resp.status, "records": records, "t0": t0, "first": first,
                "end": time.perf_counter()}
    finally:
        conn.close()


def _run_clients(n_clients: int, jobs: list, fn) -> list:
    """``fn(job)`` for every job, from ``n_clients`` threads taking jobs in
    turn; results in job order. A client thread that raises fails the run."""
    import threading

    out, errors = [None] * len(jobs), []
    nxt = iter(range(len(jobs)))
    lock = threading.Lock()

    def client():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            try:
                out[i] = fn(jobs[i])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"job {i}: {type(e).__name__}: {e}")
                return

    threads = [threading.Thread(target=client, daemon=True) for _ in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving clients failed: {errors[:3]}")
    return out


_SV_WORDS = ("the a film plot acting score music scene story actor director great good "
             "bad awful boring moving long short slow fast funny sad dark bright not very "
             "really quite well badly never always").split()


def _serve_bodies(n: int, seed: int) -> list[dict]:
    """Request bodies of 1-4 texts of 16-300 words each."""
    rs = np.random.default_rng(seed)
    return [{"texts": [" ".join(rs.choice(_SV_WORDS, size=int(rs.integers(16, 301))))
                       for _ in range(int(rs.integers(1, 5)))]} for _ in range(n)]


def _warm_bodies(n: int, seed: int) -> list[dict]:
    """The swap's warmup rows: one text of 127-300 words each, so that every
    rung of the warmup pads to 128 tokens, the length a batch of the mix
    pads to unless all of its texts are shorter. A batch that pads shorter
    misses once a (rows, length) shape: the warmup drives rungs of rows,
    not the length ladder."""
    rs = np.random.default_rng(seed)
    return [{"texts": [" ".join(rs.choice(_SV_WORDS, size=int(rs.integers(127, 301))))]}
            for _ in range(n)]


class _CacheLog:
    """A ``CompiledCache`` capture (``set_capture``) that logs every build
    and every later call of what it built, with its thread and time."""

    def __init__(self):
        import threading

        self.events: list[tuple] = []  # (t, thread, "build" | "call", key, built_on)
        self._ident = threading.get_ident

    def wrap(self, key: tuple, built):
        built_on = self._ident()
        self.events.append((time.perf_counter(), built_on, "build", key, built_on))

        def call(*args, **kwargs):
            self.events.append((time.perf_counter(), self._ident(), "call", key, built_on))
            return built(*args, **kwargs)

        return call


def _post_timed(base: str, body) -> dict:
    t0 = time.perf_counter()
    status, _, data = _http(base, "POST", "/", body)
    return {"status": status, "reply": json.loads(data) if data else None, "t0": t0,
            "end": time.perf_counter()}


def _check_scores(results: list, bodies: list, ref: dict, tag: str) -> tuple[float, float]:
    """Every reply 200 with one score row a text, within main path 1's bf16
    limits of the stage's transform of the same texts."""
    bad = [i for i, r in enumerate(results) if r["status"] != 200 or "scores" not in r["reply"]]
    if bad:
        raise AssertionError(f"[serve] {tag}: {len(bad)} replies not 200 with scores, first "
                             f"{results[bad[0]]}")
    got = np.asarray([s for r in results for s in r["reply"]["scores"]], np.float32)
    want = np.stack([ref[t] for b in bodies for t in b["texts"]])
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"[serve] {tag}: scores of shape {got.shape}, want {want.shape}")
    diff = float(np.abs(got - want).max())
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    log(f"[serve] {tag}: {len(results)} replies, {got.shape[0]} texts: max|dprob| against the "
        f"stage's transform {diff:.3e} (tol {SV_TOL}), argmax agreement {agree:.4f} "
        f"(want >= {SV_AGREE})")
    if not (diff <= SV_TOL and agree >= SV_AGREE):
        raise AssertionError(f"[serve] {tag}: served scores disagree with the transform")
    return diff, agree


def _latency_line(results: list, wall: float, tag: str, card: str) -> dict:
    lat = np.asarray([(r["end"] - r["t0"]) * 1e3 for r in results])
    out = {"requests_s": len(results) / wall, "p50_ms": float(np.percentile(lat, 50)),
           "p99_ms": float(np.percentile(lat, 99)), "max_ms": float(lat.max())}
    log(f"[serve] {tag}: {len(results)} requests in {wall:.3f} s = {out['requests_s']:.1f} "
        f"requests/s; latency p50 {out['p50_ms']:.1f} ms, p99 {out['p99_ms']:.1f} ms, max "
        f"{out['max_ms']:.1f} ms (client clock) | {card}")
    return out


def _check_metrics(base: str) -> None:
    """``/metrics`` parses as Prometheus text 0.0.4 and carries the JAX
    package's series."""
    status, headers, data = _http(base, "GET", "/metrics")
    if status != 200 or not headers.get("Content-Type", "").startswith("text/plain; version=0.0.4"):
        raise AssertionError(f"[serve] /metrics answered {status} {headers}")
    families, samples = {}, 0
    for line in data.decode().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            families[name] = kind
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            base_name = re.sub(r"_(bucket|sum|count)$", "", name.split("{")[0])
            if name.split("{")[0] not in families and base_name not in families:
                raise AssertionError(f"[serve] /metrics sample {name} has no TYPE line")
            samples += 1
    missing = [s for s in SV_SERIES if s not in families]
    log(f"[serve] /metrics: {len(families)} families, {samples} samples, Prometheus text 0.0.4; "
        f"the JAX package's serving, cache, deploy and stage series present: {not missing}")
    if missing or families["synapseml_serving_request_duration_ms"] != "histogram":
        raise AssertionError(f"[serve] /metrics lacks {missing}")


def _check_trace(base: str) -> None:
    """A request's ``serving.request`` span joins the trace of the
    ``traceparent`` it was sent with."""
    from synapseml_torch.core import observability as obs

    trace_id, parent = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    obs.get_tracer().clear()
    status, _, _ = _http(base, "POST", "/", _serve_bodies(1, seed=99)[0],
                         headers={"traceparent": f"00-{trace_id}-{parent}-01"})
    spans = json.loads(_http(base, "GET", "/trace")[2])
    served = [s for s in spans if s["name"] == "serving.request" and s["trace_id"] == trace_id]
    stages = [s["name"] for s in spans if s["name"].startswith("DeepTextModel")]
    log(f"[serve] /trace: {len(spans)} spans; the request's serving.request span under the "
        f"sent traceparent: {len(served)} (parent {served[0]['parent_id'] if served else None}, "
        f"{served[0]['duration_ms'] if served else 0:.2f} ms); stage spans {stages[:2]}")
    if status != 200 or len(served) != 1 or served[0]["parent_id"] != parent:
        raise AssertionError("[serve] /trace: the request's span is not under its traceparent")


def _serve_text(device, card: str, tmp: str) -> dict:
    """(a) serve_pipeline: BERT-base DeepTextModel through the flash kernel
    in bf16 between ServeTexts and ServeReplies, on 127.0.0.1:0."""
    from synapseml_torch.core.serialization import save_stage
    from synapseml_torch.io.serving import serve_pipeline
    from synapseml_torch.registry import ModelRegistry

    cfg = bert_base()
    t0 = time.perf_counter()
    params = text_stage._init_params(cfg, 2, 0)
    tok = HashingTokenizer(vocab_size=cfg.vocab_size)
    model = DeepTextModel(model_params=params, arch_config=cfg, tokenizer_config=tok.to_config(),
                          checkpoint="bert-base", num_classes=2, batch_size=32,
                          max_token_len=128, attn_impl="flash", device=str(device))
    pipeline = PipelineModel(stages=[ServeTexts(), model, ServeReplies()])
    bodies = _serve_bodies(SV_REQUESTS + SV_CONTINUOUS, seed=12)
    texts = sorted({t for b in bodies for t in b["texts"]})
    ref_df = model.transform(DataFrame.from_dict({"text": np.asarray(texts, dtype=object)}))
    ref = dict(zip(texts, np.stack(list(ref_df.collect_column("scores")))))
    save_stage(pipeline, os.path.join(tmp, "v2"))
    warm = _warm_bodies(4, seed=13)
    log(f"[serve] (a) BERT-base weights from seed 0, the stage's transform of the "
        f"{len(texts)} texts of {len(bodies)} requests (the reference) and the pipeline saved "
        f"for the swap in {time.perf_counter() - t0:.1f} s")
    cache = cb.get_compiled_cache()
    cache_log = _CacheLog()
    cache.set_capture(cache_log)
    out = {}
    _zero_flash_counts()
    srv = serve_pipeline(pipeline, batch_interval_ms=SV_INTERVAL_MS, version="v1")
    try:
        old_token = cb.instance_token(model)
        swap = {}
        replied = itertools.count(1)  # next() is atomic: one thread sees each count

        def post(body):
            r = _post_timed(srv.address, body)
            if next(replied) == SV_SWAP_AFTER:
                swap["t0"] = time.perf_counter()
                status, _, data = _http(srv.address, "POST", "/admin/load",
                                        {"path": os.path.join(tmp, "v2"), "version": "v2",
                                         "warmup": warm})
                swap["end"] = time.perf_counter()
                with cache._lock:
                    swap["old_entries"] = sum(k[1] == old_token for k in cache._entries)
                swap["status"], swap["reply"] = status, json.loads(data)
            return r

        t0 = time.perf_counter()
        results = _run_clients(SV_CLIENTS, bodies[:SV_REQUESTS], post)
        wall = time.perf_counter() - t0
        cache.set_capture(None)
        if swap.get("status") != 200:
            raise AssertionError(f"[serve] /admin/load by path failed: {swap}")
        wu = swap["reply"]["warmup"]
        across = [r for r in results if r["t0"] < swap["end"] and r["end"] > swap["t0"]]
        gap = max((r["end"] - r["t0"]) * 1e3 for r in across)
        # the new pipeline's callables: built by the warmup (the load's
        # thread, first), then reached by the serve loop
        new = sorted((e for e in cache_log.events if e[3][0] == "deep_text_model"
                      and e[3][1] != old_token and e[0] >= swap["t0"]), key=lambda e: e[0])
        warm_thread = new[0][4] if new else None
        warmed = {e[3][2] for e in new if e[2] == "build" and e[1] == warm_thread}
        served = [e for e in new if e[1] != warm_thread]
        later = sorted({e[3][2] for e in served if e[2] == "build"})
        log(f"[serve] micro-batch ({SV_INTERVAL_MS} ms), {SV_CLIENTS} clients: /admin/load by "
            f"path after {SV_SWAP_AFTER} replies: {swap['reply']['load_ms']:.1f} ms, version "
            f"{swap['reply']['previous']} -> {swap['reply']['version']}, warmup {wu}, shapes "
            f"(rows, tokens) warmed {sorted(warmed)}; the old pipeline's cache entries after "
            f"the swap: {swap['old_entries']}; the new pipeline's first scoring call after the "
            f"swap: {served[0][2] if served else None} of a shape built by "
            f"{'the warmup' if served and served[0][4] == warm_thread else 'the serve loop'}; "
            f"later misses at shapes the warmup did not drive: {len(later)} {later}; "
            f"{len(across)} requests spanned the swap, the longest {gap:.1f} ms | {card}")
        if swap["old_entries"] or wu["mode"] != "jit" or not warmed or not served \
                or served[0][2] != "call" or served[0][4] != warm_thread \
                or set(later) & warmed:
            raise AssertionError("[serve] the swap left old entries, or the new pipeline missed "
                                 "on its first request or at a warmed shape")
        out["micro"] = _latency_line(results, wall, "micro-batch", card)
        out["micro"]["swap_gap_ms"] = gap
        out["micro"]["max_dprob"], _ = _check_scores(results, bodies[:SV_REQUESTS], ref,
                                                     "micro-batch")
        _check_metrics(srv.address)
        _check_trace(srv.address)
        # a registry publish: the einsum/flash search on the card, no executables
        reg = ModelRegistry(os.path.join(tmp, "store"))
        t0 = time.perf_counter()
        pub = reg.publish("bert", srv.pipeline_holder.pipeline,
                          aot={"rows": warm, "buckets": list(SV_TUNE_BUCKETS)},
                          autotune={"trials": 3})
        tune, aot = pub.manifest["autotune"], pub.manifest["aot"]
        times = tune["timings_ms"]["attn_impl"]
        faster = min(times, key=lambda c: sum(times[c].values()))
        log(f"[serve] registry publish in {time.perf_counter() - t0:.1f} s: autotune of attn_impl "
            f"through the serve-loop warmup, min of 3 host ms a drive by rung: einsum "
            f"{times['einsum']}, flash {times['flash']} (the faster drive: {faster}); winner "
            f"{tune['winners']['attn_impl']} (by rung {tune['per_rung']['attn_impl']}; baseline, "
            f"never pinned on the card: {tune.get('baseline')}); aot mechanism "
            f"{aot['mechanism']}, {len(aot['entries'])} executables recorded | {card}")
        if aot["entries"] or aot["mechanism"] is not None or sorted(times) != ["einsum", "flash"] \
                or tune["winners"]["attn_impl"] != "flash" \
                or tune.get("baseline") != {"attn_impl": "einsum"}:
            raise AssertionError("[serve] the publish recorded executables, skipped a backend "
                                 "or pinned the plain attention")
        status, _, data = _http(srv.address, "POST", "/admin/load",
                                {"registry": reg.root, "model": "bert", "ref": "v1",
                                 "warmup": warm})
        reply = json.loads(data)
        wu = reply.get("warmup", {})
        log(f"[serve] /admin/load by registry: {status}, {reply.get('load_ms')} ms, warmup {wu}")
        if status != 200 or wu.get("mode") != "jit" or not wu.get("executables_traced") \
                or wu.get("rows") != 8 + 16 + 32 + 64 + len(warm):
            raise AssertionError("[serve] the load by registry did not warm up by JIT")
        served = srv.pipeline_holder.pipeline
    finally:
        cache.set_capture(None)
        srv.stop()
    # continuous mode (a reply a request) over the registry-loaded pipeline
    impl = served.get("stages")[1].get("attn_impl")
    before = sum(_flash_counts()["fwd"].values())
    srv = serve_pipeline(served, batch_interval_ms=0, version="v3")
    try:
        t0 = time.perf_counter()
        results = _run_clients(SV_CLIENTS, bodies[SV_REQUESTS:],
                               lambda b: _post_timed(srv.address, b))
        out["continuous"] = _latency_line(results, time.perf_counter() - t0, "continuous", card)
        _check_scores(results, bodies[SV_REQUESTS:], ref,
                      f"continuous, after the registry load (attn_impl {impl})")
    finally:
        srv.stop()
    launched = sum(_flash_counts()["fwd"].values()) - before
    log(f"[serve] continuous traffic after the registry load: attn_impl {impl}, flash forward "
        f"launches {launched}")
    if impl != "flash" or launched == 0:
        raise AssertionError("[serve] the registry-loaded pipeline did not serve through flash")
    return out


def _llm_prompts(n: int, seed: int) -> list[dict]:
    rs = np.random.default_rng(seed)
    return [{"prompt": " ".join(rs.choice(_LLM_WORDS, size=int(rs.integers(*SV_LLM_WORDS) + 1))),
             "max_new_tokens": int(rs.integers(SV_LLM_NEW[0], SV_LLM_NEW[1] + 1)),
             "stream": True} for _ in range(n)]


def _llm_stage(name: str, sd: dict, device, tok):
    from synapseml_torch.hf import HuggingFaceCausalLM

    return HuggingFaceCausalLM(model_name=name, model_params=sd, tokenizer=tok.to_config(),
                               engine="paged", max_new_tokens=SV_LLM_NEW[1],
                               decode_slots=SV_LLM_STREAMS, batch_size=SV_LLM_STREAMS,
                               device=str(device))


def _llm_traffic(base: str, prompts: list, tag: str, card: str) -> dict:
    t0 = time.perf_counter()
    runs = _run_clients(SV_LLM_STREAMS, prompts, lambda b: _http_stream(base, b))
    wall = time.perf_counter() - t0
    bad = [r for r in runs if r["status"] != 200 or not r["records"][-1].get("done")]
    if bad:
        raise AssertionError(f"[serve] {tag}: {len(bad)} streams did not end, first {bad[0]}")
    tokens = sum(r["records"][-1]["n_tokens"] for r in runs)
    ttft = np.asarray([(r["first"] - r["t0"]) * 1e3 for r in runs])
    out = {"tokens_s": tokens / wall, "ttft_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_p99_ms": float(np.percentile(ttft, 99)), "wall_s": wall, "tokens": tokens}
    log(f"[serve] (b) {tag}: {len(runs)} streams, {SV_LLM_STREAMS} at once, {tokens} tokens in "
        f"{wall:.3f} s = {out['tokens_s']:.1f} tokens/s; time to first token p50 "
        f"{out['ttft_p50_ms']:.1f} ms, p99 {out['ttft_p99_ms']:.1f} ms (client clock) | {card}")
    return {"runs": runs, **out}


def _llm_ready(base: str, tag: str, card: str) -> None:
    """Wait until the server's engine is built and warmed (``/admin/stats``
    reports it), so that the traffic's first tokens do not wait for it."""
    t0 = time.perf_counter()
    while json.loads(_http(base, "GET", "/admin/stats")[2]).get("llm") is None:
        if time.perf_counter() - t0 > 300:
            raise AssertionError(f"[serve] (b) {tag}: the engine never came up")
        time.sleep(0.05)
    log(f"[serve] (b) {tag}: engine built and warmed (every prefill and decode rung) in "
        f"{time.perf_counter() - t0:.2f} s | {card}")


def _llm_pages_free(base: str, tag: str) -> None:
    for _ in range(500):
        llm = json.loads(_http(base, "GET", "/admin/stats")[2])["llm"]
        if llm["active"] == llm["waiting"] == llm["blocks_used"] == 0:
            return
        time.sleep(0.02)
    raise AssertionError(f"[serve] {tag}: pages still held: {llm}")


def _serve_llm_path(device, card: str) -> dict:
    """(b) serve_llm over the paged engine at Llama-2-7B width, SV_LLM_LAYERS
    layers, weights from init_llama_params(seed=0): f32 traffic held to the
    stage's transform by the margin rule, the scheduling checks, the drain;
    then the same traffic in bf16 compute for its rates."""
    import socket
    import threading

    from synapseml_torch.core import observability as obs
    from synapseml_torch.hf import causal_lm as tcl
    from synapseml_torch.io.serving import serve_llm
    from synapseml_torch.models.convert_jax import init_llama_params
    from synapseml_torch.models.nets.llama import llama2_7b

    presets = {"llama2-7b-serve-f32": lambda **kw: llama2_7b(n_layers=SV_LLM_LAYERS,
                                                              dtype=torch.float32, **kw),
               "llama2-7b-serve": lambda **kw: llama2_7b(n_layers=SV_LLM_LAYERS, **kw)}
    tcl._ARCHS.update(presets)
    tok = HashingTokenizer(vocab_size=32000)
    out = {}
    try:
        sd = init_llama_params(llama2_7b(n_layers=SV_LLM_LAYERS, dtype=torch.float32), seed=0,
                               device=device)
        stage = _llm_stage("llama2-7b-serve-f32", sd, device, tok)
        prompts = _llm_prompts(SV_LLM_PROMPTS, seed=21)
        t0 = time.perf_counter()
        ref = _completions(stage.transform(DataFrame.from_dict(
            {"prompt": np.asarray([p["prompt"] for p in prompts], dtype=object)})))
        model = stage._model_and_tokenizer()[0]
        ids = [tok.tokenize(p["prompt"]) for p in prompts]
        log(f"[serve] (b) Llama-2-7B width, {SV_LLM_LAYERS} layers, f32: prompts of "
            f"{min(map(len, ids))}-{max(map(len, ids))} tokens, max_new_tokens "
            f"{min(p['max_new_tokens'] for p in prompts)}-{max(p['max_new_tokens'] for p in prompts)}; "
            f"the stage's transform (the reference) in {time.perf_counter() - t0:.1f} s")
        srv = serve_llm(stage, version="f32")
        try:
            _llm_ready(srv.address, "f32", card)
            traffic = _llm_traffic(srv.address, prompts, "f32", card)
            got = [r["records"][-1]["output_ids"] for r in traffic["runs"]]
            chunks_ok = all([c["token"] for c in r["records"][:-1]] == r["records"][-1]["output_ids"]
                            and [c["seq"] for c in r["records"][:-1]]
                            == list(range(len(r["records"]) - 1)) for r in traffic["runs"])
            want = [w[:len(g)] for g, w in zip(got, ref)]
            compared = _margin_rule(got, want, _teacher_margins(model, ids, got),
                                    _teacher_margins(model, ids, want), "served f32 vs transform")
            log(f"[serve] (b) f32 streams equal the transform on {compared} tokens under the "
                f"margin rule; chunk framing (token, seq) consistent: {chunks_ok}")
            if not chunks_ok or any(len(g) > p["max_new_tokens"] for g, p in zip(got, prompts)):
                raise AssertionError("[serve] (b) chunk framing or budgets broken")
            out["f32"] = {k: v for k, v in traffic.items() if k != "runs"}
            # a short request sent after a long one finishes first
            long_req = {"prompt": " ".join(["token"] * 511), "max_new_tokens": 64, "stream": True}
            short_req = {"prompt": " ".join(["page"] * 15), "max_new_tokens": 16, "stream": True}
            started = threading.Event()
            res = {}
            tl = threading.Thread(target=lambda: res.setdefault(
                "long", _http_stream(srv.address, long_req, on_first=started.set)), daemon=True)
            tl.start()
            if not started.wait(60):
                raise AssertionError("[serve] (b) the long request never started")
            res["short"] = _http_stream(srv.address, short_req)
            tl.join(timeout=120)
            log(f"[serve] (b) a 16-token request sent after the first token of a 512-token one: "
                f"short ends at {(res['short']['end'] - res['long']['t0']) * 1e3:.1f} ms, long at "
                f"{(res['long']['end'] - res['long']['t0']) * 1e3:.1f} ms")
            if not res["short"]["end"] < res["long"]["end"]:
                raise AssertionError("[serve] (b) the short request waited out the long one")
            # a deadline too short: 504, finish_reason deadline, pages freed
            status, _, data = _http(srv.address, "POST", "/", {"prompt": long_req["prompt"],
                                                               "max_new_tokens": 64},
                                    headers={"X-Deadline-Ms": "1"})
            rec = json.loads(data)
            _llm_pages_free(srv.address, "deadline")
            log(f"[serve] (b) X-Deadline-Ms 1: {status} {rec}; pages freed")
            if status != 504 or rec.get("finish_reason") != "deadline":
                raise AssertionError("[serve] (b) the deadline did not give a 504")
            # the drain with a dead migrate_to: every stream re-imported locally
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                dead = f"http://127.0.0.1:{s.getsockname()[1]}"
            key = 'synapseml_llm_migrations_total{outcome="error",reason="drain"}'
            before = obs.get_registry().snapshot().get(key, 0)
            drain_prompts = [{**p, "max_new_tokens": SV_LLM_NEW[1]}
                             for p in prompts[:SV_LLM_STREAMS]]
            firsts = threading.Barrier(SV_LLM_STREAMS + 1)

            def stream(i):
                return _http_stream(srv.address, drain_prompts[i],
                                    headers={"X-Request-Key": f"drain-{i}"},
                                    on_first=lambda: firsts.wait(60))

            runner = threading.Thread(target=lambda: res.setdefault(
                "drain", _run_clients(SV_LLM_STREAMS, list(range(SV_LLM_STREAMS)), stream)),
                daemon=True)
            runner.start()
            firsts.wait(60)
            status, _, data = _http(srv.address, "POST", "/admin/drain",
                                    {"migrate_to": dead, "timeout_s": 60})
            runner.join(timeout=120)
            runs = res.get("drain") or []
            errors = obs.get_registry().snapshot().get(key, 0) - before
            got = [r["records"][-1].get("output_ids") for r in runs]
            ended = len(runs) == SV_LLM_STREAMS and all(r["records"][-1].get("done") for r in runs)
            log(f"[serve] (b) /admin/drain with a dead migrate_to: {status} {json.loads(data)}; "
                f"live streams whose handoff failed and were re-imported locally {errors:.0f} "
                f"of {SV_LLM_STREAMS}; every stream ended: {ended}")
            if not ended or not 1 <= errors <= SV_LLM_STREAMS:
                raise AssertionError("[serve] (b) the drain lost a stream or tried no handoff")
            ids8 = ids[:SV_LLM_STREAMS]
            want = [w[:len(g)] for g, w in zip(got, ref)]
            compared = _margin_rule(got, want, _teacher_margins(model, ids8, got),
                                    _teacher_margins(model, ids8, want), "drained f32 vs transform")
            _llm_pages_free(srv.address, "drain")
            out["drain"] = {"reimported": errors, "compared": compared}
        finally:
            srv.stop()
        stage.release()
        del stage, model
        _free_card()
        # bf16 compute: the rates
        stage = _llm_stage("llama2-7b-serve", sd, device, tok)
        srv = serve_llm(stage, version="bf16")
        try:
            _llm_ready(srv.address, "bf16", card)
            out["bf16"] = {k: v for k, v in _llm_traffic(srv.address, prompts, "bf16",
                                                          card).items() if k != "runs"}
        finally:
            srv.stop()
        stage.release()
        del stage, sd
    finally:
        for name in presets:
            tcl._ARCHS.pop(name, None)
        _free_card()
    return out


def phase_serving(device, card: str) -> dict:
    """Main path 12: (a) serve_pipeline with BERT-base through the flash
    kernel, its hot swaps and endpoints; (b) serve_llm over the paged
    engine. Returns the flash launches of (a) and (b) and the records."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        t0 = time.perf_counter()
        text = _serve_text(device, card, tmp)
        log(f"[serve] (a) done in {time.perf_counter() - t0:.1f} s")
        _free_card()
        counts = _flash_counts()
        t0 = time.perf_counter()
        llm = _serve_llm_path(device, card)
        log(f"[serve] (b) done in {time.perf_counter() - t0:.1f} s")
        after = _flash_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[serve] main path 12's flash launches: {after} ((a) alone {counts})")
    if sum(counts["fwd"].values()) == 0:
        raise AssertionError("main path 12 launched no flash kernel")
    return {"launches": after["fwd"], "bwd_launches": after["bwd"], "text": text, "llm": llm}


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
    phase_llm(device, card)
    done("main path 6, Llama-2-7B batch inference")
    pretrained = phase_pretrained(device, card)
    done("main path 7, pretrained checkpoint directories")
    moe = phase_moe(device, card)
    done("main path 8, Mixtral-8x7B and MoE training")
    surface = phase_gbdt_surface(device, card)
    done("main path 9, LightGBM's surface")
    phase_onnx_opset(device, card)
    done("main path 10, ONNX's whole opset")
    mesh = phase_multi_gpu(device, card, gbdt["digest"])
    done("main path 11, the multi-GPU plane at one card")
    serving = phase_serving(device, card)
    done("main path 12, HTTP model serving")
    # the flash kernels' launches on the paths, each counted from 0 just
    # before it ran: scoring (path 1), fine-tuning through flash and both
    # fitted models' scoring (path 3), bert-tiny f32 through flash on the
    # card, the long-T flash steps in bf16 and in f32, and ViT-B/16
    # fine-tuning through flash (path 5), the checkpoint fit and its model's
    # scoring (path 7), the MoE encoder's runs (path 8), the mesh fits and
    # scoring (path 11) and the served requests, swaps and publish (path 12)
    paths = (train, vit, pretrained, moe, mesh, serving,
             {"launches": tiny["fwd"], "bwd_launches": tiny["bwd"]},
             *({"launches": long_t[tag]["launches"]["fwd"],
                "bwd_launches": long_t[tag]["launches"]["bwd"]} for tag in ("flash", "flash f32")))
    launches = {k: v + sum(p["launches"][k] for p in paths)
                for k, v in main_path["launches"].items()}
    launches.update({f"bwd_{k}": sum(p["bwd_launches"][k] for p in paths)
                     for k in ("bf16", "f32")})
    kernels = phase_times(device, card, launches, max_err)
    # the histogram kernel's launches: main paths 2, 9 and 11, each counted from 0
    kernels += phase_gbdt_times(device, card,
                                {"gbdt_hist": gbdt["launches"] + surface["launches"]
                                 + mesh["gbdt_hist"],
                                 "gbdt_hist_scale": gbdt["scale_launches"]
                                 + surface["scale_launches"] + mesh["gbdt_hist_scale"]},
                                hist_err)
    done("times")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
