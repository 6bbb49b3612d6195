"""The multi-GPU plane across cards: one process a card, NCCL, held to one card.

    python3 scripts/mesh_multicard.py                 # from the root of a checkout, N cards
    python3 scripts/mesh_multicard.py --cpu --small   # a rehearsal: 4 CPU processes, gloo

Starts one process a card (``--world``, default every visible card), each
on its card under one NCCL group met on a ``FileStore`` in a temporary
directory, and runs what only exists across cards, each held to the same
work on one card (which every process also runs on its own card):

1. collectives: all-reduce of 1, 64 and 438 MB (BERT-base's f32
   gradients) over the world, ms and bus bandwidth (2 (n-1)/n bytes / s);
2. data-parallel LightGBM: Higgs-1M (``chip_smoke.higgs_data``, 100
   iterations, 31 leaves, 255 bins) over ``data=world`` through the
   histogram kernel's int64-out mode: the forest digest equal to the
   one-card forest's, fit and training seconds beside the one-card fit's;
3. the trainer: BERT-base (chip_smoke's seeded init, bf16 compute) on
   path 3's texts, 8 eager steps at a global batch of 32 x 128 over
   ``data=world`` with the transformer rule table and ZeRO, beside the same
   8 steps on one card: each step's loss within 2e-2, ms a step (the
   mesh's rows split over the cards, gradients summed by NCCL); then, on
   the mesh and on one card, the steps as chunks of 4 through
   ``train_steps_scan`` (a warm-up, a capture with the all-reduce inside
   the CUDA graph, a timed replay): the mesh's losses within 2e-2 of its
   eager steps (bitwise reported), ms a replayed step;
4. long context: ring and Ulysses attention over ``seq=world`` at
   BERT-base's heads, T = 32768, bf16, the last 1000 keys padded, forward
   and backward against the flash kernels on one card (chip_smoke's bf16
   limits), ms and peak memory.

The launcher prints each result with the card's name and power limit and,
with ``--out DIR``, keeps every rank's numbers there as JSON. Exits
non-zero if any check fails on any rank. With ``--cpu`` the processes run gloo on the
CPU (the kernels' plain versions); ``--small`` cuts every size for that.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())  # the checkout's chip_smoke and synapseml_torch

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

LOSS_TOL = 2e-2  # bf16 compute, gradients summed in another order than one card's


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, iters: int = 5) -> float:
    """Median ms of ``fn`` on the host clock, the device synchronised."""
    fn()
    _sync(device)
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def phase_collectives(device, world: int, small: bool) -> dict:
    out = {}
    sizes = (1 << 20, 64 << 20) if small else (1 << 20, 64 << 20, 438 << 20)
    for nbytes in sizes:
        x = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
        ms = _timed(lambda: dist.all_reduce(x), device)
        busbw = 2 * (world - 1) / world * nbytes / (ms / 1e3) / 1e9
        out[f"all_reduce_{nbytes >> 20}MB"] = {"ms": ms, "busbw_GBps": busbw}
    return out


def phase_gbdt(device, world: int, small: bool) -> dict:
    import chip_smoke as c
    from synapseml_torch import parallel as par
    from synapseml_torch.gbdt.booster import train_booster

    n = 20_000 if small else c.HIGGS_N
    X, y = c.higgs_data(n, 0, c.HIGGS_F)
    params = dict(c.HIGGS_PARAMS, histogram_impl="pallas", device=str(device))
    if small:
        params["num_iterations"] = 5
    out = {}
    for tag, mesh in (("one card", None), ("mesh", par.create_mesh(par.MeshConfig(data=world)))):
        _sync(device)
        t0 = time.perf_counter()
        b = train_booster(X, y, mesh=mesh, **params)
        _sync(device)
        out[tag] = {"fit_s": time.perf_counter() - t0, "digest": c.forest_digest(b),
                    "binning_ms": b.train_measures["binning_ms"],
                    "training_ms": b.train_measures["training_ms"]}
    out["bitwise"] = out["mesh"]["digest"] == out["one card"]["digest"]
    return out


def phase_trainer(device, world: int, small: bool) -> dict:
    import chip_smoke as c
    from synapseml_torch import DataFrame
    from synapseml_torch import parallel as par
    from synapseml_torch.models import text as text_stage
    from synapseml_torch.models import trainer as tt
    from synapseml_torch.models.nets.bert import bert_tiny

    steps, batch = (4, 8) if small else (8, c.FT_BATCH)
    chunk = steps // 2
    if small:
        c.bert_base = lambda **kw: bert_tiny(**kw)
        text_stage._ARCHS["bert-base"] = c.bert_base
    # rows for the steps and one more chunk: the graphs' timed replay
    df = DataFrame.from_rows(c._labelled_texts(batch * (steps + chunk), seed=0))
    stage = text_stage.DeepTextClassifier(
        checkpoint=c.FT_ARCH, num_classes=2, batch_size=batch, max_token_len=c.FT_LEN,
        max_steps=steps, learning_rate=c.FT_LR, seed=0, attn_impl="flash",
        device=str(device))
    shape = par.MeshConfig(data=world)

    def fresh(on_mesh: bool):
        trainer, data, kw, _, _ = stage._fit_plan(df)
        if on_mesh:
            trainer = tt.Trainer(
                trainer.module,
                dataclasses.replace(trainer.cfg,
                                    partition_rules=par.default_transformer_rules(shape),
                                    zero_shard=True),
                device=device, mesh=par.create_mesh(shape))
        return trainer, trainer.init_state(init_params=kw["init_params"]), data

    out = {}
    with c._InitOnce():
        for tag in ("one card", "mesh"):
            trainer, state, data = fresh(tag == "mesh")
            losses, times = [], []
            for i in range(steps):
                b = {k: v[i * batch:(i + 1) * batch] for k, v in data.items()}
                _sync(device)
                t0 = time.perf_counter()
                state, m = trainer.train_step(state, b)
                losses.append(float(m["loss"]))
                times.append((time.perf_counter() - t0) * 1e3)
            # the same steps as CUDA graphs through train_steps_scan: a
            # warm-up chunk, a capture (on the mesh with the NCCL all-reduce
            # inside) and a replay, which is timed
            trainer, state, data = fresh(tag == "mesh")
            graph_losses = []
            for i in range(3):
                sel = np.arange(i * chunk * batch, (i + 1) * chunk * batch).reshape(chunk, batch)
                stacked = {k: v[sel] for k, v in data.items()}
                _sync(device)
                t0 = time.perf_counter()
                state, m = trainer.train_steps_scan(state, stacked)
                graph_losses += m["loss"].cpu().tolist()
                replay_ms = (time.perf_counter() - t0) * 1e3 / chunk
            trainer.release_graphs()
            out[tag] = {"losses": losses, "step_ms": statistics.median(times[2:] or times),
                        "graph_losses": graph_losses[:steps], "graph_step_ms": replay_ms}
    diff = float(np.max(np.abs(np.array(out["mesh"]["losses"])
                               - np.array(out["one card"]["losses"]))))
    out["max_loss_diff"] = diff
    out["graphs_bitwise_eager"] = out["mesh"]["graph_losses"] == out["mesh"]["losses"]
    out["ok"] = (diff <= LOSS_TOL and bool(np.isfinite(out["mesh"]["losses"]).all())
                 and np.allclose(out["mesh"]["graph_losses"], out["mesh"]["losses"],
                                 atol=LOSS_TOL, rtol=0))
    return out


def phase_long_context(device, world: int, small: bool) -> dict:
    import chip_smoke as c
    from synapseml_torch import parallel as par
    from synapseml_torch.ops import attention as att
    from synapseml_torch.ops import ring_attention_sharded, ulysses_attention_sharded

    T, pad = (512, 40) if small else (c.LC_T, c.LC_PAD)
    H, D = c.LC_H, c.LC_D
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    g = torch.Generator(device=device).manual_seed(7)
    q, k, v, dout = (torch.randn((1, T, H, D), generator=g, device=device).to(dtype)
                     for _ in range(4))
    mask = torch.ones((1, T), dtype=torch.int32, device=device)
    mask[:, T - pad:] = 0
    mesh = par.create_mesh(par.MeshConfig(data=1, seq=world))
    out = {}
    for causal in (False, True):
        ref_out, ref_grads = c._lc_run(lambda a, b, d: att.flash_attention(
            a, b, d, kv_mask=mask, causal=causal), q, k, v, dout)
        for name, fn in (("ulysses", ulysses_attention_sharded), ("ring", ring_attention_sharded)):
            def run(a, b, d, fn=fn):
                return fn(mesh, a, b, d, kv_mask=mask, causal=causal)

            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            got_out, got_grads = c._lc_run(run, q, k, v, dout)
            peak = (torch.cuda.max_memory_allocated(device) / 2**30
                    if device.type == "cuda" else 0.0)
            fwd = _timed(lambda: run(q, k, v), device, iters=3)
            both = _timed(lambda: c._lc_run(run, q, k, v, dout), device, iters=3)
            out_err = (got_out.float() - ref_out.float()).abs().max().item()
            grad_err = c._bwd_err([x.transpose(1, 2).reshape(-1, T, D) for x in got_grads],
                                  [x.transpose(1, 2).reshape(-1, T, D) for x in ref_grads])
            out[f"{name}/causal={causal}"] = {
                "fwd_ms": fwd, "bwd_ms": both - fwd, "peak_gib": peak, "out_err": out_err,
                "grad_err": grad_err,
                "ok": out_err <= c.TOL_OUT[torch.bfloat16] and grad_err <= c.TOL_BWD[torch.bfloat16]}
    return out


def _rank_main(args) -> None:
    rank, world = args.rank, args.world
    if args.cpu:
        torch.set_num_threads(1)
        device = torch.device("cpu")
        backend = "gloo"
    else:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        backend = "nccl"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    store = dist.FileStore(os.path.join(args.store, "store"), world)
    kw = {} if args.cpu else {"device_id": device}
    # a collective left waiting by a failed rank aborts instead of hanging
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300), **kw)
    results = {"rank": rank, "world": world, "device": str(device)}
    try:
        for name, fn in (("collectives", phase_collectives), ("gbdt", phase_gbdt),
                         ("trainer", phase_trainer), ("long context", phase_long_context)):
            t0 = time.perf_counter()
            results[name] = fn(device, world, args.small)
            results[name + " seconds"] = time.perf_counter() - t0
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(args.store, f"rank{rank}.json"), "w") as f:
        json.dump(results, f, indent=1, default=float)


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return " | ".join(sorted(set(smi.stdout.strip().splitlines())))


def _launch(args) -> int:
    world = args.world or (4 if args.cpu else torch.cuda.device_count())
    if not args.cpu and (not torch.cuda.is_available() or world > torch.cuda.device_count()):
        sys.exit(f"mesh_multicard: {world} cards asked, "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
    card = "cpu" if args.cpu else _card()
    if not args.cpu:
        from synapseml_torch.ops import _build

        _build.build()  # once, before the ranks load the kernels
    store = tempfile.mkdtemp(prefix="mesh_multicard_")
    cmd = [sys.executable, os.path.abspath(__file__), "--world", str(world), "--store", store]
    cmd += ["--cpu"] * args.cpu + ["--small"] * args.small
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env) for r in range(world)]
    try:
        # a rank that fails stops the others, which would wait on it
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.perf_counter() - t0 > args.timeout:
                break
            time.sleep(0.5)
        rcs = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        ranks = []
        if all(rc == 0 for rc in rcs):
            for r in range(world):
                with open(os.path.join(store, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                for r in range(world):
                    shutil.copy(os.path.join(store, f"rank{r}.json"), args.out)
        shutil.rmtree(store, ignore_errors=True)
    print(f"[multicard] {world} processes exited {rcs} after "
          f"{time.perf_counter() - t0:.1f} s | {card}", flush=True)
    if not ranks:
        return 1
    r0 = ranks[0]
    for key, v in r0["collectives"].items():
        print(f"[multicard] {key} over {world}: {v['ms']:.3f} ms, bus bandwidth "
              f"{v['busbw_GBps']:.1f} GB/s | {card}")
    g = r0["gbdt"]
    same = all(r["gbdt"]["mesh"]["digest"] == g["one card"]["digest"] for r in ranks)
    print(f"[multicard] LightGBM Higgs-1M over data={world}: every rank's forest bitwise the "
          f"one-card forest: {same}; fit {g['mesh']['fit_s']:.2f} s (binning "
          f"{g['mesh']['binning_ms']:.0f} ms, training {g['mesh']['training_ms']:.0f} ms) against "
          f"one card {g['one card']['fit_s']:.2f} s ({g['one card']['binning_ms']:.0f} ms, "
          f"{g['one card']['training_ms']:.0f} ms) | {card}")
    t = r0["trainer"]
    print(f"[multicard] BERT-base over data={world} (rules, ZeRO): losses "
          f"{np.round(t['mesh']['losses'], 4).tolist()} against one card "
          f"{np.round(t['one card']['losses'], 4).tolist()} (max |d| {t['max_loss_diff']:.2e}, "
          f"limit {LOSS_TOL}); eager step {t['mesh']['step_ms']:.1f} ms against "
          f"{t['one card']['step_ms']:.1f} ms; as CUDA graphs "
          f"{np.round(t['mesh']['graph_losses'], 4).tolist()} (bitwise the eager mesh "
          f"steps: {t['graphs_bitwise_eager']}), a replayed step "
          f"{t['mesh']['graph_step_ms']:.1f} ms against {t['one card']['graph_step_ms']:.1f} "
          f"ms on one card (host clock, synchronised) | {card}")
    for key, v in r0["long context"].items():
        print(f"[multicard] {key} over seq={world}: forward {v['fwd_ms']:.2f} ms, backward "
              f"{v['bwd_ms']:.2f} ms (host clock, synchronised), peak {v['peak_gib']:.2f} GiB; "
              f"against flash on one card out {v['out_err']:.3e}, gradients "
              f"{v['grad_err']:.3e} | {card}")
    ok = (same and all(r["trainer"]["ok"] for r in ranks)
          and all(v["ok"] for r in ranks for v in r["long context"].values()))
    print(json.dumps({"ok": ok, "world": world, "card": card}))
    return 0 if ok else 1


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--timeout", type=float, default=1500)
    ap.add_argument("--rank", type=int, default=-1)
    ap.add_argument("--store", default="")
    ap.add_argument("--out", default="", help="a directory to keep every rank's JSON in")
    args = ap.parse_args()
    if args.rank >= 0:
        _rank_main(args)
    else:
        sys.exit(_launch(args))


if __name__ == "__main__":
    main()
