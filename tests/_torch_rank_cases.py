"""The rank side of the port's multi-process tests (run by ``_torch_ranks.py``).

Each suite is ``suite(rank, world, directory, args) -> {name: array}``, runs
inside one gloo process of a ``world``-process group and imports the port
only (no JAX): the test modules hold its results against the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

VOCAB, T, B = 128, 12, 8


class Mlp(torch.nn.Module):
    """The small net of the trainer's checkpoint tests: ``x`` -> 3 logits."""

    def __init__(self):
        super().__init__()
        self.mlp = torch.nn.Sequential(torch.nn.Linear(4, 16), torch.nn.ReLU(),
                                       torch.nn.Linear(16, 3))

    def forward(self, x):
        return self.mlp(x)


def _bert_state(seed: int = 0, vocab: int = VOCAB):
    from synapseml_torch.models import convert_jax
    from synapseml_torch.models.nets import bert

    cfg = bert.bert_tiny(vocab_size=vocab, dtype=torch.float32, max_len=32)
    return cfg, convert_jax.bert_state_dict_from_flax(
        convert_jax.init_flax_bert_params(cfg, 2, seed=seed))


# ---------------------------------------------------------------- mesh


def mesh_suite(rank, world, directory, args):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from synapseml_torch import parallel as pp
    from synapseml_torch.parallel import collectives as col

    out = {}
    m = pp.create_mesh(pp.MeshConfig(data=2, tensor=2))
    out["coord"] = np.array([m.coordinate()[a] for a in pp.mesh.AXES])
    out["sizes"] = np.array([m.axis_sizes[a] for a in pp.mesh.AXES])
    out["degraded"] = np.array([pp.create_mesh(pp.MeshConfig(data=3)).axis_sizes["data"]])
    x = torch.tensor([float(rank + 1), 10.0 * (rank + 1)])
    out["psum_data"] = col.psum_over(m, "data")(x).numpy()
    out["psum_all"] = col.psum_over(m, ("data", "tensor"))(x).numpy()
    out["pmean_tensor"] = col.pmean_over(m, "tensor")(x).numpy()
    out["gather_data"] = col.all_gather_over(m, "data")(x[None]).numpy()
    seq = pp.create_mesh(pp.MeshConfig(data=1, seq=world))
    out["ring"] = col.ring_permute(seq, "seq")(x).numpy()
    out["ring_back"] = col.ring_permute(seq, "seq", shift=-1)(x).numpy()
    rows = np.arange(24, dtype=np.float32).reshape(8, 3)
    dpm = pp.create_mesh(pp.MeshConfig(data=2, fsdp=2))
    out["dp_mean"] = col.data_parallel_map(dpm, lambda b: torch.from_numpy(b["x"]) * 2)(
        {"x": rows}).numpy()
    out["dp_rows"] = dpm.shard_batch({"x": rows})["x"]

    # the rule tables on the port's names: local shards and bytes
    _, state = _bert_state()
    for tag, cfg in (("tensor", pp.MeshConfig(data=2, tensor=2)),
                     ("fsdp", pp.MeshConfig(data=1, fsdp=4))):
        mesh = pp.create_mesh(cfg)
        rules = pp.default_transformer_rules(cfg)
        placed = pp.shard_tree(state, mesh, rules)
        from synapseml_torch.parallel.partition import per_device_bytes, total_bytes

        out[f"{tag}_bytes"] = np.array([total_bytes(placed), per_device_bytes(placed)])
        for name, t in placed.items():
            local = t.to_local() if isinstance(t, DTensor) else t
            out[f"{tag}/{name}"] = local.numpy()
    # ZeRO moments over the fsdp mesh: per-device optimizer bytes
    from synapseml_torch.models import trainer as tt
    from synapseml_torch.models.nets import bert

    cfg = pp.MeshConfig(data=1, fsdp=4)
    mesh = pp.create_mesh(cfg)
    tcfg, _ = _bert_state()
    trainer = tt.Trainer(bert.BertClassifier(tcfg, 2),
                         tt.TrainerConfig(partition_rules=pp.PartitionRules(),
                                          zero_shard=True), device="cpu", mesh=mesh)
    st = trainer.init_state(init_params=state)
    moments = trainer._placed_moments(st)
    out["zero_bytes"] = np.array([pp.partition.total_bytes(moments),
                                  pp.partition.per_device_bytes(moments)])
    out.update(_refusals(state))
    out.update(_sharded_stages(pp.MeshConfig(data=world)))
    dist.barrier()
    return out


def _refusals(state) -> dict:
    """The messages of what placing the parameters needs (queue A item 9):
    the trainer on a tensor mesh, the trainer and the causal LM with a rule
    table that cuts a weight over an axis of size > 1."""
    from synapseml_torch import parallel as pp
    from synapseml_torch.hf import HuggingFaceCausalLM
    from synapseml_torch.hf import causal_lm as tcl
    from synapseml_torch.models import trainer as tt
    from synapseml_torch.models.nets import bert, llama
    from synapseml_torch.models.tokenizer import HashingTokenizer

    tcl._ARCHS["llama-tiny"] = lambda **kw: llama.llama_tiny(dtype=torch.float32, **kw)
    tcfg, _ = _bert_state()
    shapes = {"tensor": pp.MeshConfig(data=2, tensor=2), "fsdp": pp.MeshConfig(data=1, fsdp=4)}
    cases = {
        "trainer_tensor": lambda: tt.Trainer(
            bert.BertClassifier(tcfg, 2), tt.TrainerConfig(), device="cpu",
            mesh=pp.create_mesh(shapes["tensor"])),
        "trainer_fsdp_rules": lambda: tt.Trainer(
            bert.BertClassifier(tcfg, 2),
            tt.TrainerConfig(partition_rules=pp.default_transformer_rules(shapes["fsdp"]),
                             zero_shard=True), device="cpu", mesh=pp.create_mesh(shapes["fsdp"])),
        "lm_rules": lambda: HuggingFaceCausalLM(
            model_name="llama-tiny", tokenizer=HashingTokenizer(vocab_size=256).to_config(),
            device="cpu", mesh_config=shapes["fsdp"],
            partition_rules=pp.default_llama_rules(shapes["fsdp"]))._model_and_tokenizer(),
    }
    out = {}
    for tag, make in cases.items():
        try:
            make()
            out[f"refused/{tag}"] = np.array([""])
        except NotImplementedError as e:
            out[f"refused/{tag}"] = np.array([str(e)])
    return out


def _sharded_stages(shape) -> dict:
    """Scores, embeddings and greedy completions of the inference stages,
    without a mesh and with ``mesh_config`` (each rank its rows, gathered),
    in f32."""
    from synapseml_torch import DataFrame
    from synapseml_torch.hf import HuggingFaceCausalLM, HuggingFaceSentenceEmbedder
    from synapseml_torch.hf import causal_lm as tcl
    from synapseml_torch.models import text as ttext
    from synapseml_torch.models.nets import bert, llama
    from synapseml_torch.models.tokenizer import HashingTokenizer

    tcl._ARCHS["llama-tiny"] = lambda **kw: llama.llama_tiny(dtype=torch.float32, **kw)
    tok = HashingTokenizer(vocab_size=VOCAB).to_config()
    cfg = bert.bert_tiny(vocab_size=VOCAB, dtype=torch.float32, max_len=32)
    params = ttext._init_params(cfg, 2, 0)
    texts = np.asarray([" ".join(f"w{(7 * i + j) % 50}" for j in range(3 + i % 9))
                        for i in range(10)], dtype=object)
    df = DataFrame.from_dict({"text": texts, "prompt": texts})
    out = {}
    for tag, mc in (("plain", None), ("sharded", shape)):
        model = ttext.DeepTextModel(model_params=params, arch_config=cfg, tokenizer_config=tok,
                                    num_classes=2, max_token_len=16, batch_size=4,
                                    device="cpu", mesh_config=mc)
        out[f"text/{tag}"] = np.stack(list(model.transform(df).collect_column("scores")))
        emb = HuggingFaceSentenceEmbedder(model_name="bert-tiny", tokenizer=tok, max_token_len=16,
                                          batch_size=4, device="cpu", mesh_config=mc)
        out[f"embed/{tag}"] = np.stack(list(emb.transform(df).collect_column("embeddings")))
        lm = HuggingFaceCausalLM(model_name="llama-tiny",
                                 tokenizer=HashingTokenizer(vocab_size=256).to_config(),
                                 max_new_tokens=5, prompt_bucket=8, batch_size=4,
                                 device="cpu", mesh_config=mc)
        out[f"lm/{tag}"] = np.stack([np.asarray(c) for c in
                                     lm.transform(df).collect_column("completions")])
    return out


# ---------------------------------------------------------------- checkpoints


def ckpt_write_suite(rank, world, directory, args):
    """World 4: a DTensor tree placed by the transformer table on (data=2,
    tensor=2), each rank writing its shard of the coordinated step."""
    from synapseml_torch import parallel as pp

    cfg = pp.MeshConfig(data=2, tensor=2)
    mesh = pp.create_mesh(cfg)
    _, state = _bert_state(seed=3)
    placed = pp.shard_tree(state, mesh, pp.default_transformer_rules(cfg))
    tree = {"params": placed, "step": np.asarray(7, np.int64)}
    ck = pp.AsyncCheckpointer(args["path"], process_index=rank, process_count=world,
                              run_id="r1", meta={"orig_world": world})
    ck.save({**tree, "data_iter": {"cursor": np.asarray([rank, 10 + rank], np.int64)}}, 7)
    ck.close()
    return {}


def ckpt_read_suite(rank, world, directory, args):
    """World 2: the world-4 step restored onto (data=1, fsdp=2) by the rule
    table; each rank's local shards and the per-rank payloads."""
    from torch.distributed.tensor import DTensor

    from synapseml_torch import parallel as pp

    cfg = pp.MeshConfig(data=1, fsdp=2)
    mesh = pp.create_mesh(cfg)
    fn = pp.checkpoint_sharding_fn(pp.default_transformer_rules(cfg), mesh)
    tree = pp.restore_checkpoint(args["path"], sharding_fn=fn)
    out = {"step": np.asarray(tree["step"])}
    for name, t in tree["params"].items():
        out[f"local/{name}"] = (t.to_local() if isinstance(t, DTensor) else t).numpy()
        out[f"full/{name}"] = (t.full_tensor() if isinstance(t, DTensor) else t).numpy()
    hosts = pp.restore_host_states(args["path"])
    out["cursors"] = np.stack([hosts[r]["data_iter"]["cursor"] for r in sorted(hosts)])
    return out


def resume_suite(rank, world, directory, args):
    """A data=world mesh fit with checkpoints every 4 steps, killed after
    step 8 (its later steps removed), resumed: the final params, moments
    and step of both runs."""
    import shutil

    import torch.distributed as dist

    from synapseml_torch import parallel as pp
    from synapseml_torch.data import MemorySource
    from synapseml_torch.models import trainer as tt

    rs = np.random.default_rng(2)
    data = {"x": rs.normal(size=(96, 4)).astype(np.float32),
            "labels": (np.arange(96) % 3).astype(np.int32)}

    def trainer():
        torch.manual_seed(0)
        net = Mlp()
        cfg = pp.MeshConfig(data=world)
        return tt.Trainer(net, tt.TrainerConfig(total_steps=12, learning_rate=1e-2,
                                                partition_rules=pp.PartitionRules(),
                                                zero_shard=True),
                          device="cpu", mesh=pp.create_mesh(cfg))

    path = args["path"]
    with pp.AsyncCheckpointer(path, keep=5) as ck:
        full = tt.fit_source(trainer(), MemorySource(data, shard_rows=32), batch_size=16,
                             total_steps=12, seed=5, checkpointer=ck, checkpoint_every=4)
    if rank == 0:
        shutil.rmtree(f"{path}/step_0000000012")
    dist.barrier()
    resumed = tt.fit_source(trainer(), MemorySource(data, shard_rows=32), batch_size=16,
                            total_steps=12, seed=5, resume_from=path)
    out = {"steps": np.array([full.step, resumed.step])}
    for i, name in enumerate(full.params):
        out[f"full/{name}"] = full.params[name].detach().numpy()
        out[f"resumed/{name}"] = resumed.params[name].detach().numpy()
    for j, (a, b) in enumerate(zip(full.opt_state.mu, resumed.opt_state.mu)):
        out[f"mu_full/{j}"] = a.numpy()
        out[f"mu_resumed/{j}"] = b.numpy()
    out.update(_stage_fits(world, args["path"] + "_stage"))
    return out


def _stage_fits(world: int, ckpt_dir: str) -> dict:
    """DeepTextClassifier (bert-tiny in f32) fitted without a mesh and with
    ``mesh_config=data=world`` and ``checkpoint_dir``: both models' params,
    and the latest verified step every rank sees after the fit."""
    from synapseml_torch import DataFrame
    from synapseml_torch import parallel as pp
    from synapseml_torch.models import text as ttext
    from synapseml_torch.models.nets import bert

    ttext._ARCHS["bert-tiny"] = lambda **kw: bert.bert_tiny(dtype=torch.float32, **kw)
    rs = np.random.default_rng(4)
    words = np.array(["good", "bad", "film", "plot", "great", "awful", "the", "a"])
    rows = [{"text": " ".join(rs.choice(words, size=int(rs.integers(3, 12)))),
             "label": int(i % 2)} for i in range(32)]
    df = DataFrame.from_rows(rows)
    kw = dict(device="cpu", max_steps=4, batch_size=8, max_token_len=16, learning_rate=1e-3)
    plain = ttext.DeepTextClassifier(**kw).fit(df).get("model_params")
    meshed = ttext.DeepTextClassifier(mesh_config=pp.MeshConfig(data=world),
                                      checkpoint_dir=ckpt_dir, checkpoint_every=2,
                                      **kw).fit(df).get("model_params")
    out = {"stage/steps": np.asarray([pp.latest_verified_step(ckpt_dir)])}
    for k in plain:
        out[f"stage/plain/{k}"] = plain[k]
        out[f"stage/mesh/{k}"] = meshed[k]
    return out


# ---------------------------------------------------------------- ring / Ulysses


def attention_inputs(seed: int, b: int = 2, t: int = 32, h: int = 4, d: int = 16):
    rs = np.random.default_rng(seed)
    q, k, v, g = (rs.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((b, t), bool)
    mask[0, t - 5:] = False
    mask[1, t // 2 - 3:t // 2] = False
    return q, k, v, mask, g


def ring_suite(rank, world, directory, args):
    """Ring and Ulysses on a seq=world mesh, forward and gradients of
    ``sum(out * g)``, non-causal and causal with the padding mask."""
    from synapseml_torch import parallel as pp
    from synapseml_torch.ops import ring_attention_sharded, ulysses_attention_sharded

    mesh = pp.create_mesh(pp.MeshConfig(data=1, seq=world))
    q, k, v, mask, g = attention_inputs(args["seed"])
    out = {}
    for impl, fn in (("ring", ring_attention_sharded), ("ulysses", ulysses_attention_sharded)):
        for causal in (False, True):
            qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
            kw = dict(kv_mask=torch.from_numpy(mask), causal=causal)
            if impl == "ring":
                kw["chunk"] = 4  # several chunks a block
            o = fn(mesh, qt, kt, vt, **kw)
            (o * torch.from_numpy(g)).sum().backward()
            tag = f"{impl}/{int(causal)}"
            out[f"{tag}/out"] = o.detach().numpy()
            for name, t in (("dq", qt), ("dk", kt), ("dv", vt)):
                out[f"{tag}/{name}"] = t.grad.numpy()
    return out


# ---------------------------------------------------------------- trainer


def trainer_batches(n: int = 4, seed: int = 0):
    rs = np.random.default_rng(seed)
    out = []
    for i in range(n):
        mask = np.ones((B, T), np.int32)
        for r in range(B):
            mask[r, rs.integers(3, T + 1):] = 0
        valid = np.ones(B, np.float32)
        valid[B - 1 - i % 3:] = 0.0
        out.append({"input_ids": (rs.integers(1, VOCAB, (B, T)) * mask).astype(np.int32),
                    "attention_mask": mask,
                    "labels": rs.integers(0, 2, B).astype(np.int32),
                    "_valid": valid})
    return out


TRAINER_COMMON = dict(learning_rate=2e-3, total_steps=4, grad_clip=0.5, lr_schedule="constant")


def trainer_suite(rank, world, directory, args):
    """bert_tiny steps on each mesh shape of ``args['cases']``: the losses,
    grad norms and final params (rank 0's; every rank's must agree)."""
    import dataclasses

    from synapseml_torch import parallel as pp
    from synapseml_torch.models import trainer as tt
    from synapseml_torch.models.nets import bert

    init = dict(np.load(args["init"]))
    out = {}
    for case in args["cases"]:
        name, shape, extra = case["name"], case["mesh"], case.get("extra", {})
        cfg = pp.MeshConfig(**shape)
        mesh = pp.create_mesh(cfg, allow_fewer=False)
        tcfg, _ = _bert_state()
        if extra.get("attn_impl"):
            tcfg = dataclasses.replace(tcfg, attn_impl=extra["attn_impl"])
        # the port keeps the parameters whole: its table places nothing
        rules = pp.PartitionRules() if extra.get("rules") else None
        if case.get("refused"):  # placing the parameters waits for item 9
            rules = pp.default_transformer_rules(cfg)
            try:
                tt.Trainer(bert.BertClassifier(tcfg, 2),
                           tt.TrainerConfig(partition_rules=rules, **TRAINER_COMMON),
                           device="cpu", mesh=mesh)
                out[f"{name}/refused"] = np.array([""])
            except NotImplementedError as e:
                out[f"{name}/refused"] = np.array([str(e)])
            continue
        trainer = tt.Trainer(bert.BertClassifier(tcfg, 2),
                             tt.TrainerConfig(partition_rules=rules,
                                              zero_shard=bool(extra.get("zero")),
                                              **TRAINER_COMMON),
                             device="cpu", mesh=mesh)
        state = trainer.init_state(init_params=init)
        losses, norms = [], []
        for batch in trainer_batches():
            state, m = trainer.train_step(state, batch)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
        out[f"{name}/loss"] = np.array(losses)
        out[f"{name}/grad_norm"] = np.array(norms)
        for k, v in state.params.items():
            out[f"{name}/p/{k}"] = v.detach().numpy()
    return out


# ---------------------------------------------------------------- GBDT


def gbdt_data(kind: str, n: int = 1001, seed: int = 0):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(n, 5))
    groups = None
    if kind == "binary":
        y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    elif kind == "regression":
        y = (x[:, 0] * 2 + np.sin(x[:, 1]) + 0.1 * rs.normal(size=n)).astype(np.float32)
    elif kind == "multiclass":
        y = (np.digitize(x[:, 0], [-0.5, 0.5])).astype(np.float32)
    else:  # lambdarank: groups of 7..20 rows
        sizes = []
        while sum(sizes) < n:
            sizes.append(int(rs.integers(7, 21)))
        sizes[-1] -= sum(sizes) - n
        groups = np.asarray(sizes, np.int64)
        y = np.clip(np.round(x[:, 0] * 1.5 + 2), 0, 4).astype(np.float32)
    return x, y, groups


GBDT_KW = {"binary": dict(objective="binary"),
           "regression": dict(objective="regression"),
           "multiclass": dict(objective="multiclass", num_class=3),
           "lambdarank": dict(objective="lambdarank")}


def gbdt_fit(kind: str, mesh=None, **extra):
    from synapseml_torch.gbdt.booster import train_booster

    x, y, groups = gbdt_data(kind)
    kw = dict(num_iterations=4, learning_rate=0.3, num_leaves=7, min_data_in_leaf=5,
              histogram_impl="pallas", device="cpu", **GBDT_KW[kind])
    kw.update(extra)
    if groups is not None:
        kw["group_sizes"] = groups
    return train_booster(x, y, mesh=mesh, **kw)


def gbdt_suite(rank, world, directory, args):
    from synapseml_torch import parallel as pp

    mesh = pp.create_mesh(pp.MeshConfig(data=world))
    out = {}
    for kind in GBDT_KW:
        for mode, extra in (("gbdt", {}), ("goss", dict(boosting_type="goss")),
                            ("segment", dict(histogram_impl="segment"))):
            if mode != "gbdt" and kind not in ("binary", "lambdarank"):
                continue
            b = gbdt_fit(kind, mesh, **extra)
            x, _, _ = gbdt_data(kind)
            tag = f"{kind}/{mode}"
            out[f"{tag}/feature"] = b.feature
            out[f"{tag}/threshold"] = b.threshold_value
            out[f"{tag}/leaf"] = b.leaf_value
            out[f"{tag}/pred"] = np.asarray(b.predict(x[:200], device="cpu")) \
                if kind != "lambdarank" else np.asarray(b.raw_score(x[:200], device="cpu"))
    return out
