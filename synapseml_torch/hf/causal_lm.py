"""HuggingFaceCausalLM: batch LLM generation as a DataFrame transformer.

Counterpart of ``synapseml_tpu/hf/causal_lm.py`` (reference
``hf/HuggingFaceCausalLMTransform.py:103-331``), with the same Params and
defaults plus ``device``: prompts (or chat message lists) -> tokenize ->
pad to a prompt bucket -> prefill + decode -> completions (text with a
``transformers`` tokenizer, token ids with the hashing tokenizer, which
cannot decode). ``engine="dense"`` runs
:func:`..models.nets.llama.generate` (a KV cache of ``max_len`` slots,
early EOS exit) a batch bucket at a time; ``engine="paged"`` runs the
token-granular :class:`..models.paged_engine.PagedDecodeEngine`, where
early-EOS rows free their pages and slots mid-batch. Greedy output is
token-identical between them in f32.

The model is built once a stage, on ``device`` (default ``"cuda"``; a host
without a card must ask for ``"cpu"``). ``model_name`` is a preset or a
local HuggingFace checkpoint directory (Llama, Mistral, Mixtral or GPT-2:
:func:`..models.convert_hf.pretrained_causal_lm`, with the directory's
tokenizer unless ``tokenizer`` is given); ``drafter_ref`` takes either too.
``model_params`` is this package's ``LlamaLM`` state_dict (tensors or
numpy arrays; ``convert_jax.llama_state_dict_from_flax`` maps a Flax
tree); None means the directory's weights, or ``init_llama_params(seed=0)``
for a preset. Tensors already on the device in the
dtype they are kept in are used as they are, not copied. The decoder's
dense weights and expert tensors are cast to the compute dtype once, when
the model loads, and the dense path and every engine share them. Callables come through
``CompiledCache`` under the JAX package's fn ids (``hf_causal_lm``,
``llama_paged_*``) and run eagerly.

``mesh_config`` (with ``partition_rules``, default the Llama table, checked
against the weights) runs the dense engine over a mesh of the process
group: each process decodes its rows of a greedy batch and the rows are
gathered; a sampled batch is decoded whole on every process (its draws
come from one stream a batch). The weights stay whole on every process, so
a table that cuts a weight over an axis of size > 1 (the JAX package
shards them over the mesh) is refused with ``NotImplementedError`` naming
ROADMAP.md queue A item 9. The paged engine refuses a mesh, as the JAX
package's does.

``serving_engine()`` returns a :class:`CausalLMServingEngine`
(``:333-646`` there), the text adapter ``io.serving.serve_llm`` schedules
tokens on: request payloads in (prompt or ids, ``max_new_tokens``,
``stream``), the stage's greedy paged engine between, chunks and terminal
records out; ``export``/``import_snapshot``/``resume`` carry a live
sequence across workers as the JAX adapter's JSON does.
"""

from __future__ import annotations

import base64
import time

import numpy as np
import torch
from torch import nn

from ..core import batching as cb
from ..core.dataframe import DataFrame
from ..core.device import device_type, resolve_device
from ..core.params import ComplexParam, Param, TypeConverters
from ..core.pipeline import Transformer
from ..models.convert_hf import pretrained_causal_lm, resolve_model_source
from ..models.convert_jax import init_llama_params
from ..models.nets.llama import LlamaLM, fold_in, generate, llama2_7b, llama_tiny
from ..models.nets.transformer import MoEBlock

__all__ = ["HuggingFaceCausalLM", "default_chat_template", "load_llama"]

_ARCHS = {"llama2-7b": llama2_7b, "llama-tiny": llama_tiny}


def default_chat_template(messages) -> str:
    """Minimal chat template (the reference applies the HF tokenizer's)."""
    parts = [f"<|{m['role']}|>\n{m['content']}" for m in messages]
    return "\n".join(parts) + "\n<|assistant|>\n"


def _compute_dtype_names(model: LlamaLM) -> set[str]:
    """The parameters :func:`load_llama` holds in the compute dtype: the
    decoder's ``nn.Linear`` weights and biases and the MoE blocks' expert
    tensors, not a router (f32, as the JAX module keeps it)."""
    out = set()
    for prefix, m in model.decoder.named_modules(prefix="decoder"):
        if isinstance(m, MoEBlock):
            out.update(f"{prefix}.{n}" for n, _ in m.named_parameters(recurse=False))
        elif isinstance(m, nn.Linear) and not prefix.endswith(".router"):
            out.update(f"{prefix}.{n}" for n, _ in m.named_parameters())
    return out


def load_llama(cfg, state_dict: dict, device) -> LlamaLM:
    """A :class:`LlamaLM` on ``device`` for inference, holding
    ``state_dict`` (numpy arrays or tensors; tensors already there in
    the dtype they are kept in are assigned, not copied). The decoder's
    ``nn.Linear`` weights and an MoE block's expert tensors are held in
    ``cfg.dtype``: ``dense``'s per-call cast and the experts' become no-ops,
    bitwise the same. The embedding, the norms, the routers and the f32
    ``lm_head`` stay in ``cfg.param_dtype``. Each tensor moves to ``device``
    in its own dtype (an F16 or BF16 checkpoint's is not widened on the
    host) and is cast there once, straight to the dtype it is kept in; the
    ``state_dict`` given keeps its own tensors."""
    with torch.device("meta"):
        model = LlamaLM(cfg)
    compute = _compute_dtype_names(model)
    state = {}
    for k, v in state_dict.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        state[k] = t.to(device).to(cfg.dtype if k in compute else cfg.param_dtype)
    model.load_state_dict(state, assign=True)
    return model.eval()


class HuggingFaceCausalLM(Transformer):
    feature_name = "hf"

    model_name = Param("model_name", "architecture preset or local HF checkpoint dir",
                       default="llama-tiny")
    model_params = ComplexParam("model_params", "this package's LlamaLM state_dict "
                                "(None = init_llama_params, seed 0)", default=None)
    tokenizer = ComplexParam("tokenizer", "tokenizer spec/object", default=None)
    input_col = Param("input_col", "prompt text column (completion mode)",
                      default="prompt")
    messages_col = Param("messages_col", "chat messages column (chat mode, "
                         "takes precedence when set)", default=None)
    output_col = Param("output_col", "generated text column", default="completions")
    max_new_tokens = Param("max_new_tokens", "tokens to generate", default=32,
                           converter=TypeConverters.to_int)
    prompt_bucket = Param("prompt_bucket", "pad prompts to multiples of this",
                          default=64, converter=TypeConverters.to_int)
    batch_size = Param("batch_size", "rows per padded device batch", default=8,
                       converter=TypeConverters.to_int)
    eos_id = Param("eos_id", "stop token id", default=None)
    do_sample = Param("do_sample", "sample instead of greedy decode", default=False,
                      converter=TypeConverters.to_bool)
    temperature = Param("temperature", "softmax temperature when sampling",
                        default=1.0, converter=TypeConverters.to_float)
    top_k = Param("top_k", "restrict sampling to the k most likely tokens "
                  "(None = no limit)", default=None)
    top_p = Param("top_p", "nucleus sampling: smallest token set with "
                  "cumulative probability >= top_p (None = no limit)",
                  default=None)
    seed = Param("seed", "RNG seed for sampling; a fixed seed makes sampled "
                 "generation deterministic on a device", default=0,
                 converter=TypeConverters.to_int)
    mesh_config = ComplexParam("mesh_config", "MeshConfig for sharded inference "
                               "(a greedy batch's rows split over the data-parallel "
                               "processes; the dense engine only)", default=None)
    partition_rules = ComplexParam("partition_rules", "PartitionRules regex table "
                                   "checked against the weights on the mesh (None = "
                                   "the default Llama table); one that cuts a weight "
                                   "is refused (ROADMAP.md queue A item 9)", default=None)
    generation_params_col = Param(
        "generation_params_col", "optional column of per-row dicts of "
        "generate kwargs (max_new_tokens/do_sample/temperature/top_k/top_p/"
        "seed/eos_id) overriding the transformer-level params; rows are "
        "bucketed by identical config", default=None)
    engine = Param("engine", "decode engine: 'dense' (run-to-completion generate) "
                   "or 'paged' (token-granular paged-KV continuous batching)",
                   default="dense")
    kv_block_len = Param("kv_block_len", "paged engine: tokens per KV page",
                         default=16, converter=TypeConverters.to_int)
    kv_blocks = Param("kv_blocks", "paged engine: physical KV pages in the "
                      "pool (None = enough for decode_slots x max_len)",
                      default=None)
    decode_slots = Param("decode_slots", "paged engine: max concurrently "
                         "decoding sequences (None = batch_size)",
                         default=None)
    prefix_cache = Param("prefix_cache", "paged engine: content-hash full KV pages so "
                         "sequences sharing a prompt prefix reuse resident pages",
                         default=False, converter=TypeConverters.to_bool)
    draft_tokens = Param("draft_tokens", "paged engine: greedy speculative decoding, "
                         "this many draft tokens a step (0 = off)", default=0,
                         converter=TypeConverters.to_int)
    drafter_ref = Param("drafter_ref", "paged engine: who drafts when draft_tokens > 0 "
                        "— None/'self' early exit at half the layers, 'self:<n>' at "
                        "layer n, or an architecture preset or local checkpoint dir",
                        default=None)
    device = Param("device", "torch device: 'cuda' (default), 'cuda:N' or 'cpu'",
                   default="cuda", converter=TypeConverters.to_string,
                   validator=lambda v: device_type(v) in ("cuda", "cpu"))

    _TRANSIENT = ("_mesh",)  # the built model and engines are "_cache_*" entries
    _CACHE_KEYS = frozenset({"model_name", "model_params", "tokenizer",
                             "mesh_config", "partition_rules",
                             "max_new_tokens", "eos_id",
                             "do_sample", "temperature", "top_k", "top_p",
                             "seed", "engine", "kv_block_len", "kv_blocks",
                             "decode_slots", "prefix_cache", "draft_tokens",
                             "drafter_ref", "device"})

    def set(self, **kw):
        out = super().set(**kw)
        if self._CACHE_KEYS & kw.keys():
            self.release()
        return out

    def release(self) -> None:
        """Drop the built model and every paged engine (their page pools)."""
        for eng in self.__dict__.pop("_cache_engines", {}).values():
            eng.release()
        self.__dict__.pop("_cache_model", None)
        cb.invalidate_token(self)  # cached callables captured old state

    # ---- lazy model/tokenizer ----
    def _model_and_tokenizer(self):
        if self.__dict__.get("_cache_model") is None:
            device = resolve_device("HuggingFaceCausalLM", self.get("device"))
            # a checkpoint directory or a preset (the reference's
            # AutoModelForCausalLM.from_pretrained path)
            cfg, loaded, tok = resolve_model_source(self.get("model_name"), _ARCHS,
                                                    self.get("tokenizer"), pretrained_causal_lm)
            params = self.get("model_params")
            if params is None:
                params = loaded
            if params is None:
                params = init_llama_params(cfg, seed=0, device=device)
            self.__dict__["_mesh"] = self._mesh_for(params)
            self.__dict__["_cache_model"] = (load_llama(cfg, params, device), tok)
        return self.__dict__["_cache_model"]

    def _mesh_for(self, params):
        """The stage's mesh (None without ``mesh_config``), its rule table
        (``partition_rules``, default the Llama table) checked against the
        weights: every sharded dim divides over its axes."""
        if self.get("mesh_config") is None:
            return None
        from ..parallel.mesh import create_mesh
        from ..parallel.partition import (default_llama_rules, match_partition_rules,
                                          sharded_leaves, tree_shardings)

        mesh = create_mesh(self.get("mesh_config"))
        rules = self.get("partition_rules") or default_llama_rules(mesh.config)
        tree_shardings(mesh, match_partition_rules(rules, dict(params)), dict(params))
        cut = sharded_leaves(rules, {k: tuple(v.shape) for k, v in dict(params).items()},
                             mesh.axis_sizes)
        if cut:
            name, axes = next(iter(cut.items()))
            raise NotImplementedError(
                f"sharding the weights by partition_rules ({len(cut)} leaves cut, {name!r} "
                f"over {axes}; the dense engine keeps every weight whole) is not ported to "
                f"synapseml_torch yet: ROADMAP.md queue A item 9")
        return mesh

    _GEN_KEYS = ("max_new_tokens", "eos_id", "do_sample", "temperature",
                 "top_k", "top_p", "seed")

    def _effective_gen_cfg(self, overrides=None) -> dict:
        """Transformer-level generation params overlaid with a per-row
        override dict."""
        eff = {k: self.get(k) for k in self._GEN_KEYS}
        if overrides:
            unknown = sorted(set(overrides) - set(self._GEN_KEYS))
            if unknown:
                raise ValueError(f"unsupported generation params {unknown}; "
                                 f"supported: {list(self._GEN_KEYS)}")
            eff.update(overrides)
        eff["max_new_tokens"] = int(eff["max_new_tokens"])
        return eff

    def _generate_fn(self, B: int, P: int, eff: dict):
        """The (batch bucket, prompt bucket, generation config) callable
        through the CompiledCache: ``fn(ids, mask, offset) -> [B, P + new]``
        host int32 ids."""
        eff_key = tuple(eff[k] for k in self._GEN_KEYS)

        def build():
            model, _tok = self._model_and_tokenizer()
            sampling = eff["do_sample"]
            temperature = float(eff["temperature"]) if sampling else 0.0
            top_k, top_p = eff["top_k"], eff["top_p"]
            # under a mesh each process decodes its rows greedily and the
            # rows are gathered; sampled rows draw from one stream a batch,
            # so every process decodes the whole batch there
            mesh = self.__dict__.get("_mesh")
            split = mesh is not None and mesh.data_parallel_size() > 1 and not sampling

            def fn(ids, mask, offset):
                # fold the batch's global row offset into the stream so that
                # identical prompts in different batches draw different samples
                rng = fold_in(int(eff["seed"]), int(offset)) if sampling else None
                if split:
                    ids, mask = mesh.shard_batch(ids), mesh.shard_batch(mask)
                out = generate(model, torch.from_numpy(ids), eff["max_new_tokens"],
                               eos_id=eff["eos_id"], prompt_mask=torch.from_numpy(mask),
                               temperature=temperature,
                               top_k=None if top_k is None else int(top_k),
                               top_p=None if top_p is None else float(top_p),
                               rng=rng)
                if split:
                    from ..parallel.collectives import all_gather_dim

                    out = all_gather_dim(mesh, out, ("data", "fsdp"))
                return out.cpu().numpy()
            return fn

        return cb.get_compiled_cache().get(
            "hf_causal_lm", (B, P) + eff_key, build,
            instance=cb.instance_token(self), dtype="int32")

    def _resolve_drafter(self):
        """``drafter_ref`` -> engine knobs ``(draft_layers, drafter)``."""
        if int(self.get("draft_tokens") or 0) <= 0:
            return None, None
        ref = self.get("drafter_ref")
        if ref is None or ref == "self":
            return None, None  # engine default: early exit at n_layers // 2
        if isinstance(ref, str) and ref.startswith("self:"):
            return int(ref.split(":", 1)[1]), None
        model, _tok = self._model_and_tokenizer()
        d_cfg, d_params, _ = resolve_model_source(ref, _ARCHS, self.get("tokenizer"),
                                                  pretrained_causal_lm)
        if d_params is None:
            d_params = init_llama_params(d_cfg, seed=1, device=model.device)
        return None, load_llama(d_cfg, d_params, model.device)

    def _paged_engine(self, eff: dict):
        """The stage's paged engine for one sampling config (greedy shares
        one): one page pool and one set of callables, keyed by this stage's
        instance token."""
        key = (bool(eff["do_sample"]),
               float(eff["temperature"]) if eff["do_sample"] else 0.0,
               eff["top_k"], eff["top_p"], int(eff["seed"]), eff["eos_id"])
        engines = self.__dict__.setdefault("_cache_engines", {})
        eng = engines.get(key)
        if eng is None or eng._released:
            from ..models.paged_engine import PagedDecodeEngine

            model, _tok = self._model_and_tokenizer()
            if self.__dict__.get("_mesh") is not None:
                raise ValueError("engine='paged' does not support mesh_config yet; "
                                 "sharded generation rides the dense path")
            sampling = bool(eff["do_sample"])
            slots = self.get("decode_slots") or max(int(self.get("batch_size")), 2)
            draft_layers, drafter = self._resolve_drafter()
            eng = PagedDecodeEngine(
                model, block_len=int(self.get("kv_block_len")),
                n_blocks=self.get("kv_blocks"), max_slots=int(slots),
                temperature=float(eff["temperature"]) if sampling else 0.0,
                top_k=None if eff["top_k"] is None else int(eff["top_k"]),
                top_p=None if eff["top_p"] is None else float(eff["top_p"]),
                seed=int(eff["seed"]), eos_id=eff["eos_id"],
                instance=cb.instance_token(self),
                prefix_cache=bool(self.get("prefix_cache")),
                draft_tokens=int(self.get("draft_tokens") or 0),
                draft_layers=draft_layers, drafter=drafter)
            engines[key] = eng
            # each engine owns a device page pool: keep at most 4, releasing
            # the oldest idle one
            if len(engines) > 4:
                for k in list(engines):
                    if k != key and not engines[k].has_work():
                        engines.pop(k).release()
                        break
        return eng

    def serving_engine(self) -> "CausalLMServingEngine":
        """The text-level adapter ``io.serving.serve_llm`` schedules tokens
        on (tokenize request -> paged engine -> detokenized chunks)."""
        return CausalLMServingEngine(self)

    def _texts_of(self, p) -> list[str]:
        mc = self.get("messages_col")
        if mc:
            return [default_chat_template(list(m)) for m in p[mc]]
        return [str(t) for t in p[self.get("input_col")]]

    def _transform(self, df: DataFrame) -> DataFrame:
        mc = self.get("messages_col")
        self.require_columns(df, mc if mc else self.get("input_col"))
        if self.get("generation_params_col"):
            self.require_columns(df, self.get("generation_params_col"))
        engine_kind = self.get("engine")
        if engine_kind not in ("dense", "paged"):
            raise ValueError(f"engine must be 'dense' or 'paged', got {engine_kind!r}")
        model, tok = self._model_and_tokenizer()
        B = self.get("batch_size")
        mesh = self.__dict__.get("_mesh")
        dp = mesh.data_parallel_size() if mesh is not None else 1
        if B % dp:
            raise ValueError(f"batch_size ({B}) must be a multiple of the mesh's "
                             f"data-parallel size ({dp})")
        bucket = self.get("prompt_bucket")
        bucketer = cb.default_bucketer()
        pcol = self.get("generation_params_col")

        def row_groups(p, n):
            """[(override dict or None, row indices)]: rows bucketed by
            identical per-row config."""
            if pcol is None:
                return [(None, np.arange(n))]
            buckets: dict = {}
            for i, d in enumerate(p[pcol]):
                d = dict(d) if d else {}
                key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                                   for k, v in d.items()))
                buckets.setdefault(key, (d, []))[1].append(i)
            return [(d, np.asarray(ix)) for d, ix in buckets.values()]

        def per_part(p, part_offset):
            n = len(next(iter(p.values()))) if p else 0
            if n == 0:
                return None
            texts = self._texts_of(p)
            col = np.empty(n, dtype=object)
            decode = getattr(tok, "decode", None)
            for overrides, ix in row_groups(p, n):
                eff = self._effective_gen_cfg(overrides)
                enc = tok([texts[i] for i in ix],
                          max_len=model.cfg.max_len - eff["max_new_tokens"],
                          multiple_of=bucket)
                ids = np.asarray(enc["input_ids"], np.int32)
                mask = np.asarray(enc["attention_mask"], np.int32)
                m = len(ix)
                if engine_kind == "paged":
                    prompts = [ids[j][mask[j] > 0].tolist() for j in range(m)]
                    # a zero-token prompt gets an empty completion for its
                    # row instead of failing the whole scan
                    live = [j for j, pr in enumerate(prompts) if pr]
                    gen_rows = [np.zeros(0, np.int32)] * m
                    if live:
                        for j, g in zip(live, self._paged_engine(eff).generate(
                                [prompts[j] for j in live], eff["max_new_tokens"],
                                uids=[part_offset + int(ix[j]) for j in live])):
                            gen_rows[j] = g
                else:
                    P = ids.shape[1]
                    outs = []
                    for s, e, row_bucket in bucketer.slices(m, B):
                        row_bucket = cb.round_up_to_multiple(row_bucket, dp)
                        ib = cb.pad_rows(ids[s:e], row_bucket)
                        mb = cb.pad_rows(mask[s:e], row_bucket, mode="constant", constant=1)
                        fn = self._generate_fn(row_bucket, P, eff)
                        gen = cb.unpad_rows(fn(ib, mb, np.int32(part_offset + int(ix[s]))),
                                            e - s)
                        outs.append(gen[:, P:])  # generated ids only
                    gen_rows = list(np.concatenate(outs, axis=0))
                for j, i in enumerate(ix):
                    toks = np.asarray(gen_rows[j])
                    if eff["eos_id"] is not None:
                        stop = np.nonzero(toks == eff["eos_id"])[0]
                        if len(stop):
                            toks = toks[: stop[0]]
                    col[i] = decode(toks.tolist()) if decode else toks
            q = dict(p)
            q[self.get("output_col")] = col
            return q

        offsets = np.cumsum([0] + [len(next(iter(p.values()))) if p else 0
                                   for p in df.partitions[:-1]])
        out_parts = []
        for p, off in zip(df.partitions, offsets):
            q = per_part(p, int(off))
            if q is None:
                q = dict(p)
                q[self.get("output_col")] = np.empty(0, dtype=object)
            out_parts.append(q)
        return DataFrame(out_parts)


class CausalLMServingEngine:
    """Text adapter between ``io.serving.serve_llm``'s token scheduler and
    the stage's shared :class:`~..models.paged_engine.PagedDecodeEngine`:
    parses request payloads (``{"prompt" | "input_ids", "max_new_tokens",
    "stream"}``), tokenizes through the stage's tokenizer, and renders
    per-token chunks and terminal replies (detokenized when the tokenizer
    can decode, raw token ids otherwise)."""

    def __init__(self, stage: HuggingFaceCausalLM):
        model, tok = stage._model_and_tokenizer()
        if stage.__dict__.get("_mesh") is not None:
            raise ValueError("serve_llm rides the paged engine, which does "
                             "not support mesh_config yet")
        self._tok = tok
        self._decode = getattr(tok, "decode", None)
        self._max_len = model.cfg.max_len
        eff = stage._effective_gen_cfg()
        self._default_max_new = int(eff["max_new_tokens"])
        self._engine = stage._paged_engine(eff)

    # -- scheduling delegation (the serve_llm protocol) --
    def admit(self):
        return self._engine.admit()

    def step(self):
        return self._engine.step()

    def has_work(self) -> bool:
        return self._engine.has_work()

    @property
    def waiting_count(self) -> int:
        return self._engine.waiting_count

    def warmup(self) -> int:
        return self._engine.warmup()

    def abort(self, seq, reason: str = "aborted"):
        return self._engine.abort(seq, reason=reason)

    def abort_all(self, reason: str = "aborted"):
        return self._engine.abort_all(reason=reason)

    def live_requests(self):
        return self._engine.live_sequences()

    def release(self) -> None:
        self._engine.release()

    def stats(self) -> dict:
        return self._engine.stats()

    # -- request surface --
    def _prompt_ids(self, payload) -> list:
        if "input_ids" in payload:
            return [int(t) for t in payload["input_ids"]]
        prompt = payload.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("need 'prompt' (non-empty string) or 'input_ids'")
        # the prompt is kept whole up to the model horizon; the engine caps
        # max_new to the room left and reports finish_reason 'length'
        enc = self._tok([prompt], max_len=self._max_len - 1, multiple_of=1)
        row_ids = np.asarray(enc["input_ids"][0])
        row_mask = np.asarray(enc["attention_mask"][0])
        return row_ids[row_mask > 0].tolist()

    def _max_new(self, body: dict, cap: int) -> int:
        max_new = int(body.get("max_new_tokens", self._default_max_new))
        return max(1, min(max_new, int(cap)))

    def submit(self, payload, request_id: str, max_new_cap: int = 1024,
               deadline: float | None = None, journal_key: str | None = None):
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object with 'prompt' or 'input_ids'")
        stream = bool(payload.get("stream", False))
        max_new = self._max_new(payload, max_new_cap)
        ids = self._prompt_ids(payload)
        return self._engine.submit(ids, max_new, request_id=request_id, stream=stream,
                                   deadline=deadline, journal_key=journal_key)

    # -- live migration surface (serve_llm drain / front resubmit) --
    def export(self, uid: int) -> "dict | None":
        """JSON-able snapshot of one live sequence (the engine's binary npz
        payload as base64): the wire form of ``export_sequence``."""
        snap = self._engine.export_sequence(uid)
        if snap is None:
            return None
        return {"manifest": snap["manifest"],
                "payload_b64": base64.b64encode(snap["payload"]).decode(),
                "digests": snap["digests"]}

    def _seed_emitted_text(self, seq) -> None:
        # the client has the text of every emitted token: prime the
        # cumulative-decode cursor so the next chunk streams only the delta
        if self._decode is not None and seq.generated:
            full = self._decode(list(seq.generated))
            if not full.endswith("\ufffd"):
                seq._emitted_text = full

    @staticmethod
    def _deadline_ms_left(deadline: float | None) -> float | None:
        return None if deadline is None else (deadline - time.perf_counter()) * 1e3

    def import_snapshot(self, obj, request_id: str, deadline: float | None = None,
                        journal_key: str | None = None):
        """Readmit an exported sequence under this worker's exchange: the
        continuation always streams and keeps the origin's uid."""
        if not isinstance(obj, dict) or "manifest" not in obj:
            raise ValueError("__import__ needs a snapshot with 'manifest'")
        man = dict(obj["manifest"])
        man["request_id"] = request_id
        man["stream"] = True
        if journal_key is not None:
            man["journal_key"] = journal_key
        if deadline is not None:
            man["deadline_ms_left"] = self._deadline_ms_left(deadline)
        payload = (base64.b64decode(obj["payload_b64"]) if obj.get("payload_b64")
                   else (obj.get("payload") or b""))
        seq = self._engine.import_sequence({"manifest": man, "payload": payload,
                                            "digests": obj.get("digests") or {}})
        self._seed_emitted_text(seq)
        return seq

    def resume(self, obj, request_id: str, max_new_cap: int = 1024,
               deadline: float | None = None, journal_key: str | None = None):
        """Crash-path resubmit (no KV snapshot survived): re-tokenize the
        original body and re-prefill over prompt + the tokens already
        relayed (token-identical under greedy)."""
        if not isinstance(obj, dict) or not isinstance(obj.get("body"), dict):
            raise ValueError("__resume__ needs {'body': <original request>, "
                             "'emitted_ids': [...]}")
        body = obj["body"]
        man = {"uid": (int(obj["uid"]) if obj.get("uid") is not None
                       else hash(request_id) & 0x7FFFFFFF),
               "prompt_ids": self._prompt_ids(body),
               "generated": [int(t) for t in obj.get("emitted_ids") or []],
               "max_new_tokens": self._max_new(body, max_new_cap),
               "request_id": request_id, "stream": True, "journal_key": journal_key,
               "tokens_in_pages": 0}
        if deadline is not None:
            man["deadline_ms_left"] = self._deadline_ms_left(deadline)
        seq = self._engine.import_sequence({"manifest": man, "payload": b"", "digests": {}})
        self._seed_emitted_text(seq)
        return seq

    def chunk_for(self, event: dict) -> dict:
        out = {"token": event["token"]}
        if self._decode is not None:
            # byte-level BPE pieces may not decode alone: decode the
            # cumulative ids and stream the text delta, holding back an
            # incomplete tail until a later token completes it
            seq = event["seq"]
            full = self._decode(list(seq.generated))
            prev = getattr(seq, "_emitted_text", "")
            if full.endswith("\ufffd"):
                out["text"] = ""
            else:
                out["text"] = full[len(prev):] if full.startswith(prev) else full
                seq._emitted_text = full
        return out

    def result_for(self, seq) -> dict:
        toks = list(seq.generated)
        if self._engine.eos_id is not None and toks and toks[-1] == self._engine.eos_id:
            toks = toks[:-1]
        out = {"done": True, "n_tokens": len(toks), "finish_reason": seq.finish_reason,
               "output_ids": toks}
        if self._decode is not None:
            out["text"] = self._decode(toks)
        if seq.preemptions:
            out["preemptions"] = seq.preemptions
        return out
