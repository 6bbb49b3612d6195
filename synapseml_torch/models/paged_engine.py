"""Token-granular paged-KV decode engine for the causal LM path.

Counterpart of ``synapseml_tpu/models/paged_engine.py``, with the same
scheduler, allocator, metrics and migration format:

* **Paged KV pool**: one ``[n_blocks, block_len, kv_heads, head_dim]``
  tensor a layer (``models/nets/llama.py`` paged functions), written in
  place, plus a block table a sequence. A finished sequence's pages free the
  moment it emits EOS or exhausts ``max_new_tokens``. Block 0 is the trash
  page: never allocated, it absorbs masked writes, so live pages never
  alias.
* **Prefill/decode split**: a prefill callable per bucketed prompt length
  (``ShapeBucketer.seq_bucket_for``) and a single-step decode callable per
  bucketed active-slot count, each got only through the shared
  :class:`~..core.batching.CompiledCache` under the JAX package's fn ids
  (``llama_paged_{prefill,decode,extend,spec}``), so a request stream takes
  at most ladder-many of each. They run eagerly.
* **Continuous batching**: :meth:`admit` prefills waiting sequences into
  free slots between decode steps and :meth:`step` decodes one token for
  every active slot. When the pool runs dry mid-decode the youngest
  sequence is preempted (pages freed, re-queued for re-prefill over
  prompt + generated: token-identical under greedy).
* Prefix caching (:mod:`.prefix_cache`, with copy-on-write of a shared
  divergence block) and greedy speculative decoding (early exit over the
  first layers' pools, or a dense windowed drafter model) are off by
  default.

Sampling cannot reproduce ``jax.random``'s bits: a row's draw at a step is
seeded with ``fold_in(fold_in(seed, uid), step)``, so each request's stream
is a pure function of ``(seed, uid)`` on a device. Greedy decode is exact,
and token-identical to :func:`..nets.llama.greedy_generate` in f32.
"""

from __future__ import annotations

import hashlib
import io
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from ..core import batching as cb
from ..core import observability as obs
from .nets.llama import (LlamaLM, _make_selector, early_exit_model, fold_in, paged_decode_step,
                         paged_extend, paged_prefill, paged_verify)

__all__ = ["BlockAllocator", "PagedDecodeEngine", "SequenceState"]


_ENGINE_METRICS = obs.HandleCache(lambda reg: {
    "step_ms": reg.histogram(
        "synapseml_llm_step_ms",
        "wall time of one engine step, split prefill vs decode", ("phase",)),
    "token_ms": reg.histogram(
        "synapseml_llm_token_latency_ms",
        "decode wall time per emitted token (step time / tokens emitted)"),
    "ttft_ms": reg.histogram(
        "synapseml_llm_ttft_ms",
        "submit -> first generated token (queue wait + prefill)"),
    "tokens": reg.counter(
        "synapseml_llm_tokens_total",
        "generated tokens by phase (prefill = first token)", ("phase",)),
    "occupancy": reg.gauge(
        "synapseml_llm_kv_block_occupancy",
        "fraction of the physical KV block pool allocated to live sequences"),
    "fragmentation": reg.gauge(
        "synapseml_llm_kv_fragmentation",
        "unused token slots inside allocated blocks / allocated capacity "
        "(tail waste of the page granularity)"),
    "refilled": reg.counter(
        "synapseml_llm_slots_refilled_total",
        "decode slots handed to a waiting sequence after a finish freed "
        "capacity (the no-run-to-completion-barrier counter)"),
    "preempted": reg.counter(
        "synapseml_llm_slots_preempted_total",
        "sequences evicted mid-decode because the block pool ran dry "
        "(re-queued for re-prefill)"),
    "finished": reg.counter(
        "synapseml_llm_sequences_finished_total",
        "sequences completed, by finish reason", ("reason",)),
    "spec_proposed": reg.counter(
        "synapseml_llm_spec_tokens_proposed_total",
        "draft tokens proposed to the speculative verify step"),
    "spec_accepted": reg.counter(
        "synapseml_llm_spec_tokens_accepted_total",
        "draft tokens the full model confirmed (greedy match)"),
    "spec_steps": reg.counter(
        "synapseml_llm_spec_steps_total",
        "engine steps by decode mode: 'spec' = fused draft+verify, "
        "'fallback' = plain single-token (pool too tight for the window)",
        ("mode",)),
    "spec_accept_rate": reg.gauge(
        "synapseml_llm_spec_acceptance_rate",
        "cumulative accepted / proposed draft tokens"),
})


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes as a host uint8 array (numpy has no bf16)."""
    return t.detach().contiguous().view(torch.uint8).cpu().numpy()


def _npz_safe(t: torch.Tensor) -> np.ndarray:
    """npz-writable form of one KV chunk: builtin numpy dtypes as they are,
    bf16 as raw bytes (the manifest's dtype restores it on import)."""
    if t.dtype == torch.bfloat16:
        return _raw_bytes(t).reshape(-1)
    return t.detach().cpu().numpy()


_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class BlockAllocator:
    """Free-list allocator over the physical page pool. Block 0 is the
    reserved trash page and is never handed out; double-free and
    allocate-while-live are hard errors (the no-aliasing invariant).

    Blocks are reference-counted for prefix-KV sharing: ``alloc`` hands out
    blocks at refcount 1, :meth:`ref` lets another holder pin a live block,
    and ``free`` drops one reference per call; a block returns to the free
    list when the last holder lets go."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 is the trash page), "
                             f"got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self._free: list[int] = list(range(self.n_blocks - 1, 0, -1))
        self._live: set[int] = set()
        self._refs: dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._live)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (pool minus the trash page)."""
        return self.n_blocks - 1

    def alloc(self, n: int) -> list[int] | None:
        """``n`` blocks or None (never a partial allocation)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._live.update(out)
        for b in out:
            self._refs[b] = 1
        return out

    def ref(self, block: int) -> None:
        """Add one reference to an already-live block (prefix sharing)."""
        if block not in self._live:
            raise RuntimeError(
                f"ref on block {block} that is not live (use-after-free "
                f"or trash-page share — an aliasing bug)")
        self._refs[block] += 1

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def free(self, blocks: Iterable[int]) -> None:
        for b in blocks:
            if b not in self._live:
                raise RuntimeError(
                    f"freeing block {b} that is not live (double free or "
                    f"trash-page free — an aliasing bug)")
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._live.remove(b)
                self._free.append(b)


@dataclass
class SequenceState:
    """One request's decode state (host side; device state is the pages)."""

    uid: int
    prompt_ids: list
    max_new_tokens: int
    request_id: str | None = None
    stream: bool = False
    generated: list = field(default_factory=list)
    blocks: list = field(default_factory=list)
    tokens_in_pages: int = 0       # prompt + generated tokens written to pages
    preemptions: int = 0
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: float | None = None
    finish_reason: str | None = None
    deadline: float | None = None  # perf_counter instant; past it the engine
    #                                frees the pages, finish reason 'deadline'
    journal_key: str | None = None  # the front's idempotency key, kept in exports
    registered_blocks: int = 0     # full blocks already chain-hashed into
    prefix_digest: bytes = b""     # the prefix cache, + the chain digest there

    @property
    def context_ids(self) -> list:
        """Tokens a (re-)prefill must process: prompt + generated so far."""
        return list(self.prompt_ids) + list(self.generated)

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


class PagedDecodeEngine:
    """Continuous-batching decode engine over a paged KV pool.

    ``submit`` -> waiting queue; ``admit`` prefills waiting sequences into
    capacity (bucketed prompt lengths, fixed prefill batch width); ``step``
    decodes one token for every active sequence (bucketed slot count). Both
    return event dicts ``{"seq", "token", "done", "finish_reason"}``.

    ``model`` is the :class:`..nets.llama.LlamaLM` whose weights (and
    compute-dtype copy) the engine reads; the pool lives on its device.
    Sampling (``temperature``/``top_k``/``top_p``/``seed``) is fixed per
    engine; greedy, the default, is what the parity guarantee covers.
    ``drafter`` is a small :class:`LlamaLM` for speculative decoding (None:
    early exit of ``model`` at ``draft_layers``)."""

    def __init__(self, model: LlamaLM, *, block_len: int = 16,
                 n_blocks: int | None = None, max_slots: int = 8,
                 max_len: int | None = None, prefill_batch: int = 4,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None, seed: int = 0,
                 eos_id: int | None = None, bucketer=None,
                 instance: Any = None, fn_prefix: str = "llama_paged",
                 prefix_cache: bool = False, draft_tokens: int = 0,
                 draft_layers: int | None = None, drafter: LlamaLM | None = None):
        cfg = model.cfg
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self.block_len = int(block_len)
        self.max_len = int(max_len or cfg.max_len)
        if self.max_len > cfg.max_len:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"RoPE/cache horizon {cfg.max_len}")
        self.max_blocks = -(-self.max_len // self.block_len)
        self.max_slots = int(max_slots)
        self.prefill_batch = int(prefill_batch)
        if n_blocks is None:
            # default: every slot can run to max_len concurrently + trash
            n_blocks = 1 + self.max_slots * self.max_blocks
        self.allocator = BlockAllocator(n_blocks)
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = int(seed)
        self.bucketer = bucketer or cb.default_bucketer()
        self._fn_prefix = fn_prefix
        self._instance = instance if instance is not None else cb.instance_token(self)
        # decode slot rungs: ladder rungs <= max_slots, plus max_slots itself
        rungs = [r for r in self.bucketer.ladder if r <= self.max_slots]
        if not rungs or rungs[-1] < self.max_slots:
            rungs.append(self.max_slots)
        self.slot_rungs: tuple[int, ...] = tuple(rungs)
        # physical pool: one [n_blocks, bl, KV, D] tensor per layer, written
        # in place by every prefill/decode call
        shape = (n_blocks, self.block_len, cfg.kv_heads, cfg.head_dim)
        self._k_pages = [torch.zeros(shape, dtype=cfg.dtype, device=self.device)
                         for _ in range(cfg.n_layers)]
        self._v_pages = [torch.zeros(shape, dtype=cfg.dtype, device=self.device)
                         for _ in range(cfg.n_layers)]
        self._prefix_cache = None
        if prefix_cache:
            from .prefix_cache import PrefixCache
            self._prefix_cache = PrefixCache(self.allocator, self.block_len)
        self.draft_tokens = int(draft_tokens)
        if self.draft_tokens < 0:
            raise ValueError(f"draft_tokens={draft_tokens}")
        if self.draft_tokens > 0 and temperature is not None and temperature > 0.0:
            raise ValueError(
                "speculative decoding is greedy-only (the acceptance rule "
                "compares argmaxes); temperature > 0 would break the "
                "token-identity guarantee — set draft_tokens=0 to sample")
        self.draft_layers = None
        self._drafter = None
        self._draft_model = None
        if self.draft_tokens > 0:
            if drafter is not None:
                # a small model drafts over a dense left-aligned context
                # window (no second page pool; the window only affects draft
                # quality, never correctness: the full model verifies)
                if drafter.cfg.max_len < self.max_len:
                    raise ValueError(
                        f"drafter max_len={drafter.cfg.max_len} cannot position-"
                        f"encode the engine horizon max_len={self.max_len}")
                self._drafter = self._draft_model = drafter
                self._draft_window = self.bucketer.seq_bucket_for(
                    min(64, self.max_len), cap=self.max_len)
            else:
                # self-draft: early exit at draft_layers over the same
                # weights and the first layers' pools
                E = draft_layers if draft_layers is not None else max(1, cfg.n_layers // 2)
                if not 1 <= E <= cfg.n_layers:
                    raise ValueError(f"draft_layers={E} outside [1, {cfg.n_layers}]")
                self.draft_layers = int(E)
                self._draft_model = early_exit_model(model, self.draft_layers)
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_steps = 0
        self._spec_fallbacks = 0
        self._lock = threading.RLock()
        self._waiting: deque[SequenceState] = deque()
        self._active: list[SequenceState] = []
        self._uid = 0
        self._freed_since_admit = 0  # finish/preempt -> refill accounting
        self._released = False
        self._progress_ticks = 0  # engine-wide: any token emitted or sequence finished

    # ------------------------------------------------------------------
    # callables (CompiledCache is the only door)
    # ------------------------------------------------------------------
    def _cfg_key(self) -> tuple:
        return (self.temperature, self.top_k, self.top_p, self.block_len)

    def _to_device(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Host int arrays -> int64 tensors on the engine's device, in one
        copy."""
        flat = np.concatenate([np.asarray(a, np.int64).ravel() for a in arrays])
        dev = torch.from_numpy(flat).to(self.device)
        out, at = [], 0
        for a in arrays:
            out.append(dev[at:at + a.size].view(a.shape))
            at += a.size
        return out

    def _selector(self) -> Callable:
        """Per-row selector ``[S,V] logits, [S] uids, [S] steps (host) ->
        [S] ids``: row i draws with key ``fold_in(fold_in(seed, uid),
        step)``, so each request's stream is a pure function of (seed, uid)."""
        base = _make_selector(self.temperature, self.top_k, self.top_p)
        if self.temperature is None or self.temperature <= 0.0:
            return lambda logits, uids, steps: base(logits, 0)

        def select(logits, uids, steps):
            return torch.cat([base(logits[i:i + 1], fold_in(fold_in(self.seed, int(u)), int(s)))
                              for i, (u, s) in enumerate(zip(uids, steps))])
        return select

    def _prefill_fn(self, B: int, P: int) -> Callable:
        def _build():
            model, bl, select = self.model, self.block_len, self._selector()

            def fn(ids, mask, tables, uids, steps):
                ids, mask, tables = self._to_device(ids, mask, tables)
                logits = paged_prefill(model, bl, ids, mask, tables, self._k_pages,
                                       self._v_pages)
                return select(logits, uids, steps)
            return fn

        return cb.get_compiled_cache().get(
            f"{self._fn_prefix}_prefill", (B, P, self.max_blocks) + self._cfg_key(), _build,
            instance=self._instance, dtype="int32")

    def _decode_fn(self, S: int) -> Callable:
        def _build():
            model, bl, select = self.model, self.block_len, self._selector()

            def fn(tokens, seq_lens, active, tables, uids, steps):
                tokens, seq_lens, active, tables = self._to_device(tokens, seq_lens, active,
                                                                   tables)
                logits = paged_decode_step(model, bl, tokens, seq_lens, active, tables,
                                           self._k_pages, self._v_pages)
                return select(logits, uids, steps)
            return fn

        return cb.get_compiled_cache().get(
            f"{self._fn_prefix}_decode", (S, self.max_blocks) + self._cfg_key(), _build,
            instance=self._instance, dtype="int32")

    def _extend_fn(self, B: int, Q: int) -> Callable:
        """Suffix prefill over a cached prefix: copies each row's divergence
        block (``cow_dst`` < 0 = no copy) to its private page, then
        prefills only the uncached suffix with decode-mode attention over
        the pooled prefix."""
        def _build():
            model, bl, select = self.model, self.block_len, self._selector()

            def fn(ids, mask, start_pos, tables, cow_src, cow_dst, uids, steps):
                rows = np.nonzero(cow_dst >= 0)[0]
                ids, mask, start_pos, tables, src, dst = self._to_device(
                    ids, mask, start_pos, tables, cow_src[rows], cow_dst[rows])
                if len(rows):
                    for pages in self._k_pages + self._v_pages:
                        pages[dst] = pages[src]
                logits = paged_extend(model, bl, ids, mask, start_pos, tables,
                                      self._k_pages, self._v_pages)
                return select(logits, uids, steps)
            return fn

        return cb.get_compiled_cache().get(
            f"{self._fn_prefix}_extend", (B, Q, self.max_blocks) + self._cfg_key(), _build,
            instance=self._instance, dtype="int32")

    def _spec_fn(self, S: int) -> Callable:
        """Fused greedy draft + verify: K single-token draft steps (early
        exit over the first layers' pools, or the dense windowed drafter)
        then one K+1-token verify forward of the full model. Returns
        ``(pred [S,K+1], n_accepted [S])``; the emitted tokens are
        ``pred[:, :n_accepted+1]``: a draft survives only where the full
        model's argmax agrees, and the first disagreement emits the full
        model's own token."""
        K = self.draft_tokens

        def _build():
            model, bl, draft = self.model, self.block_len, self._draft_model

            def accept(window, logits):
                pred = torch.argmax(logits, dim=-1)
                match = (pred[:, :K] == window[:, 1:]).long()
                return pred, torch.cumprod(match, dim=1).sum(dim=1)

            if self._drafter is not None:
                W = self._draft_window

                def fn(last_tok, seq_lens, active, tables, win, pos, L0):
                    last_tok, seq_lens, active, tables, win, pos, L0 = self._to_device(
                        last_tok, seq_lens, active, tables, win, pos, L0)
                    rows = torch.arange(last_tok.shape[0], device=last_tok.device)
                    wm = (torch.arange(W, device=win.device)[None, :] < L0[:, None]).long()
                    drafts = []
                    with torch.no_grad():
                        for j in range(K):
                            logits = draft(win, positions=pos, attention_mask=wm)
                            last = logits[rows, (L0 + j - 1).clamp_min(0)]
                            d = torch.argmax(last, dim=-1)
                            drafts.append(d)
                            win[rows, L0 + j] = d
                            wm[rows, L0 + j] = 1
                    window = torch.stack([last_tok] + drafts, dim=1)
                    logits = paged_verify(model, bl, window, seq_lens, active, tables,
                                          self._k_pages, self._v_pages)
                    return accept(window, logits)
                return fn

            def fn(last_tok, seq_lens, active, tables):
                last_tok, seq_lens, active, tables = self._to_device(
                    last_tok, seq_lens, active, tables)
                drafts, d = [], last_tok
                for j in range(K):
                    logits = paged_decode_step(draft, bl, d, seq_lens + j, active, tables,
                                               self._k_pages, self._v_pages)
                    d = torch.argmax(logits, dim=-1)
                    drafts.append(d)
                window = torch.stack([last_tok] + drafts, dim=1)
                logits = paged_verify(model, bl, window, seq_lens, active, tables,
                                      self._k_pages, self._v_pages)
                return accept(window, logits)
            return fn

        mode = (("ext", self._draft_window) if self._drafter is not None
                else ("self", self.draft_layers))
        return cb.get_compiled_cache().get(
            f"{self._fn_prefix}_spec", (S, self.max_blocks, K) + mode + self._cfg_key(),
            _build, instance=self._instance, dtype="int32")

    # ------------------------------------------------------------------
    # scheduling surface
    # ------------------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int,
               request_id: str | None = None, stream: bool = False,
               uid: int | None = None, deadline: float | None = None,
               journal_key: str | None = None) -> SequenceState:
        """Queue a tokenized prompt. ``uid`` seeds the sequence's sampling
        stream (auto-assigned when None); ``deadline`` is a
        ``time.perf_counter()`` instant past which the sequence expires with
        ``finish_reason='deadline'``."""
        prompt_ids = [int(t) for t in prompt_ids]
        if not prompt_ids:
            raise ValueError("empty prompt")
        if len(prompt_ids) >= self.max_len:
            raise ValueError(f"prompt ({len(prompt_ids)} tokens) must leave "
                             f"room to generate under max_len={self.max_len}")
        # the engine horizon caps generation (finish_reason 'length')
        max_new = max(1, min(int(max_new_tokens), self.max_len - len(prompt_ids)))
        with self._lock:
            if uid is None:
                self._uid += 1
                uid = self._uid
            seq = SequenceState(uid=int(uid), prompt_ids=prompt_ids,
                                max_new_tokens=max_new, request_id=request_id,
                                stream=stream, deadline=deadline,
                                journal_key=journal_key)
            self._waiting.append(seq)
        return seq

    @property
    def prefix_cache(self):
        """The engine's :class:`~.prefix_cache.PrefixCache`, or None."""
        return self._prefix_cache

    @property
    def active_count(self) -> int:
        return len(self._active)

    @property
    def waiting_count(self) -> int:
        return len(self._waiting)

    def has_work(self) -> bool:
        return bool(self._active or self._waiting)

    def _blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.block_len)

    def _reclaim(self, n: int) -> None:
        """Make room for ``n`` blocks by evicting cold prefix-cache entries
        (cheaper than preempting a live sequence)."""
        if self._prefix_cache is not None and self.allocator.free_count < n:
            self._prefix_cache.evict(n - self.allocator.free_count)

    def _register_blocks(self, seq: SequenceState) -> None:
        """Chain-hash every newly filled block of committed tokens into the
        prefix cache. Full blocks are immutable from here on (writes only
        target positions >= ``tokens_in_pages``)."""
        pc = self._prefix_cache
        if pc is None:
            return
        bl = self.block_len
        n_full = min(seq.tokens_in_pages // bl, len(seq.blocks))
        if n_full <= seq.registered_blocks:
            return
        ctx = seq.context_ids
        h = seq.prefix_digest
        for i in range(seq.registered_blocks, n_full):
            h = pc.insert(h, ctx[i * bl:(i + 1) * bl], seq.blocks[i])
        seq.registered_blocks = n_full
        seq.prefix_digest = h

    def _update_pool_gauges(self) -> None:
        m = _ENGINE_METRICS.get()
        cap = self.allocator.capacity
        used = self.allocator.used_count
        m["occupancy"].labels().set(used / cap if cap else 0.0)
        live_tokens = sum(s.tokens_in_pages for s in self._active)
        alloc_tokens = used * self.block_len
        m["fragmentation"].labels().set(
            (alloc_tokens - live_tokens) / alloc_tokens if alloc_tokens else 0.0)

    def _finish(self, seq: SequenceState, reason: str) -> None:
        self._progress_ticks += 1
        seq.finish_reason = reason
        if seq.blocks:
            self.allocator.free(seq.blocks)
            seq.blocks = []
        if seq in self._active:
            self._active.remove(seq)
            self._freed_since_admit += 1
        _ENGINE_METRICS.get()["finished"].inc(reason=reason)
        self._update_pool_gauges()

    def _emit(self, seq: SequenceState, token: int) -> dict:
        self._progress_ticks += 1
        now = time.perf_counter()
        m = _ENGINE_METRICS.get()
        if seq.first_token_at is None:
            seq.first_token_at = now
            m["ttft_ms"].labels().observe((now - seq.submitted_at) * 1e3)
        done = False
        if self.eos_id is not None and token == self.eos_id:
            done, reason = True, "eos"
        elif len(seq.generated) >= seq.max_new_tokens:
            done, reason = True, "length"
        if done:
            self._finish(seq, reason)
        # "index": the token's 0-based position in the generation (exact
        # when one speculative step emits several tokens)
        return {"seq": seq, "token": int(token), "done": done,
                "index": len(seq.generated) - 1, "finish_reason": seq.finish_reason}

    def _check_live(self) -> None:
        if self._released:
            raise RuntimeError("this PagedDecodeEngine was released; build a new one")

    def admit(self) -> list[dict]:
        """Prefill waiting sequences into free capacity, up to
        ``prefill_batch`` a call, prompts padded to one seq-ladder bucket.
        With the prefix cache on, each candidate first looks up its longest
        cached full-block chain: shared blocks are referenced (never
        written), only fresh blocks are allocated, and the sequence takes
        the extend callable (prefill over the uncached suffix). A
        fully-cached prompt copies its divergence block, so the mandatory
        last-token recompute writes a private page."""
        self._check_live()
        events: list[dict] = self.expire_deadlines()
        with self._lock:
            while self._waiting and len(self._active) < self.max_slots:
                group: list[tuple[SequenceState, int, int]] = []  # (seq, reuse, cow_src)
                while (self._waiting and len(group) < self.prefill_batch
                       and len(self._active) + len(group) < self.max_slots):
                    seq = self._waiting[0]
                    ctx = seq.context_ids
                    need = self._blocks_for(len(ctx))
                    if need > self.allocator.capacity:
                        # no amount of freeing can satisfy it: finish it
                        # rather than wedge the queue's head
                        self._waiting.popleft()
                        self._finish(seq, "kv_capacity")
                        events.append({"seq": seq, "token": None, "done": True,
                                       "finish_reason": "kv_capacity"})
                        continue
                    shared: list[int] = []
                    digests: list[bytes] = []
                    reuse, cow_src = 0, -1
                    if self._prefix_cache is not None:
                        cblocks, digests = self._prefix_cache.lookup(ctx)
                        # whole blocks, and always >= 1 suffix token to
                        # prefill (its logits give the first token)
                        reuse = min(len(cblocks) * self.block_len, len(ctx) - 1)
                        n_shared = reuse // self.block_len
                        if reuse % self.block_len:
                            # fully-cached prompt: copy the divergence block
                            cow_src = cblocks[n_shared]
                        shared = cblocks[:n_shared]
                        # pin before any eviction can run (a reclaim could
                        # otherwise hand these very blocks back as fresh
                        # suffix pages); cow_src stays pinned until the
                        # extend call has copied it
                        for b in shared:
                            self.allocator.ref(b)
                        if cow_src >= 0:
                            self.allocator.ref(cow_src)
                    need_new = need - len(shared)
                    self._reclaim(need_new)
                    got = self.allocator.alloc(need_new)
                    if got is None:
                        for b in shared:  # unpin: the seq stays waiting
                            self.allocator.free([b])
                        if cow_src >= 0:
                            self.allocator.free([cow_src])
                        break  # pool dry: decode must free pages first
                    self._waiting.popleft()
                    seq.blocks = shared + got
                    seq.registered_blocks = len(shared)
                    seq.prefix_digest = digests[len(shared) - 1] if shared else b""
                    if reuse and self._prefix_cache is not None:
                        self._prefix_cache.note_reused(reuse)
                    group.append((seq, reuse, cow_src))
                if not group:
                    break
                plain = [g for g in group if g[1] == 0]
                hits = [g for g in group if g[1] > 0]
                B = self.prefill_batch
                m = _ENGINE_METRICS.get()
                admitted: list[tuple[SequenceState, int]] = []
                if plain:
                    t0 = time.perf_counter()
                    P = self.bucketer.seq_bucket_for(
                        max(len(s.context_ids) for s, _, _ in plain), cap=self.max_len)
                    ids = np.zeros((B, P), np.int64)
                    mask = np.zeros((B, P), np.int64)
                    tables = np.zeros((B, self.max_blocks), np.int64)
                    uids = np.zeros((B,), np.int64)
                    steps = np.zeros((B,), np.int64)
                    for i, (seq, _, _) in enumerate(plain):
                        ctx = seq.context_ids
                        ids[i, :len(ctx)] = ctx
                        mask[i, :len(ctx)] = 1
                        tables[i, :len(seq.blocks)] = seq.blocks
                        uids[i] = seq.uid
                        steps[i] = len(seq.generated)
                    next_tok = self._prefill_fn(B, P)(ids, mask, tables, uids, steps).cpu()
                    m["step_ms"].observe((time.perf_counter() - t0) * 1e3, phase="prefill")
                    admitted += [(seq, int(next_tok[i])) for i, (seq, _, _) in enumerate(plain)]
                if hits:
                    t0 = time.perf_counter()
                    Q = self.bucketer.seq_bucket_for(
                        max(len(s.context_ids) - r for s, r, _ in hits), cap=self.max_len)
                    ids = np.zeros((B, Q), np.int64)
                    mask = np.zeros((B, Q), np.int64)
                    start = np.zeros((B,), np.int64)
                    tables = np.zeros((B, self.max_blocks), np.int64)
                    cow_src = np.full((B,), -1, np.int64)
                    cow_dst = np.full((B,), -1, np.int64)
                    uids = np.zeros((B,), np.int64)
                    steps = np.zeros((B,), np.int64)
                    for i, (seq, r, cs) in enumerate(hits):
                        suffix = seq.context_ids[r:]
                        ids[i, :len(suffix)] = suffix
                        mask[i, :len(suffix)] = 1
                        start[i] = r
                        tables[i, :len(seq.blocks)] = seq.blocks
                        if cs >= 0:
                            cow_src[i] = cs
                            cow_dst[i] = seq.blocks[r // self.block_len]
                        uids[i] = seq.uid
                        steps[i] = len(seq.generated)
                    next_tok = self._extend_fn(B, Q)(ids, mask, start, tables, cow_src,
                                                     cow_dst, uids, steps).cpu()
                    m["step_ms"].observe((time.perf_counter() - t0) * 1e3, phase="prefill")
                    for i, (seq, _, cs) in enumerate(hits):
                        if cs >= 0:
                            # the divergence-block copy is done: unpin it
                            self.allocator.free([cs])
                        admitted.append((seq, int(next_tok[i])))
                m["tokens"].inc(len(admitted), phase="prefill")
                for seq, tok in admitted:
                    seq.tokens_in_pages = len(seq.context_ids)
                    seq.generated.append(tok)
                    self._active.append(seq)
                    if self._freed_since_admit > 0:
                        self._freed_since_admit -= 1
                        m["refilled"].inc()
                    events.append(self._emit(seq, tok))
                    if not seq.done:
                        self._register_blocks(seq)
                self._update_pool_gauges()
        return events

    def _preempt_youngest(self, keep: SequenceState) -> bool:
        """Free the most recently admitted active sequence (other than
        ``keep``) back to the waiting queue; its next prefill recomputes
        prompt + generated (token-identical under greedy)."""
        for victim in reversed(self._active):
            if victim is keep:
                continue
            self._active.remove(victim)
            self.allocator.free(victim.blocks)
            victim.blocks = []
            victim.tokens_in_pages = 0
            victim.registered_blocks = 0
            victim.prefix_digest = b""
            victim.preemptions += 1
            self._waiting.appendleft(victim)
            self._freed_since_admit += 1
            _ENGINE_METRICS.get()["preempted"].inc()
            return True
        return False

    def _try_spec_step(self, events: list[dict]) -> bool:
        """One fused draft + verify step for every active sequence (caller
        holds the lock). False tells :meth:`step` to run the plain
        single-token callable: a K+1-token window would cross ``max_len``,
        or the pool cannot cover it even after prefix-cache eviction."""
        K = self.draft_tokens
        batch = [s for s in self._active if not s.done]
        if not batch:
            return True
        if any(s.tokens_in_pages + K >= self.max_len for s in batch):
            return False
        # grow tables over the whole window (cache eviction only, no preemption)
        for seq in batch:
            grow = (seq.tokens_in_pages + K) // self.block_len + 1 - len(seq.blocks)
            if grow <= 0:
                continue
            self._reclaim(grow)
            got = self.allocator.alloc(grow)
            if got is None:
                return False
            seq.blocks.extend(got)
        t0 = time.perf_counter()
        S_active = len(batch)
        S = next(r for r in self.slot_rungs if r >= S_active)
        last_tok = np.zeros((S,), np.int64)
        seq_lens = np.zeros((S,), np.int64)
        active = np.zeros((S,), np.int64)
        tables = np.zeros((S, self.max_blocks), np.int64)
        for i, seq in enumerate(batch):
            last_tok[i] = seq.generated[-1]
            seq_lens[i] = seq.tokens_in_pages
            active[i] = 1
            tables[i, :len(seq.blocks)] = seq.blocks
        fn = self._spec_fn(S)
        if self._drafter is not None:
            W = self._draft_window
            win = np.zeros((S, W), np.int64)
            pos = np.zeros((S, W), np.int64)
            L0 = np.zeros((S,), np.int64)
            for i, seq in enumerate(batch):
                ctx = seq.context_ids
                L = min(len(ctx), W - K)
                win[i, :L] = ctx[-L:]
                pos[i, :] = (len(ctx) - L) + np.arange(W)
                L0[i] = L
            pred, n_acc = fn(last_tok, seq_lens, active, tables, win, pos, L0)
        else:
            pred, n_acc = fn(last_tok, seq_lens, active, tables)
        pred, n_acc = pred.cpu().numpy(), n_acc.cpu().numpy()
        m = _ENGINE_METRICS.get()
        dt_ms = (time.perf_counter() - t0) * 1e3
        m["step_ms"].observe(dt_ms, phase="decode")
        emitted = 0
        for i, seq in enumerate(batch):
            a = int(n_acc[i])
            self._spec_proposed += K
            self._spec_accepted += a
            for t in range(a + 1):
                tok = int(pred[i, t])
                seq.tokens_in_pages += 1
                seq.generated.append(tok)
                emitted += 1
                ev = self._emit(seq, tok)
                events.append(ev)
                if ev["done"]:
                    break  # EOS/length inside the window: drop the tail
            if not seq.done:
                self._register_blocks(seq)
        self._spec_steps += 1
        m["spec_steps"].inc(mode="spec")
        m["spec_proposed"].inc(K * S_active)
        m["spec_accepted"].inc(int(n_acc[:S_active].sum()))
        if self._spec_proposed:
            m["spec_accept_rate"].labels().set(self._spec_accepted / self._spec_proposed)
        m["token_ms"].labels().observe(dt_ms / max(emitted, 1))
        m["tokens"].inc(emitted, phase="decode")
        self._update_pool_gauges()
        return True

    def step(self) -> list[dict]:
        """One decode step for every active sequence (bucketed slot count);
        returns per-sequence token events. Finished sequences free their
        pages at once. With ``draft_tokens`` > 0 the step runs the fused
        draft + verify callable (up to ``draft_tokens`` + 1 tokens a
        sequence), falling back to the single-token one when the pool or
        the horizon cannot take a full window."""
        self._check_live()
        events: list[dict] = self.expire_deadlines()
        with self._lock:
            if not self._active:
                return events
            if self.draft_tokens > 0 and self._try_spec_step(events):
                return events
            # grow block tables where the next token crosses a page boundary
            for seq in list(self._active):
                if seq.done or seq not in self._active:
                    continue  # preempted/finished by an earlier iteration
                if seq.tokens_in_pages // self.block_len >= len(seq.blocks):
                    self._reclaim(1)
                    grown = self.allocator.alloc(1)
                    while grown is None:
                        if not self._preempt_youngest(keep=seq):
                            # a lone sequence exhausted the whole pool
                            self._finish(seq, "kv_capacity")
                            events.append({"seq": seq, "token": None, "done": True,
                                           "finish_reason": "kv_capacity"})
                            break
                        grown = self.allocator.alloc(1)
                    if grown is not None:
                        seq.blocks.extend(grown)
            batch = list(self._active)
            if not batch:
                return events
            t0 = time.perf_counter()
            S_active = len(batch)
            S = next(r for r in self.slot_rungs if r >= S_active)
            tokens = np.zeros((S,), np.int64)
            seq_lens = np.zeros((S,), np.int64)
            active = np.zeros((S,), np.int64)
            tables = np.zeros((S, self.max_blocks), np.int64)
            uids = np.zeros((S,), np.int64)
            steps = np.zeros((S,), np.int64)
            for i, seq in enumerate(batch):
                tokens[i] = seq.generated[-1]
                seq_lens[i] = seq.tokens_in_pages
                active[i] = 1
                tables[i, :len(seq.blocks)] = seq.blocks
                uids[i] = seq.uid
                steps[i] = len(seq.generated)
            next_tok = self._decode_fn(S)(tokens, seq_lens, active, tables, uids,
                                          steps).cpu().numpy()
            m = _ENGINE_METRICS.get()
            dt_ms = (time.perf_counter() - t0) * 1e3
            m["step_ms"].observe(dt_ms, phase="decode")
            m["token_ms"].labels().observe(dt_ms / max(S_active, 1))
            m["tokens"].inc(S_active, phase="decode")
            if self.draft_tokens > 0:
                self._spec_fallbacks += 1
                m["spec_steps"].inc(mode="fallback")
            for i, seq in enumerate(batch):
                seq.tokens_in_pages += 1
                seq.generated.append(int(next_tok[i]))
                events.append(self._emit(seq, int(next_tok[i])))
                if not seq.done:
                    self._register_blocks(seq)
            self._update_pool_gauges()
        return events

    # ------------------------------------------------------------------
    # offline generation loop + warmup
    # ------------------------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens,
                 uids: Sequence[int] | None = None) -> list[list[int]]:
        """Run tokenized prompts to completion through the continuous
        scheduler; returns generated ids per prompt (EOS kept as the final
        token when hit). ``max_new_tokens`` is an int or one a prompt."""
        if isinstance(max_new_tokens, (int, np.integer)):
            max_new_tokens = [int(max_new_tokens)] * len(prompts)
        seqs = [self.submit(p, n, uid=None if uids is None else int(u))
                for p, n, u in zip(prompts, max_new_tokens,
                                   uids if uids is not None else range(len(prompts)))]
        # progress is the engine's tick counter, not this caller's events:
        # another thread driving the same engine may do the work
        last, idle = -1, 0
        while any(not s.done for s in seqs):
            self.admit()
            self.step()
            now = self._progress_ticks
            if now == last:
                idle += 1
                if idle > 2000:
                    stuck = [s.uid for s in seqs if not s.done]
                    raise RuntimeError(
                        f"paged engine stalled with sequences {stuck} unfinished "
                        f"(pool too small for a single sequence?)")
                if idle > 10:
                    time.sleep(0.001)  # another thread holds the work
            else:
                last, idle = now, 0
        return [list(s.generated) for s in seqs]

    def warmup(self, prompt_lens: Sequence[int] | None = None,
               slot_counts: Sequence[int] | None = None) -> int:
        """Take every prefill rung (seq ladder up to ``max_len``) and decode
        rung (slot ladder) from the cache and run each once over all-trash
        block tables, so every write lands on the reserved page and live
        sequences are untouched. Returns the number of callables run."""
        self._check_live()
        if prompt_lens is None:
            prompt_lens = self.bucketer.seq_buckets_upto(self.max_len)
        if slot_counts is None:
            slot_counts = self.slot_rungs
        n = 0
        B = self.prefill_batch
        rungs = sorted({self.bucketer.seq_bucket_for(int(p), cap=self.max_len)
                        for p in prompt_lens})
        zb = np.zeros((B,), np.int64)
        with self._lock:
            for P in rungs:
                mask = np.zeros((B, P), np.int64)
                mask[:, 0] = 1
                self._prefill_fn(B, P)(np.zeros((B, P), np.int64), mask,
                                       np.zeros((B, self.max_blocks), np.int64), zb, zb)
                n += 1
            if self._prefix_cache is not None:
                for Q in rungs:
                    mask = np.zeros((B, Q), np.int64)
                    mask[:, 0] = 1
                    none = np.full((B,), -1, np.int64)
                    self._extend_fn(B, Q)(np.zeros((B, Q), np.int64), mask, zb,
                                          np.zeros((B, self.max_blocks), np.int64),
                                          none, none, zb, zb)
                    n += 1
            for S in sorted({int(s) for s in slot_counts}):
                zs = np.zeros((S,), np.int64)
                tables = np.zeros((S, self.max_blocks), np.int64)
                self._decode_fn(S)(zs, zs, zs, tables, zs, zs)
                n += 1
                if self.draft_tokens > 0:
                    if self._drafter is not None:
                        zw = np.zeros((S, self._draft_window), np.int64)
                        self._spec_fn(S)(zs, zs, zs, tables, zw, zw, zs)
                    else:
                        self._spec_fn(S)(zs, zs, zs, tables)
                    n += 1
        return n

    # ------------------------------------------------------------------
    # sequence migration (live drain / crash handoff)
    # ------------------------------------------------------------------
    def model_digest(self) -> str:
        """sha256 over the model's state_dict (names, shapes, dtypes, bytes)
        and the generation knobs (sampling config, seed, eos): two engines
        with equal digests emit identical streams for the same ``(uid,
        prompt, generated)``, which :meth:`import_sequence` needs to resume
        without recompute. Computed once per engine."""
        if getattr(self, "_model_digest_v", None) is None:
            h = hashlib.sha256()
            for name, t in sorted(self.model.state_dict().items()):
                h.update(name.encode())
                h.update(repr((tuple(t.shape), _dtype_name(t.dtype))).encode())
                h.update(_raw_bytes(t).tobytes())
            h.update(repr((self.temperature, self.top_k, self.top_p,
                           self.seed, self.eos_id)).encode())
            self._model_digest_v = h.hexdigest()
        return self._model_digest_v

    def export_sequence(self, uid: int) -> dict | None:
        """Snapshot one live (active or waiting) sequence and remove it from
        this engine (pages freed, finish reason ``'migrated'``); None for an
        unknown or finished uid. ``{"manifest": <JSON-able>, "payload":
        <npz bytes>, "digests": {"payload": <sha256 hex>}}``: the manifest
        holds the host state and, per layer, ``kv/{k,v}/NNN`` -> ``{"shape",
        "dtype", "parts": [{"key", "start", "stop"}]}``, one part a page of
        TOKEN rows (so an engine with another ``block_len`` can take it)."""
        with self._lock:
            seq = next((s for s in self._active if s.uid == int(uid)), None)
            was_waiting = False
            if seq is None:
                seq = next((s for s in self._waiting if s.uid == int(uid)), None)
                if seq is None:
                    return None
                was_waiting = True
            T = 0 if was_waiting else int(seq.tokens_in_pages)
            manifest: dict = {
                "version": 1,
                "uid": int(seq.uid),
                "prompt_ids": [int(t) for t in seq.prompt_ids],
                "generated": [int(t) for t in seq.generated],
                "max_new_tokens": int(seq.max_new_tokens),
                "request_id": seq.request_id,
                "stream": bool(seq.stream),
                "preemptions": int(seq.preemptions),
                "tokens_in_pages": T,
                "journal_key": seq.journal_key,
                # deadlines are perf_counter instants: ship the budget left
                "deadline_ms_left": (None if seq.deadline is None
                                     else (seq.deadline - time.perf_counter()) * 1e3),
                "sampling": {"temperature": self.temperature, "top_k": self.top_k,
                             "top_p": self.top_p, "seed": self.seed,
                             "eos_id": self.eos_id},
                "model_digest": self.model_digest(),
                "chunks": {},
            }
            payload: dict[str, np.ndarray] = {}
            if T > 0:
                rows = torch.as_tensor(seq.blocks, device=self.device)
                for axis, pool in (("k", self._k_pages), ("v", self._v_pages)):
                    for L, pages in enumerate(pool):
                        name = f"kv/{axis}/{L:03d}"
                        kvh, hd = int(pages.shape[2]), int(pages.shape[3])
                        flat = pages[rows].reshape(-1, kvh, hd)[:T]
                        parts = []
                        for k in range(len(seq.blocks)):
                            start = k * self.block_len
                            stop = min(start + self.block_len, T)
                            if start >= stop:
                                break
                            key = f"c:{name}#{k}"
                            payload[key] = _npz_safe(flat[start:stop])
                            parts.append({"key": key, "start": [start, 0, 0],
                                          "stop": [stop, kvh, hd]})
                        manifest["chunks"][name] = {"shape": [T, kvh, hd],
                                                    "dtype": _dtype_name(flat.dtype),
                                                    "parts": parts}
            buf = io.BytesIO()
            np.savez(buf, **payload)
            blob = buf.getvalue()
            if was_waiting:
                self._waiting.remove(seq)
            self._finish(seq, "migrated")
            return {"manifest": manifest, "payload": blob,
                    "digests": {"payload": hashlib.sha256(blob).hexdigest()}}

    def import_sequence(self, snapshot: dict) -> SequenceState:
        """Readmit an exported sequence. Fast path: the model digest and the
        payload's sha256 match, pages are allocated and the KV chunks
        written in, and decode resumes with no recompute. On a digest or
        sidecar mismatch, torn chunks, slot pressure or page exhaustion:
        re-prefill over prompt + generated (token-identical under greedy).
        Either way the next ``admit()``/``step()`` emits only new tokens."""
        man = snapshot["manifest"]
        blob = snapshot.get("payload") or b""
        want = (snapshot.get("digests") or {}).get("payload")
        # a crash resume carries no digest: it re-prefills whatever this
        # engine's digest is, so the digest (a hash over every weight, seconds
        # at 7B width, on the serve loop) is not computed for it
        intact = man.get("model_digest") is not None \
            and man["model_digest"] == self.model_digest()
        if intact and want is not None and hashlib.sha256(blob).hexdigest() != want:
            intact = False  # torn payload: recompute, never decode garbage
        T = int(man.get("tokens_in_pages") or 0)
        left = man.get("deadline_ms_left")
        seq = SequenceState(
            uid=int(man["uid"]),
            prompt_ids=[int(t) for t in man["prompt_ids"]],
            max_new_tokens=int(man["max_new_tokens"]),
            request_id=man.get("request_id"),
            stream=bool(man.get("stream")),
            generated=[int(t) for t in man.get("generated") or []],
            preemptions=int(man.get("preemptions") or 0),
            journal_key=man.get("journal_key"),
            deadline=None if left is None else time.perf_counter() + float(left) / 1e3)
        if seq.generated:
            seq.first_token_at = time.perf_counter()  # ttft was observed at the origin

        def _fallback():
            seq.tokens_in_pages = 0
            seq.preemptions += 1
            self._waiting.appendleft(seq)
            _ENGINE_METRICS.get()["preempted"].inc()
            return seq

        with self._lock:
            self._uid = max(self._uid, seq.uid)
            # an active sequence's pages hold every context token but the
            # newest generated one (the next decode step's input)
            resumable = (intact and T > 0 and seq.generated
                         and T == len(seq.context_ids) - 1
                         and len(self._active) < self.max_slots and T < self.max_len)
            if not resumable:
                return _fallback()
            n = self._blocks_for(T)
            self._reclaim(n)
            blocks = self.allocator.alloc(n)
            if blocks is None:
                return _fallback()  # import-side page exhaustion
            try:
                data = np.load(io.BytesIO(blob), allow_pickle=False)
                staged = {}
                for axis, pool in (("k", self._k_pages), ("v", self._v_pages)):
                    for L, pages in enumerate(pool):
                        name = f"kv/{axis}/{L:03d}"
                        entry = man["chunks"][name]
                        kvh, hd = int(pages.shape[2]), int(pages.shape[3])
                        dt = _DTYPES[entry["dtype"]]
                        buf = torch.zeros((n * self.block_len, kvh, hd), dtype=dt)
                        for part in entry["parts"]:
                            arr = np.asarray(data[part["key"]])
                            lo, hi = part["start"][0], part["stop"][0]
                            t = (torch.frombuffer(bytearray(arr.tobytes()), dtype=dt)
                                 if arr.dtype == np.uint8 else torch.from_numpy(arr))
                            buf[lo:hi] = t.reshape(hi - lo, kvh, hd)
                        staged[(axis, L)] = buf.view(n, self.block_len, kvh, hd)
            except Exception:
                # a torn or incomplete chunk set: nothing was written yet
                self.allocator.free(blocks)
                return _fallback()
            idx = torch.as_tensor(blocks, device=self.device)
            for (axis, L), buf in staged.items():
                pool = self._k_pages if axis == "k" else self._v_pages
                pool[L][idx] = buf.to(device=self.device, dtype=pool[L].dtype)
            seq.blocks = list(blocks)
            seq.tokens_in_pages = T
            self._active.append(seq)
            self._update_pool_gauges()
            return seq

    def live_sequences(self) -> list[SequenceState]:
        """Every active + waiting sequence (a consistent snapshot)."""
        with self._lock:
            return list(self._active) + list(self._waiting)

    def expire_deadlines(self, now: float | None = None) -> list[dict]:
        """Finish every sequence whose client deadline has passed (pages
        freed, ``finish_reason='deadline'``); returns their terminal events.
        Runs at the top of every :meth:`admit`/:meth:`step`."""
        now = time.perf_counter() if now is None else now
        events: list[dict] = []
        with self._lock:
            doomed = [s for s in self._active if s.deadline is not None and now >= s.deadline]
            doomed += [s for s in self._waiting if s.deadline is not None and now >= s.deadline]
            for seq in doomed:
                if seq in self._waiting:
                    self._waiting.remove(seq)
                self._finish(seq, "deadline")
                events.append({"seq": seq, "token": None, "done": True,
                               "finish_reason": "deadline"})
        return events

    def abort(self, seq: SequenceState, reason: str = "aborted") -> None:
        """Terminate one sequence, freeing its pages and slot at once."""
        with self._lock:
            if not seq.done:
                if seq in self._waiting:
                    self._waiting.remove(seq)
                self._finish(seq, reason)

    def abort_all(self, reason: str = "aborted") -> list[SequenceState]:
        """Terminate every waiting and active sequence, freeing all pages."""
        with self._lock:
            doomed = list(self._active) + list(self._waiting)
            self._waiting.clear()
            for seq in doomed:
                if not seq.done:
                    self._finish(seq, reason)
            return doomed

    def stats(self) -> dict:
        with self._lock:
            cap = self.allocator.capacity
            out = {"active": len(self._active), "waiting": len(self._waiting),
                   "blocks_used": self.allocator.used_count,
                   "blocks_free": self.allocator.free_count,
                   "occupancy": self.allocator.used_count / cap if cap else 0.0}
            if self._prefix_cache is not None:
                pc = self._prefix_cache.stats()
                pc["occupancy"] = pc["blocks"] / cap if cap else 0.0
                out["prefix_cache"] = pc
            if self.draft_tokens > 0:
                out["speculation"] = {
                    "draft_tokens": self.draft_tokens,
                    "proposed": self._spec_proposed,
                    "accepted": self._spec_accepted,
                    "acceptance_rate": (self._spec_accepted / self._spec_proposed
                                        if self._spec_proposed else 0.0),
                    "steps": self._spec_steps,
                    "fallbacks": self._spec_fallbacks}
            return out

    def release(self) -> None:
        """Evict this engine's callables from the shared cache, drop its page
        pool (its device memory) and mark it dead: a released engine is
        never reused (the stage builds a new one)."""
        self._released = True
        self._k_pages, self._v_pages = [], []
        cb.get_compiled_cache().evict_instance(self._instance)
