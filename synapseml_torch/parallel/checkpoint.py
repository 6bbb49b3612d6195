"""Checkpoints and resume: the npz format, coordinated per-rank shards, async writes.

Counterpart of ``synapseml_tpu/parallel/checkpoint.py`` with the same
on-disk layout, so either package reads what the other wrote:

  step_%010d/
    state.npz, state.tree.json   one process's whole tree (save_checkpoint)
    sharding.json                the partition-plane section, when declared
    *.sha256                     a digest sidecar a payload
    DONE                         written last; a step without it is invisible

or, for a coordinated N-rank step, ``state.shardRRRRR-of-NNNNN.{npz,json}``
per rank with an ``ACK`` each and the driver's JSON ``DONE`` (two-phase
commit; :func:`save_checkpoint_shard`, :func:`commit_checkpoint`).
Verification against the sidecars demotes a torn newest step to the
previous verified one (:func:`latest_verified_step`), :func:`gc_checkpoints`
keeps the last K verified steps, and :func:`restore_checkpoint` places each
leaf through a ``sharding_fn`` (a DTensor on this world's mesh, whatever the
world that wrote it).

Leaves are torch tensors (a ``DTensor`` spanning other processes writes
only its local chunks, through the coordinated writer) or numpy arrays.
``use_orbax=True`` names a JAX library; here it selects
``torch.distributed.checkpoint`` (a ``dcp/`` directory beside the tree's
structure JSON), and the port restores what it wrote.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..core import serialization

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "latest_verified_step",
           "verify_checkpoint", "CheckpointCorrupt", "checkpoint_sharding",
           "AsyncCheckpointer", "save_checkpoint_shard", "commit_checkpoint",
           "checkpoint_world", "restore_host_states", "checkpoint_meta", "gc_checkpoints"]

_logger = logging.getLogger("synapseml_torch.parallel.checkpoint")

# serializes the commit write side (sweep + DONE install)
_commit_lock = threading.Lock()

# per-directory verification memo of the save_checkpoint(keep=) path
_gc_memo: dict[str, dict] = {}


class CheckpointCorrupt(RuntimeError):
    """A checkpoint payload failed its sha256 sidecar verification: the
    file is torn or bit-rotted, not merely incomplete."""


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:010d}")


def _spans_processes(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor) and x.device_mesh.size() > 1


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(x, DTensor):
            x = x.to_local()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_host(name: str, x):
    """Host numpy for one leaf. A ``DTensor`` spanning other processes
    cannot be fetched by the single-process writer."""
    if _spans_processes(x):
        raise ValueError(
            f"checkpoint leaf {name!r} is sharded across processes — the single-host npz "
            "writer cannot gather it. Use the coordinated path: every process calls "
            "save_checkpoint_shard(...) (each writes only its local chunks) and the driver "
            "commits via commit_checkpoint(...); restore_checkpoint reassembles the shards "
            "on any number of processes")
    return _numpy(x)


def _host_tree(tree):
    from .partition import tree_map_with_path, tree_path_name

    return tree_map_with_path(lambda p, x: _to_host(tree_path_name(p), x), tree)


def save_checkpoint(path: str, tree: Any, step: int = 0, use_orbax: bool | None = None,
                    sharding: dict | None = None, keep: int | None = None) -> str:
    """Save a tree (params, optimizer state, ...) as ``step_%010d/``:
    leaves fetched to the host first, ``sharding`` written as
    ``sharding.json``, digest sidecars, then ``DONE``. ``keep`` runs
    :func:`gc_checkpoints` after the write."""
    target = _step_dir(path, step)
    os.makedirs(target, exist_ok=True)
    host_tree = _host_tree(tree)
    if use_orbax:
        _save_dcp(os.path.join(target, "dcp"), host_tree)
    else:
        serialization.save_pytree(host_tree, os.path.join(target, "state"))
    if sharding:
        with open(os.path.join(target, "sharding.json"), "w") as f:
            json.dump(sharding, f, indent=2, sort_keys=True)
    if not use_orbax:
        # a sidecar a payload, written before DONE: restore verifies against
        # them and demotes a torn step
        for payload in ("state.npz", "state.tree.json", "sharding.json"):
            _write_digest_sidecar(os.path.join(target, payload))
    with open(os.path.join(target, "DONE"), "w") as f:
        f.write(str(step))
    if keep is not None:
        cache = _gc_memo.setdefault(os.path.abspath(path), {})
        if not use_orbax:
            cache[int(step)] = True
        gc_checkpoints(path, keep, verified_cache=cache)
    return target


def _save_dcp(target: str, host_tree) -> None:
    """The tree through ``torch.distributed.checkpoint`` (one process: no
    process group needed), its structure beside it."""
    import torch.distributed.checkpoint as dcp

    flat = serialization.flatten_pytree(host_tree,
                                        leaf_fn=lambda x: torch.from_numpy(np.array(x)))
    dcp.save(flat, checkpoint_id=target, no_dist=True)
    with open(os.path.join(target, "tree.json"), "w") as f:
        json.dump(serialization.tree_structure(host_tree), f)


def _load_dcp(target: str):
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(target).read_metadata()
    flat = {}
    for name, md in meta.state_dict_metadata.items():
        if isinstance(md, TensorStorageMetadata):
            flat[name] = torch.empty(md.size, dtype=md.properties.dtype)
    dcp.load(flat, checkpoint_id=target, no_dist=True)
    with open(os.path.join(target, "tree.json")) as f:
        structure = json.load(f)
    return serialization.rebuild_pytree(structure, {k: v.numpy() for k, v in flat.items()})


def _sidecar_path(payload_path: str) -> str:
    return payload_path + ".sha256"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_digest_sidecar(payload_path: str) -> None:
    if not os.path.isfile(payload_path):
        return
    with open(_sidecar_path(payload_path), "w") as f:
        f.write(_sha256_file(payload_path))


# ---------------------------------------------------------------------------
# coordinated multi-rank checkpoints (two-phase commit)
# ---------------------------------------------------------------------------
#
#   step_0000000012/
#     state.shard00000-of-00004.npz    rank 0: every whole (replicated) leaf
#     state.shard00000-of-00004.json     and its chunks
#     state.shard00001-of-00004.npz    ranks > 0: their local chunks and
#     ...                                their per-rank payload
#     *.sha256, state.tree.json, sharding.json
#     ACK.00001-of-00004               phase 1: rank i's payload is durable
#     DONE                             phase 2: the driver's commit marker

def _shard_stem(rank: int, world: int) -> str:
    return f"state.shard{rank:05d}-of-{world:05d}"


def _ack_name(rank: int, world: int) -> str:
    return f"ACK.{rank:05d}-of-{world:05d}"


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _Chunks:
    """A leaf's local pieces, taken at snapshot time: ``[(start, stop,
    array)]`` of a global ``shape``/``dtype``."""

    def __init__(self, shape, dtype, chunks):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.chunks = chunks


def _local_chunks(leaf) -> list:
    """The local piece of a ``DTensor`` as ``[(start, stop, np.ndarray)]``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        tuple(leaf.shape), leaf.device_mesh, leaf.placements)
    local = leaf.to_local().detach().cpu().numpy()
    start = [int(o) for o in offset]
    return [(start, [s + n for s, n in zip(start, shape)], local)]


def _dtype_name(leaf) -> str:
    dtype = getattr(leaf, "dtype", np.float32)
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty((), dtype=dtype).numpy().dtype
    return str(np.dtype(dtype))


def save_checkpoint_shard(path: str, tree: Any, step: int, *, process_index: int,
                          process_count: int, host_tree: Any | None = None,
                          sharding: dict | None = None, meta: dict | None = None,
                          chunk_fn=None, run_id: str | None = None) -> str:
    """Phase 1 of a coordinated checkpoint: write THIS process's shard of
    ``tree`` (every process calls it with the same ``step``).

    A leaf spanning other processes (a ``DTensor``, or a snapshot of one)
    contributes only its local chunks; a whole leaf is written by rank 0
    only. ``host_tree`` is per-rank payload (the loader cursor);
    ``meta`` (rank 0) run-level facts; ``chunk_fn(name, leaf) ->
    [(start, stop, array)] | None`` overrides chunk extraction; ``run_id``
    stamps the ACK for the driver's fence. Ends with this rank's ACK; the
    step becomes restorable only after :func:`commit_checkpoint`."""
    if not 0 <= int(process_index) < int(process_count):
        raise ValueError(f"process_index {process_index} outside world {process_count}")
    rank, world = int(process_index), int(process_count)
    target = _step_dir(path, step)
    os.makedirs(target, exist_ok=True)
    stem = _shard_stem(rank, world)
    flat = serialization.flatten_pytree(tree, leaf_fn=lambda x: x)
    payload: dict[str, np.ndarray] = {}
    manifest: dict = {"rank": rank, "world": world, "step": int(step),
                      "globals": [], "chunks": {}, "host": None}
    for name, leaf in flat.items():
        chunks = chunk_fn(name, leaf) if chunk_fn is not None else None
        if chunks is None and isinstance(leaf, _Chunks):
            chunks = leaf.chunks
        elif chunks is None and _spans_processes(leaf):
            chunks = _local_chunks(leaf)
        if chunks is not None:
            parts = []
            for k, (start, stop, arr) in enumerate(chunks):
                key = f"c:{name}#{k}"
                payload[key] = _numpy(arr)
                parts.append({"key": key, "start": [int(x) for x in start],
                              "stop": [int(x) for x in stop]})
            manifest["chunks"][name] = {
                "shape": [int(s) for s in getattr(leaf, "shape", np.shape(leaf))],
                "dtype": _dtype_name(leaf), "parts": parts}
        elif rank == 0:
            payload[f"g:{name}"] = _numpy(leaf)
            manifest["globals"].append(name)
    if host_tree is not None:
        for name, leaf in serialization.flatten_pytree(host_tree).items():
            payload[f"h:{name}"] = leaf
        manifest["host"] = serialization.tree_structure(host_tree)
    if rank == 0 and meta:
        manifest["meta"] = dict(meta)
    written = [stem + ".npz", stem + ".json"]
    np.savez(os.path.join(target, stem + ".npz"), **payload)
    with open(os.path.join(target, stem + ".json"), "w") as f:
        json.dump(manifest, f, sort_keys=True)
    if rank == 0:
        with open(os.path.join(target, "state.tree.json"), "w") as f:
            json.dump(serialization.tree_structure(tree), f)
        written.append("state.tree.json")
        if sharding:
            with open(os.path.join(target, "sharding.json"), "w") as f:
                json.dump(sharding, f, indent=2, sort_keys=True)
            written.append("sharding.json")
    for name in written:
        _fsync_file(os.path.join(target, name))
        _write_digest_sidecar(os.path.join(target, name))
    ack = os.path.join(target, _ack_name(rank, world))
    ack_payload = {"step": int(step), "rank": rank, "files": written}
    if run_id is not None:
        ack_payload["run"] = str(run_id)
    # temp + rename: the driver's scanner may read the ACK at any instant
    tmp = ack + ".tmp"
    with open(tmp, "w") as f:
        json.dump(ack_payload, f)
    _fsync_file(tmp)
    os.replace(tmp, ack)
    return target


def commit_checkpoint(path: str, step: int, process_count: int,
                      run_id: str | None = None) -> str | None:
    """Phase 2 (driver side): with every rank's ACK present (stamped with
    ``run_id`` when given) and every file each lists on disk, sweep what a
    previous incarnation left in the step directory and write ``DONE``.
    Returns the step directory, or None while the set is incomplete."""
    world = int(process_count)
    target = _step_dir(path, step)
    if not os.path.isdir(target):
        return None
    fenced = 0
    acked: set[str] = set()
    for rank in range(world):
        ack = os.path.join(target, _ack_name(rank, world))
        if not os.path.isfile(ack):
            return None
        try:
            with open(ack) as f:
                data = json.load(f)
            listed = data.get("files", [])
        except (OSError, json.JSONDecodeError):
            return None
        if run_id is not None and data.get("run") != str(run_id):
            fenced += 1  # a stale ack of an earlier incarnation
            continue
        if any(not os.path.isfile(os.path.join(target, name)) for name in listed):
            return None
        acked.update(listed)
    if fenced:
        _warn_run_fenced(path, step, fenced, world)
        return None
    done = os.path.join(target, "DONE")
    with _commit_lock:
        if os.path.exists(done):
            return target
        keep = set(acked)
        keep.update(name + ".sha256" for name in acked)
        keep.update(_ack_name(r, world) for r in range(world))
        keep.add("DONE")
        try:
            for name in os.listdir(target):
                if name not in keep:
                    with contextlib.suppress(OSError):
                        os.remove(os.path.join(target, name))
        except OSError:
            pass
        tmp = f"{done}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "world": world}, f)
        _fsync_file(tmp)
        os.replace(tmp, done)
    return target


def _done_world(target: str) -> int | None:
    """The world size a step's DONE records (None: a single-process step)."""
    try:
        with open(os.path.join(target, "DONE")) as f:
            raw = f.read()
    except OSError:
        return None
    try:
        data = json.loads(raw)
    except json.JSONDecodeError:
        return None
    return int(data["world"]) if isinstance(data, dict) and "world" in data else None


def checkpoint_world(path: str, step: int) -> int | None:
    """How many processes wrote a committed step (None = one)."""
    return _done_world(_step_dir(path, step))


def _assemble_sharded(target: str, world: int) -> Any:
    """The global tree from N shard files, on the host (any number of
    readers). Coverage is checked element by element: a chunk set that
    does not tile its leaf is :class:`CheckpointCorrupt`."""
    with open(os.path.join(target, "state.tree.json")) as f:
        structure = json.load(f)
    flat: dict[str, np.ndarray] = {}
    covered: dict[str, np.ndarray] = {}
    for rank in range(world):
        stem = _shard_stem(rank, world)
        with open(os.path.join(target, stem + ".json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(target, stem + ".npz"), allow_pickle=False) as npz:
            for name in manifest.get("globals", ()):
                flat[name] = npz[f"g:{name}"]
            for name, info in manifest.get("chunks", {}).items():
                shape = tuple(int(s) for s in info["shape"])
                if name not in flat:
                    flat[name] = np.empty(shape, dtype=np.dtype(info["dtype"]))
                    covered[name] = np.zeros(shape, dtype=bool)
                for part in info["parts"]:
                    idx = tuple(slice(a, b) for a, b in zip(part["start"], part["stop"]))
                    flat[name][idx] = npz[part["key"]]
                    covered[name][idx] = True
    for name, mask in covered.items():
        if not mask.all():
            raise CheckpointCorrupt(
                f"sharded checkpoint leaf {name!r} assembled {int(np.count_nonzero(mask))} of "
                f"{int(mask.size)} elements from {world} shard(s) — a rank's chunk set is "
                "missing or does not tile the leaf")
    return serialization.rebuild_pytree(structure, flat)


def restore_host_states(path: str, step: int | None = None,
                        verify: bool = True) -> dict[int, Any]:
    """Every rank's per-rank payload of a committed coordinated step,
    ``{rank: tree}``; ``{}`` for a single-process step."""
    if step is None:
        step = latest_verified_step(path) if verify else latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no completed checkpoint under {path}")
        verify = False
    target = _step_dir(path, step)
    world = _done_world(target)
    if world is None:
        return {}
    if verify and not verify_checkpoint(path, step):
        raise CheckpointCorrupt(f"checkpoint step {step} under {path} fails verification")
    out: dict[int, Any] = {}
    for rank in range(world):
        stem = _shard_stem(rank, world)
        with open(os.path.join(target, stem + ".json")) as f:
            manifest = json.load(f)
        if manifest.get("host") is None:
            continue
        with np.load(os.path.join(target, stem + ".npz"), allow_pickle=False) as npz:
            flat = {k[2:]: npz[k] for k in npz.files if k.startswith("h:")}
        out[rank] = serialization.rebuild_pytree(manifest["host"], flat)
    return out


def checkpoint_meta(path: str, step: int | None = None) -> dict:
    """Rank 0's ``meta`` of a committed coordinated step; ``{}`` otherwise."""
    if step is None:
        step = latest_verified_step(path)
        if step is None:
            return {}
    target = _step_dir(path, step)
    world = _done_world(target)
    if world is None:
        return {}
    with open(os.path.join(target, _shard_stem(0, world) + ".json")) as f:
        return json.load(f).get("meta") or {}


def verify_checkpoint(path: str, step: int) -> bool:
    """True iff every payload with a sidecar matches it (payloads without
    one verify vacuously)."""
    target = _step_dir(path, step)
    for name in os.listdir(target) if os.path.isdir(target) else ():
        if not name.endswith(".sha256"):
            continue
        payload = os.path.join(target, name[:-len(".sha256")])
        if not os.path.isfile(payload):
            return False
        with open(os.path.join(target, name)) as f:
            expected = f.read().strip()
        if _sha256_file(payload) != expected:
            return False
    return True


def latest_verified_step(path: str) -> int | None:
    """The newest completed step whose payloads verify; a failing step
    demotes to the previous one with one structured warning."""
    for step in reversed(_completed_steps(path)):
        if verify_checkpoint(path, step):
            return step
        _warn_corrupt(path, step)
    return None


_warned_run_fenced: set = set()


def _warn_run_fenced(path: str, step: int, fenced: int, world: int) -> None:
    key = (os.path.abspath(path), int(step))
    if key in _warned_run_fenced:
        return
    _warned_run_fenced.add(key)
    _logger.warning(json.dumps({
        "event": "checkpoint_commit_run_fenced", "path": path, "step": int(step),
        "fenced_acks": int(fenced), "world": int(world),
        "hint": "ACK run ids do not match this incarnation; pass the rendezvous reply's "
                "run_id to save_checkpoint_shard (transient during a torn relaunch)"}))


_warned_corrupt: set = set()


def _warn_corrupt(path: str, step: int) -> None:
    key = (os.path.abspath(path), int(step))
    if key in _warned_corrupt:
        return
    _warned_corrupt.add(key)
    _logger.warning(json.dumps({
        "event": "checkpoint_verification_failed", "path": path, "step": int(step),
        "action": "demoted to previous completed step"}))


def checkpoint_sharding(path: str, step: int | None = None) -> dict | None:
    """The ``sharding`` section saved with a step (default: the latest
    verified one), or None."""
    if step is None:
        step = latest_verified_step(path)
        if step is None:
            return None
    target = os.path.join(_step_dir(path, step), "sharding.json")
    if not os.path.isfile(target):
        return None
    with open(target) as f:
        return json.load(f)


def _is_complete(target: str) -> bool:
    """DONE and the payload both present; a coordinated step needs every
    rank's ACK and shard too."""
    if not os.path.exists(os.path.join(target, "DONE")):
        return False
    world = _done_world(target)
    if world is not None:
        return all(os.path.isfile(os.path.join(target, _ack_name(r, world)))
                   and os.path.isfile(os.path.join(target, _shard_stem(r, world) + ".npz"))
                   for r in range(world))
    return (os.path.exists(os.path.join(target, "state.npz"))
            or os.path.isdir(os.path.join(target, "dcp")))


def _completed_steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    steps = []
    for d in os.listdir(path):
        if not d.startswith("step_"):
            continue
        try:
            step = int(d.split("_", 1)[1])
        except ValueError:
            continue
        if _is_complete(os.path.join(path, d)):
            steps.append(step)
    return sorted(steps)


def latest_step(path: str) -> int | None:
    steps = _completed_steps(path)
    return steps[-1] if steps else None


def _path_aware(fn) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    required = [p for p in sig.parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty]
    return len(required) >= 2


def restore_checkpoint(path: str, step: int | None = None, sharding_fn=None,
                       verify: bool = True) -> Any:
    """Restore a step (default: the latest verified one), placing leaves as
    they load.

    ``verify`` checks every payload against its sidecar; an explicitly
    requested corrupt step raises :class:`CheckpointCorrupt`.
    ``sharding_fn`` is ``fn(leaf) -> NamedSharding`` or the path-aware
    ``fn(name, leaf) -> NamedSharding | None`` (None keeps the leaf host
    numpy); each leaf becomes a ``DTensor`` on that sharding, made from the
    host value by local splitting."""
    verified_already = False
    if step is None:
        if verify:
            step = latest_verified_step(path)
            verified_already = True
        else:
            step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no completed checkpoint under {path}")
    target = _step_dir(path, step)
    if not _is_complete(target):
        if os.path.isdir(target) and (
                _done_world(target) is not None
                or any(n.startswith(("state.shard", "ACK.")) for n in os.listdir(target))):
            raise CheckpointCorrupt(
                f"checkpoint step {step} under {path} is a torn multi-host write (phase-1 "
                f"shards without a complete commit) — latest completed: {latest_step(path)}")
        raise FileNotFoundError(
            f"checkpoint step {step} under {path} is incomplete (crash during save?) — "
            f"latest completed: {latest_step(path)}")
    if verify and not verified_already and not verify_checkpoint(path, step):
        raise CheckpointCorrupt(
            f"checkpoint step {step} under {path} fails its sha256 sidecar verification "
            f"(torn or bit-rotted payload) — latest verified: {latest_verified_step(path)}")
    world = _done_world(target)
    if world is not None:
        tree = _assemble_sharded(target, world)
    elif os.path.isdir(os.path.join(target, "dcp")):
        tree = _load_dcp(os.path.join(target, "dcp"))
    else:
        tree = serialization.load_pytree(os.path.join(target, "state"))
    if sharding_fn is not None:
        from .partition import place_leaf, tree_map_with_path, tree_path_name

        if _path_aware(sharding_fn):
            def place(path_, x):
                sh = sharding_fn(tree_path_name(path_), x)
                return x if sh is None else place_leaf(x, sh)
        else:
            def place(path_, x):
                return place_leaf(x, sharding_fn(x))

        tree = tree_map_with_path(place, tree)
    return tree


def gc_checkpoints(path: str, keep: int, verified_cache: dict | None = None) -> list[int]:
    """Keep the last ``keep`` verified steps; prune every completed step
    older than the oldest kept, corrupt ones included, and incomplete steps
    older than the newest completed one. The newest verified step and
    anything newer are never touched. Returns the pruned steps."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    done = _completed_steps(path)
    cache = verified_cache if verified_cache is not None else {}

    def _check(step: int) -> bool:
        if step not in cache:
            cache[step] = verify_checkpoint(path, step)
        return cache[step]

    pruned = []
    if done:
        for d in os.listdir(path) if os.path.isdir(path) else ():
            if not d.startswith("step_"):
                continue
            try:
                step = int(d.split("_", 1)[1])
            except ValueError:
                continue
            target = os.path.join(path, d)
            if step < done[-1] and not _is_complete(target):
                shutil.rmtree(target, ignore_errors=True)
                pruned.append(step)
    verified = [s for s in done if _check(s)]
    if not verified:
        return sorted(set(pruned))
    kept = set(verified[-keep:])
    newest_verified = verified[-1]
    for step in done:
        if step >= newest_verified or step in kept:
            continue
        shutil.rmtree(_step_dir(path, step), ignore_errors=True)
        cache.pop(step, None)
        pruned.append(step)
    return sorted(set(pruned))


class _Snapshot:
    """A save's copy of a tree: card leaves copied on the device in stream
    order, then to pinned host memory on a side stream whose event the
    writer waits on; host leaves copied at once."""

    def __init__(self, tree, coordinated: bool):
        from .partition import tree_map_with_path

        self.event = None
        self._side = None
        cuda = []

        def snap(_, x):
            if isinstance(x, torch.Tensor):
                if _spans_processes(x):
                    if not coordinated:
                        return x  # refused by the single-process writer with a clear error
                    from torch.distributed.tensor._utils import \
                        compute_local_shape_and_global_offset

                    shape, offset = compute_local_shape_and_global_offset(
                        tuple(x.shape), x.device_mesh, x.placements)
                    start = [int(o) for o in offset]
                    local = self._copy(x.to_local(), cuda)
                    return _Chunks(x.shape, x.dtype,
                                   [(start, [s + n for s, n in zip(start, shape)], local)])
                from torch.distributed.tensor import DTensor

                return self._copy(x.to_local() if isinstance(x, DTensor) else x, cuda)
            # np.array copies, so the caller may change its buffers at once
            return np.array(x)

        self.tree = tree_map_with_path(snap, tree)
        if cuda:
            side = torch.cuda.Stream(cuda[0].device)
            side.wait_stream(torch.cuda.current_stream(cuda[0].device))
            with torch.cuda.stream(side):
                for holder in cuda:
                    holder.start()
            self.event = torch.cuda.Event()
            self.event.record(side)
            self._side = side

    def _copy(self, t: torch.Tensor, cuda: list):
        t = t.detach()
        if t.device.type != "cuda":
            return t.clone().numpy()
        holder = _PinnedCopy(t.clone())  # in stream order: later in-place steps are after
        cuda.append(holder)
        return holder

    def host(self):
        """The snapshot as numpy (blocks on the side stream's copies)."""
        from .partition import tree_map_with_path

        if self.event is not None:
            self.event.synchronize()

        def fetch(_, x):
            if isinstance(x, _PinnedCopy):
                return x.host.numpy()
            if isinstance(x, _Chunks):
                return _Chunks(x.shape, x.dtype, [
                    (a, b, c.host.numpy() if isinstance(c, _PinnedCopy) else c)
                    for a, b, c in x.chunks])
            return x

        return tree_map_with_path(fetch, self.tree)


class _PinnedCopy:
    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self.device = dev.device
        self.host = None

    def start(self) -> None:
        self.host = torch.empty(self.dev.shape, dtype=self.dev.dtype, pin_memory=True)
        self.host.copy_(self.dev, non_blocking=True)
        self.dev.record_stream(torch.cuda.current_stream(self.device))


def _writer_rank() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class AsyncCheckpointer:
    """Checkpoint writes that overlap with training.

    ``save`` returns once the tree is snapshotted: card tensors are copied
    on the device in stream order (so a step enqueued after ``save``
    returns, a CUDA-graph replay that updates the params in place
    included, cannot tear the snapshot), and the copy to pinned host memory
    runs on a side stream; the serialization, digests and fsync run on one
    background thread, which waits on that copy's event. At most ONE write
    is in flight: a ``save`` while the previous write runs blocks until it
    is done (raising its error). ``keep`` retains the last verified steps.

    With ``process_count > 1`` (or ``coordinated=True``) each save writes
    this process's shard (:func:`save_checkpoint_shard`), the
    ``host_state_key`` subtree moving into the per-rank payload, and the
    driver commits. Otherwise, in a process group of several ranks, rank 0
    writes the whole tree and the others only take part in the snapshot;
    :meth:`close` then waits at a barrier so that every rank sees the last
    step.

    Call ``wait()`` or ``close()`` (or use it as a context manager) before
    reading the checkpoints; the last write's errors surface there.
    """

    def __init__(self, path: str, keep: int = 3, use_orbax: bool = False,
                 sharding: dict | None = None, process_index: int = 0,
                 process_count: int = 1, host_state_key: str = "data_iter",
                 meta: dict | None = None, coordinated: bool | None = None,
                 run_id: str | None = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.path = path
        self.keep = keep
        self.use_orbax = use_orbax
        self.sharding = sharding
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.coordinated = (self.process_count > 1 if coordinated is None
                            else bool(coordinated))
        self.host_state_key = host_state_key
        self.meta = meta
        self.run_id = run_id
        rank, world = _writer_rank()
        self._group_world = world
        self.writes = self.coordinated or rank == 0
        self._verified_cache: dict = {}
        self._exec = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._inflight: concurrent.futures.Future | None = None
        # the last single-process write: bytes on disk and seconds on the
        # writer thread (the wait for the host copy included)
        self.last_write_bytes = 0
        self.last_write_s = 0.0

    def save(self, tree: Any, step: int):
        """Snapshot now, write in the background; returns the Future. Blocks
        first iff the previous write is still running."""
        self.wait()
        snapshot = _Snapshot(tree, self.coordinated)
        if not self.writes:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            fut.set_result(None)
            self._inflight = fut
            return fut
        self._inflight = self._exec.submit(self._write, snapshot, step)
        return self._inflight

    def _write(self, snapshot: _Snapshot, step: int) -> str:
        t0 = time.perf_counter()
        tree = snapshot.host()
        if self.coordinated:
            host_tree = None
            if isinstance(tree, dict) and self.host_state_key in tree:
                tree = dict(tree)
                host_tree = {self.host_state_key: tree.pop(self.host_state_key)}
            return save_checkpoint_shard(
                self.path, tree, step, process_index=self.process_index,
                process_count=self.process_count, host_tree=host_tree,
                sharding=self.sharding, meta=self.meta, run_id=self.run_id)
        target = save_checkpoint(self.path, tree, step, use_orbax=self.use_orbax,
                                 sharding=self.sharding)
        self.last_write_s = time.perf_counter() - t0
        self.last_write_bytes = sum(
            os.path.getsize(os.path.join(target, n)) for n in os.listdir(target)
            if os.path.isfile(os.path.join(target, n)))
        self._verified_cache[int(step)] = True
        gc_checkpoints(self.path, self.keep, verified_cache=self._verified_cache)
        return target

    def wait(self) -> None:
        """Block until the in-flight write finishes; re-raise its error."""
        fut, self._inflight = self._inflight, None
        if fut is not None:
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._exec.shutdown(wait=True)
            if not self.coordinated and self._group_world > 1:
                import torch.distributed as dist

                if dist.is_initialized():
                    dist.barrier()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
