"""Declarative sharding plane: regex partition rules over plain trees.

Counterpart of ``synapseml_tpu/parallel/partition.py``: an ordered table of
``(regex, spec entries)`` rules, matched first-match-wins against each
leaf's slash-joined path name, gives every leaf of any plain tree (a
``state_dict``, an optimizer state, a checkpoint) its placement on the
mesh. Leaf names here are the port's: a ``state_dict`` key keeps its dots
(``encoder.layers.0.attn.q.weight``) and nesting adds slashes
(``opt_state/mu/encoder.layers.0.attn.q.weight``), so one table matches a
parameter and its optimizer moments.

A spec becomes DTensor placements on the mesh (``Shard(d)`` on each mesh dim
an entry names, ``Replicate()`` elsewhere): :func:`place_leaf` makes a
``DTensor`` from the full value every process holds, with no
communication (the value is split, not broadcast). The table serves the
trainer (parameter specs, ZeRO sharding of the optimizer state over the
replica axes), checkpoints (:func:`checkpoint_sharding_fn`,
``sharding.json``), pipeline stage splits (``stage_regex``) and stage
manifests (:func:`apply_manifest_sharding`).

Scalar and single-element leaves always replicate; unmatched leaves follow
the table's ``unmatched`` policy (``replicate`` | ``error``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import re
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .mesh import AXES, MeshConfig, MeshContext, NamedSharding, P, spec_axes

__all__ = ["PartitionRules", "match_partition_rules", "tree_path_name",
           "tree_map_with_path", "tree_leaves", "shard_tree", "tree_shardings",
           "place_tree", "place_leaf", "opt_state_specs", "zero_shard_spec", "sharded_leaves",
           "split_stage_params", "stack_stages", "pipeline_param_specs",
           "pipeline_opt_specs", "checkpoint_sharding_fn", "spec_digests",
           "sharding_manifest_section", "apply_manifest_sharding", "sharding_target",
           "emit_shard_metrics", "per_device_bytes", "total_bytes",
           "default_llama_rules", "default_transformer_rules"]

logger = logging.getLogger("synapseml_torch.parallel.partition")


# ---- trees: nested dicts / lists / tuples of tensors or arrays -----------

def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(x, P)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf, *rest_leaves)`` over the leaves of ``tree`` (and of
    trees of the same structure in ``rest``); ``path`` is the tuple of keys
    and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if _is_node(tree):
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest), path=path + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return fn(path, tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map_with_path(lambda _, x: out.append(x), tree)
    return out


def tree_path_name(path: Sequence) -> str:
    """A path of keys and indices -> its slash-joined name."""
    return "/".join(str(p) for p in path)


def _spec_entry_to_json(entry) -> Any:
    if entry is None or isinstance(entry, str):
        return entry
    return list(entry)


def _spec_entry_from_json(entry) -> Any:
    if entry is None or isinstance(entry, str):
        return entry
    return tuple(entry)


def _spec_axes(spec) -> set:
    return {a for _, axes in spec_axes(spec) for a in axes}


@dataclasses.dataclass(frozen=True)
class PartitionRules:
    """The serializable rule table.

    ``rules``: ordered ``(pattern, spec entries)`` pairs; ``pattern`` is
    ``re.search``-ed against the slash-joined leaf name; ``spec entries``
    holds one entry a tensor dim (``None`` | ``"axis"`` | ``("axis",
    "axis")``). First match wins. ``unmatched``: ``"replicate"`` or
    ``"error"``. ``zero_axes``: the replica axes ZeRO shards optimizer
    state over. ``stage_regex``: one capture group (the stage index)
    naming the pipeline cut points. ``mesh``: the :class:`MeshConfig` the
    table targets, recorded for manifests and checkpoints."""

    rules: tuple = ()
    unmatched: str = "replicate"
    zero_axes: tuple = ("data", "fsdp")
    stage_regex: str | None = None
    mesh: MeshConfig | None = None

    def __post_init__(self):
        norm = []
        for pattern, entries in self.rules:
            re.compile(pattern)  # fail fast on a bad regex
            norm.append((str(pattern), tuple(_spec_entry_from_json(e) for e in entries)))
        object.__setattr__(self, "rules", tuple(norm))
        object.__setattr__(self, "zero_axes", tuple(self.zero_axes))
        if self.unmatched not in ("replicate", "error"):
            raise ValueError(f"unmatched must be 'replicate' or 'error', got {self.unmatched!r}")
        if self.stage_regex is not None:
            rx = re.compile(self.stage_regex)
            if rx.groups != 1:
                raise ValueError(f"stage_regex needs exactly ONE capture group (the stage "
                                 f"index), got {rx.groups} in {self.stage_regex!r}")
        if self.mesh is not None and not isinstance(self.mesh, MeshConfig):
            object.__setattr__(self, "mesh", MeshConfig(**dict(self.mesh)))

    def spec_for(self, name: str, shape: Sequence[int]) -> P:
        """First-match-wins spec for one leaf; scalars and single-element
        leaves replicate."""
        shape = tuple(int(s) for s in shape)
        if len(shape) == 0 or math.prod(shape) == 1:
            return P()
        for pattern, entries in self.rules:
            if re.search(pattern, name) is not None:
                if len(entries) > len(shape):
                    raise ValueError(f"partition rule {pattern!r} has {len(entries)} dim "
                                     f"entries but {name!r} has rank {len(shape)}")
                return P(*entries)
        if self.unmatched == "replicate":
            return P()
        raise ValueError(f"no partition rule matches {name!r} (unmatched='error'); "
                         f"rules: {[p for p, _ in self.rules]}")

    def to_json(self) -> dict:
        out = {"rules": [[p, [_spec_entry_to_json(e) for e in entries]]
                         for p, entries in self.rules],
               "unmatched": self.unmatched, "zero_axes": list(self.zero_axes)}
        if self.stage_regex is not None:
            out["stage_regex"] = self.stage_regex
        if self.mesh is not None:
            out["mesh"] = dataclasses.asdict(self.mesh)
        return out

    @classmethod
    def from_json(cls, data: dict) -> "PartitionRules":
        mesh = data.get("mesh")
        return cls(rules=tuple((p, tuple(_spec_entry_from_json(e) for e in entries))
                               for p, entries in data.get("rules", ())),
                   unmatched=data.get("unmatched", "replicate"),
                   zero_axes=tuple(data.get("zero_axes", ("data", "fsdp"))),
                   stage_regex=data.get("stage_regex"),
                   mesh=MeshConfig(**mesh) if mesh else None)

    def digest(self) -> str:
        blob = json.dumps(self.to_json(), sort_keys=True, separators=(",", ":")).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def _leaf_shape(leaf) -> tuple:
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else tuple(np.shape(leaf))


def _leaf_itemsize(leaf) -> int:
    dtype = getattr(leaf, "dtype", np.float32)
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return int(np.dtype(dtype).itemsize)


def match_partition_rules(rules: PartitionRules, tree: Any) -> Any:
    """A tree of specs, one a leaf of ``tree`` (only ``.shape`` is read)."""
    return tree_map_with_path(
        lambda path, leaf: rules.spec_for(tree_path_name(path), _leaf_shape(leaf)), tree)


def _validate_spec(name: str, shape: tuple, spec, sizes: dict) -> None:
    for d, axes in spec_axes(spec):
        for a in axes:
            if a not in sizes:
                raise ValueError(f"{name}: spec axis {a!r} is not a mesh axis "
                                 f"(have {sorted(sizes)})")
        div = math.prod(sizes[a] for a in axes)
        if shape[d] % div:
            raise ValueError(f"{name}: dim {d} of shape {shape} is not divisible by the "
                             f"{axes} axis product {div}")


def sharded_leaves(rules: PartitionRules, shapes: dict, sizes: dict) -> dict:
    """The leaves of ``shapes`` (name -> shape) whose spec names a mesh axis
    of size > 1, with those axes: the leaves a placement would cut."""
    out = {}
    for name, shape in shapes.items():
        axes = sorted(a for a in _spec_axes(rules.spec_for(name, shape)) if sizes.get(a, 1) > 1)
        if axes:
            out[name] = tuple(axes)
    return out


def tree_shardings(mesh_ctx: MeshContext, spec_tree: Any, value_tree: Any | None = None) -> Any:
    """Spec tree -> :class:`NamedSharding` tree on the mesh. ``value_tree``
    (the same structure) turns on divisibility checks that name the failing
    leaf."""
    sizes = mesh_ctx.axis_sizes
    if value_tree is not None:
        def check(path, leaf, spec):
            _validate_spec(tree_path_name(path), _leaf_shape(leaf), spec, sizes)
            return NamedSharding(mesh_ctx, spec)

        return tree_map_with_path(check, value_tree, spec_tree)

    def to_sharding(x):
        if isinstance(x, P):
            return NamedSharding(mesh_ctx, x)
        if isinstance(x, dict):
            return {k: to_sharding(v) for k, v in x.items()}
        return type(x)(to_sharding(v) for v in x)

    return to_sharding(spec_tree)


def place_leaf(x: Any, sharding: NamedSharding) -> Any:
    """One leaf onto a sharding: a ``DTensor`` with its placements, made
    from the full value this process holds (every process holds the same)
    by local splitting, no collective. A ``DTensor`` already on that
    sharding is returned as it is; one on another is redistributed. A mesh
    without a process group places a leaf as the tensor itself."""
    mesh = sharding.mesh
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        if list(x.placements) == list(sharding.placements):
            return x
        return x.redistribute(mesh.device_mesh, sharding.placements)
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    t = t.to(mesh.device)
    if mesh.device_mesh is None:
        return t
    rep = DTensor.from_local(t, mesh.device_mesh, [Replicate()] * len(AXES), run_check=False)
    return rep.redistribute(mesh.device_mesh, sharding.placements)


def place_tree(tree: Any, sharding_tree: Any) -> Any:
    """Every leaf onto its sharding."""
    return tree_map_with_path(lambda _, x, sh: place_leaf(x, sh), tree, sharding_tree)


def shard_tree(tree: Any, mesh_ctx: MeshContext, rules: PartitionRules) -> Any:
    """Match, validate and place a plain tree in one call."""
    specs = match_partition_rules(rules, tree)
    return place_tree(tree, tree_shardings(mesh_ctx, specs, tree))


# ---- ZeRO: optimizer-state sharding over the replica group ---------------

def zero_shard_spec(spec, shape: Sequence[int], sizes: dict, zero_axes: Sequence[str]) -> P:
    """Extend a leaf's spec with the ZeRO partitioning: shard the FIRST
    unsharded dim divisible by the replica-group size over the zero axes
    the spec does not use already. Leaves with no such dim keep their
    spec."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0 or math.prod(shape) == 1:
        return P(*spec)
    used = _spec_axes(spec)
    free = tuple(a for a in zero_axes if a not in used and sizes.get(a, 1) > 1)
    if not free:
        return P(*spec)
    group = math.prod(sizes[a] for a in free)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for d, entry in enumerate(entries):
        if entry is None and shape[d] % group == 0:
            entries[d] = free[0] if len(free) == 1 else free
            return P(*entries)
    return P(*spec)


def opt_state_specs(rules: PartitionRules, opt_state: Any, mesh_ctx: MeshContext,
                    zero: bool = False) -> Any:
    """Spec tree of an optimizer state: the same table (its paths embed
    the param names), plus the ZeRO sharding over ``rules.zero_axes`` with
    ``zero=True``."""
    sizes = mesh_ctx.axis_sizes

    def pick(path, leaf):
        name = tree_path_name(path)
        shape = _leaf_shape(leaf)
        spec = rules.spec_for(name, shape)
        if zero:
            spec = zero_shard_spec(spec, shape, sizes, rules.zero_axes)
        return spec

    return tree_map_with_path(pick, opt_state)


# ---- pipeline stage splits (cut points from the rule table) --------------

def _insert(tree: dict, parts: list, leaf) -> None:
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _flat_with_names(tree) -> list[tuple[str, Any]]:
    out: list = []
    tree_map_with_path(lambda path, x: out.append((tree_path_name(path), x)), tree)
    return out


def split_stage_params(params: Any, stage_regex: str) -> tuple[dict, list[dict]]:
    """Split a tree into pipeline stages by the cut regex (ONE capture
    group, the stage index; ``layers\\.(\\d+)`` on the port's names).
    Returns ``(shared, stages)``: ``shared`` holds every unmatched leaf,
    ``stages[i]`` the i-th stage's leaves with the index replaced by ``#``
    in their names, so every stage has one structure (checked)."""
    rx = re.compile(stage_regex)
    if rx.groups != 1:
        raise ValueError(f"stage_regex needs exactly ONE capture group, got {rx.groups} "
                         f"in {stage_regex!r}")
    shared: dict = {}
    staged: dict[int, dict] = {}
    for name, leaf in _flat_with_names(params):
        m = rx.search(name)
        if m is None:
            _insert(shared, name.split("/"), leaf)
            continue
        try:
            idx = int(m.group(1))
        except ValueError as e:
            raise ValueError(f"stage_regex capture on {name!r} is not an integer stage "
                             f"index: {m.group(1)!r}") from e
        norm = name[:m.start(1)] + "#" + name[m.end(1):]
        _insert(staged.setdefault(idx, {}), norm.split("/"), leaf)
    indices = sorted(staged)
    if indices != list(range(len(indices))):
        raise ValueError(f"stage indices must be contiguous from 0, got {indices}")
    if not indices:
        raise ValueError(f"stage_regex {stage_regex!r} matched no params")
    stages = [staged[i] for i in indices]
    ref = {n: _leaf_shape(x) for n, x in _flat_with_names(stages[0])}
    for i, st in enumerate(stages[1:], start=1):
        got = {n: _leaf_shape(x) for n, x in _flat_with_names(st)}
        if got != ref:
            raise ValueError(f"stage {i} structure differs from stage 0 (stages must be "
                             f"chainable): {sorted(set(got) ^ set(ref)) or 'shape drift'}")
    return shared, stages


def _stack(leaves: list):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack([np.asarray(x) for x in leaves])


def stack_stages(params: Any, stage_regex: str) -> tuple[dict, Any]:
    """:func:`split_stage_params`, then every stage leaf stacked on a new
    leading stage axis (the layout a pipeline shards over ``pipe``)."""
    shared, stages = split_stage_params(params, stage_regex)
    stacked = tree_map_with_path(lambda _, *xs: _stack(list(xs)), stages[0], *stages[1:])
    return shared, stacked


def _is_stage_leaf(name: str) -> bool:
    return name.startswith("stages/") or "/stages/" in name


def pipeline_param_specs(rules: PartitionRules | None, params: Any,
                         axis_name: str = "pipe") -> Any:
    """Specs of a ``{"shared": ..., "stages": <stacked>}`` tree: stage
    leaves shard their leading axis over ``axis_name``, shared leaves
    follow the table."""
    rules = rules or PartitionRules()

    def pick(path, leaf):
        name = tree_path_name(path)
        shape = _leaf_shape(leaf)
        if _is_stage_leaf(name) and len(shape) >= 1:
            return P(axis_name)
        return rules.spec_for(name, shape)

    return tree_map_with_path(pick, params)


def pipeline_opt_specs(rules: PartitionRules | None, opt_state: Any, mesh_ctx: MeshContext,
                       zero: bool = False, axis_name: str = "pipe") -> Any:
    """Optimizer-state specs mirroring :func:`pipeline_param_specs`, ZeRO on
    top when enabled."""
    rules = rules or PartitionRules()
    sizes = mesh_ctx.axis_sizes

    def pick(path, leaf):
        name = tree_path_name(path)
        shape = _leaf_shape(leaf)
        if len(shape) == 0 or math.prod(shape) == 1:
            return P()
        spec = P(axis_name) if _is_stage_leaf(name) else rules.spec_for(name, shape)
        if zero:
            spec = zero_shard_spec(spec, shape, sizes, rules.zero_axes)
        return spec

    return tree_map_with_path(pick, opt_state)


# ---- checkpoint restore placement ----------------------------------------

def checkpoint_sharding_fn(rules: PartitionRules, mesh_ctx: MeshContext, zero: bool = False,
                           pipeline_axis: str | None = None):
    """A path-aware ``sharding_fn(name, leaf)`` for ``restore_checkpoint``:
    each leaf of a train-state tree restores onto its rule-table placement.
    The root (``params``/``opt_state``/``batch_stats``) is stripped before
    matching, so restore sees the names live placement saw; ``data_iter``
    and scalars (the step, the optimizer count) stay host-side numpy
    (None)."""
    sizes = mesh_ctx.axis_sizes

    def fn(name: str, leaf):
        root, _, rest = name.partition("/")
        shape = _leaf_shape(leaf)
        if root == "data_iter" or len(shape) == 0:
            return None
        if math.prod(shape) == 1:
            return NamedSharding(mesh_ctx, P())
        local = rest if root in ("params", "opt_state", "batch_stats") and rest else name
        if pipeline_axis is not None and _is_stage_leaf(local):
            spec = P(pipeline_axis)
        else:
            spec = rules.spec_for(local, shape)
        if zero and root == "opt_state":
            spec = zero_shard_spec(spec, shape, sizes, rules.zero_axes)
        return NamedSharding(mesh_ctx, spec)

    return fn


# ---- manifests (the stage's `sharding` section) --------------------------

def spec_digests(rules: PartitionRules, tree: Any) -> dict:
    """``{path: sha256(path + spec)[:12]}`` a leaf: a loader sees a table
    edit that moves any leaf."""
    out = {}
    for name, leaf in _flat_with_names(tree):
        spec = rules.spec_for(name, _leaf_shape(leaf))
        blob = json.dumps([name, [_spec_entry_to_json(e) for e in spec]],
                          sort_keys=True).encode()
        out[name] = hashlib.sha256(blob).hexdigest()[:12]
    return out


def sharding_manifest_section(rules: PartitionRules, params: Any | None = None) -> dict:
    """The ``sharding`` section: rule table, its mesh and per-leaf spec
    digests (when the tree is given)."""
    section = {"rules": rules.to_json(), "digest": rules.digest()}
    if rules.mesh is not None:
        section["mesh"] = dataclasses.asdict(rules.mesh)
    if params is not None:
        section["spec_digests"] = spec_digests(rules, params)
    return section


def _log_demote(reason: str, **context) -> None:
    payload = {"event": "sharding_demoted_to_replicated", "reason": reason}
    payload.update({k: v for k, v in context.items() if v is not None})
    logger.warning(json.dumps(payload, sort_keys=True, default=str))


def _has_param(stage, name: str) -> bool:
    has = getattr(stage, "has_param", None)
    return bool(has(name)) if callable(has) else False


def sharding_target(stage):
    """The stage declaring both ``partition_rules`` and ``mesh_config``
    (itself, or the first nested stage of a pipeline that does)."""
    if _has_param(stage, "partition_rules") and _has_param(stage, "mesh_config"):
        return stage
    if _has_param(stage, "stages"):
        for child in (stage.get("stages") or []):
            found = sharding_target(child)
            if found is not None:
                return found
    return None


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def apply_manifest_sharding(stage, section: dict, enabled: bool = True,
                            **context) -> tuple[bool, str | None]:
    """Apply a manifest's ``sharding`` section to a loaded stage. Any
    mismatch (a mesh this world cannot build, a stage without the
    rule-table params) demotes to a replicated load: the stage's
    ``mesh_config``/``partition_rules`` are cleared and one structured
    warning is logged. Never raises for topology reasons."""
    target = sharding_target(stage)
    if target is not None:
        stage = target
    has_rules = _has_param(stage, "partition_rules")
    has_mesh = _has_param(stage, "mesh_config")

    def demote(reason: str, warn: bool = True) -> tuple[bool, str]:
        clear = {}
        if has_rules and stage.get("partition_rules") is not None:
            clear["partition_rules"] = None
        if has_mesh and stage.get("mesh_config") is not None:
            clear["mesh_config"] = None
        if clear:
            stage.set(**clear)
        if warn:
            _log_demote(reason, **context)
        return False, reason

    if not enabled:
        return demote("sharding disabled by request", warn=False)
    try:
        rules = PartitionRules.from_json(section.get("rules") or {})
    except (TypeError, ValueError) as e:
        return demote(f"unreadable rule table: {e}")
    mesh_sizes = section.get("mesh") or (dataclasses.asdict(rules.mesh) if rules.mesh else None)
    if not has_rules or not has_mesh:
        return demote(f"stage {type(stage).__name__} has no partition_rules/mesh_config params")
    if mesh_sizes is None:
        return demote("manifest sharding section carries no mesh topology")
    world = _world_size()
    try:
        cfg = MeshConfig(**{k: int(v) for k, v in mesh_sizes.items() if k in AXES})
        cfg.resolve(world)
    except (TypeError, ValueError) as e:
        return demote(f"mesh {mesh_sizes} does not fit this world of {world} processes: {e}")
    stage.set(mesh_config=cfg, partition_rules=rules)
    return True, None


# ---- observability: the synapseml_shard_* gauge family -------------------

def total_bytes(tree: Any) -> int:
    return sum(int(np.prod(_leaf_shape(x)) or 1) * _leaf_itemsize(x) for x in tree_leaves(tree))


def _local_shape(x) -> tuple:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return tuple(x.to_local().shape)
    return _leaf_shape(x)


def per_device_bytes(tree: Any) -> int:
    """Bytes this process holds for a placed tree (a ``DTensor`` counts its
    local shard; any other leaf counts whole)."""
    return sum(int(np.prod(_local_shape(x)) or 1) * _leaf_itemsize(x) for x in tree_leaves(tree))


def _axis_bytes(tree: Any, sizes: dict) -> dict:
    """Total bytes of the leaves whose placement uses each mesh axis."""
    from torch.distributed.tensor import DTensor, Shard

    out = {a: 0 for a in sizes if sizes[a] > 1}
    for x in tree_leaves(tree):
        if not isinstance(x, DTensor):
            continue
        nbytes = int(np.prod(_leaf_shape(x)) or 1) * _leaf_itemsize(x)
        for a, pl in zip(AXES, x.placements):
            if isinstance(pl, Shard) and a in out:
                out[a] += nbytes
    return out


def emit_shard_metrics(params: Any, opt_state: Any | None = None,
                       mesh_ctx: MeshContext | None = None, engine: str = "trainer") -> dict:
    """The ``synapseml_shard_*`` gauges (the JAX package's series names):
    total and per-device bytes a tree kind, bytes a mesh axis, and device
    memory headroom after params and optimizer state on a card. Returns
    the snapshot."""
    from ..core import observability as obs

    reg = obs.get_registry()
    sizes = mesh_ctx.axis_sizes if mesh_ctx is not None else {}
    snapshot: dict = {}
    per_dev_total = 0
    for kind, tree in (("params", params), ("opt_state", opt_state)):
        if tree is None:
            continue
        tot = total_bytes(tree)
        dev = per_device_bytes(tree)
        per_dev_total += dev
        reg.gauge("synapseml_shard_total_bytes", "global bytes of the placed tree",
                  ("kind", "engine")).set(tot, kind=kind, engine=engine)
        reg.gauge("synapseml_shard_bytes_per_device",
                  "bytes ONE device holds for the placed tree (the ZeRO denominator)",
                  ("kind", "engine")).set(dev, kind=kind, engine=engine)
        snapshot[kind] = {"total_bytes": tot, "bytes_per_device": dev}
        for axis, nbytes in _axis_bytes(tree, sizes).items():
            reg.gauge("synapseml_shard_axis_bytes", "bytes of leaves sharded over each mesh axis",
                      ("kind", "axis", "engine")).set(nbytes, kind=kind, axis=axis,
                                                      engine=engine)
            snapshot[kind].setdefault("axis_bytes", {})[axis] = nbytes
    device = mesh_ctx.device if mesh_ctx is not None else torch.device("cpu")
    if device.type == "cuda":
        limit = int(torch.cuda.get_device_properties(device).total_memory)
        headroom = limit - per_dev_total
        reg.gauge("synapseml_shard_hbm_headroom_bytes",
                  "device memory limit minus per-device params+opt bytes",
                  ("engine",)).set(headroom, engine=engine)
        snapshot["hbm_headroom_bytes"] = headroom
    return snapshot


# ---- default rule tables, on the port's state_dict names -----------------
#
# A torch ``Linear.weight`` is the transposed Flax ``kernel`` ([out, in]
# against [in, out]), and the attention projections flatten (heads,
# head_dim) into one dim ([H*D, hidden] for q/k/v, [hidden, H*D] for o),
# so each rule below places the same tensor dims on the same axes as the
# JAX table's rule for the same leaf.

def _model_axis_for(mesh: MeshConfig | None) -> str:
    """``tensor``, or ``fsdp`` on a mesh with an fsdp group and no tensor
    parallelism."""
    if mesh is not None and mesh.tensor == 1 and mesh.fsdp != 1:
        return "fsdp"
    return "tensor"


def default_llama_rules(mesh: MeshConfig | None = None, **overrides) -> PartitionRules:
    """Megatron-style table for :class:`~synapseml_torch.models.nets.llama.LlamaLM`
    (and GPT-2): embeddings over the vocab dim, q/k/v over heads, o and the
    MLP's down projection over their input dim, norms replicated; on a
    tensor-less fsdp mesh the hidden dim of every projection instead.
    ``stage_regex`` names the decoder layers."""
    mp = _model_axis_for(mesh)
    if mp == "fsdp":
        rules = (
            (r"(^|\.)embed\.weight$", (None, "fsdp")),
            (r"(^|\.)wpe\.weight$", (None, None)),
            (r"(^|\.)lm_head\.weight$", (None, "fsdp")),
            (r"attn\.(q|k|v)\.weight$", (None, "fsdp")),
            (r"attn\.o\.weight$", ("fsdp", None)),
            (r"mlp\.(wi|wi_0|wi_1|gate|up)\.weight$", (None, "fsdp")),
            (r"mlp\.(wo|down)\.weight$", ("fsdp", None)),
            (r"(norm|ln|scale)", (None,)),
        )
    else:
        rules = (
            (r"(^|\.)embed\.weight$", (mp, None)),
            (r"(^|\.)wpe\.weight$", (None, None)),
            (r"(^|\.)lm_head\.weight$", (mp, None)),
            (r"attn\.(q|k|v)\.weight$", (mp, None)),
            (r"attn\.o\.weight$", (None, mp)),
            (r"mlp\.(wi|wi_0|wi_1|gate|up)\.weight$", (mp, None)),
            (r"mlp\.(wo|down)\.weight$", (None, mp)),
            (r"(norm|ln|scale)", (None,)),
        )
    kw: dict = dict(rules=rules, stage_regex=r"layers\.(\d+)", mesh=mesh)
    kw.update(overrides)
    return PartitionRules(**kw)


def default_transformer_rules(mesh: MeshConfig | None = None, **overrides) -> PartitionRules:
    """The encoder table (BERT and ViT classifiers): embedding tables over
    the vocab dim, every dense weight over its output dim but the output
    projections (attention ``o``, the MLP's ``down``) over their input
    dim, biases and norms replicated; on a tensor-less fsdp mesh the dim
    that is the Flax kernel's first (a linear weight's input dim, ``H*D``
    of ``o``)."""
    mp = _model_axis_for(mesh)
    if mp == "fsdp":
        rules = (
            (r"(word|position|segment)\.weight$", (None, "fsdp")),
            (r"(norm\d*)\.weight$", (None,)),
            (r"patch_embed\.weight$", (None, None, "fsdp", None)),
            (r"weight$", (None, "fsdp")),
            (r"bias$", (None,)),
        )
    else:
        rules = (
            (r"(word|position|segment)\.weight$", (mp, None)),
            (r"(norm\d*)\.weight$", (None,)),
            (r"patch_embed\.weight$", (None, None, None, mp)),
            (r"(^|[./])(o|wo|down|out|output)\.weight$", (None, mp)),
            (r"weight$", (mp, None)),
            (r"bias$", (None,)),
        )
    kw: dict = dict(rules=rules, stage_regex=r"layers\.(\d+)", mesh=mesh)
    kw.update(overrides)
    return PartitionRules(**kw)
