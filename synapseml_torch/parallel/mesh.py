"""The mesh: named axes over the process group's ranks.

Counterpart of ``synapseml_tpu/parallel/mesh.py``. The JAX package drives
every device of a host from one controller over a ``jax.sharding.Mesh``;
torch runs one process a device, so here a :class:`MeshContext` wraps a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the same six named axes in the same order:

  axis      meaning
  ----      -------
  'data'    data parallelism (batch rows sharded)
  'fsdp'    parameter sharding inside the data-parallel group
  'tensor'  tensor (model) parallelism
  'seq'     sequence/context parallelism (ring and Ulysses attention)
  'expert'  expert parallelism for MoE
  'pipe'    pipeline (stage) parallelism

A ``PartitionSpec`` entry becomes a DTensor placement: ``Shard(dim)`` on
each mesh dim the entry names, ``Replicate()`` on every other dim
(:meth:`MeshContext.placements`). Without a process group the world is one
process and the context holds no ``DeviceMesh``: every axis has size 1,
every collective is the identity and a placed leaf is the tensor itself.
Each process supplies the same global batch and takes its own rows
(:meth:`MeshContext.shard_batch`), as the JAX package's processes do.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["AXES", "MeshConfig", "MeshContext", "NamedSharding", "P", "create_mesh",
           "batch_sharding", "replicated", "current_mesh", "logical_axis_rules",
           "shard_params", "shard_inference_params"]

AXES = ("data", "fsdp", "tensor", "seq", "expert", "pipe")


class P(tuple):
    """A partition spec: one entry a tensor dim, each ``None``, a mesh axis
    name or a tuple of names (``jax.sharding.PartitionSpec``'s
    constructor arguments)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spec_axes(spec) -> list[tuple[int, tuple[str, ...]]]:
    """``(dim, axes)`` of every sharded dim of ``spec``."""
    out = []
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        out.append((d, (entry,) if isinstance(entry, str) else tuple(entry)))
    return out


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis sizes; -1 on ``data`` means 'absorb all remaining ranks'."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = dataclasses.asdict(self)
        fixed = math.prod(v for v in sizes.values() if v > 0)
        free = [k for k, v in sizes.items() if v <= 0]
        if len(free) > 1:
            raise ValueError(f"at most one axis may be -1, got {free}")
        if free:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[free[0]] = n_devices // fixed
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(f"mesh {sizes} does not cover {n_devices} devices")
        return sizes


_local = threading.local()


def current_mesh() -> "MeshContext | None":
    """The innermost mesh entered with ``with mesh_ctx:`` on this thread."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class NamedSharding:
    """A spec on a mesh: what ``jax.sharding.NamedSharding`` is to the JAX
    package. ``placements`` are its DTensor placements."""

    def __init__(self, mesh: "MeshContext", spec=None):
        self.mesh = mesh
        self.spec = P(*(spec or ()))

    @property
    def placements(self) -> list:
        return self.mesh.placements(self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r}, {self.mesh.axis_sizes})"


class MeshContext:
    """A constructed mesh plus sharding helpers: the handle estimators and
    the trainer receive. ``device_mesh`` is None for a one-process world
    without a process group."""

    def __init__(self, device_mesh, config: MeshConfig, sizes: dict[str, int],
                 device: torch.device):
        self.device_mesh = device_mesh
        self.config = config
        self._sizes = {a: int(sizes[a]) for a in AXES}
        self.device = device

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(self._sizes)

    @property
    def n_devices(self) -> int:
        return math.prod(self._sizes.values())

    def coordinate(self) -> dict[str, int]:
        """This process's index along every axis."""
        if self.device_mesh is None:
            return {a: 0 for a in AXES}
        coord = self.device_mesh.get_coordinate()
        if coord is None:
            raise RuntimeError("this process is not a member of the mesh")
        return dict(zip(AXES, coord))

    def get_group(self, axis: str):
        """The process group of ``axis`` (None without a process group)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def group_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self._sizes[a] for a in axes)

    def group_index(self, axes) -> int:
        """This process's index in the group of ``axes``, the first axis
        major (a ``("data", "fsdp")`` spec entry's order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        coord = self.coordinate()
        idx = 0
        for a in axes:
            idx = idx * self._sizes[a] + coord[a]
        return idx

    def group_ranks(self, axes) -> list[int]:
        """The global ranks of this process's group over ``axes``, in
        :meth:`group_index` order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.device_mesh is None:
            return [0]
        mesh = self.device_mesh.mesh  # [6-D] tensor of global ranks
        coord = self.coordinate()
        index = tuple(slice(None) if a in axes else coord[a] for a in AXES)
        sub = mesh[index]
        # the remaining dims are the named axes in AXES order: put them in
        # the order the caller named them
        kept = [a for a in AXES if a in axes]
        sub = sub.permute(*[kept.index(a) for a in axes])
        return [int(r) for r in sub.reshape(-1).tolist()]

    def process_group(self, axes):
        """A process group over ``axes`` (one axis: the mesh's own group;
        several: a group made once over their ranks, cached). None when the
        group has one member or there is no process group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.device_mesh is None or self.group_size(axes) == 1:
            return None
        kept = [a for a in axes if self._sizes[a] > 1]
        if len(kept) == 1:
            return self.get_group(kept[0])
        cache = self.__dict__.setdefault("_groups", {})
        key = tuple(kept)
        if key not in cache:
            import torch.distributed as dist

            # every rank builds every group of this shape, in one order
            mesh = self.device_mesh.mesh
            others = [a for a in AXES if a not in kept]
            perm = [AXES.index(a) for a in others] + [AXES.index(a) for a in kept]
            blocks = mesh.permute(*perm).reshape(-1, self.group_size(kept))
            mine = None
            for ranks in blocks.tolist():
                g = dist.new_group(ranks)
                if dist.get_rank() in ranks:
                    mine = g
            cache[key] = mine
        return cache[key]

    def placements(self, spec) -> list:
        """The DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim
        an entry names, ``Replicate()`` on the others."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate() for _ in AXES]
        for d, axes in spec_axes(spec):
            for a in axes:
                if a not in self._sizes:
                    raise ValueError(f"spec axis {a!r} is not a mesh axis (have {list(AXES)})")
                out[AXES.index(a)] = Shard(d)
        return out

    def sharding(self, *spec) -> NamedSharding:
        return NamedSharding(self, P(*spec))

    def batch_sharding(self) -> NamedSharding:
        """Shard the leading (batch) dim over every data-like axis."""
        return self.sharding(("data", "fsdp"))

    def replicated(self) -> NamedSharding:
        return self.sharding()

    def data_parallel_size(self) -> int:
        return self._sizes["data"] * self._sizes["fsdp"]

    def _rows(self, n: int) -> slice:
        dp = self.data_parallel_size()
        if n % dp:
            raise ValueError(f"a batch of {n} rows does not divide over the data-parallel "
                             f"size {dp}; pad it (the loader's multiple_of)")
        i = self.group_index(("data", "fsdp"))
        return slice(i * n // dp, (i + 1) * n // dp)

    def shard_batch(self, batch: Any) -> Any:
        """This process's rows of a global host batch (every process
        supplies the same batch), dim 0 split over ``("data", "fsdp")``."""
        def take(x):
            return x[self._rows(np.shape(x)[0])]

        return _map_leaves(take, batch)

    def shard_stacked_batch(self, batch: Any) -> Any:
        """This process's rows of ``[K, batch, ...]`` step-stacked arrays:
        K kept (the scan axis), dim 1 split over the data axes."""
        def take(x):
            return x[:, self._rows(np.shape(x)[1])]

        return _map_leaves(take, batch)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _local.stack.pop()
        return False

    def __repr__(self) -> str:
        return f"MeshContext({self.axis_sizes})"


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def _world() -> tuple[int, str | None]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_backend()
    return 1, None


def create_mesh(config: MeshConfig | None = None, devices: Sequence[int] | None = None,
                allow_fewer: bool = True) -> MeshContext:
    """Build the mesh over the process group's ranks (``devices``: the
    global ranks it spans, default every rank), ``data`` outermost and
    ``pipe`` innermost as in the JAX package. A config that does not fit
    the world degrades, with ``allow_fewer``, to every rank on ``data``.
    An NCCL group builds a CUDA mesh on this process's card
    (``torch.cuda.current_device()``), any other group a CPU mesh."""
    config = config or MeshConfig()
    world, backend = _world()
    ranks = list(range(world)) if devices is None else [int(d) for d in devices]
    n = len(ranks)
    try:
        sizes = config.resolve(n)
    except ValueError:
        if not allow_fewer:
            raise
        sizes = {k: 1 for k in AXES}
        sizes["data"] = n
    device_type = "cuda" if backend == "nccl" else "cpu"
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    if backend is None:
        return MeshContext(None, config, sizes, device)
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(sizes[a] for a in AXES)
    dm = DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                    mesh_dim_names=AXES)
    return MeshContext(dm, config, sizes, device)


def batch_sharding(mesh_ctx: MeshContext) -> NamedSharding:
    return mesh_ctx.batch_sharding()


def replicated(mesh_ctx: MeshContext) -> NamedSharding:
    return mesh_ctx.replicated()


# ---- logical axis rules: the names Flax modules annotate -> mesh axes ----

DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("data", "fsdp")),
    ("embed", "fsdp"),
    ("mlp", "tensor"),
    ("heads", "tensor"),
    ("kv", None),
    ("vocab", "tensor"),
    ("seq", "seq"),
    ("expert", "expert"),
    ("pipe", "pipe"),
)


def logical_axis_rules(extra: Sequence[tuple[str, Any]] = ()) -> list[tuple[str, Any]]:
    return list(DEFAULT_RULES) + list(extra)


def shard_params(params: Any, mesh_ctx: MeshContext, rules=None) -> Any:
    """Place a ``state_dict`` (or any tree of tensors) on the mesh by a
    :class:`~synapseml_torch.parallel.partition.PartitionRules` table
    (default: :func:`~.partition.default_transformer_rules` for the mesh's
    config). The port's modules carry no Flax ``nn.Partitioned``
    metadata, so the rule table is the one placement path."""
    from . import partition as pp

    if rules is None or not isinstance(rules, pp.PartitionRules):
        rules = pp.default_transformer_rules(mesh_ctx.config)
    return pp.shard_tree(params, mesh_ctx, rules)


def shard_inference_params(module, params, mesh_ctx: MeshContext, rules=None) -> Any:
    """Place a plain ``state_dict`` for ``module`` (a pretrained one, say)
    on the mesh: :func:`~.partition.default_llama_rules` for a
    ``LlamaLM``, the transformer table for any other module, unless
    ``rules`` is given."""
    from . import partition as pp

    if rules is None:
        is_llama = type(module).__name__ in ("LlamaLM", "PagedLlamaLM")
        rules = (pp.default_llama_rules if is_llama
                 else pp.default_transformer_rules)(mesh_ctx.config)
    return pp.shard_tree(params, mesh_ctx, rules)
