"""Distributed bootstrap: driver rendezvous, then a torch process group.

Counterpart of ``synapseml_tpu/parallel/backend.py``. A driver collects
worker registrations over a plain TCP line protocol (one JSON line each
way), orders them by (partition id, executor id) as the reference's
``NetworkManager`` does, and replies to each with ``{coordinator, rank,
world, run_id}``. Where the JAX package then calls
``jax.distributed.initialize``, :func:`initialize_backend` ends in
``torch.distributed.init_process_group`` at ``tcp://<coordinator>``: NCCL
when the process has a card, gloo on the CPU. Without a driver address it
records the process group already set up (or a world of one) and starts
nothing. :func:`reset_backend` destroys a group it made.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import uuid
from dataclasses import dataclass

__all__ = ["DriverRendezvous", "worker_rendezvous", "DistributedBackend",
           "initialize_backend", "reset_backend"]


@dataclass
class WorkerInfo:
    host: str
    executor_id: str
    partition_id: int


class DriverRendezvous:
    """Driver side: collect ``world_size`` worker registrations, assign
    ranks by (min partition id, executor id) and reply with
    ``{coordinator, rank, world, run_id}``. The coordinator is the rank-0
    worker's host at ``coordinator_port``, where its process group's store
    listens. ``keep_alive=True`` keeps every worker connection open after
    the reply, by rank in :attr:`conns`: the gang channel, which
    :meth:`gang` hands to a :class:`~synapseml_torch.parallel.gang.
    GangCoordinator`."""

    def __init__(self, world_size: int, coordinator_port: int = 9377,
                 bind: str = "0.0.0.0", keep_alive: bool = False):
        self.world_size = world_size
        self.coordinator_port = coordinator_port
        self.keep_alive = bool(keep_alive)
        # one id per launch, handed to every worker: coordinated checkpoint
        # ACKs carry it and the commit fences on it
        self.run_id = uuid.uuid4().hex[:12]
        self.conns: dict[int, socket.socket] = {}
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((bind, 0))
        self._srv.listen(world_size * 2)
        self.port = self._srv.getsockname()[1]
        self._thread: threading.Thread | None = None
        self.error: BaseException | None = None

    @property
    def address(self) -> str:
        return f"{socket.gethostname()}:{self.port}"

    def start(self) -> "DriverRendezvous":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            conns, infos = [], []
            while len(conns) < self.world_size:
                conn, _ = self._srv.accept()
                data = json.loads(conn.makefile("r").readline())
                infos.append(WorkerInfo(**data))
                conns.append(conn)
            order = sorted(range(len(infos)),
                           key=lambda i: (infos[i].partition_id, infos[i].executor_id))
            coordinator = f"{infos[order[0]].host}:{self.coordinator_port}"
            for rank, i in enumerate(order):
                reply = {"coordinator": coordinator, "rank": rank,
                         "world": self.world_size, "run_id": self.run_id}
                conns[i].sendall((json.dumps(reply) + "\n").encode())
                if self.keep_alive:
                    self.conns[rank] = conns[i]
            if not self.keep_alive:
                for c in conns:
                    c.close()
        except BaseException as e:  # noqa: BLE001 - surfaced by join()
            self.error = e
        finally:
            self._srv.close()

    def join(self, timeout_s: float = 120.0) -> None:
        assert self._thread is not None
        self._thread.join(timeout_s)
        if self.error:
            raise self.error

    def gang(self, **kwargs):
        """The bootstrap channel promoted to the gang plane: a started
        :class:`~synapseml_torch.parallel.gang.GangCoordinator` over the
        kept-alive worker sockets, ``run_id`` defaulting to this launch's.
        Call after :meth:`join`; needs ``keep_alive=True``."""
        if not self.keep_alive:
            raise RuntimeError("DriverRendezvous(keep_alive=True) is required for a gang channel")
        if len(self.conns) != self.world_size:
            raise RuntimeError(f"rendezvous incomplete: {len(self.conns)}/{self.world_size} "
                               "workers connected")
        from .gang import GangCoordinator

        kwargs.setdefault("run_id", self.run_id)
        return GangCoordinator(self.conns, **kwargs).start()


def worker_rendezvous(driver_address: str, executor_id: str, partition_id: int,
                      timeout_s: float = 120.0, retry_interval_s: float = 0.25,
                      policy=None, deadline=None, keep_alive: bool = False):
    """Worker side: register with the driver, receive ``{coordinator, rank,
    world, run_id}``. Connects retry with jittered geometric backoff
    (capped at 5 s), every attempt bounded by what is left of
    ``timeout_s`` (or of ``deadline``, a ``core.resilience.Deadline``
    shared with the caller); retries and expiries count on
    ``resilience_measures("parallel")``, the wall time on
    ``synapseml_rendezvous_duration_ms``. ``keep_alive=True`` returns
    ``(info, socket)`` with the connection still open."""
    from ..core import observability as obs

    with obs.get_tracer().span("parallel.rendezvous",
                               {"driver": driver_address, "partition_id": partition_id}):
        t0 = time.perf_counter()
        try:
            return _worker_rendezvous(driver_address, executor_id, partition_id,
                                      timeout_s, retry_interval_s, policy, deadline, keep_alive)
        finally:
            obs.get_registry().histogram(
                "synapseml_rendezvous_duration_ms",
                "worker rendezvous wall time (connect retries included)",
            ).observe((time.perf_counter() - t0) * 1e3)


def _worker_rendezvous(driver_address, executor_id, partition_id, timeout_s,
                       retry_interval_s, policy, deadline, keep_alive):
    from ..core.resilience import Deadline, DeadlineExpired, RetryPolicy, resilience_measures

    host, port = driver_address.rsplit(":", 1)
    measures = resilience_measures("parallel")
    deadline = deadline if deadline is not None else Deadline(timeout_s)
    if policy is None:
        backoffs, b = [], retry_interval_s * 1000.0
        while len(backoffs) < 64:
            backoffs.append(min(b, 5000.0))
            b *= 2
        policy = RetryPolicy(backoffs_ms=tuple(backoffs))
    last: BaseException | None = None
    attempt = 0
    while True:
        try:
            connect_timeout = deadline.cap(timeout_s)
        except DeadlineExpired:
            measures.count("deadline_expired")
            raise TimeoutError(f"rendezvous with {driver_address} failed: {last}") from last
        try:
            s = socket.create_connection((host, int(port)), timeout=connect_timeout)
            try:
                payload = {"host": socket.gethostname(), "executor_id": executor_id,
                           "partition_id": partition_id}
                s.sendall((json.dumps(payload) + "\n").encode())
                if keep_alive:
                    # the reply unbuffered, up to its newline: bytes behind it
                    # belong to the channel's next user
                    line = b""
                    while not line.endswith(b"\n"):
                        ch = s.recv(1)
                        if not ch:
                            raise OSError("rendezvous connection closed before the rank reply")
                        line += ch
                    s.settimeout(None)
                    return json.loads(line), s
                info = json.loads(s.makefile("r").readline())
                s.close()
                return info
            except BaseException:
                s.close()
                raise
        except OSError as e:
            last = e
            wait_s = policy.backoff_ms(attempt) / 1000.0
            attempt += 1
            if not deadline.sleep_allowed(wait_s):
                measures.count("deadline_expired")
                raise TimeoutError(f"rendezvous with {driver_address} failed: {last}") from last
            if not policy.acquire_retry():
                measures.count("retry_budget_exhausted")
                raise TimeoutError(f"rendezvous with {driver_address} failed "
                                   f"(retry budget exhausted): {last}") from last
            measures.count("retry")
            time.sleep(wait_s)


@dataclass
class DistributedBackend:
    """The one comm backend handle estimators receive."""

    rank: int
    world: int
    coordinator: str | None
    initialized: bool

    @property
    def is_distributed(self) -> bool:
        return self.world > 1


_BACKEND: DistributedBackend | None = None


def initialize_backend(driver_address: str | None = None, executor_id: str | None = None,
                       partition_id: int = 0, rendezvous_timeout_s: float = 120.0,
                       backend: str | None = None) -> DistributedBackend:
    """The process group, from a rendezvous (``driver_address``) or from
    what is already set up.

    Without a driver address: records the initialized default group's rank
    and world, or a world of one, and starts nothing. With one: a
    deadline-bounded rendezvous, then ``init_process_group(backend,
    init_method="tcp://<coordinator>", rank, world_size)``; ``backend``
    defaults to NCCL when this process has a card (after
    ``torch.cuda.set_device(LOCAL_RANK or rank % cards)``), else gloo."""
    global _BACKEND
    if _BACKEND is not None:
        return _BACKEND
    import torch
    import torch.distributed as dist

    if driver_address is None:
        if dist.is_available() and dist.is_initialized():
            _BACKEND = DistributedBackend(rank=dist.get_rank(), world=dist.get_world_size(),
                                          coordinator=None, initialized=False)
        else:
            _BACKEND = DistributedBackend(rank=0, world=1, coordinator=None, initialized=False)
        return _BACKEND
    info = worker_rendezvous(driver_address, executor_id or socket.gethostname(),
                             partition_id, timeout_s=rendezvous_timeout_s)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", info["rank"] % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{info['coordinator']}",
                            rank=info["rank"], world_size=info["world"])
    _BACKEND = DistributedBackend(rank=info["rank"], world=info["world"],
                                  coordinator=info["coordinator"], initialized=True)
    return _BACKEND


def reset_backend() -> None:
    """Forget the recorded backend; destroy the process group if
    :func:`initialize_backend` made it."""
    global _BACKEND
    if _BACKEND is not None and _BACKEND.initialized:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    _BACKEND = None
