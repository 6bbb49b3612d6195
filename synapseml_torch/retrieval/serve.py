"""Retrieval worker process: a residency-managed ``/m/<index>`` holder.

Counterpart of ``synapseml_tpu/retrieval/serve.py``, patterned on
``fleet.autoscaler.fleet_worker_main``: the worker resolves the published
index artifact through a byte-budgeted ``ResidencyManager`` (shard bytes
count against the same budget as any resident model), serves it behind
``serve_multi_model``, and registers with the front advertising which
shard NAMES it is responsible for — the fan-out front assigns each shard of
a query to a worker advertising it, and a worker that advertises a subset
scores only that subset (all workers materialize the full artifact; the
advertisement partitions scoring work, not bytes on disk).

The worker is a fresh interpreter that searches on the index stage's
``device``: it resolves that device before it registers, so an index
published for the card exits the worker non-zero on a host without one.

An alias-watch thread polls the registry ref and evicts the resident on
movement, so a delta-shard publish becomes queryable on the NEXT request
with zero serve downtime (the reload rides the residency miss path).
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["retrieval_worker_main"]


def retrieval_worker_main(registry_root: str, index: str,
                          register_url: str | None = None, *,
                          ref: str = "latest",
                          shards: list[str] | None = None,
                          byte_budget: int = 1 << 30, port: int = 0,
                          refresh_s: float = 0.5) -> None:
    """Serve published index ``index`` from one worker process and park.
    ``shards`` limits the advertised scoring responsibility (None = the
    full roster); ``refresh_s`` is the alias-watch poll interval (0
    disables the watch)."""
    from ..fleet.autoscaler import _post_json
    from ..fleet.residency import ResidencyManager, serve_multi_model
    from ..io.distributed_serving import _check_devices
    from ..registry import ModelRegistry

    registry = ModelRegistry(registry_root)
    residency = ResidencyManager(registry, byte_budget, refs={index: ref})
    server = serve_multi_model(residency, port=port)
    stage, version = residency.acquire(index)
    _check_devices(stage)
    roster = list(stage.get("shard_names") or [])
    advertised = [s for s in (shards if shards is not None else roster)
                  if s in roster] or roster
    info = {"host": server.host, "port": server.port, "pid": os.getpid(),
            "version": version, "model": index,
            "shards": advertised, "total_shards": len(roster)}

    if refresh_s > 0:
        def watch():
            current = version
            while True:
                time.sleep(refresh_s)
                try:
                    target = registry.resolve_ref(index, ref)
                except Exception:  # noqa: BLE001 — transient registry I/O
                    continue
                if target != current:
                    residency.evict(index)  # next acquire loads the mover
                    current = target
                    if register_url:
                        # re-register: a new version may carry new shards
                        # (deltas); a subset worker adds the fresh ones to
                        # its advertisement, a full worker tracks the roster
                        try:
                            st, v = residency.acquire(index)
                            new_roster = list(st.get("shard_names") or [])
                            if shards is None:
                                new_adv = new_roster
                            else:
                                fresh = [s for s in new_roster
                                         if s not in roster]
                                new_adv = sorted(set(info["shards"])
                                                 | set(fresh))
                            info.update(version=v, shards=new_adv,
                                        total_shards=len(new_roster))
                            _post_json(register_url, info)
                        except Exception:  # noqa: BLE001
                            continue

        threading.Thread(target=watch, daemon=True).start()

    if register_url:
        def on_drained(_report):
            from ..io.distributed_serving import deregister_worker

            deregister_worker(register_url, info)
            os._exit(0)

        server.on_drained = on_drained
        _post_json(register_url, info, timeout_s=30.0)
    print(f"retrieval worker ready {json.dumps(info)}", flush=True)
    while True:  # killed by the launcher, or exits via on_drained
        time.sleep(1.0)
