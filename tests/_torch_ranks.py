"""Multi-process harness of the port's parallel tests: gloo worlds on the CPU.

``spawn(suite, world, tmp_path, **args)`` starts ``world`` processes of this
file, each ``python _torch_ranks.py <suite> <rank> <world> <dir>``; they meet
through a ``FileStore`` under ``dir`` (no TCP port), run with one thread,
call ``suite(rank, world, dir, args)`` from the test module named in the
suite (``module:function``) and write what it returns (a dict of numpy
arrays) to ``<dir>/rank<r>.npz``. The processes import the port only: the
JAX side of every comparison runs in the test process. Returns the ranks'
results, ``[dict] * world``, or raises with their stderr.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)


def spawn(suite: str, world: int, directory, timeout: float = 240.0, **args) -> list[dict]:
    directory = str(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "args.json"), "w") as f:
        json.dump(args, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([_ROOT, _HERE, os.environ.get("PYTHONPATH", "")]))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), suite, str(r),
                               str(world), directory], env=env, cwd=_ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(f"rank {r} exited {p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise RuntimeError("\n".join(errs))
    out = []
    for r in range(world):
        with np.load(os.path.join(directory, f"rank{r}.npz"), allow_pickle=False) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _main() -> None:
    suite, rank, world, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(directory, "args.json")) as f:
        args = json.load(f)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        module, fn = suite.split(":")
        result = getattr(importlib.import_module(module), fn)(rank, world, directory, args)
        np.savez(os.path.join(directory, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in (result or {}).items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
