"""Process groups for the sharded paths (no JAX counterpart: it stands in
for ``jax.sharding.Mesh``; one process per rank, as MPI's ``mpirun``).

* :func:`init` joins this process to the group: NCCL for the card, gloo
  for ``device="cpu"``.  Without ``rank`` and ``world`` it reads
  ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).  On the card a
  rank runs on the card of its local rank, and more ranks on a host than
  it has cards raise (with ``rank`` and ``world`` given, every rank is on
  this host).
* :func:`spawn` starts ``world`` ranks on this host (the spawn start
  method, rendezvous through a ``FileStore`` in a fresh temporary
  directory, so no TCP port is taken) and returns every rank's result.
* :func:`run_single` runs world size 1 in this process: the sharded path
  on one card.

Running the sharded bioheat step on n cards::

    torchrun --nproc-per-node n my_script.py   # my_script calls init()
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: how long a rank waits for its peers in a collective before failing
TIMEOUT = datetime.timedelta(seconds=300)


def init(device=None, rank=None, world=None, store=None) -> torch.device:
    """Join the process group and return this rank's device: ``None`` or
    ``"cuda"`` is card ``rank`` over NCCL, ``"cpu"`` the CPU over gloo."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if rank is None:
        env = os.environ
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    else:
        local, local_world = rank, world
    if cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        if local_world > torch.cuda.device_count():
            raise RuntimeError(f"a world of {local_world} ranks on this host "
                               f"needs {local_world} cards; "
                               f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if not dist.is_initialized():
        kw = dict(store=store) if store is not None else dict(init_method="env://")
        dist.init_process_group("gloo" if cpu else "nccl", rank=rank,
                                world_size=world, timeout=TIMEOUT, **kw)
        # a first collective that every rank joins: NCCL sets up its
        # communicator there, so a later batch of point-to-point ops (a halo
        # colour) may leave out ranks without a partner
        dist.all_reduce(torch.zeros(1, device=dev))
    return dev


def _rank_main(rank, world, path, device, fn, args, results):
    """One spawned rank: join, run ``fn(rank, world, dev, *args)``, leave."""
    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dev = init(device, rank, world, dist.FileStore(path, world))
        try:
            out = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, device, *args, timeout: float = 600.0) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` new processes and
    return the results in rank order.  ``fn`` must be importable by name
    (a module-level function) and its result picklable.  Raises with the
    failing rank's traceback if any rank fails."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="par_store_")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, os.path.join(tmp, "store"), device,
                               fn, args, results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out = {}
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
        while len(out) < world:
            while results.empty():
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} "
                                       f"did not finish in {timeout} s")
                if any(p.exitcode not in (None, 0) for p in procs) and results.empty():
                    bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    raise RuntimeError(f"ranks {bad} died without a result")
                procs[0].join(0.05)
            rank, ok, val = results.get()
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(60)
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)


def run_single(fn, device=None):
    """``fn(0, 1, dev)`` in this process at world size 1: NCCL on the card
    (``None``), gloo on ``"cpu"``."""
    dev = init(device, 0, 1, dist.HashStore())
    try:
        return fn(0, 1, dev)
    finally:
        dist.destroy_process_group()
