"""Multi-process runtime: join the process group, shard the batch.

Port of :mod:`spectralae.dist.multihost`.  JAX federates the hosts' devices
into one global device set; here each rank is one process, and
:func:`init_multihost` joins it to the default process group of
:mod:`torch.distributed`, on which :mod:`spectralae_torch.dist.mesh` builds
the mesh:

- :func:`init_multihost`: the rendezvous, with a timeout on every
  collective.  Each rank takes the card of its local index; the backend
  follows the device: NCCL where each rank has a card of its own, gloo
  for CPU ranks and for several ranks on one card (NCCL refuses two ranks
  on one GPU);
- :func:`local_batch_to_global`: this rank's slice of the batch, checked
  against the other shards' sizes (each rank feeds only its own frames; no
  rank holds the global batch);
- :func:`is_coordinator`: gate host-side effects (checkpoint writes,
  logging) to rank 0;
- :func:`spawn_ranks`: run a function on ``world`` ranks of this host, each
  a process started with the ``spawn`` method, with timeouts on the
  rendezvous, on every collective and on the whole run (the tests' gloo
  meshes on the CPU, and several ranks on one card).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from . import collectives


_NO_CARD = ("{fn}: torch finds no CUDA device; pass device=\"cpu\" to run "
            "the ranks on the CPU")


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   device: torch.device | str | None = None,
                   local_processes: int | None = None,
                   backend: str | None = None,
                   timeout: float = 300.0) -> str:
    """Join (or create) the multi-process runtime; returns the backend.

    ``coordinator``: ``host:port`` of rank 0's TCP store, or a
    ``file://`` or ``tcp://`` URL; with no arguments the rendezvous comes
    from the environment of ``torchrun`` (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).

    ``local_processes``: the ranks on this host, the rank's local index
    then ``process_id % local_processes`` (ranks numbered host by host);
    by default ``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` under ``torchrun``,
    else a host holds as many ranks as it has cards, at most
    ``num_processes``.

    ``device``: the rank's device, made the current one; by default, and
    for ``"cuda"`` with no index, the card of its local index.  With no
    card it raises: CPU ranks pass ``device="cpu"`` (there is no fallback
    to the CPU).

    ``backend``: by default NCCL when the device is a card and this host
    has a card for each of its ranks, else gloo: CPU ranks, or more ranks
    than cards (NCCL refuses two ranks on one GPU).  Every rank must make
    the same choice: ranks told to share one card pass ``"gloo"``.

    ``timeout``: seconds any collective may wait before it raises, so a
    rank that failed cannot leave the others hanging.  A second call in a
    process that has joined returns the backend.
    """
    if dist.is_initialized():
        return dist.get_backend()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_processes is None and "LOCAL_WORLD_SIZE" in os.environ:
        local = int(os.environ["LOCAL_WORLD_SIZE"])          # torchrun
        local_rank = int(os.environ["LOCAL_RANK"])
    else:
        local = local_processes or max(1, min(num_processes or 1, cards))
        local_rank = (process_id or 0) % local
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not cards:
        raise RuntimeError(_NO_CARD.format(fn="init_multihost"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank % max(cards, 1))
    if backend is None:
        backend = ("nccl" if device.type == "cuda" and local <= cards
                   else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if coordinator is None:
        url = "env://"
    elif "://" in coordinator:
        url = coordinator
    else:
        url = f"tcp://{coordinator}"
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return backend


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """True on the process that should perform host-side side effects."""
    return process_index() == 0


def local_batch_to_global(mesh, local_batch) -> torch.Tensor:
    """This rank's ``[B_local, D, H, W]`` slice of the batch, as the tensor
    the distributed functions take (each rank runs on its own shard; no
    rank assembles the global batch).  Raises unless every rank on the
    mesh's ``data`` axis holds as many frames."""
    x = torch.as_tensor(np.asarray(local_batch) if not torch.is_tensor(
        local_batch) else local_batch)
    collectives.check_shards(x.shape[0], mesh.axis("data"))
    return x


def _rank_main(fn, rank, world, url, device, backend, timeout, args,
               out) -> None:
    """One rank of :func:`spawn_ranks`: join the group, run ``fn``, report
    its result or its traceback, leave the group."""
    torch.set_num_threads(1)
    try:
        init_multihost(url, world, rank, device=device, local_processes=world,
                       backend=backend, timeout=timeout)
        # pickled here: a tensor put on the queue as it is would travel as
        # a shared-memory handle that dies with this process
        out.put((rank, True, pickle.dumps(fn(rank, *args))))
    except BaseException:     # reported to the parent, which raises it
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, args: tuple = (), *,
                device: torch.device | str | None = None,
                timeout: float = 180.0) -> list:
    """Run ``fn(rank, *args)`` on ``world`` ranks of one process group and
    return their results in rank order.

    Each rank is a process started with the ``spawn`` method (never
    ``fork``: the parent may hold CUDA or torch threads), with one torch
    thread, joined by :func:`init_multihost` over a ``FileStore`` in a
    fresh temporary directory (no TCP port, so concurrent runs cannot
    collide).  ``fn`` and its results must pickle; ``fn`` must live in a
    module the ranks can import.  ``device``: ``"cuda"`` (the default) for
    a card a rank (NCCL when the host has enough, else gloo), one card
    (``"cuda:0"``) that every rank shares over gloo, or ``"cpu"`` (gloo);
    with no card and no ``"cpu"`` it raises before it starts a rank.
    Every collective waits at most ``timeout`` seconds, and so does the
    whole run: a rank that raises, dies or hangs ends the run, every rank
    is killed, and the first traceback is raised as a RuntimeError.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(_NO_CARD.format(fn="spawn_ranks"))
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="spectralae_ranks_")
    out = ctx.Queue()
    url = f"file://{tmp}/store"
    backend = ("gloo" if world > 1 and dev.type == "cuda"
               and dev.index is not None else None)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, url, str(dev), backend, timeout,
                               args, out)) for r in range(world)]
    results, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        # drain the queue before joining: a rank blocks on a full pipe
        while len(results) < world and failure is None:
            try:
                rank, ok, value = out.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    time.sleep(0.5)    # its report may still be in flight
                    if out.empty():
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    failure = (f"the ranks did not finish in {timeout:g} s "
                               f"(results from {sorted(results)})")
                continue
            if ok:
                results[rank] = pickle.loads(value)
            else:
                failure = f"rank {rank} raised:\n{value}"
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()) if failure is None
                   else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}, "
                           f"{world}): {failure}")
    return [results[r] for r in range(world)]
