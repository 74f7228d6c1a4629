"""The process group of data-parallel runs (counterpart of
``istnet_tpu/parallel/multihost.py``).

One process per device, PyTorch's idiom for the JAX package's mesh. A run
is configured by torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, set on every process) or
by the caller's arguments: ``spawn`` below hands its processes a store on
127.0.0.1, a test a ``file://`` rendezvous.

``initialize`` joins the group: NCCL for the card, gloo when the caller asks
for the CPU (or names gloo, which also takes CUDA tensors: two ranks that
share one card, where NCCL refuses). Nothing configured: a no-op, the
single-process run. Configured and the handshake fails: it raises, as JAX's
does (``istnet_tpu/parallel/multihost.py:60-69``); a pod run must never
degrade into N independent runs, and NCCL failing never drops to gloo.
"""

from __future__ import annotations

import datetime
import os
import pickle

import torch
import torch.distributed as dist

LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
SPAWN_HOST = "127.0.0.1"


def launch_env() -> dict | None:
    """torchrun's variables of this process, None when none is set; a
    partial set raises (a launch that half configured itself)."""
    present = {k: os.environ[k] for k in (*LAUNCH_VARS, "LOCAL_RANK")
               if os.environ.get(k)}
    if not present:
        return None
    missing = [k for k in LAUNCH_VARS if k not in present]
    if missing:
        raise RuntimeError(f"a multi-process launch is configured "
                           f"({sorted(present)}) but {missing} are not set")
    return present


def initialize(device: str | torch.device = "cuda", *,
               backend: str | None = None, init_method: str | None = None,
               store=None,
               rank: int | None = None, world_size: int | None = None,
               local_rank: int | None = None,
               timeout: datetime.timedelta | None = None) -> torch.device:
    """Join the process group; returns this process's device (``cuda:
    LOCAL_RANK`` on the card, made current, or the CPU).

    The launch comes from ``init_method`` or ``store`` with ``rank`` and
    ``world_size`` when given, else from torchrun's variables. Nothing
    configured: no group, and ``device`` as it is. Already in a group: the
    device only."""
    device = torch.device(device)
    if rank is None:
        env = launch_env()
        if env is None:
            return device
        # torch's env:// rendezvous reads the same variables (and, under
        # torchrun, joins the agent's store)
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
    local_rank = rank if local_rank is None else local_rank
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: no CUDA card; pass "
                               "device='cpu' for a gloo group on the CPU")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {} if timeout is None else {"timeout": timeout}
    if device.type == "cuda" and backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size, **kwargs)
    return device


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Every process of the group meets here; a no-op without a group."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def per_host_batch_size(global_batch: int, n: int | None = None) -> int:
    """The slice of the global batch each of ``n`` processes (this group's
    by default) loads."""
    n = process_count() if n is None else n
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} hosts")
    return global_batch // n


def _spawned(index: int, fn, world: int, port: int, queue, args) -> None:
    store = dist.TCPStore(SPAWN_HOST, port, world_size=None, is_master=False)
    # plain pickle bytes: torch's queue would share a tensor's memory through
    # this process, which may have exited before the parent reads it
    queue.put((index, pickle.dumps(fn(index, world, store, *args))))


def spawn(fn, nprocs: int, *args, timeout: float | None = None) -> list:
    """Run ``fn(rank, world, store, *args)`` in ``nprocs`` processes (start
    method ``spawn``) and return their results in rank order. ``store`` is
    a client of a TCP store this process serves on 127.0.0.1 (the port the
    system picks, so concurrent runs cannot collide): pass it to
    ``initialize(..., store=store, rank=rank, world_size=world)``. A
    process that raises or dies ends the others and raises here; so does
    running past ``timeout`` seconds (a hang)."""
    import time

    import torch.multiprocessing as mp

    store = dist.TCPStore(SPAWN_HOST, 0, world_size=None, is_master=True,
                          wait_for_workers=False)
    queue = mp.get_context("spawn").SimpleQueue()
    context = mp.start_processes(_spawned, args=(fn, nprocs, store.port, queue,
                                                 args),
                                 nprocs=nprocs, join=False,
                                 start_method="spawn")
    results = {}

    def drain() -> None:
        while not queue.empty():
            index, value = queue.get()
            results[index] = pickle.loads(value)

    # drained while waiting: a result larger than the pipe's buffer blocks
    # its writer until it is read
    start = time.monotonic()
    while not context.join(timeout=0.5):
        drain()
        if timeout is not None and time.monotonic() - start > timeout:
            for proc in context.processes:
                proc.kill()
            raise TimeoutError(f"spawned processes ran past {timeout} s")
    drain()
    return [results[i] for i in range(nprocs)]
