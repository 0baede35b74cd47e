"""Multi-process runtime: the ranks, their devices and their transport.

Port of dynfu_tpu/dist/runtime.py. JAX runs one process over all devices;
here every rank is a process of its own, in one torch.distributed process
group:

* rank r runs on cuda:(local rank % cards) (`rank_device`);
* the transport is NCCL when every local rank has a card of its own, gloo
  with CUDA tensors when ranks share a card, and gloo on the CPU
  (device="cpu", the tests). The kernels run on the card in both CUDA
  cases; only the transport changes. An explicit backend="nccl" that
  cannot be served (two ranks on one card) raises. Rank 0 prints the
  backend it chose.

Launch, one of:
    torchrun --nproc-per-node 2 -m dynfu_tpu_torch.io.cli run <dataset>
    DYNFU_COORDINATOR=host0:9876 DYNFU_NUM_PROCESSES=4 DYNFU_PROCESS_ID=$i \\
        python -m dynfu_tpu_torch.io.cli run <dataset> --devices 4
or `spawn(fn, n, *args)` from one process: local ranks by
torch.multiprocessing, meeting through a FileStore in a temporary directory
(no port); `dynfu-torch run --devices N` uses it when no launcher set the
ranks.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

# a rank whose peer died fails its collective after this, instead of
# waiting forever
TIMEOUT = datetime.timedelta(seconds=300)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


def choose_backend(device, local_world: int,
                   backend: Optional[str] = None) -> str:
    """gloo on the CPU; on CUDA NCCL when each of the host's `local_world`
    ranks has a card, else gloo (the ranks share a card). An explicit
    backend that cannot be served raises."""
    if torch.device(device).type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: gloo only")
        return "gloo"
    cards = torch.cuda.device_count()
    if backend is None:
        return "nccl" if local_world <= cards else "gloo"
    if backend == "nccl" and local_world > cards:
        raise ValueError(f"backend 'nccl' needs a card per rank: "
                         f"{local_world} ranks on {cards} card(s)")
    return backend


def rank_device(device="cuda") -> torch.device:
    """The calling rank's device: cuda:(local rank % cards), or the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
    store=None,
) -> bool:
    """Join the process group, from the arguments, DYNFU_COORDINATOR /
    DYNFU_NUM_PROCESSES / DYNFU_PROCESS_ID, or torchrun's MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK (or through `store`, as `spawn` does).

    Returns True when a process group is up, False for one process without
    a store (a no-op). Idempotent; errors other than "already initialised"
    propagate."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("DYNFU_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(env.get("DYNFU_PROCESS_ID", "-1"))
    if store is None:
        coordinator_address = (coordinator_address
                               or env.get("DYNFU_COORDINATOR"))
        if not coordinator_address and "MASTER_ADDR" in env \
                and "WORLD_SIZE" in env:
            coordinator_address = (f"{env['MASTER_ADDR']}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
            num_processes = int(env["WORLD_SIZE"])
            process_id = int(env.get("RANK", "0"))
        if not coordinator_address or num_processes <= 1:
            return False
        kw = dict(init_method=f"tcp://{coordinator_address}")
    else:
        kw = dict(store=store)
    local_world = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend = choose_backend(device, local_world, backend)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id))
                              % torch.cuda.device_count())
    try:
        dist.init_process_group(backend, world_size=num_processes,
                                rank=process_id, timeout=TIMEOUT, **kw)
    except (RuntimeError, ValueError) as e:  # already initialised
        if "already" not in str(e).lower() and "twice" not in str(e).lower():
            raise
    if process_id == 0:
        print(f"dist: {num_processes} rank(s), backend {backend}", flush=True)
    return True


def is_primary() -> bool:
    """True on the process that writes artifacts and logs (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(rank, fn, n_ranks, store_path, device, backend, args):
    init_distributed(num_processes=n_ranks, process_id=rank, device=device,
                     backend=backend, store=dist.FileStore(store_path,
                                                           n_ranks))
    try:
        return fn(*args)
    finally:
        dist.destroy_process_group()


def _child(i, first, *rest):
    _rank_main(i + first, *rest)


def spawn(fn, n_ranks: int, *args, device="cuda",
          backend: Optional[str] = None, inline: bool = False):
    """Run fn(*args) on `n_ranks` local ranks, each in the process group
    (through a FileStore in a temporary directory). fn must be importable
    (a module-level function): the children are spawned processes. With
    `inline`, rank 0 is the calling process and fn's return value there is
    returned; otherwise every rank is a child and None is returned. Every
    child has exited when this returns; a failed rank raises here."""
    import torch.multiprocessing as mp

    first = int(inline)
    tmp = tempfile.mkdtemp(prefix="dynfu_ranks_")
    store = os.path.join(tmp, "store")
    rest = (fn, n_ranks, store, device, backend, args)
    try:
        ctx = mp.start_processes(_child, args=(first, *rest),
                                 nprocs=n_ranks - first, join=False,
                                 start_method="spawn")
        try:
            out = _rank_main(0, *rest) if inline else None
            while not ctx.join():
                pass
        except BaseException:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
            raise
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
