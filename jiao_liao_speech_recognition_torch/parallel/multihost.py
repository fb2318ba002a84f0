"""Multi-process training runtime, the JAX package's ``parallel/multihost.py``
on ``torch.distributed``.

JAX runs one controller per host over all of its devices; torch runs one
process per card. ``initialize`` wires the processes into one process
group, after which every process runs the same program: the data pipeline
builds the same seeded epoch plan everywhere and collates only this
process's rows (data/pipeline.py), the model is wrapped by FSDP2 over the
mesh (parallel/mesh.py), and host IO (metrics, the final bundle, checkpoint
retention) is the primary process's.

Topology, first found wins: the arguments; ``JL_COORDINATOR`` (host:port),
``JL_NUM_PROCESSES``, ``JL_PROCESS_ID``; then ``torch.distributed.run``'s
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``.
On a card the backend is NCCL with the process bound to its card; gloo
when the caller asks for the CPU (the tests). Without a process group,
``process_count()`` is 1, ``is_primary()`` true and ``barrier`` a no-op.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list] = None,
    device: str = "cuda",
    graph_collectives: bool = False,
) -> None:
    """Join the process group (idempotent). `device` "cuda" binds this
    process to its card (``local_device_ids[0]``, else ``LOCAL_RANK``, else
    the process id modulo the visible cards) and raises without one; "cpu"
    takes gloo. `graph_collectives` says that NCCL collectives will be
    captured in CUDA graphs (the serving engine's step on a split model):
    it sets ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` before the group starts,
    as PyTorch's CUDA-graph notes on whole-network capture ask, which also
    turns off NCCL's watchdog abort of a stuck or failed rank. Training
    leaves it False."""
    if is_initialized():
        return
    env = os.environ
    coordinator_address = coordinator_address or env.get("JL_COORDINATOR")
    init = f"tcp://{coordinator_address}"
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        init = "env://"  # torch.distributed.run's store, which its agent may host
    if num_processes is None:
        num = env.get("JL_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(num) if num else None
    if process_id is None:
        pid = env.get("JL_PROCESS_ID") or env.get("RANK")
        process_id = int(pid) if pid else None
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize: no topology; pass coordinator_address, num_processes and process_id, "
            "set JL_COORDINATOR / JL_NUM_PROCESSES / JL_PROCESS_ID, or launch under "
            "python -m torch.distributed.run")
    if torch.device(device).type == "cpu":
        dist.init_process_group("gloo", init_method=init, world_size=num_processes,
                                rank=process_id)
        return
    if not torch.cuda.is_available():
        raise RuntimeError("initialize: asked for cuda, but no CUDA device is visible")
    if local_device_ids:
        local = int(local_device_ids[0])
    elif env.get("LOCAL_RANK"):
        local = int(env["LOCAL_RANK"])
    else:
        local = process_id % torch.cuda.device_count()
    torch.cuda.set_device(local)
    if graph_collectives:
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "0"
    dist.init_process_group("nccl", init_method=init, world_size=num_processes,
                            rank=process_id, device_id=torch.device("cuda", local))


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()


def device_type() -> str:
    """The device type of the group's collectives: "cuda" for NCCL, else
    "cpu" (and "cpu" without a group)."""
    return "cuda" if is_initialized() and dist.get_backend() == "nccl" else "cpu"


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns host IO (metrics, the final bundle,
    checkpoint files and their retention): rank 0."""
    return process_index() == 0


def barrier(tag: str = "jl_barrier") -> None:
    """Block until every process reaches this point (no-op single-process).
    `tag` names the point, as JAX's ``sync_global_devices`` does; torch's
    barrier takes no name."""
    del tag
    if process_count() > 1:
        dist.barrier()


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """x summed over every process, over `group`'s, or over each group of a
    tuple of them in turn (x itself, single-process); x is not changed."""
    if process_count() == 1:
        return x
    y = x.detach().clone().to(device_type())
    for g in group if isinstance(group, tuple) else (group,):
        dist.all_reduce(y, group=g)
    return y.to(x.device)


def any_process(flag: bool) -> bool:
    """True when `flag` is true on any process (a SIGTERM seen by one)."""
    if process_count() == 1:
        return flag
    return bool(all_sum(torch.tensor([int(flag)], device=device_type())).item())


def broadcast_object(obj):
    """Rank 0's `obj` on every process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
