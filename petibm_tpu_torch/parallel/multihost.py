"""Multi-process bring-up: ``torch.distributed.init_process_group``.

Counterpart of ``petibm_tpu/parallel/multihost.py`` (multihost.py:1-95).
The reference's multi-node story is MPI: every rank calls PetscInitialize
and DMDA decomposes grids across all ranks (reference:
cartesianmesh.cpp:492-538).  Here one process runs per device and joins a
``torch.distributed`` process group; the ``parameters.sharding`` node then
decomposes the fields over the group (``parallel/dist.py``).

Config (YAML or API dict), the JAX package's keys:

  parameters:
    distributed: true            # from the environment
    # or explicit:
    distributed:
      coordinator: "10.0.0.1:1234"
      numProcesses: 4
      processId: 0               # or from the environment, see below

Environment: the JAX package's PETIBM_TPU_COORDINATOR,
PETIBM_TPU_NUM_PROCESSES, PETIBM_TPU_PROCESS_ID and PETIBM_TPU_DISTRIBUTED
(opt in without a config node), and torchrun's RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT; a launch by torchrun (WORLD_SIZE
> 1 with MASTER_ADDR set) opts in as PETIBM_TPU_DISTRIBUTED does.  The
backend follows the device: NCCL for a run on cuda, gloo on the CPU.
"""

from __future__ import annotations

import os

_SINGLE = False


def _torchrun() -> bool:
    return (int(os.environ.get("WORLD_SIZE", "1")) > 1
            and bool(os.environ.get("MASTER_ADDR")))


def is_initialized() -> bool:
    """Whether a process group is up (or a single process was set up)."""
    import torch.distributed as dist

    return _SINGLE or (dist.is_available() and dist.is_initialized())


def maybe_initialize(node=None, device=None) -> bool:
    """Bring the process group up if asked and not already up.

    ``node`` is the ``parameters.distributed`` value: absent or falsy means
    a single process (no-op) unless PETIBM_TPU_DISTRIBUTED or a torchrun
    launch opts in; ``true`` reads the environment; a dict gives
    coordinator/numProcesses/processId.  ``device`` is the solver's device
    request (None means cuda), which picks the backend: NCCL, or gloo on
    the CPU.  Returns
    True when a process group is (now) initialized."""
    global _SINGLE
    import torch.distributed as dist

    if node is None and (os.environ.get("PETIBM_TPU_DISTRIBUTED", "")
                         not in ("", "0", "false") or _torchrun()):
        node = True
    if not node:
        return is_initialized()
    if is_initialized():
        return True
    explicit = node if isinstance(node, dict) else {}
    coord = explicit.get("coordinator",
                         os.environ.get("PETIBM_TPU_COORDINATOR"))
    nproc = explicit.get("numProcesses",
                         os.environ.get("PETIBM_TPU_NUM_PROCESSES",
                                        os.environ.get("WORLD_SIZE")))
    pid = explicit.get("processId", os.environ.get(
        "PETIBM_TPU_PROCESS_ID", os.environ.get("RANK")))
    if coord is None and os.environ.get("MASTER_ADDR"):
        coord = (f"{os.environ['MASTER_ADDR']}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
    if int(nproc or 1) == 1 and coord is None:
        # a single process with nothing to coordinate (JAX :79-85)
        _SINGLE = True
        return True
    if coord is None or pid is None or nproc is None:
        raise ValueError("parameters.distributed needs a coordinator, "
                         "numProcesses and processId (or torchrun's "
                         "MASTER_ADDR, WORLD_SIZE and RANK)")
    cpu = device is not None and str(device).startswith("cpu")
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://{coord}",
                            rank=int(pid), world_size=int(nproc))
    return True


def shutdown() -> None:
    """Leave the process group at the end of a run: a barrier, so that no
    rank tears its transport down while another still reads from it, then
    ``destroy_process_group``.  A no-op without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank() -> int:
    """The rank among the processes of this host (torchrun's LOCAL_RANK),
    else the global rank."""
    return int(os.environ.get("LOCAL_RANK", process_info()[0]))
