"""Distribution over a ``torch.distributed`` process group.

Counterpart of ``petibm_tpu/parallel/``: the reference's MPI/PETSc DMDA
domain decomposition (reference: cartesianmesh.cpp:492-538).  One process
runs per device and owns one block of every grid field; the halo
exchanges, the reductions and the FDM's all-to-all transposes are
explicit collectives (``dist.py``), where the JAX package leaves them to
GSPMD.  ``sharded_step``, ``shard_state``, ``constrain_*`` and
``state_shardings`` annotate jax arrays and have no counterpart: a
decomposed solver holds its blocks from the start.
"""

from .dist import (  # noqa: F401
    FIELD_KEYS,
    GroupSum,
    LevelBlocks,
    LocalMesh,
    Partition,
    ProcessMesh,
    counters,
    mesh_from_config,
    reset_counters,
)
from .multihost import (  # noqa: F401
    is_initialized,
    local_rank,
    maybe_initialize,
    process_info,
)
