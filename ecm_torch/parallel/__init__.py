"""Parallelism of the port (``ecm_tpu.parallel``): a ``("data", "disp")``
mesh over a ``torch.distributed`` process group; on the data axis,
global-batch BatchNorm, loss and metrics under :func:`use_mesh`; on the
disparity axis, each rank's slab of the disparities with the halo exchanges
of ``halo`` and their backward; and ``dryrun`` (the counterpart of
``__graft_entry__.dryrun_multichip``)."""

from ecm_torch.parallel.sharding import (
    Mesh,
    active_mesh,
    batch_sharding,
    constrain_features,
    constrain_volume,
    init_from_env,
    is_main_process,
    make_mesh,
    replicate,
    use_mesh,
)

__all__ = [
    "Mesh",
    "active_mesh",
    "batch_sharding",
    "constrain_features",
    "constrain_volume",
    "init_from_env",
    "is_main_process",
    "make_mesh",
    "replicate",
    "use_mesh",
]
