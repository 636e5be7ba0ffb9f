"""Axis roles of a run (port of the reference ``parallel/sharding.py``'s
``make_parallel_config``).

On the port's process-group mesh (``launch/mesh.py``): the batch shards
over ``data`` when the global batch divides by its size, and the sequence
over ``model`` (the paper's P workers).  Parameters are replicated; the
reference's FSDP layout is not ported.
"""
from __future__ import annotations

from repro_torch.core.config import ParallelConfig, ShapeSpec
from repro_torch.launch.mesh import mesh_axis_size


def make_parallel_config(mesh, shape: ShapeSpec,
                         schedule: str = "balanced",
                         remat: str = "remat_aware") -> ParallelConfig:
    """Resolve axis roles for ``shape`` on ``mesh`` (None: one process)."""
    names = ("data", "model") if mesh is None else mesh.axis_names
    batch_axes = []
    if "data" in names:
        n = mesh_axis_size(mesh, "data")
        if shape.global_batch % n == 0 and shape.global_batch >= n:
            batch_axes.append("data")
    return ParallelConfig(batch_axes=tuple(batch_axes), seq_axis="model",
                          fsdp_axes=tuple(a for a in ("data",)
                                          if a in names),
                          schedule=schedule, remat=remat)
