"""Multi-rank execution: RNS-channel and coefficient sharding.

The JAX package lays its arrays over a GSPMD mesh; the port runs SPMD over
``torch.distributed`` process groups with explicit collectives (``comm``).
Each rank runs its own engine on its rows of the padded channel axis and,
on a mesh with a ``coef`` axis, its columns of the coefficient axis:
``CkksEngine(mesh=make_mesh(n))`` or ``CkksEngine(mesh=make_mesh2d(r, s))``
inside ``run_ranks(n, fn)`` (ranks as threads of one process, several on
one card if need be), or in each process of a ``torch.distributed`` job.
``coef_shard`` splits the coefficient axis of the transforms over the
``coef`` axis.
"""

from .sharding import (
    Mesh,
    coef_columns,
    local_rows,
    make_mesh,
    make_mesh2d,
    pad_channels_to,
    replicate_datastruct,
    rns_sharding,
    run_ranks,
    shard_datastruct,
    shard_poly,
)

__all__ = [
    "Mesh",
    "run_ranks",
    "make_mesh",
    "make_mesh2d",
    "shard_poly",
    "shard_datastruct",
    "replicate_datastruct",
    "rns_sharding",
    "local_rows",
    "coef_columns",
    "pad_channels_to",
]
