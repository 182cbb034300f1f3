"""Multi-rank scaling: the mesh of ranks and the row-partitioned box and
table solves.

The state dimension (the flat cell axis of the masked box) is the single
parallel axis of the Krylov-FSP math.  ``sharded.py`` holds the mesh (one
process per rank over ``torch.distributed``), the row-sharded box step and
the row-sharded table operator, matvec and step;
``multihost.py`` starts and joins the processes; ``dryrun.py`` runs a
whole sharded solve as a check.
"""

__all__ = [
    "ShardMesh",
    "make_mesh",
    "operator_shardings",
    "shard_operator",
    "sharded_box_step_fn",
    "sharded_dilate_fn",
    "sharded_matvec",
    "sharded_step_fn",
]


def __getattr__(name):
    if name in __all__:
        from . import sharded

        return getattr(sharded, name)
    raise AttributeError(name)
