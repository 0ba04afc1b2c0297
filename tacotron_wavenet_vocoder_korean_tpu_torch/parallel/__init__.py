"""Multi-process training: the JAX package's device mesh as
``torch.distributed`` process groups, sharding rules over the train
state, and the collectives of data and tensor parallelism (counterpart of
the JAX package's ``parallel``)."""
from .mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, P, all_reduce_mean,
    all_reduce_sum, choose_backend, copy_to_model, gather_tree, make_mesh,
    mesh_ranks, reduce_from_model, shard_tree, tree_placements)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "P",
    "all_reduce_mean", "all_reduce_sum", "choose_backend", "copy_to_model",
    "gather_tree", "make_mesh", "mesh_ranks", "reduce_from_model",
    "shard_tree", "tree_placements",
]
