"""Data-parallel training and the row-sharded bank over
``torch.distributed`` (twin of ``satrans_tpu/parallel/``).

A rank is a process: each rank owns one device and runs the same
program on its block of the global batch (:mod:`.sharding`).  The bank's
physical rows can be split among the ranks; they are read through the
two-round exchange (:mod:`.embedding_sharded`) and updated on their
owners (:mod:`.bank_sharded`).  :mod:`.distributed` brings the process
group up and computes the exact AUC without gathering the scores.
Nothing here initialises a process group at import.
"""

from .sharding import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
