"""Tensor parallelism of one role over the devices of its submesh
(``parallel.tp``), and the per-device leaf record it is built on
(``parallel.shards``)."""
