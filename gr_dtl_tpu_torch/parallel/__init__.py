"""Multi-stream, multi-rank receivers over a ``(stream, time)`` grid of
``torch.distributed`` ranks (port of gr_dtl_tpu/parallel/): the grid
(``mesh``), process start-up (``dist``), the collectives (``_coll``), the
sharded batch receiver and loopback (``stream``), the always-on sharded
session (``session``) and the spawning of worker processes (``launch``)."""
