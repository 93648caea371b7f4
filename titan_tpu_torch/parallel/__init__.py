"""The multi-device layer (port of ``titan_tpu/parallel/``): the vertex
mesh over ``torch.distributed`` (``mesh.py``), the partitioning and the
sparse exchange (``partition.py``), and the process-group set-up and the
rank launcher (``multihost.py``)."""
