"""The (data, model) device mesh on ``torch.distributed``
(``parallel/mesh.py``), tensor and spatial parallelism in the graph
executor (``parallel/sharding.py``), and serving many camera streams
(``parallel/streams.py``)."""
