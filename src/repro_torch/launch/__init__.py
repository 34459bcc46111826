"""Command-line entry points of the port (``python -m
repro_torch.launch.<name>``): ``search_serve``, the serving CLI,
``allpairs``, the many-against-many clustering CLI, ``serve``, the LM
serving CLI (batched prefill + greedy decode), ``train``, the LM
training CLI (checkpoints, resume, the LSH dedup stage), and ``dryrun``,
the per-device sizing of every LM cell on the production mesh of
``meta`` entries (with ``mesh``, ``hlo_walk``, ``roofline`` and
``report``, which renders its tables)."""
