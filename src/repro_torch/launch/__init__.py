"""Command-line entry points of the port (``python -m
repro_torch.launch.<name>``): ``search_serve``, the serving CLI,
``allpairs``, the many-against-many clustering CLI, ``serve``, the LM
serving CLI (batched prefill + greedy decode), and ``train``, the LM
training CLI (checkpoints, resume, the LSH dedup stage)."""
