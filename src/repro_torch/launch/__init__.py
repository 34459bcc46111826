"""Command-line entry points of the port (``python -m
repro_torch.launch.<name>``): ``search_serve``, the serving CLI, and
``allpairs``, the many-against-many clustering CLI."""
