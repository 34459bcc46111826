"""The paper's configurations (``configs/scallops.py``)."""
