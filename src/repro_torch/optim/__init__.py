"""Optimizers of the PyTorch port (``optimizer.py``)."""
