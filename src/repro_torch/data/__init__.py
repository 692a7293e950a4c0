"""The data pipeline of the PyTorch port (``pipeline.py``)."""
