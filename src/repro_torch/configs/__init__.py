"""Configs of the PyTorch port (its own copy of the DPSNN dataclasses)."""
