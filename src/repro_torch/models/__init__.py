"""The LM zoo of the PyTorch port: layers, attention with KV caches,
the decoder-only stack (dense and VLM) and ``model.build_model``."""
