"""Network, dynamics and simulation loop of the PyTorch port."""
