"""Training of the PyTorch port: engine and checkpoints."""
