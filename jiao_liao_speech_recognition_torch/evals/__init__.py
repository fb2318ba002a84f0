"""Evaluation metrics of the PyTorch port."""
