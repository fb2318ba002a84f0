"""Encoder layers, the CTC model, the weight bridge and ModelBundle."""
