"""Greedy CTC decoding."""
