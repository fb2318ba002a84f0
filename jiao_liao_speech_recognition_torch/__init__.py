"""PyTorch / CUDA port of the Jiao-Liao Mandarin ASR framework for one
NVIDIA H100 (sm_90a), beside the JAX package it is held against.

This slice covers flagship greedy CTC transcription: log-mel (K1), the
conv subsampler, pre-LN blocks with the fused attention (K2) and
LN+MLP+residual (K3) sublayers, and the fused head+argmax (K4). The four
kernels are CUDA C++ in ``csrc/``, built at first use by ``_build.py``.
Entry points: ``api.load`` / ``api.featurize`` / ``api.transcribe``.
"""
