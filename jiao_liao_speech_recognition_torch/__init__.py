"""PyTorch / CUDA port of the Jiao-Liao Mandarin ASR framework for one
NVIDIA H100 (sm_90a), beside the JAX package it is held against.

The port covers flagship greedy CTC transcription (K1 log-mel, K2/K3 fused
sublayers, K4 head + argmax), WF-adapter fine-tuning (K6/K8 flash, K7),
Whisper large-v3 greedy transcription (K5 LN+QKV, K6, K3 at d=1280, K9
decode attention), Whisper serving (``serve/engine.py``) and CTC streaming
(``serve/streaming.py``). The kernels are CUDA C++ in ``csrc/``, built at
first use by ``_build.py``. Entry points: ``api.load`` / ``api.featurize`` /
``api.transcribe`` / ``api.fine_tune`` / ``api.stream``.
"""
