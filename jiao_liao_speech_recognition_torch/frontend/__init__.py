"""Log-mel frontend: features.py (plain), fused_frontend.py (K1), cmvn.py, audio_io.py."""
