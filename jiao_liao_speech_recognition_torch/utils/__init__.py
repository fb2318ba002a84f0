"""Config twins (config.py)."""
