"""Kernel wrappers (K2 fused_attention, K3 fused_mlp, K4 fused_head) with their plain versions."""
