"""Character tokenizer, manifests and the host batch pipeline."""
