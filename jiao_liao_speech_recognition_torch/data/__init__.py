"""Character tokenizer."""
