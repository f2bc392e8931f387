"""Numerical ops: primitives, the attention kernel's wrapper, top-k masks, distances."""
