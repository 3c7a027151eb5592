"""LM serving: caches, cache-building prefill and greedy decode steps."""
