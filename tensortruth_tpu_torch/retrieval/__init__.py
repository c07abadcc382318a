"""Retrieval core: stacked-corpus engine, auto-merge, ranking gate, metrics."""
