"""Perona core: preprocessing, graphs, the model and its parameters."""
