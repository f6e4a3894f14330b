"""Benchmark setup, checkpoints, inference and serving."""
