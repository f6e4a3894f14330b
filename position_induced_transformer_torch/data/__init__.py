"""Data loaders, synthetic generators and mesh builders (numpy)."""
