"""Small helpers: device selection, weight conversion."""
