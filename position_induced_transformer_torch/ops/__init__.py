"""Plain PyTorch operators: distances, locality, initializers, position attention."""
