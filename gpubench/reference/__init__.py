"""Plain references of the configurations: PyTorch operations only, and
nothing of the program under test."""
