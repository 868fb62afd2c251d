"""The plain reference: NumPy and plain PyTorch, nothing of the program."""
