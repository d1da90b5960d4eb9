"""The plain reference: float32 PyTorch, no kernels, nothing of the
program."""
