"""The plain PyTorch reference the benchmark holds the program to: float32,
TF32 off, no kernel, fold or cache, and nothing of the program under
test."""
