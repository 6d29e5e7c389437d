"""The plain reference the benchmark holds the fit to: plain PyTorch, nothing of the program."""
