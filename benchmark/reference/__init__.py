"""The plain reference the benchmark holds the port to: plain PyTorch,
importing nothing of the program."""
