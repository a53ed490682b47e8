"""The plain reference the benchmark holds the port against: frozen copies
of both models, the losses and the optimizer step in PyTorch calls alone.
It imports nothing of the port."""
