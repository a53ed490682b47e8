"""Runs on more than one device over `torch.distributed`."""
