"""Losses, optimizer, train/eval steps and metrics."""
