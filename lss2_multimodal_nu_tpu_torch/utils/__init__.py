"""Logging, profiling and visualisation utilities."""
