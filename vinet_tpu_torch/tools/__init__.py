"""Measurement tools for the port's kernels on a CUDA card (nothing here runs
on the model's path)."""
