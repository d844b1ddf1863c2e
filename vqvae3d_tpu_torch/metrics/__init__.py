"""Reconstruction metrics of the port."""
