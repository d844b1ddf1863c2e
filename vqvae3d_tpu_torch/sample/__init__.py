"""Ancestral sampling of code grids from the priors: naive and cached."""
