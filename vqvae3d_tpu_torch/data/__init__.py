"""Host-side data modules of the port (numpy only; no torch, no jax)."""
