"""Stage-1 model of the port: blocks, the EMA quantizer (eval path) and the VQ-VAE."""
