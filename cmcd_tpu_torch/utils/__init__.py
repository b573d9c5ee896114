"""Utilities of the port (the JAX package's checkpointing, W2, PSIS,
logging and plotting wait for ROADMAP queue A)."""
