"""Counterparts of the JAX package's ``scripts/`` that the port runs."""
