"""Attention ops of the port: the plain versions and the hand-written kernels."""
