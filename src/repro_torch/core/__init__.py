"""Bit, entropy and key primitives of the port (torch, no JAX)."""
