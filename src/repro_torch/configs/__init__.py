"""Selectable configurations of the port (the paper's own workload so far)."""
