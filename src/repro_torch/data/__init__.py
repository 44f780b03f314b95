"""Synthetic sensor data (scene configuration only, so far)."""
