"""Synthetic sensor data: the scene configuration and the RGB/thermal scenes."""
