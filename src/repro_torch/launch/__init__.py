"""Command-line launchers of the port (the LM serving launcher so far)."""
