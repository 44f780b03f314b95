"""Command-line launchers of the port: LM serving (``serve``) and training (``train``)."""
