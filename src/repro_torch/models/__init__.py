"""Model heads of the port (the Bayes decision head so far)."""
