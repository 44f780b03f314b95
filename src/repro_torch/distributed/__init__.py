"""Fault tolerance for the serving path: watchdog, CUSUM, seeded chaos."""
