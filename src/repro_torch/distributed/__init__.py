"""Distribution and fault tolerance: the ambient mesh context (its
single-device half) and, for the serving path, watchdog, CUSUM and seeded
chaos."""
