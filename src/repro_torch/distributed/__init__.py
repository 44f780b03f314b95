"""Distribution and fault tolerance: the ambient mesh context
(``context.py``), the sharding rules (``sharding.py``), the GPipe pipeline
(``pipeline.py``), and the fault hooks of the serving and training paths
(``fault.py``: watchdog, CUSUM, seeded chaos, preemption guard, straggler
watch and loss-spike rewind)."""
