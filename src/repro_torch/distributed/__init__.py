"""Distribution and fault tolerance: the ambient mesh context (its
single-device half) and the fault hooks of the serving and training paths:
watchdog, CUSUM, seeded chaos, preemption guard, straggler watch and
loss-spike rewind."""
