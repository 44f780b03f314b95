"""The cells' traffic at a size the CPU runs in a second: (configuration,
traffic) overrides by configuration name."""

SMALL = {
    "paper-bayes-fusion": ({"height": 4, "width": 8, "frames_per_batch": 2}, {}),
    "scenarios-4096": ({"n_bits": 256}, {"frames_per_call": 64, "ring": 2}),
}
