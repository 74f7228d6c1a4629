"""The benchmark's general code: the manifest, the window, the trace
reduction, the roofline and FLOP counts, the weights and the comparison
with the reference."""
