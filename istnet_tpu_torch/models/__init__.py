"""Top-level models of the port."""
