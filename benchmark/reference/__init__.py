"""The plain reference of the benchmark: IST-Net, its serving
preprocessing and its train step in plain PyTorch, importing nothing of
the program under test and nothing of JAX."""
