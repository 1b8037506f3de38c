"""Plain references the benchmark judges the program by (PyTorch and NumPy
only; nothing of the program)."""
