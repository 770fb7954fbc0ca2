"""The plain reference of what the benchmark's cells compute, in plain
PyTorch: nothing here imports the port, JAX or the JAX package."""
