"""Plain PyTorch and NumPy references of what the cells' timed paths
produce. Nothing here imports the program, JAX or the JAX package."""
