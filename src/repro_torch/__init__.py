"""PyTorch/CUDA port of the WTA-CRS reproduction (the JAX package
``repro`` is the reference it is held against; this package imports
neither it nor jax)."""
