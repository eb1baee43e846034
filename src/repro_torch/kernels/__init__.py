"""Hand-written Hopper kernels of the port, built from ``csrc/`` sources by
``_build`` on first use."""
