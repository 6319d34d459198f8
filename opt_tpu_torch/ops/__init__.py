"""Device ops of the PyTorch port: stencil shifts, graph gathers and their
host tables, and the fused CG."""
