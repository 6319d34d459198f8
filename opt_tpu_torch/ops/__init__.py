"""Device ops of the PyTorch port: stencil shifts and the fused grid CG."""
