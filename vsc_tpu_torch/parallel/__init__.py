"""Device-level concerns of the port: the accelerator health probe."""
