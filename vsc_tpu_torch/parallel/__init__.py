"""Device-level concerns of the port: the accelerator health probe
(``health.py``) and batch placement for the step CLIs (``auto.py``)."""
