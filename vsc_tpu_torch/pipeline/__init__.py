"""Pipeline entry points of the port: depth estimation and the streaming
converter CLI (``python -m vsc_tpu_torch.pipeline.stream_convert``)."""
