"""Orchestration of the port: :func:`nellie_tpu_torch.pipeline.run.run`."""
