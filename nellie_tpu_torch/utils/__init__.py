"""Host utilities of the port: its logger and the region morphology of the
feature tables."""
