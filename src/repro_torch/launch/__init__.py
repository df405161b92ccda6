"""Launch layer: the GBDT serving entry point (``serve_gbdt``)."""
