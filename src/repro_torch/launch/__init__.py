"""Launch layer: the GBDT serving entry point (``serve_gbdt``) and the LM's
prefill step (``steps.make_prefill_step``)."""
