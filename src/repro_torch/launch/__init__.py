"""Launch layer: the GBDT serving entry point (``serve_gbdt``), the
process groups of the distributed trainer (``distributed``) and its
example (``distributed_gbdt``), the quickstart, and the LM's prefill step
(``steps.make_prefill_step``)."""
