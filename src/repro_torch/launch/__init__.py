"""Launch layer: the GBDT serving entry point (``serve_gbdt``), the
process groups of the distributed trainer (``distributed``) and its
example (``distributed_gbdt``), the quickstart, and the LM's steps
(``steps.make_train_step``, ``steps.make_prefill_step``,
``steps.make_serve_step``), its training launcher (``train``) and
pretraining entry point (``lm_pretrain``), its greedy serving launcher
(``serve``) and the serving demo (``serve_decode``); and the mesh
tooling: the pods' shapes and sharding plan (``mesh``, ``shardings``,
``specs``), applied as DTensor placements on a ``DeviceMesh``, a step
counted on the meta device on one H100's constants or under the plan in
a fake group of the pods' size (``roofline``, ``dryrun``), its tables
(``report``) and the override harness (``hillclimb``)."""
