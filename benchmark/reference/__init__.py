"""The plain references that decide ``correct``: plain PyTorch in float32
with TF32 off, importing nothing of the program under test.

A configuration's ``model`` names its module here, ``reference/<model>.py``,
which the harness loads by that name (``spec.model(config)``) and never by
an import of its own.  A model enters the benchmark by a file of that kind;
it imports nothing of ``benchmark`` and stands alone.  It gives:

* ``dense_groups(cfg)``: the dense leaf groups in draw order, ``[(group,
  [{key: (shape, std)}, ...]), ...]``, one dict a layer, each leaf drawn as
  ``randn(shape) * std`` (in f32, on the run's weight generator) in the
  order listed.  ``program.draw_dense`` draws them, ``program.dense_leaves``
  lists them, and the group names are the keys of the program's
  ``params`` that hold them.
* ``PROGRAM_KEYS``: ``{configuration key: attribute of the program's
  DLRMConfig}``, the sizes that ``program.program_config`` holds against
  the program before any run.
* ``forward_macs(cfg)``: multiply-adds of one example's forward;
  ``gemms(cfg, batch, train)``: ``(m, k, n)`` of every matrix product of a
  step or scored batch.  ``counts.model_flops`` (the ``*_mfu`` metrics)
  and ``gemm_bound_s`` (``gemm_roofline.*``) read them.
* For a model with the dot interaction only: ``interaction_features(cfg)``
  and ``num_pairs(cfg)``, which ``counts.interaction_bound_s`` reads for
  ``interaction_roofline.*``.  A cell whose model has another interaction
  is not listed under those metrics.
* The model in plain f32: ``precision(tf32)`` (the TF32 control),
  ``pool(rows, hot)`` (a batch's looked-up rows ``(B, sum H, D)``, each
  table's ``hot[t]`` side by side, sum-pooled to ``(B, T, D)``),
  ``score(dense_params, pooled, dense)``, ``leaves(dense_params)``, ``Rows``
  (the touched rows of each table, ``Rows(ids, values, hot)``, with
  ``index`` and ``pooled``) and ``Trainer(dense_params, rows, job,
  half_batch=False)`` with ``step(batch) -> (loss, dense gradients, tables'
  summed gradients)``.

``hot`` is the per-table hotness, a list of T whole numbers: the
configuration's ``n_hot``, one int for every table or a list of one a
table, as ``traffic.hotness`` spells it out.  A batch's ``sparse`` is
``(B, sum H)`` int: each table's ``hot[t]`` columns side by side, in table
order.  The harness hands the reference the flat ids whatever the
hotness; the program gets (B, T, H) where every table has one H > 1.
"""
