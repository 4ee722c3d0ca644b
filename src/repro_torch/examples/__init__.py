"""Runnable examples of the port: ``linreg_ds``, ``train_lm`` and
``serve_lm`` run on the card (or ``--device cpu``); ``quickstart``,
``autotune_plan``, ``optimize_resources`` and ``sweep_plans`` cost plans
only (``--h100`` prices the port's card)."""
