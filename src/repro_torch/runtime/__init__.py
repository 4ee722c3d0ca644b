"""Runtimes of the port: ``serve_engine`` (batched serving),
``train_loop`` (the train step, the ``Trainer`` and the online
recalibrator), ``straggler`` (the step-time monitor) and ``elastic``
(replanning on a resized cluster)."""
