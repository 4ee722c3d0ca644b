"""Runtimes of the port: ``serve_engine`` (batched serving) and
``train_loop`` (the train step)."""
