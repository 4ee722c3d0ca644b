"""Runtimes of the port: ``serve_engine`` (batched serving)."""
