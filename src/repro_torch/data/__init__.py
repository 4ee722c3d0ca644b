"""Input pipelines of the port: ``pipeline`` (the synthetic token stream
and its prefetch thread)."""
