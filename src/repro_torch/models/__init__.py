"""Models of the port: ``layers`` (primitives), ``transformer`` (dense decoder
family), ``model`` (the facade entry points use)."""
