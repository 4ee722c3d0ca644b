"""Runnable examples of the port: ``linreg_ds``."""
