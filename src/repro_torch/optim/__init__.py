"""Optimizers of the port: ``adamw`` (AdamW, schedule, clipping) and
``compress`` (gradient compression with error feedback)."""
