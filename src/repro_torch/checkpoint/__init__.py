"""Checkpoints of the port: ``store`` (the reference's on-disk format)."""
