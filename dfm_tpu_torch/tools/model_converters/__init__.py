"""Checkpoint converters of the port (reference checkpoints -> the
port's files)."""
