"""Synthetic feature data, pair sampling and batch streams of the port."""
