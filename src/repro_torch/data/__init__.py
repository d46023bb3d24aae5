"""Synthetic feature data of the port."""
