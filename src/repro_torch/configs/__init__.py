"""Experiment configurations of the port."""
