"""Synthetic host-side instance generators."""
