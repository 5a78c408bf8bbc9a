r"""Utilities."""
