r"""Model families."""
