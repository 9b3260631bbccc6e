"""Serving engines of the port (counterpart of `repro.serve`)."""
