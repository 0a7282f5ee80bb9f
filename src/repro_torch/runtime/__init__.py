"""Serving steps of the port (the training half waits for its slice)."""
