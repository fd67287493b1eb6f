"""Runtime spine of the port (this slice: the error taxonomy only)."""
