"""Single-card policy of the port (see `policy.py`)."""
