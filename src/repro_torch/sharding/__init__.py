"""Sharding policy and logical-axis partitioning of the port (see
`policy.py`, `partitioning.py`)."""
