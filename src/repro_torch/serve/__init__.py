"""Batched serving of the port: prefill + greedy decode (`engine.py`)."""
