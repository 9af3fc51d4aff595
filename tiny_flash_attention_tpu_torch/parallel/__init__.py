"""Training layer of the port: the single-card train step (train.py)."""
