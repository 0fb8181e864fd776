"""Sharding of the model zoo (``repro/distributed/``): the no-mesh path."""
