"""Sharding of the model zoo (``repro/distributed/``): the logical-axis rule
engine over a ``DeviceMesh`` (``sharding.py``) and the host-staged
collectives of ranks that share a card (``host_staged.py``)."""

from .sharding import DEFAULT_RULES, hint, logical_spec, named_sharding, sharding_ctx

__all__ = ["DEFAULT_RULES", "hint", "logical_spec", "named_sharding", "sharding_ctx"]
