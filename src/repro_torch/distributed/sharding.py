"""Logical-axis sharding hints of the model zoo (``repro/distributed/sharding.py``),
the no-mesh path only.

Every activation the reference's models annotate carries the same
``hint(x, *axes)`` call here, by logical axis name.  Without a sharding
context, which is all the port has yet, ``hint`` returns ``x`` unchanged,
as the reference's does, so one device runs the exact model code.  The rule
engine (``sharding_ctx``, ``logical_spec``, ``named_sharding``,
``tree_shardings`` over a ``DeviceMesh``) waits for ROADMAP queue A, item
"configs/shapes.py, distributed/sharding.py, launch/mesh.py and
launch/dryrun.py"; it only has to fill in ``current_ctx`` and ``hint``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["current_ctx", "hint"]


def current_ctx():
    """The active sharding context: always None until the rule engine lands."""
    return None


def hint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain ``x``'s layout by logical axis names.  With no sharding
    context (:func:`current_ctx` is None) the layout stays as it is."""
    return x
