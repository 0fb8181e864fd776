"""Serving-side persistence of the port.  So far only the mid-solve
snapshot store (:class:`SolveCheckpoint`) that ``checkpoint_dir=`` uses;
the scheduler and the warm-session store come with the serving layer."""

from .store import SolveCheckpoint, default_checkpoint_root

__all__ = ["SolveCheckpoint", "default_checkpoint_root"]
