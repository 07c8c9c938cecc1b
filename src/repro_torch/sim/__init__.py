"""The simulator's admission policies (FIFO, 1F1B); the event engine is
not ported yet."""

from .policies import FIFO, AdmissionPolicy, OneFOneB, resolve_policy

__all__ = ["AdmissionPolicy", "FIFO", "OneFOneB", "resolve_policy"]
