"""Losses of the port; importing the package registers them in
``registry.LOSSES``."""
from . import common, gaussian  # noqa: F401
