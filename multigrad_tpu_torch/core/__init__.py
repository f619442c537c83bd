"""The model core: ``OnePointModel``, ``OnePointGroup`` and
``param_view``."""
from .model import OnePointModel  # noqa: F401
from .group import OnePointGroup, param_view  # noqa: F401
