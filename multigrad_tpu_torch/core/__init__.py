"""The model core: ``OnePointModel``."""
from .model import OnePointModel  # noqa: F401
