"""Dataset containers of the port."""

from .dataset import DataSet  # noqa: F401
