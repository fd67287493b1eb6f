"""Data substrate: the deterministic synthetic token pipeline."""
from .pipeline import SyntheticLM, make_batch  # noqa: F401
