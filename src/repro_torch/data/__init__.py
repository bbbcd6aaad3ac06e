"""Training data (counterpart of ``repro.data``)."""
from .pipeline import DataConfig, PackedDocs, SyntheticLM, make_batches, make_source  # noqa: F401
