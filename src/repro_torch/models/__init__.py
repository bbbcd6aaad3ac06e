from .api import Model, build_model  # noqa: F401
