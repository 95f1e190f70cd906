from .pipeline import SyntheticStream, batch_for_step  # noqa: F401
