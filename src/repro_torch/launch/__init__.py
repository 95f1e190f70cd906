"""Entry points that drive a model: ``serve.generate``."""
