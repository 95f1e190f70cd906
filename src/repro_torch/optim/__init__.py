from .adamw import AdamW  # noqa: F401
from .schedules import cosine_with_warmup  # noqa: F401
