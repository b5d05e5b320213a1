from .optimizer import (AdamW, AdamWMaster, cast_params,  # noqa: F401
                        warmup_cosine)
