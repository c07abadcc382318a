from tensortruth_tpu_torch.indexing.builder import build_module
from tensortruth_tpu_torch.indexing.metadata import (
    list_available_models,
    list_modules_for_model,
    resolve_model_id,
)

__all__ = [
    "build_module",
    "list_available_models",
    "list_modules_for_model",
    "resolve_model_id",
]
