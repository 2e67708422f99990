from modern_search_engines_project_tpu_torch.models.checkpoint import (
    latest_step_dir,
    load_encoder,
)
from modern_search_engines_project_tpu_torch.models.encoder import (
    BiEncoder,
    EncoderConfig,
    TorchEncoder,
    init_reference_params,
    params_digest,
    params_from_reference,
)
from modern_search_engines_project_tpu_torch.models.hash_encoder import HashingEncoder

__all__ = [
    "BiEncoder",
    "EncoderConfig",
    "HashingEncoder",
    "TorchEncoder",
    "init_reference_params",
    "latest_step_dir",
    "load_encoder",
    "params_digest",
    "params_from_reference",
]
