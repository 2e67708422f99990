from modern_search_engines_project_tpu_torch.models.hash_encoder import HashingEncoder

__all__ = ["HashingEncoder"]
