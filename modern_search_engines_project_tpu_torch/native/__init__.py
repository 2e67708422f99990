from modern_search_engines_project_tpu_torch.native import native_analyzer

__all__ = ["native_analyzer"]
