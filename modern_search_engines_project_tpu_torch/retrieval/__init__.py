from modern_search_engines_project_tpu_torch.retrieval.device_index import DeviceIndex
from modern_search_engines_project_tpu_torch.retrieval.engine import SearchEngine
from modern_search_engines_project_tpu_torch.retrieval.numpy_ref import (
    bm25_search_numpy,
    hybrid_search_numpy,
    preprocess_query,
)
from modern_search_engines_project_tpu_torch.retrieval.rerank import (
    RankedDoc,
    apply_domain_cap,
    dedup_by_base_url,
    hybrid_diversification,
    positional_adjustment,
)

__all__ = [
    "DeviceIndex",
    "SearchEngine",
    "RankedDoc",
    "apply_domain_cap",
    "dedup_by_base_url",
    "hybrid_diversification",
    "positional_adjustment",
    "bm25_search_numpy",
    "hybrid_search_numpy",
    "preprocess_query",
]
