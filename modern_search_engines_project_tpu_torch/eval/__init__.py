from modern_search_engines_project_tpu_torch.eval.batch import (
    BatchResult,
    parse_queries_file,
    run_batch,
    run_batch_file,
    write_results_file,
)
from modern_search_engines_project_tpu_torch.eval.metrics import (
    evaluate_run,
    mrr,
    ndcg_at_k,
    precision_at_k,
    ranking_overlap_at_k,
    recall_at_k,
)

__all__ = [
    "BatchResult",
    "parse_queries_file",
    "run_batch",
    "run_batch_file",
    "write_results_file",
    "evaluate_run",
    "mrr",
    "ndcg_at_k",
    "precision_at_k",
    "ranking_overlap_at_k",
    "recall_at_k",
]
