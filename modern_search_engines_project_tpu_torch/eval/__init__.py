from modern_search_engines_project_tpu_torch.eval.batch import (
    BatchResult,
    parse_queries_file,
    run_batch,
    run_batch_file,
    write_results_file,
)

__all__ = [
    "BatchResult",
    "parse_queries_file",
    "run_batch",
    "run_batch_file",
    "write_results_file",
]
