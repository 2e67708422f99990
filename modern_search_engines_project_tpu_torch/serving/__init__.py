from modern_search_engines_project_tpu_torch.serving.assistant import (
    ExtractiveSummarizer,
    GenerativeSummarizer,
    HttpLlmClient,
    Summarizer,
)

__all__ = [
    "ExtractiveSummarizer",
    "GenerativeSummarizer",
    "HttpLlmClient",
    "Summarizer",
]
