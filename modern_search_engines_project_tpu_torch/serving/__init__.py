from modern_search_engines_project_tpu_torch.serving.assistant import (
    ExtractiveSummarizer,
    GenerativeSummarizer,
    HttpLlmClient,
    Summarizer,
)
from modern_search_engines_project_tpu_torch.serving.topic import (
    extract_domain_topic,
)

__all__ = [
    "ExtractiveSummarizer",
    "GenerativeSummarizer",
    "HttpLlmClient",
    "SearchService",
    "Summarizer",
    "extract_domain_topic",
]


def __getattr__(name):
    # the HTTP control plane loads only when asked for
    if name == "SearchService":
        from modern_search_engines_project_tpu_torch.serving.api import (
            SearchService,
        )

        return SearchService
    raise AttributeError(name)
