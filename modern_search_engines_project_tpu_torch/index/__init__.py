from modern_search_engines_project_tpu_torch.index.builder import (
    Document,
    IndexArtifacts,
    IndexBuilder,
    extract_domain,
    make_snippet,
)
from modern_search_engines_project_tpu_torch.index.vocab import TermDictionary

__all__ = [
    "Document",
    "IndexArtifacts",
    "IndexBuilder",
    "TermDictionary",
    "extract_domain",
    "make_snippet",
]
