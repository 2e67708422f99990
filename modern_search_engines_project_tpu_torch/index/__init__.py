from modern_search_engines_project_tpu_torch.index.artifacts import (
    load_artifacts,
    save_artifacts,
)
from modern_search_engines_project_tpu_torch.index.builder import (
    Document,
    IndexArtifacts,
    IndexBuilder,
    extract_domain,
    make_snippet,
)
from modern_search_engines_project_tpu_torch.index.pipeline import (
    BuildPipeline,
    DataParallelEncoder,
)
from modern_search_engines_project_tpu_torch.index.vocab import TermDictionary

__all__ = [
    "BuildPipeline",
    "DataParallelEncoder",
    "Document",
    "IndexArtifacts",
    "IndexBuilder",
    "TermDictionary",
    "extract_domain",
    "load_artifacts",
    "make_snippet",
    "save_artifacts",
]
