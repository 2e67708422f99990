from modern_search_engines_project_tpu_torch.text.analyzer import (
    Analyzer,
    STOPWORDS,
    lemmatize,
    normalize_text,
)
from modern_search_engines_project_tpu_torch.text.chunker import (
    create_sliding_windows,
    sliding_window_bounds,
    window_texts,
)
from modern_search_engines_project_tpu_torch.text.hash_tokenizer import HashTokenizer

__all__ = [
    "Analyzer",
    "STOPWORDS",
    "lemmatize",
    "normalize_text",
    "create_sliding_windows",
    "sliding_window_bounds",
    "window_texts",
    "HashTokenizer",
]
