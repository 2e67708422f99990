"""PyTorch/CUDA port of the hybrid search framework, for one NVIDIA H100.

The package beside it, ``modern_search_engines_project_tpu``, is the
reference; this one mirrors its layout (``config.py``, ``text/``,
``index/``, ``models/``, ``retrieval/``, ``serving/``, ``utils/``) so each
counterpart is found by path, and imports nothing from it.  The main path
is the online hybrid query, ``retrieval.engine.SearchEngine.search_batch``:
BM25 (hand-written CUDA kernels on either posting layout) feeding the
bucketed dense tail (one hand-written CUDA kernel), with the trained
bi-encoder, the optional cross-encoder stage 3 (``models/``) and the
search assistant's summarizers (``serving/assistant.py``).  The kernel
sources live in ``csrc/``; every kernel has a plain PyTorch version beside
its wrapper, which is what runs on CPU tensors.
"""

__version__ = "0.1.0"

from modern_search_engines_project_tpu_torch.config import Config, DEFAULT_CONFIG

__all__ = ["Config", "DEFAULT_CONFIG", "__version__"]
