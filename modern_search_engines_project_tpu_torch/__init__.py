"""PyTorch/CUDA port of the hybrid search framework, for one NVIDIA H100.

The package beside it, ``modern_search_engines_project_tpu``, is the
reference; this one mirrors its layout (``config.py``, ``text/``,
``index/``, ``models/``, ``retrieval/``, ``utils/``) so each counterpart is
found by path, and imports nothing from it.  The ported slice is the
default online hybrid query, ``retrieval.engine.SearchEngine.search_batch``:
slot-layout BM25 (three hand-written CUDA kernels) feeding the bucketed
dense tail (one hand-written CUDA kernel).  The kernel sources live in
``csrc/``; every kernel has a plain PyTorch version beside its wrapper,
which is what runs on CPU tensors.
"""

__version__ = "0.1.0"

from modern_search_engines_project_tpu_torch.config import Config, DEFAULT_CONFIG

__all__ = ["Config", "DEFAULT_CONFIG", "__version__"]
