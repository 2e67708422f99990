"""The torch port runs with no jax and imports nothing of the reference
package; its kernels are built by nvcc into a plain C library (no PyTorch
extension build)."""

import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "modern_search_engines_project_tpu_torch"
# every Python module of the port (native/, bench_kernels.py and the
# synthetic index among them), the native analyzer's C++ source, and
# chip_smoke.py
SOURCES = (sorted(PORT.rglob("*.py")) + sorted((PORT / "native").glob("*.cpp"))
           + [ROOT / "chip_smoke.py"])
FORBIDDEN = re.compile(
    r"\bjax\b|\bflax\b|modern_search_engines_project_tpu\.|"
    r"from\s+modern_search_engines_project_tpu\s+import"
)


def test_port_searches_with_jax_blocked():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None  # any import of jax now fails
        sys.modules["flax"] = None
        from modern_search_engines_project_tpu_torch.config import Config
        from modern_search_engines_project_tpu_torch.index import (
            Document, IndexBuilder)
        from modern_search_engines_project_tpu_torch.models import HashingEncoder
        from modern_search_engines_project_tpu_torch.retrieval import SearchEngine
        from modern_search_engines_project_tpu_torch import (  # noqa: F401
            bench_kernels, native, synthetic)
        abc = "abcdefghijklmnopqrstuvwxyz"
        words = [f"w{a}{b}q" for a in abc for b in abc]
        texts = [" ".join(words[(i * 13 + j * 29) % 676] for j in range(8))
                 for i in range(40)]
        docs = [Document(i, f"https://www.s{i % 5}.de/{i}", f"t{i}", t)
                for i, t in enumerate(texts)]
        cfg = Config(embedding_dim=32, window_size=32, step_size=25,
                     top_k_retrieval=20, top_k_reranking=5)
        enc = HashingEncoder(dim=32)
        art = IndexBuilder(enc, cfg).build(docs)
        for layout in ("slots", "blocked"):
            eng = SearchEngine(art, enc, cfg.replace(bm25_layout=layout),
                               device="cpu")
            res = eng.search_batch([texts[3][:10], texts[7]] * 5, top_k=5)
            assert len(res) == 10 and all(len(r) > 0 for r in res), res
            assert eng.bm25_search(texts[7]) and eng.dense_search(texts[7])
        empty = SearchEngine(IndexBuilder(enc, cfg).build([]), enc, cfg,
                             device="cpu")
        assert empty.search("castle") == []
        loaded = [m for m in sys.modules if m == "modern_search_engines_project_tpu"
                  or m.startswith("modern_search_engines_project_tpu.")]
        assert not loaded, loaded
        print("ok")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_encoder_loads_and_encodes_with_jax_flax_msgpack_blocked():
    """The bi-encoder's checkpoint reader needs neither the reference's
    serializer nor the msgpack package: the committed demo checkpoint
    loads and encodes, with the reference's digest."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = sys.modules["flax"] = None
        sys.modules["msgpack"] = None
        from modern_search_engines_project_tpu_torch.models import TorchEncoder
        enc = TorchEncoder.from_checkpoint("runs/encoder-demo", device="cpu")
        out = enc.encode_batch(["castle tour", "the neckar river", ""])
        assert out.shape == (3, 64), out.shape
        loaded = [m for m in sys.modules if m == "modern_search_engines_project_tpu"
                  or m.startswith("modern_search_engines_project_tpu.")]
        assert not loaded, loaded
        print(enc.params_digest())
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    from modern_search_engines_project_tpu.models.encoder import JaxEncoder

    want = JaxEncoder.from_checkpoint(str(ROOT / "runs" / "encoder-demo"))
    assert out.stdout.strip() == want.params_digest()


@pytest.mark.parametrize(
    "path", SOURCES, ids=[str(p.relative_to(ROOT)) for p in SOURCES]
)
def test_source_names_neither_jax_nor_reference_package(path):
    hits = [
        f"{i}: {line}"
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if FORBIDDEN.search(line)
    ]
    assert not hits, hits


def test_kernels_are_plain_c_builds():
    """Route: nvcc into a shared library bound with ctypes, never PyTorch's
    extension builder or its headers."""
    for p in list(PORT.rglob("*.py")) + list((PORT / "csrc").glob("*.cu*")):
        text = p.read_text()
        assert "cpp_extension" not in text, p
        assert "torch/extension.h" not in text, p
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu")) == [
        "bm25_blocked.cu", "bm25_slots.cu", "dense_stats.cu",
    ]


def test_each_kernel_names_what_it_replaces():
    from modern_search_engines_project_tpu_torch.retrieval import (  # noqa: F401
        bm25_blocked,
        bm25_slots,
        dense_stats,
    )
    from modern_search_engines_project_tpu_torch.retrieval.cuda_lib import (
        KERNELS,
        SIGNATURES,
    )

    assert sorted(k.name for k in KERNELS) == [
        "bm25_blocked", "bm25_blocked_udedup", "bm25_slots",
        "bm25_slots_udedup_acc", "bm25_slots_udedup_i8",
        "bm25_slots_udedup_sublane", "bm25_slots_udedup_wide",
        "bm25_slots_udedup_wide_i8", "dense_stats",
    ]
    for k in KERNELS:
        assert k.symbol in SIGNATURES
        src = (ROOT / k.source).read_text()
        assert f'extern "C" int {k.symbol}(' in src
        ref_file, line = k.replaces.split(":")
        ref_src = (ROOT / ref_file).read_text().splitlines()
        assert ref_src[int(line) - 1].startswith("def _"), k.replaces
        fn = ref_src[int(line) - 1][4:].split("(")[0]
        assert fn in src, (k.name, fn)  # the source note names it
