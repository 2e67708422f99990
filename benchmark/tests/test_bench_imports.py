"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's)."""

from __future__ import annotations

import subprocess
import sys
import types

from benchmark import cells, run


def test_banned_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "modern_search_engines_project_tpu_torch_x",
                        types.ModuleType("x"))
    assert "modern_search_engines_project_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "modern_search_engines_project_tpu.sub",
                        types.ModuleType("sub"))
    assert run.banned_modules() == ["modern_search_engines_project_tpu"]


def test_a_run_imports_no_jax():
    code = (
        "import benchmark.run, benchmark.sweep, benchmark.control\n"
        "import modern_search_engines_project_tpu_torch.models\n"
        "import modern_search_engines_project_tpu_torch.retrieval\n"
        "import modern_search_engines_project_tpu_torch.serving.api\n"
        "import modern_search_engines_project_tpu_torch.serving.fastpath\n"
        "import modern_search_engines_project_tpu_torch.serving.http\n"
        "from benchmark import cells\n"
        "spec = cells.spec()\n"
        "[cells.reader(m) for m in spec['end_to_end'] + spec['per_layer']]\n"
        "print(sorted({m.split('.')[0] for m in __import__('sys').modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "modern_search_engines_project_tpu_torch" in top
    assert not top & set(run.BANNED)
