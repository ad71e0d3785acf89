"""Rules of the port that a correct result cannot show.

* No module of ``repro_torch`` and no line of ``chip_smoke.py`` imports
  ``jax``, the JAX package ``repro`` or ``ml_dtypes`` (JAX's bfloat16
  type): the port stands alone on the card.
* The public entry points run on the CUDA device by default and never
  quietly on the CPU: without a card they raise unless the caller passes
  ``device="cpu"``.
"""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import snn as tsnn
from repro_torch.launch import steps as tsteps

# the package exports the function `join`, which shadows the module name
tjoin = importlib.import_module("repro_torch.core.join")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_files():
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not bad, bad


def test_import_scan_catches_a_forbidden_import(tmp_path):
    # the scan itself must see every spelling it is meant to refuse
    for src in ("import jax.numpy as jnp\n", "from repro.core import snn\n",
                "import importlib\nimportlib.import_module('repro.core')\n",
                "import ml_dtypes\n"):
        p = tmp_path / "m.py"
        p.write_text(src)
        assert any(m.split(".")[0] in FORBIDDEN for m in _imported_modules(p))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(60, 4)).astype(np.float32),
            rng.normal(size=(5, 4)).astype(np.float32))


def test_entry_points_raise_without_a_card(no_card):
    x, q = _data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsnn.build_index(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsnn.build_index(x, device="cuda")
    idx = tsnn.build_index(x, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsnn.query_radius_csr(idx, q, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tjoin.query_counts(idx, q, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsnn.index_from_arrays(idx.mu, idx.v1, idx.xs.numpy(),
                               idx.alphas.numpy(), idx.half_norms.numpy(),
                               idx.order)
    assert not idx._packs        # nothing ran on the CPU along the way


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    x, q = _data()
    idx = tsnn.build_index(x, device="cpu")
    assert idx.xs.device.type == "cpu"
    res = tsnn.query_radius_csr(idx, q, 1.5, device="cpu")
    counts = tjoin.query_counts(idx, q, 1.5, device="cpu")
    np.testing.assert_array_equal(counts, np.diff(res.indptr))


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_recsys_steps_build_on_the_card_by_default(no_card, shape):
    sd = tsteps.build_step("mind", shape, reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sd.init_args()
    model, batch = sd.init_args(device="cpu")
    assert model.items.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in batch.values())
