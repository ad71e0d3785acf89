"""Rules of the port that a correct result cannot show.

* No module of ``repro_torch`` and no line of ``chip_smoke.py`` imports
  ``jax``, the JAX package ``repro`` or ``ml_dtypes`` (JAX's bfloat16
  type): the port stands alone on the card.
* The public entry points run on the CUDA device by default and never
  quietly on the CPU: without a card they raise unless the caller passes
  ``device="cpu"``.
"""
import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.distributed as jdist
import repro_torch.core as tcore
import repro_torch.distributed as tdist
from repro_torch.core import knn as tknn
from repro_torch.core import snn as tsnn
from repro_torch.core import streaming as tst
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import recsys as trs
from repro_torch.models import transformer as tt
from repro_torch.serving import IndexRegistry, SNNServer, TenantRuntime
from repro_torch.utils import tree_leaves

# the package exports functions named `join` and `dbscan`, which shadow the
# module names
tjoin = importlib.import_module("repro_torch.core.join")
tdb = importlib.import_module("repro_torch.core.dbscan")

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


SERVING_MODULES = ("configs/snn_default", "ft/checkpoint", "ft/elastic",
                   "ft/watchdog", "serving/runtime", "serving/registry",
                   "serving/server", "data/pipeline", "launch/serve")
SHARDED_MODULES = ("core/sharded", "launch/mesh", "launch/snn_cell")
TRAINING_MODULES = ("optim/optimizers", "launch/train", "utils")
DISTRIBUTED_MODULES = ("distributed/__init__", "distributed/sharding",
                       "distributed/compression",
                       "distributed/collective_matmul",
                       "distributed/parallel")
DRYRUN_MODULES = ("launch/hlo_analysis", "launch/dryrun")
LM_MODULES = ("models/attention", "models/transformer", "models/moe",
              "configs/nemotron_4_15b", "configs/internlm2_20b",
              "configs/minicpm3_4b", "configs/llama4_scout_17b_a16e",
              "configs/qwen3_moe_235b_a22b", "configs/bert4rec")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and files[-1].exists()
    # the serving, sharded, training, LM, distributed and dry-run slices'
    # modules are among the files scanned
    assert {PORT / f"{m}.py" for m in SERVING_MODULES + SHARDED_MODULES
            + TRAINING_MODULES + LM_MODULES + DISTRIBUTED_MODULES
            + DRYRUN_MODULES} <= set(files)
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
    calls = [
        lambda: tknn.query_knn(idx, q, 3),
        lambda: tjoin.join_counts(q, None, 1.0, b_index=idx),
        lambda: tjoin.join_counts(q, x, 1.0),
        lambda: tjoin.degree_histogram(x, 1.0, index=idx),
        lambda: tjoin.degree_histogram(x, 1.0),
        lambda: tjoin.reverse_neighbors(q, x, 1.0, target_index=idx),
        lambda: tst.StreamingSNNIndex(x),
        lambda: tst.StreamingSNNIndex.from_state(
            *tst.StreamingSNNIndex(x, device="cpu").state_leaves()),
        lambda: tdb.dbscan(x, 1.0, backend="snn"),
        lambda: tdb.neighbor_graph(x, 1.0),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not idx._packs        # nothing ran on the CPU along the way


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    x, q = _data()
    idx = tsnn.build_index(x, device="cpu")
    assert idx.xs.device.type == "cpu"
    res = tsnn.query_radius_csr(idx, q, 1.5, device="cpu")
    counts = tjoin.query_counts(idx, q, 1.5, device="cpu")
    np.testing.assert_array_equal(counts, np.diff(res.indptr))
    np.testing.assert_array_equal(
        tjoin.join_counts(q, None, 1.5, b_index=idx, device="cpu"), counts)
    hist, deg = tjoin.degree_histogram(x, 1.5, index=idx, device="cpu")
    assert deg.shape == (60,) and hist.sum() == 60
    rev = tjoin.reverse_neighbors(q, x, 1.5, target_index=idx, device="cpu")
    assert rev.nnz == res.nnz
    ids = tknn.query_knn(idx, q, 4, return_distance=False, device="cpu")
    assert ids.shape == (5, 4) and ids.min() >= 0
    # the host queries and the fixed-shape query run on the index's device
    batch = tsnn.query_radius_batch(idx, q, 1.5, return_distance=False)
    assert [b.size for b in batch] == counts.tolist()
    fixed = tsnn.query_radius_fixed(idx, q, 1.5, 8)
    np.testing.assert_array_equal(fixed[3], counts)
    st = tst.StreamingSNNIndex(x, device="cpu")
    st.append(q)
    assert st.base.xs.device.type == st.parts[1].xs.device.type == "cpu"
    np.testing.assert_array_equal(
        st.query_counts_device(q, 1.5),
        np.diff(st.query_radius_csr(q, 1.5).indptr))
    back = tst.StreamingSNNIndex.from_state(*st.state_leaves(), device="cpu")
    assert back.device.type == "cpu"
    for backend in ("snn", "brute", "kdtree"):
        labels = tdb.dbscan(x, 1.5, 3, backend=backend, device="cpu")
        assert labels.shape == (60,)


def test_package_names_have_the_reference_meanings():
    # `query_counts` is the host Algorithm 2 count (with its group size),
    # `query_counts_device` the engine's; every other name as in repro.core
    assert tcore.query_counts is tsnn.query_counts
    assert tcore.query_counts_device is tjoin.query_counts
    assert "group_size" in inspect.signature(tcore.query_counts).parameters

    def public(mod):   # functions and classes; submodules vary with imports
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}

    assert public(jcore) - public(tcore) == set()
    assert public(jdist) - public(tdist) == set()


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand",
                                   "train_batch"])
def test_recsys_steps_build_on_the_card_by_default(no_card, shape):
    sd = tsteps.build_step("mind", shape, reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sd.init_args()
    model, *state, batch = sd.init_args(device="cpu")
    assert model.items.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in batch.values())
    if state:                                   # the optimizer's state
        assert state[0]["dense"]["mu"]["bilinear"].device.type == "cpu"


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-moe-235b-a22b", "decode_32k"), ("minicpm3-4b", "prefill_32k"),
    ("bert4rec", "retrieval_cand")])
def test_lm_steps_build_on_the_card_by_default(no_card, arch, shape):
    sd = tsteps.build_step(arch, shape, reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sd.init_args()
    params, *rest = sd.init_args(device="cpu")
    tensors = tree_leaves(params) + [t for t in tree_leaves(rest)
                                     if isinstance(t, torch.Tensor)]
    assert {t.device.type for t in tensors} == {"cpu"}
    tree = trs.params_to_jax(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trs.params_from_jax(arch, tree, reduced=True) if arch == "bert4rec" \
            else tt.params_from_jax(tree, dataclasses.replace(
                tsteps.get_arch(arch).make_config(shape, True), max_seq=64))
    out = sd.fn(params, *rest)
    assert {t.device.type for t in tree_leaves(out)} == {"cpu"}


def test_serving_entry_points_need_a_card_or_cpu(no_card, tmp_path, capsys):
    x, q = _data()
    calls = [
        lambda: SNNServer(x),
        lambda: IndexRegistry(),
        lambda: TenantRuntime(x),
        lambda: tserve.main(["--n", "300", "--d", "4", "--requests", "4"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    reg = IndexRegistry(device="cpu", checkpoint_root=str(tmp_path))
    rt = reg.create("t", x)
    assert rt.index.device.type == "cpu"
    reg.save("t")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg.restore("t", device="cuda")
    # a registry's restore and server default to the registry's device
    assert reg.restore("t").index.device.type == "cpu"
    back = reg.restore("t", device="cpu")
    assert back.index.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SNNServer(registry=reg, device="cuda")
    assert SNNServer(registry=reg).device.type == "cpu"
    server = SNNServer(registry=reg, device="cpu")
    assert server.runtime("t") is back
    assert TenantRuntime(x, device="cpu").index.device.type == "cpu"
    tserve.main(["--n", "300", "--d", "4", "--requests", "4",
                 "--radius", "0.5"], device="cpu")
    assert "4 requests in" in capsys.readouterr().out


def test_registry_takes_its_own_card_under_every_name(monkeypatch, tmp_path):
    # a registry made with device=None holds torch.device("cuda"); "cuda:0"
    # and torch.device("cuda", 0) name the same (current) card
    x, _ = _data()
    cpu_reg = IndexRegistry(device="cpu", checkpoint_root=str(tmp_path))
    cpu_reg.create("t", x)
    cpu_reg.save("t")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    reg = IndexRegistry(checkpoint_root=str(tmp_path))
    assert reg.device == torch.device("cuda")
    restored_on = []
    real_from_state = tst.StreamingSNNIndex.from_state

    def from_state(leaves, extra, device=None):
        restored_on.append(device)   # the tenant itself is built on the CPU
        return real_from_state(leaves, extra, device="cpu")

    registry_mod = importlib.import_module("repro_torch.serving.registry")
    monkeypatch.setattr(registry_mod.StreamingSNNIndex, "from_state",
                        staticmethod(from_state))
    for name in ("cuda", "cuda:0", torch.device("cuda", 0)):
        assert SNNServer(registry=reg, device=name).device.type == "cuda"
        reg.restore("t", device=name)
    assert restored_on == [torch.device("cuda")] * 3
    for other in ("cpu", "cuda:1"):
        with pytest.raises(ValueError, match="tenants live on"):
            SNNServer(registry=reg, device=other)
        with pytest.raises(ValueError, match="tenants live on"):
            reg.restore("t", device=other)


def _defined(path: Path) -> set:
    """Public names a module defines at its top level (functions, classes,
    constants), read from its source: importing the reference's dry-run
    would set XLA_FLAGS for the whole process."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("mod", ["hlo_analysis", "dryrun"])
def test_the_reference_names_have_counterparts(mod):
    ref = _defined(ROOT / "src" / "repro" / "launch" / f"{mod}.py")
    port = _defined(PORT / "launch" / f"{mod}.py")
    assert ref and ref - port == set()
