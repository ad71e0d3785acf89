"""Helpers of the port's training tests (`test_torch_lm_train`,
`test_torch_lm_train_steps`, `test_torch_lm_accum`, `test_torch_gnn`,
`test_torch_bert4rec_train`, `test_torch_resume`): trees compared leaf by
leaf in the JAX tree's order, and the tolerances they state.

* losses within 2^-20 of their magnitude, gradient norms within 2^-18
  (float32 sums in another order);
* gradients within 2^-16 of each leaf's largest magnitude (float32 GEMMs
  and reductions in another order than XLA's);
* after AdamW steps, the moments within 2^-14 of each leaf's largest
  magnitude (the gradients of a later step are taken at parameters that
  already differ in their last bits), and the parameters: at least 999
  in 1,000 elements of the tree within 4 float32 ulp of the leaf's
  largest magnitude plus ``2^-12 * lr`` a step, every element within
  ``2 * lr`` a step.  AdamW's update ``m / (sqrt(v) + eps)`` amplifies a
  gradient's rounding where its moments are small, and a token near a
  tie of an MoE router or an edge at a ReLU kink takes the other branch:
  such an element's update differs by up to its whole size (``lr``), with
  the other sign twice that.  A missing weight decay or bias correction
  moves every element.
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.ft.checkpoint import _flatten

LOSS_REL = 2.0 ** -20
NORM_REL = 2.0 ** -18
GRAD_REL = 2.0 ** -16
MOMENT_REL = 2.0 ** -14


@pytest.fixture(autouse=True)
def one_thread():
    """The port's side of these tests on one CPU thread: their tensors are
    small, and the driver's test workers share the cores (a module that
    imports this fixture gets it for each of its tests)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pairs(got_tree, want_tree):
    """(path, got as float64, want as float64) leaf by leaf: the port's
    tree flattened as the checkpoint flattens it (dict keys sorted), the
    JAX tree as JAX does."""
    got, _ = _flatten(got_tree)
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert len(got) == len(want), (len(got), len(want))
    for g, (path, w) in zip(got, want):
        if isinstance(g, torch.Tensor):
            g = g.detach().double().numpy()
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        yield jax.tree_util.keystr(path), g, w


def leaves_close(got_tree, want_tree, rel: float = GRAD_REL):
    """Every leaf within ``rel`` of its largest magnitude."""
    for path, g, w in pairs(got_tree, want_tree):
        top = max(np.abs(w).max(initial=0.0), 1e-30)
        assert np.abs(g - w).max(initial=0.0) <= rel * top, (
            path, np.abs(g - w).max() / top)


def scalar_close(got, want, rel: float = LOSS_REL):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    assert abs(got - float(want)) <= rel * max(abs(float(want)), 1e-30), (
        got, float(want))


def adamw_params_close(got_tree, want_tree, lr: float, steps: int):
    """The parameters after ``steps`` AdamW steps (see the module's
    docstring)."""
    far = total = 0
    for path, g, w in pairs(got_tree, want_tree):
        d = np.abs(g - w)
        top = np.float32(np.abs(w).max(initial=0.0))
        assert d.max(initial=0.0) <= 2 * lr * steps, (path, d.max() / lr)
        far += int((d > 4 * np.spacing(top) + 2.0 ** -12 * lr * steps).sum())
        total += d.size
    assert far * 1000 <= total, (far, total)


def state_close(params, opt_state, jparams, jstate, lr: float, steps: int):
    """An AdamW state and its parameters after ``steps`` steps."""
    adamw_params_close(params, jparams, lr, steps)
    leaves_close(opt_state["mu"], jstate["mu"], MOMENT_REL)
    leaves_close(opt_state["nu"], jstate["nu"], MOMENT_REL)
    assert int(opt_state["step"]) == int(jstate["step"]) == steps


def steps_match(jsd, tsd, to_port, steps: int = 3, lr: float = 3e-4,
                check=None):
    """``steps`` training steps of a JAX step definition (compiled) and
    the port's from the same start: the JAX parameters carried across by
    ``to_port(numpy tree)``, the port's optimizer state and batch from its
    own ``init_args`` (the batch equal to JAX's); each step's loss and
    gradient norm, then the state: ``check(params, opt_state, jparams,
    jstate)``, by default `state_close` of an AdamW state at ``lr``.
    Returns the port's (params, opt_state, batch)."""
    jparams, jstate, jbatch = jsd.init_args()
    _, state, batch = tsd.init_args(device="cpu")
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v))
    params = to_port(jax.tree.map(np.asarray, jparams))
    fn = jax.jit(jsd.fn)
    for _ in range(steps):
        jparams, jstate, jm = fn(jparams, jstate, jbatch)
        m = tsd.fn(params, state, batch)
        scalar_close(m["loss"], jm["loss"])
        if "grad_norm" in jm:
            scalar_close(m["grad_norm"], jm["grad_norm"], NORM_REL)
    if check is None:
        state_close(params, state, jparams, jstate, lr, steps)
    else:
        check(params, state, jparams, jstate)
    return params, state, batch
