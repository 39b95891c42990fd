"""The port's examples (``examples/torch_*.py``) run shallow on the CPU, and
refuse to run without a card unless the CPU is asked for.

Each example's ``main`` takes its depth (MPC steps, ALADIN iterations,
batch scenarios), so these runs are a step or two of each at the example's
own configuration; their numbers are checked against the example's own
claims where a shallow run can make them (finite states, the supply chain's
flows agreeing), not against JAX: the modules they drive are held to JAX in
the other ``tests/test_torch_*.py`` files.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("torch_crossing_pi_admm", "torch_overtaking_consensus",
            "torch_supply_chain_aladin", "torch_fleet")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("layout", ["pairwise", "classic"])
def test_crossing_pi_admm(layout, capsys):
    res = _example("torch_crossing_pi_admm").main(layout, n_steps=2,
                                                  device="cpu")
    assert res.states.shape == (2, 2, 3) and np.all(np.isfinite(res.states))
    assert "min inter-vehicle distance" in capsys.readouterr().out


def test_overtaking_consensus(capsys):
    res = _example("torch_overtaking_consensus").main(n_steps=1,
                                                      device="cpu")
    assert res.states.shape == (2, 2, 5) and np.all(np.isfinite(res.states))
    assert "min inter-vehicle distance" in capsys.readouterr().out


def test_supply_chain_aladin():
    """The whole example (25 iterations): shipped equals received."""
    state, ys = _example("torch_supply_chain_aladin").main(25, device="cpu")
    assert ys.device.type == "cpu"
    assert float(state.coupling_res) < 1e-4


def test_fleet(capsys):
    """One step of each part, one ADMM iteration a step (a float32 ADMM
    iteration takes about 20 s on one CPU thread)."""
    (states, its, *_), (b_states, b_its, *_) = _example("torch_fleet").main(
        n_steps=1, batch_steps=1, n_scen=2, device="cpu", max_admm_iters=1)
    assert states.shape == (2, 2, 5) and b_states.shape == (2, 2, 2, 5)
    assert np.all(np.isfinite(states)) and np.all(np.isfinite(b_states))
    # the float32 profile on the CPU too: nothing switches profile
    out = capsys.readouterr().out
    assert "dtype=float32" in out and "fleet batch: 2 scenarios" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_the_card(name):
    """Without ``device`` each example runs on the CUDA card; with none it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    mod = _example(name)
    args = {"torch_crossing_pi_admm": ("pairwise", 1),
            "torch_overtaking_consensus": (1,),
            "torch_supply_chain_aladin": (1,),
            "torch_fleet": (1, 1, 2)}[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(*args)
