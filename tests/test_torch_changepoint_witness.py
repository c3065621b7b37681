"""The change-point demo's trainer witness at 8 sequences a class.

``tests/test_torch_changepoint_study.py::test_demo_cycle_matches_jax_step_by_step``
holds one cycle of the demo's arm through the port's ``Experiment`` against
JAX's ``train_step`` at 4 sequences a class (16 steps). This is the same
witness, with the same bounds and the same rule for parameters of zero
gradient, at 8 a class (32 steps at batch 1): twice the steps over which a
difference could grow, on other data. In a file of its own so that the
suite's workers run it beside the other. ~2 min a curriculum on the CPU.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_changepoint_study import (
    CURRICULA,
    KEY_BIASES,
    demo_cycle_misses,
    jax_demo_cycle_data,
    port_demo_cycle,
    zero_gradient_leaves,
)

SEQS_PER_D = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def compiled():
    """JAX's initial state and jitted step at 8 a class, shared by both
    curricula."""
    return {}


@pytest.mark.parametrize("curriculum", list(CURRICULA))
def test_demo_cycle_matches_jax_step_by_step_at_8_a_class(compiled, monkeypatch, curriculum):
    """Float64 on both sides; every loss and tensor at 1e-10, widened by 3 ×
    JAX's own one-ulp distance, the parameters of zero gradient (the
    attention key biases) left out on both sides alike. Measured: losses
    8.1e-16 / 7.0e-16 of a loss apart (continuous / discrete), tensors
    2.1e-13 / 2.2e-12 of their largest entry."""
    ref = jax_demo_cycle_data(curriculum, np.float64, SEQS_PER_D, compiled)
    assert len(ref["losses"]) == 4 * SEQS_PER_D
    loss_misses, off = demo_cycle_misses(ref, *port_demo_cycle(ref, monkeypatch))
    assert not loss_misses, loss_misses
    assert not off, off
    assert zero_gradient_leaves(ref["want"]["exp_avg"]) == KEY_BIASES
