"""Checks that need an NVIDIA GPU: the node-state pass compiled for the card
in f32 against the same pass in f64 on the host.  The ``gpu`` fixture
decides inside the test and skips on hosts without a card;
``python chip_smoke.py`` runs the same comparison at 565,671 nodes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from su2_tpu import state as st, testcase

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (JAX finds none)")
    return devs[0]


def test_node_state_on_card_matches_f64(gpu, standin_lib):
    import chip_smoke
    lay = st.Layout(2, 9)
    tp = st.TSolveParams()
    inputs = testcase.mixture_states(standin_lib, lay, 4099, seed=7)
    lib32 = jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.asarray(x, jnp.float32), gpu)
        if hasattr(x, "dtype") else x, standin_lib)
    u, tg, tke = (jax.device_put(jnp.asarray(a, jnp.float32), gpu)
                  for a in inputs)
    got = jax.jit(lambda u, t, k: st.node_state(lib32, lay, u, t, tp,
                                                turb_ke=k))(u, tg, tke)
    ref = st.node_state(standin_lib, lay,
                        *(jnp.asarray(a, jnp.float64) for a in inputs[:2]),
                        tp, turb_ke=jnp.asarray(inputs[2], jnp.float64))
    for a, b in zip(jax.tree_util.tree_leaves(got)[3:],
                    jax.tree_util.tree_leaves(ref)[3:]):
        assert chip_smoke.colwise_rel(a, b) < chip_smoke.TOL_NODE_F64
