"""The port's geffner net and the JAX-params converter against the JAX
package, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cmcd_tpu
from cmcd_tpu.networks.geffner import build_geffner_network
from cmcd_tpu_torch.networks import build_score_network
from cmcd_tpu_torch.utils.convert import geffner_from_jax, geffner_to_numpy, params_from_jax

torch.set_num_threads(1)

K, EMB = 8, 16


def _jax_net(factor_sn=0.3):
    init, apply = build_geffner_network(2, EMB, K)
    sn = jax.device_get(init(jax.random.PRNGKey(4)))
    sn["factor_sn"] = np.float32(factor_sn)
    return sn, apply


def test_converter_round_trip_is_exact():
    sn, _ = _jax_net()
    back = geffner_to_numpy(geffner_from_jax(sn, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(sn), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


@pytest.mark.parametrize("i", [0, K // 2, K - 1, K])
def test_apply_matches_jax(i):
    """i = K is the CAIS backward net's index at the last step: both clamp
    it to K - 1."""
    sn, apply = _jax_net()
    x = np.random.default_rng(i).normal(scale=5.0, size=(64, 2)).astype(np.float32)
    want = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, sn), jnp.asarray(x), i))
    got = geffner_from_jax(sn, device="cpu")(torch.from_numpy(x), i).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_net_starts_as_zero_correction_and_other_archs_raise():
    net, apply = build_score_network(2, EMB, K, generator=torch.Generator().manual_seed(0))
    assert net.in_dim == 2 + EMB
    assert torch.all(apply(net, torch.randn(4, 2), 3) == 0)
    with pytest.raises(ValueError, match="Unknown nn arch"):
        build_score_network(2, EMB, K, arch="mlp")


def test_params_from_jax_initialize_tree():
    target = cmcd_tpu.load_target("many_gmm")
    setup = cmcd_tpu.CMCDSetup(mode="MCD_CAIS_var_sn", dim=2, nbridges=K, emb_dim=EMB,
                               grad_clipping=True)
    trainable = cmcd_tpu.default_trainable(setup.mode, train_eps=False, train_vi=False)
    params, _ = cmcd_tpu.initialize(setup, target.log_prob, eps=0.65, init_sigma=15.0,
                                    trainable=trainable)
    tree = jax.device_get(params)
    port = params_from_jax(tree, device="cpu")
    assert set(port["train"]) == set(tree["train"])
    assert set(port["notrain"]) == set(tree["notrain"])
    np.testing.assert_array_equal(port["notrain"]["vd"]["logdiag"].numpy(),
                                  np.asarray(tree["notrain"]["vd"]["logdiag"]))
    np.testing.assert_array_equal(port["train"]["sn"].emb.detach().numpy(),
                                  np.asarray(tree["train"]["sn"]["emb"]))
