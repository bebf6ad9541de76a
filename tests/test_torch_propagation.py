"""The port's ROSE propagation blocks against the JAX package's, on the CPU.

Each block runs on the same inputs with the JAX module's own initial
variables carried over by `from_jax_variables` (their BN stats perturbed so
eval is not the identity), in eval and in train mode, float32, at the
tolerance of tests/test_parity_propagation.py (1e-5). `extract_neighborhood`
is held to F.conv2d with the reference's one-hot mapping kernels, exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from octave_tpu.models import propagation as jprop
from octave_tpu_torch.models import propagation as tprop
from octave_tpu_torch.utils.convert import from_jax_variables, load_reference_state_dict

TOL = 1e-5


def _mapping_kernels(k):
    """The reference's fixed mapping conv: k² one-hot 1 x k x k filters,
    filter kh*k + kw selecting offset (kh, kw)."""
    w = torch.zeros(k * k, 1, k, k)
    for kh in range(k):
        for kw in range(k):
            w[kh * k + kw, 0, kh, kw] = 1.0
    return w


@pytest.mark.parametrize("k", [3, 5, 7])
def test_extract_neighborhood_order(rng, k):
    x = rng.uniform(0, 1, (2, 9, 7, 1)).astype(np.float32)
    got = tprop.extract_neighborhood(torch.from_numpy(x), k)
    conv = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), _mapping_kernels(k), padding=k // 2)
    assert got.shape == (2, 9, 7, k * k)
    assert torch.equal(got, conv.permute(0, 2, 3, 1))
    assert np.array_equal(got.numpy(), np.asarray(jprop.extract_neighborhood(jnp.asarray(x), k)))
    with pytest.raises(ValueError, match="one channel"):
        tprop.extract_neighborhood(torch.zeros(1, 4, 4, 2), k)


def _perturbed(variables, rng):
    """JAX init variables with BN stats moved off (0, 1)."""
    variables = jax.tree.map(np.asarray, variables)
    stats = jax.tree.map(lambda a: a, variables["batch_stats"])
    for bn in stats["base"].values():
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (0.5 + rng.uniform(0, 1, bn["var"].shape)).astype(np.float32)
    return {**variables, "batch_stats": stats}


@pytest.mark.parametrize("block", ["pc", "c", "multi"])
def test_bases_match_jax(rng, block):
    hw, ch, pn = 12, 8, 5
    maps = [rng.uniform(0, 1, (2, hw, hw, 1)).astype(np.float32) for _ in range(3)]
    if block == "pc":
        jm, tm, args = jprop.BasePC(channels=ch, pn_size=pn), tprop.BasePC(ch, pn), maps
    elif block == "c":
        jm, tm, args = jprop.BaseC(channels=ch, pn_size=pn), tprop.BaseC(ch, pn), maps[:2]
    else:
        jm = jprop.BaseMulti(in_channels=3, channels=ch, pn_size=pn)
        tm, args = tprop.BaseMulti(3, ch, pn), [maps]
    jargs = [[jnp.asarray(m) for m in a] if isinstance(a, list) else jnp.asarray(a)
             for a in args]
    targs = [[torch.from_numpy(m) for m in a] if isinstance(a, list) else torch.from_numpy(a)
             for a in args]
    variables = _perturbed(jm.init(jax.random.PRNGKey(0), *jargs, False), rng)
    load_reference_state_dict(tm, from_jax_variables(variables))
    tm.eval()
    with torch.no_grad():
        got = tm(*targs)
    want = jm.apply(variables, *jargs, False)
    assert got.shape == (2, hw, hw, pn * pn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)
    # train mode: batch statistics, and the running stats they leave behind
    tm.train()
    got = tm(*targs)
    want, mut = jm.apply(variables, *jargs, True, mutable=["batch_stats"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL)
    after = from_jax_variables({**variables, "batch_stats": mut["batch_stats"]})
    for name, buf in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), after[name].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_base_init_and_channel_checks():
    torch.manual_seed(0)
    tm = tprop.BasePC(channels=64, pn_size=5, avg=0.2, std=0.05)
    w = torch.cat([tm.base.conv4.weight.flatten(), tm.base.conv7.weight.flatten()]).detach()
    assert abs(float(w.mean()) - 0.2) < 0.01 and abs(float(w.std()) - 0.05) < 0.01
    bias = tm.base.conv7.bias.detach()
    assert bias.shape == (25,) and float(bias[12]) == 1.0 and float(bias.abs().sum()) == 1.0
    assert set(tm.state_dict()) == {f"base.{n}.{p}" for n in ("conv1", "conv4") for p in
                                    ("weight",)} | {"base.conv7.weight", "base.conv7.bias"} | {
        f"base.{bn}.{p}" for bn in ("bn1", "bn4", "bn7")
        for p in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")}
    with pytest.raises(ValueError, match="depth of 3"):
        tm(torch.zeros(1, 4, 4, 1), torch.zeros(1, 4, 4, 1), torch.zeros(1, 4, 4, 2))
    with pytest.raises(ValueError, match="depth of 3"):
        tprop.BaseC(8, 3)(torch.zeros(1, 4, 4, 2), torch.zeros(1, 4, 4, 1))
    with pytest.raises(ValueError, match="had 3 channels"):
        tprop.BaseMulti(3, 8, 3)([torch.zeros(1, 4, 4, 1)] * 2)
    with pytest.raises(ValueError, match="odd pn_size"):
        tprop.BaseC(8, 4)


def test_aggregations_match_jax(rng):
    k = 5
    thick, thin = (rng.uniform(0, 1, (2, 9, 9, 1)).astype(np.float32) for _ in range(2))
    coeff = rng.uniform(0, 1, (2, 9, 9, k * k)).astype(np.float32)
    coeff /= coeff.sum(-1, keepdims=True)
    t = {n: torch.from_numpy(a) for n, a in (("thick", thick), ("thin", thin), ("c", coeff))}
    j = {n: jnp.asarray(a) for n, a in (("thick", thick), ("thin", thin), ("c", coeff))}
    pairs = [
        (tprop.AdaptiveAggregationPC(k)(t["thick"], t["thin"], t["c"]),
         jprop.AdaptiveAggregationPC(k)(j["thick"], j["thin"], j["c"])),
        (tprop.AdaptiveAggregationC(k)(t["thin"], t["c"]),
         jprop.AdaptiveAggregationC(k)(j["thin"], j["c"])),
        (tprop.AdaptiveAggregationMulti(k)(t["thick"], t["c"]),
         jprop.AdaptiveAggregationMulti(k)(j["thick"], j["c"])),
    ]
    for got, want in pairs:
        assert got.shape == (2, 9, 9, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    with pytest.raises(ValueError, match="neighbourhood"):
        tprop.AdaptiveAggregationC(3)(t["thin"], t["c"])


def test_clip_and_gap_match_jax(rng):
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    got = tprop.clip_by_tensor(torch.from_numpy(x).double(), -0.5, 0.5)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(jprop.clip_by_tensor(jnp.asarray(x), -0.5, 0.5)))
    np.testing.assert_allclose(tprop.global_average_pooling_2d(torch.from_numpy(x)).numpy(),
                               np.asarray(jprop.global_average_pooling_2d(jnp.asarray(x))),
                               atol=1e-6)
