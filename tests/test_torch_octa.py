"""The port's OctaScribbleNet facade: the cases of tests/test_octa_facade.py,
and its combined forward against the JAX facade's, on the CPU.

The JAX facade is initialised once at 32² (encoder gating on, critic of depth
4 with 8 filters, both noise layers off); its segmentor and critic variables
go to the port through the weight bridge, and both run the same image and
mask pyramid in eval mode (float32, 1e-4, the tolerance of the family's
parity tests; the critic's logits 5e-4, as tests/test_golden.py holds
disc64).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.models import octa as jocta
from octave_tpu_torch.models.octa import OctaScribbleNet, _shape_chw, octa_scribble_net
from octave_tpu_torch.utils.convert import (
    from_jax_discriminator,
    from_jax_variables,
    load_reference_state_dict,
)

HW = 32


def test_shape_inference():
    assert _shape_chw((1, 2, 304, 304)) == (2, 304, 304)  # NCHW
    assert _shape_chw((1, 304, 304, 2)) == (2, 304, 304)  # NHWC


def test_factory_arg_surface():
    """The reference constructor's argument list, `pretrian` included."""
    model, wp = octa_scribble_net(
        raw_input_shape=(1, 1, 64, 64), mask_input_shape=(1, 2, 64, 64),
        is_training=True, pretrian=True, weight_path="w.pth", num_classes=2,
        num_filters=8, instance_noise=False, label_noise=False,
        segmentor_gating_level=4, discriminator_depth=2, encoder_gating=False,
        weakly_supervise=True, device="cpu",
    )
    assert wp == "w.pth" and model.num_filters == 8 and model.training
    assert model.discriminator.depth == 2
    model, wp2 = octa_scribble_net((1, 1, 64, 64), (1, 2, 64, 64), False, device="cpu")
    assert wp2 is None and not model.training
    _, wp3 = octa_scribble_net((1, 1, 64, 64), (1, 2, 64, 64), True, pretrain=True,
                               device="cpu")
    assert wp3 == "resnest50-528c19ca.pth"


def test_channel_mismatch_warns_and_cuda_default():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        model = OctaScribbleNet((1, 1, 32, 32), (1, 3, 32, 32), num_classes=2,
                                discriminator_depth=0, device="cpu")
    assert any("Number channels" in str(x.message) for x in w)
    assert model.discriminator is None
    with pytest.raises(ValueError, match="no discriminator"):
        model.discriminate([torch.zeros(1, 32, 32, 2)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            OctaScribbleNet((1, 1, 32, 32), (1, 2, 32, 32))


def test_loss_bundle_matches_jax():
    """WPCE when weakly supervised, Dice otherwise, and the LS-GAN pair, each
    equal to the JAX facade's value."""
    weak = OctaScribbleNet((1, 1, 32, 32), (1, 2, 32, 32), weakly_supervise=True,
                           discriminator_depth=0, device="cpu")
    full = OctaScribbleNet((1, 1, 32, 32), (1, 2, 32, 32), weakly_supervise=False,
                           discriminator_depth=0, device="cpu")
    jweak = jocta.OctaScribbleNet((1, 1, 32, 32), (1, 2, 32, 32), weakly_supervise=True)
    jfull = jocta.OctaScribbleNet((1, 1, 32, 32), (1, 2, 32, 32), weakly_supervise=False)
    rng = np.random.default_rng(0)
    probs = rng.uniform(0.05, 1, (2, 8, 8, 2)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    ys = (rng.uniform(0, 1, (2, 8, 8, 2)) > 0.6).astype(np.float32)
    tp, ty, jp, jy = torch.from_numpy(probs), torch.from_numpy(ys), jnp.asarray(probs), \
        jnp.asarray(ys)
    lw, lf = float(weak.supervised_loss(tp, ty)), float(full.supervised_loss(tp, ty))
    assert lw != pytest.approx(lf)
    np.testing.assert_allclose(lw, float(jweak.supervised_loss(jp, jy)), rtol=1e-5)
    np.testing.assert_allclose(lf, float(jfull.supervised_loss(jp, jy)), rtol=1e-5)
    np.testing.assert_allclose(float(weak.supervised_loss(tp, ty, ignore_bg=True, full=True)),
                               float(jweak.supervised_loss(jp, jy, ignore_bg=True, full=True)),
                               rtol=1e-5)
    y = torch.ones(2, 1)
    assert float(OctaScribbleNet.discriminatorial_loss(y, -y)) == 0.0
    assert float(OctaScribbleNet.generator_loss(y)) == 0.0
    r, f = rng.standard_normal((4, 1)).astype(np.float32), rng.standard_normal((4, 1)).astype(
        np.float32)
    np.testing.assert_allclose(
        float(OctaScribbleNet.discriminatorial_loss(torch.from_numpy(r), torch.from_numpy(f))),
        float(jocta.OctaScribbleNet.discriminatorial_loss(jnp.asarray(r), jnp.asarray(f))),
        rtol=1e-6)


def test_combined_forward_matches_jax(rng):
    """Encoder gates, pyramid, agg map, latent and both critic logits, from
    the JAX facade's own initial variables; then a train-mode forward."""
    kw = dict(num_classes=2, num_filters=8, instance_noise=False, label_noise=False,
              discriminator_depth=4, encoder_gating=True)
    x = rng.uniform(0, 1, (1, HW, HW, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (1, HW, HW, 2)) > 0.5).astype(np.float32)
    pyr = [np.ascontiguousarray(mask[:, ::2**i, ::2**i, :]) for i in range(5)]
    jm = jocta.OctaScribbleNet((1, 3, HW, HW), (1, 2, HW, HW), is_training=False, **kw)
    variables = jax.jit(lambda k: jm.init({"params": k, "noise": k}, jnp.asarray(x),
                                          [jnp.asarray(p) for p in pyr], train=False))(
        jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    want = jax.tree.map(np.asarray, jax.jit(lambda v: jm.apply(
        v, jnp.asarray(x), [jnp.asarray(p) for p in pyr], train=False))(variables))

    model, _ = octa_scribble_net((1, 3, HW, HW), (1, 2, HW, HW), False, device="cpu", **kw)
    load_reference_state_dict(model.segmentor, from_jax_variables(
        {"params": variables["params"]["segmentor"],
         "batch_stats": variables["batch_stats"]["segmentor"]}))
    model.discriminator.load_state_dict(from_jax_discriminator(
        {"params": variables["params"]["discriminator"],
         "spectral": variables["spectral"]["discriminator"]}, instance_noise=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x), [torch.from_numpy(p) for p in pyr])
    assert set(got) == set(want) == {"attentions", "agg_map", "latent", "encoder_gates",
                                     "y_fake", "y_real"}
    for key in ("attentions", "encoder_gates"):
        assert len(got[key]) == len(want[key]) == 5
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-4, err_msg=key)
    for key in ("agg_map", "latent"):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=1e-4, err_msg=key)
    for key in ("y_fake", "y_real"):
        assert got[key].shape == (1, 1)
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=5e-4, err_msg=key)
    with torch.no_grad():
        seg_att, seg_pred = model.segment(torch.from_numpy(x))
        d = model.discriminate([torch.from_numpy(p) for p in pyr])
    np.testing.assert_allclose(seg_pred.numpy(), torch.softmax(got["agg_map"], -1).numpy(),
                               atol=1e-6)
    assert torch.equal(d, got["y_real"])

    model.train()  # batch statistics need B > 1 (the split-attention BNs pool to 1x1)
    gen = torch.Generator().manual_seed(0)
    two = lambda a: torch.from_numpy(np.concatenate([a, a[:, ::-1]]).copy())  # noqa: E731
    out = model(two(x), [two(p) for p in pyr], generator=gen)
    assert all(torch.isfinite(out[k]).all() for k in ("agg_map", "y_fake", "y_real"))
    assert [a.shape[1] for a in out["attentions"]] == [32, 16, 8, 4, 2]
