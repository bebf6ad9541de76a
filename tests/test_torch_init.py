"""The port's initial weights against the JAX package's `ResnestUNet.init`.

The ResNeSt backbone draws every conv weight from N(0, sqrt(2/n)), n =
kh*kw*out_channels (`octave_tpu/ops/common.py:63` `resnet_conv_init`, the
reference's re-init loop); the decoders' split-attention convs keep torch's
default kaiming-uniform in both packages. Each weight is a sample, so it is
held to its distribution by its sample standard deviation: for n draws the
relative standard error of the sample std is 1/sqrt(2n), and a case passes
within 6 of them (against the formula) or 6*sqrt(2) (against the JAX
package's sample, itself n draws).
"""
import math

import jax
import jax.numpy as jnp
import pytest
import torch

from octave_tpu.models.segmentor import ResnestUNet as JaxResnestUNet
from octave_tpu_torch.models import resnest
from octave_tpu_torch.models.segmentor import ResnestUNet
from octave_tpu_torch.utils.convert import from_jax_variables
from port_fixtures import few_torch_threads  # noqa: F401

HW = 64
Z = 6.0  # standard errors


def _backbone_convs():
    """State-dict keys of every conv weight of the backbone: the stem's
    three, and each Bottleneck's conv1, split-attention conv, fc1, fc2,
    conv3 and (first block of a stage) downsample conv."""
    names = [f"encoder_0_1_2.0.{i}.weight" for i in (0, 3, 6)]
    for layer, blocks in enumerate((3, 4, 6, 3), start=1):
        for b in range(blocks):
            pre = f"encoder_{layer}.{b}."
            names += [pre + n for n in ("conv1.weight", "conv2.conv.weight",
                                        "conv2.fc1.weight", "conv2.fc2.weight", "conv3.weight")]
            if b == 0:
                names.append(pre + "downsample.1.weight")
    return names


BACKBONE = _backbone_convs()
DECODER_SPLAT = [f"decoder_{d}.conv.3.{n}.weight" for d in range(5) for n in ("conv", "fc1", "fc2")]


@pytest.fixture(scope="module")
def port_sd():
    torch.manual_seed(0)
    return ResnestUNet(2).state_dict()


@pytest.fixture(scope="module")
def jax_sd():
    """JAX's init at 64², in the port's names and layout."""
    model = JaxResnestUNet(num_classes=2)
    variables = jax.jit(lambda k: model.init(k, jnp.zeros((1, HW, HW, 3)), False))(
        jax.random.PRNGKey(0))
    return from_jax_variables(variables)


def _rel(a: float, b: float) -> float:
    return abs(a / b - 1.0)


def test_backbone_conv_list_is_complete(port_sd):
    convs = {k for k, v in port_sd.items() if k.startswith("encoder_") and v.ndim == 4}
    assert convs == set(BACKBONE) and len(BACKBONE) == 87


@pytest.mark.parametrize("name", BACKBONE)
def test_backbone_conv_draws_resnet_init(port_sd, jax_sd, name):
    w = port_sd[name]
    n = w.numel()
    want = math.sqrt(2.0 / (w.shape[2] * w.shape[3] * w.shape[0]))
    got, theirs = float(w.std()), float(jax_sd[name].std())
    assert jax_sd[name].shape == w.shape
    assert _rel(got, want) <= Z / math.sqrt(2 * n), (got, want)
    assert _rel(got, theirs) <= Z * math.sqrt(2) / math.sqrt(2 * n), (got, theirs)
    assert abs(float(w.mean())) <= Z * want / math.sqrt(n)


@pytest.mark.parametrize("name", DECODER_SPLAT)
def test_decoder_split_attention_keeps_kaiming_uniform(port_sd, jax_sd, name):
    """torch's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), std bound/sqrt(3)."""
    w = port_sd[name]
    n = w.numel()
    bound = 1.0 / math.sqrt(w[0].numel())
    got, theirs = float(w.std()), float(jax_sd[name].std())
    assert float(w.abs().max()) <= bound * (1 + 2**-23)  # the float32 bound
    assert _rel(got, bound / math.sqrt(3)) <= Z / math.sqrt(2 * n), (got, bound)
    assert _rel(got, theirs) <= Z * math.sqrt(2) / math.sqrt(2 * n), (got, theirs)


def test_backbone_biases_and_norms_keep_their_draws(monkeypatch):
    """The re-init runs after the stages are built and draws conv weights
    only: without it, the same seed gives the same backbone biases (fc1,
    fc2) and batch norms, and other conv weights."""
    torch.manual_seed(3)
    drawn = resnest.resnest50().state_dict()
    monkeypatch.setattr(resnest, "resnet_conv_init_", lambda module: None)
    torch.manual_seed(3)
    default = resnest.resnest50().state_dict()
    assert drawn.keys() == default.keys()
    assert any(k.endswith("fc1.bias") for k in drawn)
    for key, value in drawn.items():
        if value.ndim == 4:  # the conv weights
            assert not torch.equal(value, default[key]), key
        else:
            assert torch.equal(value, default[key]), key
