"""The port's LS-GAN critic against the JAX package's, on the CPU.

Weights come from a JAX `init` and cross with `from_jax_discriminator`.
Forward logits agree to 1e-5 (float32 convolutions summed in another
order); gradients to 1e-5 of each tensor's largest entry; the reference's
stored logits (tests/golden/disc64.npz) to 5e-4, as tests/test_golden.py.
JAX's threefry noise cannot be reproduced, so the parity cases run with both
noise layers off and the noise contracts are checked on their own.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goldens import disc_pyramid, fill_state_dict, load_fixture
from octave_tpu.models.discriminator import DiscriminatorBlock as JaxD
from octave_tpu_torch.models.discriminator import (
    DiscriminatorBlock,
    InstanceNoise,
    LabelNoise,
)
from octave_tpu_torch.utils.convert import from_jax_discriminator

# (input_hw, depth, num_filters): the train-test critic, and a non-square one
CONFIGS = [((32, 32), 4, 8), ((64, 48), 3, 16)]


def _pyramid(rng, hw, depth, b=2, k=2):
    maps = []
    for i in range(depth + 1):
        a = rng.uniform(0.01, 1, (b, hw[0] // 2**i, hw[1] // 2**i, k)).astype(np.float32)
        maps.append(a / a.sum(-1, keepdims=True))
    return maps


@functools.lru_cache(maxsize=None)
def _jax_init(hw, depth, nf):
    jm = JaxD(input_hw=hw, depth=depth, num_filters=nf, instance_noise=False, label_noise=False)
    zeros = [jnp.zeros((1, hw[0] // 2**i, hw[1] // 2**i, 2)) for i in range(depth + 1)]
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: jm.init({"params": k, "noise": k}, zeros, False))(key)
    return jm, jax.tree.map(np.asarray, variables)


def _pair(hw, depth, nf):
    """The JAX critic and its init, and the port's critic on those weights."""
    jm, variables = _jax_init(hw, depth, nf)
    tm = DiscriminatorBlock(hw, depth=depth, num_filters=nf, instance_noise=False,
                            label_noise=False)
    tm.load_state_dict(from_jax_discriminator(variables, instance_noise=False))
    return jm, variables, tm


def _t(maps):
    return [torch.from_numpy(m) for m in maps]


@pytest.mark.parametrize("hw,depth,nf", CONFIGS)
def test_forward_matches_jax(hw, depth, nf):
    """JAX init -> port: the same eval and train logits."""
    jm, variables, tm = _pair(hw, depth, nf)
    ys = _pyramid(np.random.default_rng(1), hw, depth)
    for train in (False, True):
        want, _ = jm.apply(variables, [jnp.asarray(y) for y in ys], train, mutable=["spectral"])
        with torch.no_grad():
            got = tm.train(train)(_t(ys))
        assert got.shape == (2, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("hw,depth,nf", CONFIGS)
def test_spectral_state_follows_the_jax_step(hw, depth, nf):
    """The step's three critic calls: the generator phase iterates and drops
    its u/v; then D(fake) iterates u0 -> u1 and D(real) u1 -> u2."""
    jm, variables, tm = _pair(hw, depth, nf)
    rng = np.random.default_rng(2)
    fake, real = _pyramid(rng, hw, depth), _pyramid(rng, hw, depth)
    params, spec0 = variables["params"], variables["spectral"]
    _, mut1 = jm.apply({"params": params, "spectral": spec0}, [jnp.asarray(y) for y in fake],
                       True, mutable=["spectral"])
    _, mut2 = jm.apply({"params": params, "spectral": mut1["spectral"]},
                       [jnp.asarray(y) for y in real], True, mutable=["spectral"])
    tm.train()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        tm(_t(fake), update=False)
        assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())
        tm(_t(fake))
        tm(_t(real))
    sd = tm.state_dict()
    for i in range(depth):
        for vec in ("u", "v"):
            want = np.asarray(mut2["spectral"][f"spectral_{i}"][vec])
            got = sd[f"spectral_dict.spectral_{i}.0.weight_{vec}"].numpy()
            assert not np.allclose(got, before[f"spectral_dict.spectral_{i}.0.weight_{vec}"])
            np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("hw,depth,nf", CONFIGS)
def test_gradients_match_jax(hw, depth, nf):
    """Training-mode input and parameter gradients; sigma's gradient flows
    through W only, as in the JAX module."""
    jm, variables, tm = _pair(hw, depth, nf)
    rng = np.random.default_rng(3)
    ys = _pyramid(rng, hw, depth)
    coef = rng.standard_normal((2, 1)).astype(np.float32)

    def loss(params, ys):
        out, _ = jm.apply({"params": params, "spectral": variables["spectral"]}, ys, True,
                          mutable=["spectral"])
        return jnp.sum(out * coef) + jnp.sum(out**2)

    g_params, g_ys = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                                    [jnp.asarray(y) for y in ys])
    want = from_jax_discriminator({"params": g_params, "spectral": variables["spectral"]},
                                  instance_noise=False)
    xs = [y.requires_grad_() for y in _t(ys)]
    out = tm.train()(xs, update=False)
    (torch.sum(out * torch.from_numpy(coef)) + torch.sum(out**2)).backward()
    checked = 0
    for name, p in tm.named_parameters():
        g = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(),
                                   err_msg=name)
        checked += 1
    assert checked == 2 * (2 + 2 * depth)
    for x, g in zip(xs, g_ys):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


def test_golden_disc64():
    """The reference-named fill loads with no conversion and gives the
    reference's logits (eval: stored u/v, clip, no noise added)."""
    manifest, meta, out = load_fixture("disc64")
    tm = DiscriminatorBlock((meta["h"], meta["w"]), depth=meta["depth"],
                            num_filters=meta["num_filters"], instance_noise=True,
                            label_noise=False)
    assert set(tm.state_dict()) == set(manifest)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in fill_state_dict(manifest).items()})
    ys = disc_pyramid(meta["seed"], 2, 2, meta["h"], meta["w"], meta["depth"])
    with torch.no_grad():
        got = tm.eval()([torch.from_numpy(y).permute(0, 2, 3, 1).contiguous() for y in ys])
    assert got.shape == out["logits"].shape
    assert float(np.abs(got.numpy() - out["logits"]).max()) < 5e-4


def test_instance_noise_contract():
    """One (H, W) map per call, shared over batch and channels, added in
    training only; the [0, 1] clip applies in eval too."""
    x = torch.full((3, 2, 5, 7), 0.5)
    noise = InstanceNoise()
    gen = torch.Generator().manual_seed(0)
    y = noise.train()(x, gen)
    d = y - 0.5
    assert y.shape == x.shape and y.min() >= 0 and y.max() <= 1
    assert torch.equal(d, d[:1, :1].expand_as(d))  # one map for every sample and channel
    assert d.abs().max() > 0
    assert not torch.equal(noise(x, gen), y)  # a new draw on every call
    wide = torch.linspace(-1, 2, 12).reshape(1, 1, 3, 4)
    assert torch.equal(noise.eval()(wide, gen), wide.clamp(0, 1))
    want = (0.5 + 0.2 * torch.randn((5, 7), generator=torch.Generator().manual_seed(0)))
    assert torch.allclose(y[0, 0], want.clamp(0, 1))


def test_label_noise_contract():
    """One uniform scalar per call decides the flip for the whole batch, in
    eval as in training; about prob of the calls flip."""
    x = torch.arange(1.0, 9.0).reshape(8, 1)
    noise = LabelNoise(prob=0.1, mode="sign").eval()
    gen = torch.Generator().manual_seed(0)
    flips = 0
    for _ in range(400):
        y = noise(x, gen)
        assert torch.equal(y, x) or torch.equal(y, -x)
        flips += int(torch.equal(y, -x))
    ref = torch.Generator().manual_seed(0)  # one scalar draw per call
    assert flips == sum(int(torch.rand((), generator=ref) < 0.1) for _ in range(400))
    assert 20 <= flips <= 65
    label = LabelNoise(prob=1.0, mode="label")
    assert torch.equal(label(torch.tensor([[0.25], [3.0]]), gen), torch.tensor([[0.75], [2.0]]))


def test_noise_is_drawn_from_the_passed_generator():
    tm = DiscriminatorBlock((32, 32), depth=2, num_filters=4).train()
    ys = _t(_pyramid(np.random.default_rng(4), (32, 32), 2))
    a = tm(ys, torch.Generator().manual_seed(5), update=False)
    b = tm(ys, torch.Generator().manual_seed(5), update=False)
    c = tm(ys, torch.Generator().manual_seed(6), update=False)
    assert torch.equal(a, b) and not torch.equal(a, c)



def _critic_map(tm, maps):
    """The (B, C, h, w) map a critic's output conv receives."""
    s = torch.nn.functional.leaky_relu(tm.stack_0[-2](maps[0].permute(0, 3, 1, 2)), 0.2)
    for i in range(tm.depth):
        s = torch.sigmoid(tm.squeeze_dict[f"squeeze_{i}"][0](s))
        s = torch.cat((s, maps[i + 1].permute(0, 3, 1, 2)), dim=1)
        s = torch.tanh(tm.spectral_dict[f"spectral_{i}"][0](s))
    return s


def test_output_conv_as_gemm_and_on_larger_maps():
    """Where the output conv's kernel spans the whole map the critic takes it
    as a GEMM: logits and weight gradient as the conv's (1e-5). A pyramid
    larger than input_hw runs the conv itself and gives the JAX critic's
    several logits per sample."""
    rng = np.random.default_rng(5)
    jm, variables, tm = _pair((32, 32), 1, 8)
    tm.eval()  # stored u/v: every forward below sees the same weights
    maps = _t(_pyramid(rng, (32, 32), 1))
    conv = tm.out[0]
    got = tm(maps)
    ref = torch.nn.functional.conv2d(_critic_map(tm, maps), conv.weight, conv.bias)
    assert conv.kernel_size == (8, 8) and ref.shape == (2, 1, 1, 1)
    torch.testing.assert_close(got, ref.reshape(2, -1), atol=1e-5, rtol=0)
    g_gemm = torch.autograd.grad(got.sum(), conv.weight)[0]
    g_conv = torch.autograd.grad(ref.sum(), conv.weight)[0]
    torch.testing.assert_close(g_gemm, g_conv, atol=1e-5, rtol=0)
    big = _pyramid(rng, (64, 64), 1)
    j_logits = np.asarray(jm.apply(variables, [jnp.asarray(m) for m in big], False))
    t_logits = tm(_t(big)).detach().numpy()
    assert t_logits.shape == j_logits.shape == (2, 81)
    np.testing.assert_allclose(t_logits, j_logits, atol=1e-5)
