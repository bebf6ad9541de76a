"""The port's device-side augmentation against the JAX package's.

The JAX functions split their PRNG key themselves; the port's transforms are
functions of given draws. Each test reproduces the JAX draws from the key
(the same splits and samplers as octave_tpu/data/augment.py) and feeds them
to the port: the dihedral part must then be exact and the jitter within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octave_tpu.data import augment as jaug
from octave_tpu.data import preprocess as jpre
from octave_tpu_torch.data import augment as taug
from octave_tpu_torch.data import preprocess as tpre

B, HW = 8, 16


def _dihedral_bits(key, b):
    """The three per-sample bits `random_dihedral(key, ...)` draws."""
    kf, kv, kr = jax.random.split(key, 3)
    return tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, (b,))))
                 for k in (kf, kv, kr))


def _jitter_draws(key, b, amount):
    """db, dc (b,1,1,1) as `intensity_jitter(key, ...)` draws them."""
    kb, kc = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(
        jax.random.uniform(k, (b, 1, 1, 1), jnp.float32, -amount, amount))) for k in (kb, kc))


def _augment_draws(key, b, intensity):
    """All draws of `augment(key, ...)`."""
    kg, ki = jax.random.split(key)
    bits = _dihedral_bits(kg, b)
    jit = _jitter_draws(ki, b, intensity) if intensity > 0 else (None, None)
    return taug.Draws(*bits, *jit)


@pytest.fixture()
def tensors(rng):
    img = rng.uniform(0, 1, (B, HW, HW, 3)).astype(np.float32)
    lab = (rng.uniform(0, 1, (B, HW, HW, 2)) > 0.5).astype(np.float32)
    return img, lab


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_dihedral_equals_jax(tensors, seed):
    img, lab = tensors
    key = jax.random.PRNGKey(seed)
    want = jaug.random_dihedral(key, jnp.asarray(img), jnp.asarray(lab))
    got = taug.random_dihedral(*_dihedral_bits(key, B), torch.from_numpy(img),
                               torch.from_numpy(lab))
    for g, w in zip(got, want):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_each_bit_is_its_transform(tensors):
    """flip_h mirrors w, flip_v mirrors h, rot transposes then mirrors w."""
    img = torch.from_numpy(tensors[0])
    on, off = torch.ones(B, dtype=torch.bool), torch.zeros(B, dtype=torch.bool)
    assert torch.equal(taug.random_dihedral(off, off, off, img)[0], img)
    assert torch.equal(taug.random_dihedral(on, off, off, img)[0], img.flip(2))
    assert torch.equal(taug.random_dihedral(off, on, off, img)[0], img.flip(1))
    assert torch.equal(taug.random_dihedral(off, off, on, img)[0],
                       img.transpose(1, 2).flip(2))
    mixed = torch.arange(B) % 2 == 0
    out = taug.random_dihedral(mixed, off, off, img)[0]
    assert torch.equal(out[0], img[0].flip(1)) and torch.equal(out[1], img[1])


def test_non_square_raises(rng):
    x = torch.zeros(2, 8, 12, 1)
    bits = (torch.zeros(2, dtype=torch.bool),) * 3
    with pytest.raises(ValueError, match="square"):
        taug.random_dihedral(*bits, x)


@pytest.mark.parametrize("amount", [0.1, 0.3])
def test_intensity_jitter_equals_jax(tensors, amount):
    img, _ = tensors
    key = jax.random.PRNGKey(5)
    want = jaug.intensity_jitter(key, jnp.asarray(img), amount, amount)
    got = taug.intensity_jitter(torch.from_numpy(img), *_jitter_draws(key, B, amount))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


@pytest.mark.parametrize("intensity", [0.0, 0.1])
def test_prepare_batch_augment_equals_jax(rng, intensity):
    """The whole prepared batch under augmentation, resize included; the
    pyramid is the pyramid of the augmented mask."""
    image = rng.integers(0, 256, (B, 20, 20), dtype=np.uint8)
    scrib = rng.integers(0, 3, (B, 20, 20)).astype(np.uint8)
    mask = rng.integers(0, 2, (B, 20, 20)).astype(np.uint8)
    key = jax.random.PRNGKey(11)
    want = jpre.prepare_batch(jnp.asarray(image), jnp.asarray(scrib), jnp.asarray(mask),
                              size=(HW, HW), depth=3, augment_key=key,
                              augment_intensity=intensity)
    got = tpre.prepare_batch(image, scrib, mask, size=(HW, HW), depth=3,
                             augment_draws=_augment_draws(key, B, intensity), device="cpu")
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]), atol=1e-6)
    for k in ("scribble_onehot", "mask_onehot"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert len(got["mask_pyramid"]) == 4
    for g, w in zip(got["mask_pyramid"], want["mask_pyramid"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got["mask_pyramid"], tpre.mask_pyramid(got["mask_onehot"], 3)):
        assert torch.equal(g, w)
    plain = tpre.prepare_batch(image, scrib, mask, size=(HW, HW), depth=3, device="cpu")
    assert not torch.equal(plain["mask_onehot"], got["mask_onehot"])
    assert all(t.is_contiguous() for t in (got["image"], got["scribble_onehot"],
                                           got["mask_onehot"]))


def test_draws_cover_d4_and_repeat_with_the_seed():
    gen = torch.Generator().manual_seed(3)
    d = taug.draw(gen, 256, intensity=0.2)
    elements = {(bool(a), bool(b), bool(c)) for a, b, c in zip(d.flip_h, d.flip_v, d.rot)}
    assert len(elements) == 8  # all of D4
    assert d.db.shape == d.dc.shape == (256, 1, 1, 1)
    assert float(d.db.abs().max()) <= 0.2 and float(d.dc.abs().max()) <= 0.2
    assert float(d.db.min()) < -0.1 and float(d.db.max()) > 0.1
    again = taug.draw(torch.Generator().manual_seed(3), 256, intensity=0.2)
    other = taug.draw(torch.Generator().manual_seed(4), 256, intensity=0.2)
    for a, b in zip(d, again):
        assert torch.equal(a, b)
    assert not torch.equal(d.flip_h, other.flip_h)
    no_jitter = taug.draw(torch.Generator().manual_seed(3), 4)
    assert no_jitter.db is None and no_jitter.dc is None


def test_distinct_d4_images_over_a_seeded_run():
    """One asymmetric image under 256 seeded draws: exactly 8 distinct views."""
    img = torch.arange(16.0).reshape(1, 4, 4, 1).repeat(256, 1, 1, 1)
    d = taug.draw(torch.Generator().manual_seed(0), 256)
    out = taug.random_dihedral(d.flip_h, d.flip_v, d.rot, img)[0]
    assert len({tuple(o.flatten().tolist()) for o in out}) == 8


def test_prepare_batch_requires_a_device():
    """`device` is a required keyword: no entry point of the port picks the
    CPU by itself."""
    z = np.zeros((1, 8, 8), np.uint8)
    with pytest.raises(TypeError, match="device"):
        tpre.prepare_batch(z, z, z, size=(8, 8))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tpre.prepare_batch(z, z, z, size=(8, 8), device="cuda")
