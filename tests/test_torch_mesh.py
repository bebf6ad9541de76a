"""The Predictor's fan-out over a mesh of devices against the JAX package's
mesh Predictor, on the CPU.

JAX runs its Predictor over two of the eight virtual CPU devices
(`make_mesh(2)`, as tests/test_serve.py:36-64 runs its eight); the port runs
two replicas on the one CPU (`mesh=(cpu, cpu)`), its counterpart of virtual
devices. Both take the golden fill of unet112 through the weight bridge,
float32 at 32², B = 4, and the same images: atol 1e-5, as
tests/test_serve.py holds JAX's mesh Predictor against its single one. The
fan-out is also held against the port's single Predictor, the int8
Predictor with a mesh against the one without, and a BatchServer over a
fanned-out Predictor against the direct path. On the card:
tests/test_torch_cuda.py and chip_smoke.py phase 11.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from goldens import fill_state_dict, load_fixture
from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu.parallel.mesh import make_mesh as jax_make_mesh
from octave_tpu.serve import Predictor as JaxPredictor
from octave_tpu.utils.torch_convert import convert_resnest_unet
from octave_tpu_torch.parallel import mesh as tmesh
from octave_tpu_torch.serve import BatchServer, DeviceResult, Predictor
from octave_tpu_torch.utils.convert import from_jax_variables

HW, B = (32, 32), 4
CPU2 = (torch.device("cpu"),) * 2


@pytest.fixture(scope="module")
def weights():
    """(JAX variables, the port's state dict) of the golden fill."""
    manifest, _, _ = load_fixture("unet112")
    variables = convert_resnest_unet(fill_state_dict(manifest))
    return variables, from_jax_variables(variables)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(7).uniform(0, 1, (2, B, *HW, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_mesh_pred(weights):
    """One JAX mesh Predictor for the module (its compiles dominate)."""
    return JaxPredictor(weights[0], dtype=jnp.float32, use_fused_decoder=True,
                        mesh=jax_make_mesh(2))


@pytest.fixture(scope="module")
def fanned(weights):
    return Predictor(weights[1], dtype=torch.float32, device="cpu", mesh=CPU2)


@pytest.fixture(scope="module")
def single(weights):
    return Predictor(weights[1], dtype=torch.float32, device="cpu")


def test_fanout_matches_jax_mesh_predictor(jax_mesh_pred, fanned, images):
    want = jax_mesh_pred(images[0])
    got = fanned(images[0])
    assert got.shape == want.shape == (B, *HW, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_predict_many_fanout_matches_jax(jax_mesh_pred, fanned, images):
    want = jax_mesh_pred.predict_many(images)
    got = fanned.predict_many(images)
    assert got.shape == want.shape == (2, B, *HW, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_fanout_equals_single_predictor(fanned, single, images):
    np.testing.assert_allclose(fanned(images[0]), single(images[0]), atol=1e-5, rtol=0)
    res = fanned.predict_many_device(images)
    assert isinstance(res, DeviceResult) and res.tensor.shape == (2, B, *HW, 2)
    np.testing.assert_allclose(np.asarray(res), single.predict_many(images), atol=1e-5, rtol=0)
    streamed = list(fanned.predict_stream(iter(images), depth=2))
    for s, batch in zip(streamed, images):
        np.testing.assert_allclose(s, single(batch), atol=1e-5, rtol=0)


def test_replicas_are_copies_on_their_devices(fanned):
    assert len(fanned.replicas) == 2 and fanned.mesh == CPU2
    a, b = (r.model for r in fanned.replicas)
    assert a is fanned.model and a is not b
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert p.data_ptr() != q.data_ptr() and torch.equal(p, q), name


def test_rows_must_divide_over_the_mesh(fanned, images):
    with pytest.raises(ValueError, match="does not divide"):
        fanned(images[0, :3])
    with pytest.raises(ValueError, match="does not divide"):
        fanned.predict_many(images[:, :3])


def test_device_must_be_the_mesh_first(weights):
    with pytest.raises(ValueError, match="first device"):
        Predictor(weights[1], device="cuda", mesh=CPU2)
    pred = Predictor(weights[1], dtype=torch.float32, mesh=["cpu", "cpu"])
    assert pred.device == torch.device("cpu") and len(pred.replicas) == 2


def test_int8_fanout_equals_int8_single(weights, images):
    kw = dict(dtype=torch.float32, device="cpu", int8_decoder=True,
              calibration_batches=[images[1]])
    single = Predictor(weights[1], **kw)
    fanned = Predictor(weights[1], mesh=CPU2, **kw)
    assert fanned.int8_scales == single.int8_scales
    for rep in fanned.replicas:  # the prepacked weights moved with each replica
        convs = [m for m in rep.model.modules() if m.__class__.__name__ == "Int8Conv"]
        assert convs and all(m.weight.dtype == torch.int8 for m in convs)
    np.testing.assert_allclose(fanned(images[0]), single(images[0]), atol=1e-5, rtol=0)


def test_batch_server_over_fanout_returns_in_order(fanned, single):
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (*HW, 3), dtype=np.uint8) for _ in range(7)]
    with BatchServer(fanned, batch=2, image_hw=HW, ks=(1, 2)) as srv:
        got = list(srv.map(iter(imgs)))
    assert len(got) == 7
    want = single(np.stack(imgs))
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, want[i], atol=1e-5, rtol=0)


def test_oom_in_one_replica_reaches_the_batch_server(weights):
    """An out-of-memory error in the second replica's forward, at k = 2,
    propagates out of the dispatch: the server drops k = 2 and serves the
    flood at k = 1, in order."""
    fanned = Predictor(weights[1], dtype=torch.float32, device="cpu", mesh=CPU2)
    single = Predictor(weights[1], dtype=torch.float32, device="cpu")
    replica = fanned.replicas[1].model
    predict, dispatch = replica.predict, fanned.predict_many_device
    state = {"k": 1}

    def failing_predict(*args, **kwargs):
        if state["k"] >= 2:
            raise torch.OutOfMemoryError("injected in replica 1")
        return predict(*args, **kwargs)

    def recording(stack):
        state["k"] = stack.shape[0]
        return dispatch(stack)

    replica.predict, fanned.predict_many_device = failing_predict, recording
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (*HW, 3), dtype=np.uint8) for _ in range(9)]
    with BatchServer(fanned, batch=2, image_hw=HW, ks=(1, 2), warmup=False) as srv:
        got = list(srv.map(iter(imgs)))
        assert srv._ks_live == (1,)
    want = single(np.stack(imgs))
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, want[i], atol=1e-5, rtol=0)


def test_mesh_helpers():
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 available on platform 'cuda'"):
            tmesh.make_mesh()
    with pytest.raises(ValueError, match="one type"):
        tmesh.as_mesh([])
    x = torch.arange(24.0).reshape(2, 4, 3)
    shards = tmesh.shard_batch(x, CPU2, axis_pos=1)
    assert [tuple(s.shape) for s in shards] == [(2, 2, 3), (2, 2, 3)]
    assert torch.equal(torch.cat(shards, dim=1), x)
    assert [s.shape[0] for s in tmesh.shard_batch(x.numpy(), ["cpu"] * 2)] == [1, 1]
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(x, ["cpu"] * 3)
    lin = torch.nn.Linear(3, 2)
    copies = tmesh.replicate(lin, CPU2)
    assert len(copies) == 2 and all(c is not lin for c in copies)
    assert torch.equal(copies[1].weight, lin.weight)
    assert copies[0].weight.data_ptr() != lin.weight.data_ptr()
