"""The port's Predictor streaming paths and BatchServer on the CPU.

The BatchServer cases of tests/test_serve.py in torch: with a real 32²
float32 predictor, with a device-free fake that raises
`torch.OutOfMemoryError` where the JAX fake raised RESOURCE_EXHAUSTED, and
one case against the JAX package's BatchServer on the same weights.
"""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from goldens import fill_state_dict, load_fixture

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu import serve as jserve
from octave_tpu.utils.torch_convert import convert_resnest_unet
from octave_tpu_torch.serve import BatchServer, DeviceResult, Predictor
from octave_tpu_torch.utils.convert import from_jax_variables

HW = (32, 32)


@pytest.fixture(scope="module")
def pred():
    return Predictor.initialize(image_hw=HW, dtype=torch.float32, device="cpu")


def _images(rng, n, hw=HW):
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n)]


# -- Predictor ---------------------------------------------------------------
def test_initialize_is_seeded_and_needs_cuda_by_default(pred, rng):
    x = np.stack(_images(rng, 2))
    same = Predictor.initialize(image_hw=HW, dtype=torch.float32, device="cpu")
    other = Predictor.initialize(image_hw=HW, seed=1, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(pred(x), same(x))
    assert not np.array_equal(pred(x), other(x))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Predictor.initialize(image_hw=HW)


def test_predict_stream_equals_sync(pred, rng):
    batches = [rng.uniform(0, 1, (2, *HW, 3)).astype(np.float32) for _ in range(4)]
    sync = [pred(b) for b in batches]
    for depth in (1, 2, 5):
        stream = list(pred.predict_stream(iter(batches), depth=depth))
        assert len(stream) == 4
        for s, t in zip(sync, stream):
            np.testing.assert_allclose(s, t, atol=1e-6)
    assert sync[0].shape == (2, *HW, 2)
    np.testing.assert_allclose(sync[0].sum(-1), 1.0, atol=1e-5)


def test_predict_many_device_and_warmup(pred, rng):
    stack = rng.integers(0, 256, (3, 2, *HW, 3), dtype=np.uint8)
    res = pred.predict_many_device(stack)
    assert isinstance(res, DeviceResult) and res.tensor.shape == (3, 2, *HW, 2)
    assert not res.tensor.requires_grad
    many = np.asarray(res)
    np.testing.assert_array_equal(many, pred.predict_many(stack))
    for i in range(3):
        np.testing.assert_allclose(many[i], pred(stack[i]), atol=1e-6)
    pred.warmup(2, HW, ks=(1, 2), wire_dtype=np.uint8)  # runs; nothing to compile on the CPU
    buf = pred.host_buffer((2, 2, *HW, 3), np.uint8)
    assert buf.shape == (2, 2, *HW, 3) and buf.dtype == np.uint8 and buf.flags.writeable


# -- BatchServer over the real predictor ---------------------------------------
def _server(pred, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("image_hw", HW)
    kw.setdefault("ks", (1, 2))
    kw.setdefault("warmup", False)
    return BatchServer(pred, **kw)


class TestBatchServer:
    def test_results_match_direct_and_order(self, pred, rng):
        imgs = _images(rng, 7)
        with _server(pred) as srv:
            outs = list(srv.map(iter(imgs)))
        assert len(outs) == 7
        # the direct batch=2 path: an image's output must not depend on the
        # slot or the batch the server routed it through
        for i, (img, out) in enumerate(zip(imgs, outs)):
            want = pred(np.stack([img, imgs[(i + 1) % 7]]))[0]
            np.testing.assert_allclose(out, want, atol=1e-5)

    def test_padding_slots_do_not_leak(self, pred, rng):
        img = _images(rng, 1)[0]
        with _server(pred, warmup=True) as srv:
            out = srv.submit(img).result(timeout=600)
        assert out.shape == (*HW, 2)
        np.testing.assert_allclose(out, pred(np.stack([img, img]))[0], atol=1e-5)

    def test_stale_staging_buffers_do_not_leak(self, pred, rng):
        """A staging buffer is reused: a partial batch after a full one must
        see zero padding, not the earlier request."""
        a, b, c = _images(rng, 3)
        with _server(pred, ks=(1,), pipeline_depth=1) as srv:
            for _ in range(4):  # cycle through every staging buffer
                [f.result(timeout=600) for f in [srv.submit(a), srv.submit(b)]]
            out = srv.submit(c).result(timeout=600)
        np.testing.assert_allclose(out, pred(np.stack([c, np.zeros_like(c)]))[0], atol=1e-6)

    def test_shape_and_dtype_validation(self, pred):
        with _server(pred) as srv:
            with pytest.raises(ValueError, match="shape"):
                srv.submit(np.zeros((16, 16, 3), np.uint8))
            with pytest.raises(ValueError, match="dtype"):
                srv.submit(np.zeros((*HW, 3), np.float32))

    def test_submit_after_close_raises(self, pred):
        srv = _server(pred)
        srv.close()
        srv.close()  # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(np.zeros((*HW, 3), np.uint8))

    def test_pipelined_flood_results_correct(self, pred, rng):
        imgs = _images(rng, 37)
        with _server(pred, pipeline_depth=3) as srv:
            futs = [srv.submit(img) for img in imgs]
            outs = [f.result(timeout=600) for f in futs]
        for img, out in zip(imgs[::6], outs[::6]):
            np.testing.assert_allclose(out, pred(np.stack([img, img]))[0], atol=1e-5)

    def test_pipeline_depth_one_and_validation(self, pred, rng):
        img = _images(rng, 1)[0]
        with _server(pred, pipeline_depth=1) as srv:
            out = srv.submit(img).result(timeout=600)
        np.testing.assert_allclose(out, pred(np.stack([img, img]))[0], atol=1e-5)
        with pytest.raises(ValueError, match="pipeline_depth"):
            _server(pred, pipeline_depth=0)
        with pytest.raises(ValueError, match="ks"):
            _server(pred, ks=(0, 1))

    def test_mask_output_format(self, rng):
        mask_pred = Predictor.initialize(image_hw=HW, dtype=torch.float32, device="cpu",
                                         output_format="mask_u8")
        imgs = _images(rng, 3)
        with _server(mask_pred) as srv:
            outs = list(srv.map(iter(imgs)))
        for img, out in zip(imgs, outs):
            assert out.shape == HW and out.dtype == np.uint8
            np.testing.assert_array_equal(out, mask_pred(np.stack([img, img]))[0])

    def test_int8_predictor_serves_unchanged(self, rng):
        """The server over an int8 Predictor (its convs swapped, its scales
        static) routes, pads and returns as over the float one."""
        calib = np.stack(_images(rng, 2))
        int8_pred = Predictor.initialize(image_hw=HW, dtype=torch.float32, device="cpu",
                                         int8_decoder=True, calibration_batches=[calib])
        imgs = _images(rng, 5)
        with _server(int8_pred, pipeline_depth=3) as srv:
            outs = list(srv.map(iter(imgs)))
        for img, out in zip(imgs, outs):
            np.testing.assert_allclose(out, int8_pred(np.stack([img, img]))[0], atol=1e-5)


def test_batch_server_equals_jax_batch_server(rng):
    """Same weights (through from_jax_variables), same images, float32: the
    two packages' servers agree to 1e-4."""
    manifest, _, _ = load_fixture("unet112")
    variables = convert_resnest_unet(fill_state_dict(manifest))
    jpred = jserve.Predictor(variables, dtype=jnp.float32)
    tpred = Predictor(from_jax_variables(variables), dtype=torch.float32, device="cpu")
    imgs = _images(rng, 5)
    # one compiled graph on the JAX side (k = 1); an image's output does not
    # depend on the k or the slot it was routed through
    with jserve.BatchServer(jpred, batch=2, image_hw=HW, ks=(1,), warmup=False) as srv:
        want = list(srv.map(iter(imgs)))
    with BatchServer(tpred, batch=2, image_hw=HW, ks=(1, 2)) as srv:
        got = list(srv.map(iter(imgs)))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape == (*HW, 2)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0)


# -- BatchServer logic over a device-free fake ---------------------------------
class FakePredictor:
    """Deterministic stand-in with the three methods BatchServer consumes.
    Each image's output is a function of that image's bytes, so a routing,
    slot or order fault gives a wrong answer, not a flaky one. A short sleep
    stands for device latency, so that several chunks are in flight."""

    def __init__(self, latency_s: float = 0.002):
        self.latency_s = latency_s
        self.dispatches = []  # (k, batch) per predict_many_device call

    def warmup(self, batch, image_hw, ks, channels, wire_dtype):
        pass

    host_buffer = staticmethod(np.empty)

    @staticmethod
    def expected(img: np.ndarray) -> np.ndarray:
        m = (img.astype(np.float32) / 255.0).mean(-1)
        return np.stack([m, 1.0 - m], axis=-1)

    def predict_many_device(self, stack):
        self.dispatches.append(stack.shape[:2])
        time.sleep(self.latency_s)
        return self.expected(stack)  # (k, b, h, w, 2)


def _oom(what):
    return torch.OutOfMemoryError(f"CUDA out of memory ({what})")


class TestBatchServerLogic:
    HW = (8, 8)

    def _make(self, fake=None, **kw):
        kw.setdefault("batch", 2)
        kw.setdefault("image_hw", self.HW)
        kw.setdefault("ks", (1, 2))
        fake = fake or FakePredictor()
        return fake, BatchServer(fake, **kw)

    def _check(self, imgs, outs):
        assert len(outs) == len(imgs)
        for img, out in zip(imgs, outs):
            np.testing.assert_allclose(out, FakePredictor.expected(img), atol=1e-6)

    def test_results_match_direct_and_order(self, rng):
        imgs = _images(rng, 7, self.HW)
        _, srv = self._make()
        with srv:
            outs = list(srv.map(iter(imgs)))
        self._check(imgs, outs)

    def test_padding_slots_do_not_leak(self, rng):
        img = _images(rng, 1, self.HW)[0]
        fake, srv = self._make()
        with srv:
            out = srv.submit(img).result(timeout=60)
        assert out.shape == (*self.HW, 2)
        self._check([img], [out])
        assert fake.dispatches == [(1, 2)]  # one k=1 dispatch of the (k, batch) stack

    def test_shape_and_dtype_validation(self):
        _, srv = self._make()
        with srv:
            with pytest.raises(ValueError, match="shape"):
                srv.submit(np.zeros((4, 4, 3), np.uint8))
            with pytest.raises(ValueError, match="dtype"):
                srv.submit(np.zeros((*self.HW, 3), np.float32))

    def test_submit_after_close_raises(self):
        _, srv = self._make()
        srv.close()
        srv.close()
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(np.zeros((*self.HW, 3), np.uint8))

    def test_pipelined_flood_results_correct(self, rng):
        imgs = _images(rng, 200, self.HW)
        fake, srv = self._make(pipeline_depth=3, ks=(1, 2, 4))
        with srv:
            futs = [srv.submit(img) for img in imgs]
            outs = [f.result(timeout=60) for f in futs]
        self._check(imgs, outs)
        # under flood the adaptive policy must have aggregated past k=1
        assert any(k > 1 for k, _ in fake.dispatches), fake.dispatches

    def test_pipeline_depth_one_and_validation(self, rng):
        img = _images(rng, 1, self.HW)[0]
        _, srv = self._make(pipeline_depth=1)
        with srv:
            out = srv.submit(img).result(timeout=60)
        self._check([img], [out])
        with pytest.raises(ValueError, match="pipeline_depth"):
            self._make(pipeline_depth=0)

    def test_worker_exception_propagates_to_futures(self, rng):
        class Boom(FakePredictor):
            def predict_many_device(self, stack):
                raise RuntimeError("device on fire")

        imgs = _images(rng, 3, self.HW)
        _, srv = self._make(fake=Boom())
        with srv:
            futs = [srv.submit(img) for img in imgs]
            for fut in futs:
                with pytest.raises(RuntimeError, match="device on fire"):
                    fut.result(timeout=60)
        assert srv._ks_live == (1, 2)  # not an OOM: nothing shrinks

    def test_pick_k_grows_with_backlog(self):
        _, srv = self._make(ks=(1, 2, 4))
        with srv:
            assert [srv._pick_k(n) for n in (1, 2, 3, 4, 5, 6, 7, 800)] == [1, 1, 2, 2, 2, 2, 4, 4]

    def test_oom_at_dispatch_shrinks_ks_and_recovers(self, rng):
        """torch.OutOfMemoryError at a k>1 dispatch: the server drops the
        failed depth for good, re-chunks, and every request still resolves."""
        class OomAbove1(FakePredictor):
            def predict_many_device(self, stack):
                if stack.shape[0] > 1:
                    raise _oom("dispatch")
                return super().predict_many_device(stack)

        imgs = _images(rng, 100, self.HW)
        fake, srv = self._make(fake=OomAbove1(), ks=(1, 2, 4), pipeline_depth=2)
        with srv:
            futs = [srv.submit(img) for img in imgs]
            outs = [f.result(timeout=60) for f in futs]
        self._check(imgs, outs)
        assert srv._ks_live == (1,)
        assert all(k == 1 for k, _ in fake.dispatches)  # every successful dispatch

    def test_oom_message_alone_is_not_an_oom(self, rng):
        """_is_oom goes by the exception's type, not by its text."""
        class Liar(FakePredictor):
            def predict_many_device(self, stack):
                raise RuntimeError("CUDA out of memory, RESOURCE_EXHAUSTED")

        _, srv = self._make(fake=Liar(), ks=(1, 2))
        with srv:
            with pytest.raises(RuntimeError, match="out of memory"):
                srv.submit(_images(rng, 1, self.HW)[0]).result(timeout=60)
        assert srv._ks_live == (1, 2)
        assert BatchServer._is_oom(_oom("x")) and not BatchServer._is_oom(MemoryError())

    def test_oom_at_resolve_falls_back_and_recovers(self, rng):
        """An OOM that surfaces when the resolver consumes the output (the
        download's host buffer): the resolver shrinks the live depths and
        re-runs the chunk at the smallest k."""
        class LazyFail:
            def __array__(self, dtype=None, copy=None):
                raise _oom("resolve")

        class AsyncOom(FakePredictor):
            def predict_many_device(self, stack):
                if stack.shape[0] > 1:
                    self.dispatches.append(stack.shape[:2])
                    return LazyFail()
                return super().predict_many_device(stack)

        imgs = _images(rng, 60, self.HW)
        _, srv = self._make(fake=AsyncOom(), ks=(1, 2), pipeline_depth=2)
        with srv:
            futs = [srv.submit(img) for img in imgs]
            outs = [f.result(timeout=60) for f in futs]
        self._check(imgs, outs)
        assert srv._ks_live == (1,)

    def test_inflight_image_budget_enforced(self, rng):
        """Dispatched-but-unresolved images never exceed max_inflight_images,
        and depths whose stacks cannot run two abreast within the budget are
        dropped upfront."""
        class LazyOut:
            def __init__(self, fake, arr):
                self.fake, self.arr = fake, arr

            def __array__(self, dtype=None, copy=None):
                time.sleep(0.01)  # hold the reservation: the worker runs ahead
                with self.fake.lock:
                    self.fake.cur -= 1
                return self.arr

        class Tracking(FakePredictor):
            def __init__(self):
                super().__init__(latency_s=0.0)
                self.cur = self.peak = 0
                self.lock = threading.Lock()

            def predict_many_device(self, stack):
                with self.lock:
                    self.cur += 1
                    self.peak = max(self.peak, self.cur)
                return LazyOut(self, super().predict_many_device(stack))

        imgs = _images(rng, 200, self.HW)
        fake, srv = self._make(fake=Tracking(), ks=(1, 2, 4), pipeline_depth=3,
                               max_inflight_images=4)
        with srv:
            assert srv.ks_requested == (1, 2, 4)
            assert srv.ks == (1,)  # k=2/4 stacks cannot run two abreast in 4
            futs = [srv.submit(img) for img in imgs]
            outs = [f.result(timeout=60) for f in futs]
        self._check(imgs, outs)
        assert fake.peak <= 2, fake.peak  # 4 images / (k=1 * batch=2)
        with pytest.raises(ValueError, match="max_inflight_images"):
            self._make(max_inflight_images=0)

    def test_oom_at_min_k_is_unrecoverable(self, rng):
        class AlwaysOom(FakePredictor):
            def predict_many_device(self, stack):
                raise _oom("even k=1")

        _, srv = self._make(fake=AlwaysOom())
        with srv:
            fut = srv.submit(_images(rng, 1, self.HW)[0])
            with pytest.raises(torch.OutOfMemoryError, match="even k=1"):
                fut.result(timeout=60)

    def test_staging_buffers_all_return(self, rng):
        """After a flood with failures on both paths every staging buffer is
        back in the pool."""
        class Flaky(FakePredictor):
            def predict_many_device(self, stack):
                if stack.shape[0] == 4:
                    raise _oom("k=4")
                return super().predict_many_device(stack)

        imgs = _images(rng, 50, self.HW)
        _, srv = self._make(fake=Flaky(), ks=(1, 2, 4), pipeline_depth=2)
        with srv:
            outs = list(srv.map(iter(imgs)))
        self._check(imgs, outs)
        assert srv._ks_live == (1, 2) and srv._staging.qsize() == 2 + 2
        assert srv._inflight_images == 0
