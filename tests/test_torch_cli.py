"""The port's command line on the CPU: train with a checkpoint, eval from it,
predict over a folder, convert a pretrained backbone, run the bench small.

Every command is driven in process through `cli.main` with `--device cpu`;
without `--device cpu` and without a GPU each must exit asking for CUDA.
"""
import ast
import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch
from goldens import fill_state_dict

from port_fixtures import few_torch_threads  # noqa: F401  (autouse, module scope)
from octave_tpu_torch.cli import main
from octave_tpu_torch.models.resnest import resnest50
from octave_tpu_torch.ops.quant import int8_mm
from octave_tpu_torch.serve import Predictor
from octave_tpu_torch.train.trainer import Trainer
from octave_tpu_torch.utils.checkpoint import CheckpointManager, load_pytree
from octave_tpu_torch.utils.config import Config
from octave_tpu_torch.utils.imageio import read_image, write_png_gray

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "synthetic_smoke.json")
SMALL = ["data.image_size=[32,32]", "data.synthetic_n=4", "data.batch_size=2",
         "train.eval_every=0", "train.log_every=0"]


@pytest.fixture(autouse=True)
def _remove_big_files(tmp_path):
    """The .pth copies and outputs of these tests are ~100 MB each."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _printed_metrics(capsys):
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    return ast.literal_eval(lines[-1])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A checkpoint directory written by `cli train` (2 steps at 32²), and
    the metrics that command printed."""
    d = tmp_path_factory.mktemp("ckpt")
    yield str(d)
    shutil.rmtree(d, ignore_errors=True)  # ~0.9 GB


def test_train_then_eval_checkpoint_reproduces_metrics(checkpoint, capsys):
    """`eval --checkpoint` prints exactly the metrics `train` printed: the
    restore brings back the BN running stats with the parameters."""
    common = ["--config", SMOKE, "--device", "cpu", *SMALL]
    assert main(["train", *common, "train.steps=2", f"train.checkpoint_dir={checkpoint}"]) == 0
    trained = _printed_metrics(capsys)
    assert set(trained) == {"dice", "iou", "accuracy", "sensitivity", "specificity", "auc"}
    assert os.listdir(checkpoint) == ["step_00000002"]
    assert main(["eval", "--checkpoint", checkpoint, *common]) == 0
    assert _printed_metrics(capsys) == trained
    # without a checkpoint eval scores the fresh initialisation
    assert main(["eval", *common]) == 0
    assert _printed_metrics(capsys) != trained
    with pytest.raises(SystemExit, match="no checkpoint found"):
        main(["eval", "--checkpoint", os.path.join(checkpoint, "empty"), *common])


def test_predict_directory(checkpoint, tmp_path, rng):
    """One <name>_prob.npy and one <name>_mask.png per image, equal to the
    Predictor called directly on the checkpoint's weights."""
    if not os.listdir(checkpoint):
        pytest.skip("needs the checkpoint of the train test")
    img_dir, out_dir = tmp_path / "imgs", tmp_path / "out"
    img_dir.mkdir()
    arrays = [rng.integers(0, 256, (40, 40), dtype=np.uint8) for _ in range(3)]
    for i, a in enumerate(arrays):
        write_png_gray(str(img_dir / f"im{i}.png"), a)
    args = ["predict", "--images", str(img_dir), "--out", str(out_dir), "--config", SMOKE,
            "--device", "cpu", *SMALL]
    assert main([*args, "--checkpoint", checkpoint]) == 0
    assert sorted(os.listdir(out_dir)) == [
        "im0_mask.png", "im0_prob.npy", "im1_mask.png", "im1_prob.npy",
        "im2_mask.png", "im2_prob.npy"]
    cfg = Config.load(SMOKE).apply_overrides(dict(a.split("=") for a in SMALL))
    state = CheckpointManager(checkpoint).restore_latest(Trainer(cfg, device="cpu").init_state())
    direct = Predictor(state.segmentor.state_dict(), device="cpu")
    rows = (np.arange(32) * 40) // 32  # load_image_batch's nearest resize
    xs = [np.repeat((a[rows][:, rows].astype(np.float32) / 255.0)[None, ..., None], 3, -1)
          for a in arrays]
    # the command's batches at data.batch_size=2: [im0, im1], then [im2]
    want = np.concatenate([direct(np.concatenate(xs[:2])), direct(xs[2])])[..., 1]
    for i in range(3):
        p = np.load(out_dir / f"im{i}_prob.npy")
        m = read_image(str(out_dir / f"im{i}_mask.png"))
        assert p.shape == (32, 32) and p.dtype == np.float32 and 0.0 <= p.min() <= p.max() <= 1.0
        np.testing.assert_array_equal(p, want[i])
        np.testing.assert_array_equal(m, np.where(want[i] >= 0.5, 255, 0))
    # without a checkpoint: fresh weights, still one pair of files per image
    fresh = ["predict", "--images", str(img_dir), "--out", str(tmp_path / "out2"),
             "--config", SMOKE, "--device", "cpu", *SMALL]
    assert main(fresh) == 0
    assert len(os.listdir(tmp_path / "out2")) == 6
    # --int8: the decoder in int8, calibrated on the command's first batch
    int8_dir = tmp_path / "out_int8"
    int8_mm.launches = 0
    assert main([*args[:4], str(int8_dir), *args[5:], "--checkpoint", checkpoint, "--int8"]) == 0
    assert int8_mm.launches == 2 * 33  # two batches, 33 int8 GEMMs in the decoder
    direct8 = Predictor(state.segmentor.state_dict(), device="cpu", int8_decoder=True,
                        calibration_batches=[np.concatenate(xs[:2])])
    want8 = np.concatenate([direct8(np.concatenate(xs[:2])), direct8(xs[2])])[..., 1]
    for i in range(3):
        p = np.load(int8_dir / f"im{i}_prob.npy")
        np.testing.assert_array_equal(p, want8[i])
        np.testing.assert_array_equal(read_image(str(int8_dir / f"im{i}_mask.png")),
                                      np.where(want8[i] >= 0.5, 255, 0))
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no images found"):
        main(["predict", "--images", str(tmp_path / "empty"), "--out", str(out_dir),
              "--device", "cpu"])


@pytest.mark.parametrize("cmd", ["train", "eval", "predict", "bench"])
def test_commands_need_cuda_by_default(tmp_path, cmd):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    config = ["--config", SMOKE, *SMALL]
    args = {"train": config, "eval": config,
            "predict": ["--images", str(tmp_path), "--out", str(tmp_path / "o"), *config],
            "bench": []}[cmd]  # bench takes no config: its configuration is fixed
    write_png_gray(str(tmp_path / "a.png"), np.zeros((8, 8), np.uint8))
    with pytest.raises(SystemExit, match="CUDA is not available"):
        main([cmd, *args])


def test_bench_command_on_cpu(capsys, monkeypatch):
    """`bench --device cpu` runs `bench.main` on the CPU and prints its one
    JSON line; the default size is patched down to B = 4, 32², k = 2."""
    from octave_tpu_torch import bench

    defaults = dict(zip(bench.main.__code__.co_varnames, bench.main.__defaults__))
    assert defaults == {"batch": 256, "hw": 304, "k": 4, "device": None}
    monkeypatch.setattr(bench.main, "__defaults__", (4, 32, 2, None))
    assert main(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert set(record) == {"metric", "value", "unit", "per_call_img_s",
                           "int8_mask_agreement", "device"}
    assert record["metric"].startswith("32x32 en-face") and record["device"] == "cpu"


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_data_parallel_train_spawns_ranks_and_eval_joins_torchrun(tmp_path, capsys,
                                                                   monkeypatch):
    """`train train.data_parallel=true train.n_devices=2 --device cpu`
    spawns two gloo ranks, and rank 0's metrics are, exactly, those of a
    single-device `eval` of the checkpoint rank 0 wrote and of a
    data-parallel `eval` that joins a torchrun group as its one rank."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the spawned ranks' PyTorch threads
    common = ["--config", SMOKE, "--device", "cpu", *SMALL]
    ckpt = str(tmp_path / "ckpt")
    assert main(["train", *common, "train.steps=1", "train.data_parallel=true",
                 "train.n_devices=2", f"train.checkpoint_dir={ckpt}"]) == 0
    trained = _printed_metrics(capsys)
    assert os.listdir(ckpt) == ["step_00000001"]
    assert main(["eval", "--checkpoint", ckpt, *common]) == 0
    assert _printed_metrics(capsys) == trained
    torchrun = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    for k, v in torchrun.items():
        monkeypatch.setenv(k, v)
    assert main(["eval", "--checkpoint", ckpt, *common, "train.data_parallel=true"]) == 0
    assert _printed_metrics(capsys) == trained
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit, match="needs train.n_devices"):
        main(["train", *common, "train.data_parallel=true"])
    # more ranks than visible GPUs is refused before anything is spawned
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="train.n_devices=2 but only 1 CUDA devices"):
        main(["train", "--config", SMOKE, *SMALL, "train.data_parallel=true",
              "train.n_devices=2"])


# -- convert and the pretrained backbone ---------------------------------------
@pytest.fixture(scope="module")
def resnest_pth(tmp_path_factory):
    """A resnest50 classification state dict, filled as the goldens are
    (tests/goldens.py::fill_state_dict), saved as a .pth."""
    with torch.device("meta"):
        manifest = {k: tuple(v.shape) for k, v in resnest50().state_dict().items()}
    manifest.update({"fc.weight": (1000, 2048), "fc.bias": (1000,)})
    sd = {k: torch.from_numpy(v) for k, v in fill_state_dict(manifest).items()}
    d = tmp_path_factory.mktemp("pth")
    path = d / "resnest50.pth"
    torch.save(sd, path)
    yield str(path), sd
    shutil.rmtree(d, ignore_errors=True)


def test_convert_checks_the_sha256(resnest_pth, tmp_path, capsys):
    path, sd = resnest_pth
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    out = str(tmp_path / "backbone.pt")
    assert main(["convert", "--pth", path, "--out", out, "--sha256", digest.upper()]) == 0
    assert f"sha256 verified: {digest}" in capsys.readouterr().out
    tree = load_pytree(out)
    assert len(tree) == len([k for k in sd if not k.endswith("num_batches_tracked")])
    assert all(k.startswith("backbone.") for k in tree)
    for k in ("conv1.0.weight", "layer3.5.conv2.fc2.bias", "layer4.0.downsample.2.running_var",
              "fc.weight"):
        assert torch.equal(tree["backbone." + k], sd[k]), k
    with pytest.raises(SystemExit, match="sha256 mismatch"):
        main(["convert", "--pth", path, "--out", out, "--sha256", "0" * 64])


def test_convert_checks_the_filename_fragment(resnest_pth, tmp_path, capsys):
    path, _ = resnest_pth
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    good = str(tmp_path / f"resnest50-{digest[:8]}.pth")
    bad = str(tmp_path / "resnest50-528c19ca.pth")
    shutil.copy(path, good)
    shutil.copy(path, bad)
    out = str(tmp_path / "b.pt")
    assert main(["convert", "--pth", good, "--out", out, "--no-fc"]) == 0
    assert "sha256 prefix verified via filename" in capsys.readouterr().out
    assert not any(k.startswith("backbone.fc.") for k in load_pytree(out))
    with pytest.raises(SystemExit, match="does not match"):
        main(["convert", "--pth", bad, "--out", out])


def test_convert_is_strict_about_keys(resnest_pth, tmp_path):
    path, sd = resnest_pth
    extra = str(tmp_path / "extra.pth")
    torch.save({**sd, "layer9.0.weight": torch.zeros(3)}, extra)
    out = str(tmp_path / "e.pt")
    with pytest.raises(ValueError, match="not mapped"):
        main(["convert", "--pth", extra, "--out", out])
    assert main(["convert", "--pth", extra, "--out", out, "--lenient"]) == 0
    missing = str(tmp_path / "missing.pth")
    torch.save({k: v for k, v in sd.items() if k != "layer2.1.bn1.weight"}, missing)
    with pytest.raises(KeyError, match="layer2.1.bn1.weight"):
        main(["convert", "--pth", missing, "--out", out, "--lenient"])
    wrong = str(tmp_path / "wrong.pth")
    torch.save({**sd, "bn1.bias": torch.zeros(3)}, wrong)
    with pytest.raises(ValueError, match="bn1.bias"):
        main(["convert", "--pth", wrong, "--out", out])


def test_pretrained_backbone_loads_into_the_encoder(resnest_pth):
    """model.pretrain puts the .pth's tensors into the segmentor's encoder
    (stem, bn1, layer1-4) and leaves decoder and head as initialised."""
    path, sd = resnest_pth
    over = dict(a.split("=") for a in SMALL)
    tr = Trainer(Config.load(SMOKE).apply_overrides(
        {**over, "model.pretrain": "true", "model.weight_path": path}), device="cpu")
    got = tr.init_state().segmentor.state_dict()
    plain = Trainer(Config.load(SMOKE).apply_overrides(over), device="cpu")
    fresh = plain.init_state().segmentor.state_dict()
    assert torch.equal(got["encoder_0_1_2.0.0.weight"], sd["conv1.0.weight"])
    assert torch.equal(got["encoder_0_1_2.1.running_var"], sd["bn1.running_var"])
    assert torch.equal(got["encoder_3.5.conv2.fc2.bias"], sd["layer3.5.conv2.fc2.bias"])
    assert torch.equal(got["encoder_4.0.downsample.2.weight"], sd["layer4.0.downsample.2.weight"])
    n_loaded = sum(not torch.equal(got[k], fresh[k]) for k in got if k.startswith("encoder_"))
    assert n_loaded == len([k for k in sd if not k.startswith("fc.")
                            and not k.endswith("num_batches_tracked")])
    for k in ("decoder_0.conv.0.weight", "fc.weight", "aag_2.conv1.weight"):
        assert torch.equal(got[k], fresh[k]), k
    with pytest.raises(FileNotFoundError):
        Trainer(Config.load(SMOKE).apply_overrides(
            {**over, "model.pretrain": "true", "model.weight_path": "/nonexistent/r.pth"}),
            device="cpu").init_state()
