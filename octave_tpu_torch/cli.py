"""octave_tpu_torch command line: train / eval / predict / convert / bench.

Usage:
    python -m octave_tpu_torch.cli train   [--config cfg.json] [--device cuda|cpu] [k.ey=value ...]
    python -m octave_tpu_torch.cli eval    --checkpoint DIR [--config ...] [--device ...] [k.ey=value ...]
    python -m octave_tpu_torch.cli predict --images DIR --out DIR [--checkpoint DIR] [--device ...] [...]
    python -m octave_tpu_torch.cli convert --pth resnest50-<hash>.pth --out backbone.pt [--sha256 HEX]
    python -m octave_tpu_torch.cli bench   [--device ...]

The port of `octave_tpu/cli.py` (`train` :40-48, `eval` :51-66, `convert`
:69-104, `predict` :107-170, --int8 included, `bench` :173-177): the same
config files and dotted overrides (utils/config.py). `train` and `eval` build
the segmentor that `model.architecture` and `model.encoder_gating` name;
`predict` serves ResnestUNet only, as the JAX Predictor does. `bench` runs
the serving benchmark (`octave_tpu_torch/bench.py`) and prints its JSON
line. The device is CUDA unless --device says otherwise; without CUDA the
commands exit with a message.

`train` and `eval` with `train.data_parallel=true [train.n_devices=N]` run
one rank per device: under torchrun (WORLD_SIZE set) this process joins the
group torchrun describes and takes cuda:LOCAL_RANK; otherwise it spawns N
ranks itself, one per visible GPU by default (with --device cpu, N must be
given and the ranks share the CPU). NCCL joins CUDA ranks, gloo CPU ranks.
Rank 0 prints the metrics.
"""
from __future__ import annotations

import argparse
import hashlib
import logging
import os
import re
import sys
from typing import Dict, List


def _parse_overrides(items: List[str]) -> Dict[str, str]:
    out = {}
    for it in items:
        if "=" not in it:
            raise SystemExit(f"override must be key=value, got: {it}")
        k, v = it.split("=", 1)
        out[k] = v
    return out


def _load_cfg(args):
    from octave_tpu_torch.utils.config import Config

    cfg = Config.load(args.config) if args.config else Config()
    if args.overrides:
        cfg = cfg.apply_overrides(_parse_overrides(args.overrides))
    return cfg


def _device(args):
    from octave_tpu_torch.serve import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"octave_tpu_torch {args.cmd}: {e}")


def _restored_state(trainer, checkpoint: str):
    """A fresh TrainState with the newest checkpoint of `checkpoint` loaded."""
    from octave_tpu_torch.utils.checkpoint import CheckpointManager

    state = CheckpointManager(checkpoint).restore_latest(trainer.init_state())
    if state is None:
        raise SystemExit(f"no checkpoint found in {checkpoint}")
    return state


def _train(trainer, args) -> Dict[str, float]:
    return trainer.evaluate(trainer.fit())


def _evaluate(trainer, args) -> Dict[str, float]:
    state = (_restored_state(trainer, args.checkpoint) if args.checkpoint
             else trainer.init_state())
    return trainer.evaluate(state)


_COMMANDS = {"train": _train, "eval": _evaluate}


def _rank_main(device, args, cfg) -> Dict[str, float]:
    """One rank of `train` / `eval` under data parallelism (a spawned
    process: it configures its own logging)."""
    from octave_tpu_torch.train.trainer import Trainer

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        stream=sys.stderr)
    return _COMMANDS[args.cmd](Trainer(cfg, device=device), args)


def _data_parallel(args, cfg):
    """Run the command on every rank; rank 0's metrics, or None on the
    other ranks of a torchrun group."""
    import torch

    from octave_tpu_torch.parallel import ddp

    cpu = torch.device(args.device).type == "cpu"
    backend = "gloo" if cpu else "nccl"
    if "WORLD_SIZE" in os.environ:  # one rank of a torchrun group
        device = torch.device("cpu") if cpu else torch.device("cuda", ddp.local_rank())
        if not cpu:
            _device(args)  # exits without CUDA
            torch.cuda.set_device(device)
        ddp.init_distributed(backend)
        rank = ddp.rank()
        try:
            metrics = _rank_main(device, args, cfg)
            ddp.barrier()
        finally:
            torch.distributed.destroy_process_group()
        return metrics if rank == 0 else None
    n = cfg.train.n_devices
    if cpu:
        if n is None:
            raise SystemExit(f"octave_tpu_torch {args.cmd}: train.data_parallel with --device cpu "
                             "needs train.n_devices=N")
        devices = ["cpu"] * int(n)
    else:
        _device(args)
        visible = torch.cuda.device_count()
        n = visible if n is None else int(n)
        if n > visible:
            raise SystemExit(f"octave_tpu_torch {args.cmd}: train.n_devices={n} but only "
                             f"{visible} CUDA devices are visible")
        devices = [f"cuda:{r}" for r in range(n)]
    cfg = cfg.apply_overrides({"train.n_devices": str(len(devices))})
    return ddp.launch(_rank_main, len(devices), backend, devices, args=(args, cfg),
                      timeout=None)[0]


def cmd_train_or_eval(args) -> int:
    cfg = _load_cfg(args)
    if cfg.train.data_parallel:
        metrics = _data_parallel(args, cfg)
    else:
        from octave_tpu_torch.train.trainer import Trainer

        metrics = _COMMANDS[args.cmd](Trainer(cfg, device=_device(args)), args)
    if metrics is not None:
        print({k: round(v, 4) for k, v in metrics.items()})
    return 0


def cmd_convert(args) -> int:
    from octave_tpu_torch.utils.checkpoint import save_pytree
    from octave_tpu_torch.utils.convert import convert_resnest50, load_torch_state_dict

    # checksum-verified ingest: --sha256 checks the full digest; otherwise a
    # torch-hub style `-<hex>` filename fragment (resnest50-528c19ca.pth) is
    # verified as a prefix of the digest
    with open(args.pth, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if args.sha256:
        if digest != args.sha256.lower():
            raise SystemExit(f"sha256 mismatch for {args.pth}: got {digest}, "
                             f"expected {args.sha256}")
        print(f"sha256 verified: {digest}")
    else:
        m = re.search(r"-([0-9a-f]{8,})\.pth$", args.pth)
        if m:
            frag = m.group(1)
            if not digest.startswith(frag):
                raise SystemExit(f"filename hash fragment {frag!r} does not match the "
                                 f"file's sha256 {digest}: corrupted or renamed download")
            print(f"sha256 prefix verified via filename: {digest}")

    sd = load_torch_state_dict(args.pth)
    tree = convert_resnest50(sd, with_fc=not args.no_fc, strict=not args.lenient)
    save_pytree(args.out, tree)
    n = sum(v.numel() for v in tree.values())
    print(f"converted {len(sd)} torch tensors -> {args.out} ({n / 1e6:.1f}M params)")
    return 0


def cmd_predict(args) -> int:
    """Segment a directory of images: per image, the vessel probability map
    as <name>_prob.npy and its 0.5 mask as <name>_mask.png."""
    import numpy as np

    from octave_tpu_torch.data.datasets import _list_images, load_image_batch
    from octave_tpu_torch.serve import Predictor
    from octave_tpu_torch.utils.imageio import write_png_gray

    cfg = _load_cfg(args)
    if cfg.model.architecture != "unet" or cfg.model.encoder_gating:
        raise SystemExit(
            f"octave_tpu_torch predict: serves ResnestUNet without encoder gating only (the "
            f"Predictor's model, as in the JAX package); got model.architecture="
            f"{cfg.model.architecture!r}, model.encoder_gating={cfg.model.encoder_gating}")
    device = _device(args)
    size = tuple(cfg.data.image_size)
    paths = _list_images(args.images)
    if not paths:
        raise SystemExit(f"no images found in {args.images}")
    os.makedirs(args.out, exist_ok=True)
    bs = cfg.data.batch_size

    def batches():
        for i in range(0, len(paths), bs):
            imgs = load_image_batch(paths[i: i + bs], size)
            yield np.repeat((imgs.astype(np.float32) / 255.0)[..., None], 3, axis=-1)

    kw = dict(num_classes=cfg.model.num_classes, device=device)
    if args.int8:
        # int8 PTQ of the decoder; the first batch doubles as the calibration set
        kw.update(int8_decoder=True, calibration_batches=[next(batches())])
    if args.checkpoint:
        from octave_tpu_torch.train.trainer import Trainer

        state = _restored_state(Trainer(cfg, device=device), args.checkpoint)
        pred = Predictor(state.segmentor.state_dict(), **kw)
    else:
        pred = Predictor.initialize(image_hw=size, **kw)

    i = 0
    for out in pred.predict_stream(batches()):
        for b in range(out.shape[0]):
            name = os.path.splitext(os.path.basename(paths[i]))[0]
            vessel = out[b, ..., 1] if out.shape[-1] > 1 else out[b, ..., 0]
            np.save(os.path.join(args.out, name + "_prob.npy"), vessel)
            write_png_gray(os.path.join(args.out, name + "_mask.png"),
                           (vessel >= 0.5).astype(np.uint8) * 255)
            i += 1
    print(f"wrote {i} predictions to {args.out}")
    return 0


def cmd_bench(args) -> int:
    from octave_tpu_torch import bench

    bench.main(device=_device(args))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        stream=sys.stderr)
    p = argparse.ArgumentParser(prog="octave_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", default=None, help="YAML/JSON config path")
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        sp.add_argument("overrides", nargs="*", help="dotted key=value overrides")

    sp = sub.add_parser("train")
    common(sp)
    sp.set_defaults(fn=cmd_train_or_eval)

    sp = sub.add_parser("eval")
    sp.add_argument("--checkpoint", default=None)
    common(sp)
    sp.set_defaults(fn=cmd_train_or_eval)

    sp = sub.add_parser("convert")
    sp.add_argument("--pth", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--no-fc", action="store_true")
    sp.add_argument("--sha256", default=None,
                    help="expected sha256 of the .pth (fails on mismatch)")
    sp.add_argument("--lenient", action="store_true",
                    help="skip the strict full-key-coverage check")
    sp.set_defaults(fn=cmd_convert)

    sp = sub.add_parser("predict")
    sp.add_argument("--images", required=True, help="directory of input images")
    sp.add_argument("--out", required=True, help="output directory")
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--int8", action="store_true",
                    help="int8 post-training quantisation of the decoder, calibrated on "
                         "the first batch")
    common(sp)
    sp.set_defaults(fn=cmd_predict)

    sp = sub.add_parser("bench")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
