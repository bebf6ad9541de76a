"""Operations per image of each configuration, from shapes, over the
reference networks (on the meta device: nothing is computed).

    python3 h100bench/count_ops.py            # print the counts
    python3 h100bench/count_ops.py --write    # write them into the configuration files

Serving (`octave-unet304-int8-serve`): the eval forward's bfloat16 FLOPs and,
apart, the int8 operations of the convs that scope `decoder` quantises
(`decoder_<depth>.*`), each a multiply-add counted as two, grouped convs
without their block-diagonal zeros (`torch.utils.flop_counter` counts a
grouped conv's true products); the int8 sites themselves, for the int8
conv kernel's bound; and the gated depths, for the decoder epilogue's.
Training (`octave-adv304-train`): the forward and backward FLOPs of the
segmentor and the critic in one step.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

SERVE = "octave-unet304-int8-serve"
TRAIN = "octave-adv304-train"


def _meta_params(spec):
    import torch

    return {k: torch.empty(shape, device="meta", dtype=torch.long if kind == "count"
                           else torch.float32) for k, (kind, shape) in spec.items()}


def decoder_sites(hw: int):
    """The int8 sites of scope `decoder`, one kernel launch each: every conv
    of `decoder_<depth>`, its first conv and its shortcut taking the (skip,
    upsampled) pair as two sources."""
    from reference.model import DECODER_WIDTHS

    sites = []
    for depth in range(5):
        _, uo, di, do = DECODER_WIDTHS[depth]
        h = -(-hw // 2 ** depth)  # 304, 152, 76, 38, 19
        src = [di] if depth == 0 else [di - uo, uo]
        inter = max(do * 2 // 4, 32)
        name = f"decoder_{depth}"
        sites += [
            {"name": name + ".conv.0", "sources": src, "hw": h, "hw_out": h, "cout": do, "k": 3,
             "groups": 1, "bias": False},
            {"name": name + ".conv.3.conv", "sources": [do], "hw": h, "hw_out": h,
             "cout": 2 * do, "k": 3, "groups": 4, "bias": True},
            {"name": name + ".conv.3.fc1", "sources": [do], "hw": 1, "hw_out": 1, "cout": inter,
             "k": 1, "groups": 2, "bias": True},
            {"name": name + ".conv.3.fc2", "sources": [inter], "hw": 1, "hw_out": 1,
             "cout": 2 * do, "k": 1, "groups": 2, "bias": True},
            {"name": name + ".downsample.0", "sources": src, "hw": h, "hw_out": h, "cout": do,
             "k": 1, "groups": 1, "bias": False},
        ]
    return sites


def serve_counts(hw: int) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference.model import Net, segmentor_spec

    p = _meta_params(segmentor_spec())
    x = torch.empty((1, hw, hw, 3), device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        Net(p, train=False).segmentor(x)
    total = counter.get_total_flops()
    # the reference is a function, not modules: the decoder's share is
    # counted from its sites, by the formula FlopCounterMode applies
    int8 = sum(site_ops(s, 1) for s in decoder_sites(hw))
    return {"bf16_flops": int(total - int8), "int8_ops": int(int8),
            "int8_sites": decoder_sites(hw), "epilogue_depths": epilogue_depths(hw)}


def epilogue_depths(hw: int):
    """The decoder epilogue's launches, one per gated depth: the side and
    the channels of the decoder block's output it gates."""
    from reference.model import DECODER_WIDTHS

    return [{"hw": -(-hw // 2 ** depth), "channels": DECODER_WIDTHS[depth][3]}
            for depth in range(5)]


def site_ops(site: dict, batch: int) -> int:
    rows = batch * site["hw_out"] ** 2
    return 2 * rows * site["cout"] * sum(site["k"] ** 2 * c // site["groups"]
                                         for c in site["sources"])


def train_counts(cfg: dict) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from reference.model import critic, critic_spec, Net, segmentor_spec
    from reference.train import ild, wpce

    hw = cfg["image_size"]
    depth, nf = cfg["critic"]["depth"], cfg["critic"]["filters"]
    seg = _meta_params(segmentor_spec())
    crit = _meta_params(critic_spec((hw, hw), depth, nf))
    buffers = {k: v for k, v in crit.items() if k.endswith(("weight_u", "weight_v"))}
    cp = {k: v.requires_grad_(True) for k, v in crit.items() if k not in buffers}
    trainable = {k: v.requires_grad_(True) for k, v in seg.items()
                 if k.endswith(("weight", "bias"))}
    b = 2  # batch statistics need more than one value per channel; counted per image below
    x = torch.empty((b, hw, hw, 3), device="meta")
    target = torch.empty((b, hw, hw, 2), device="meta")
    real = [torch.empty((b, hw // 2 ** i, hw // 2 ** i, 2), device="meta")
            for i in range(depth + 1)]
    counter = FlopCounterMode(display=False)
    with counter:
        pyramid, logits = Net(seg, train=True).segmentor(x)
        frozen = {k: v.detach() for k, v in cp.items()}
        y = critic(frozen, buffers, pyramid[:depth + 1], depth, None, False, torch.float32)
        total = wpce(torch.softmax(logits, -1), target) + ild(pyramid) + (y - 1).square().mean()
        torch.autograd.grad(total, list(trainable.values()))
        fake = [a.detach() for a in pyramid[:depth + 1]]
        yf = critic(cp, buffers, fake, depth, None, True, torch.float32)
        yr = critic(cp, buffers, real, depth, None, True, torch.float32)
        torch.autograd.grad((yr - 1).square().mean() + (yf + 1).square().mean(), list(cp.values()))
    return {"train_flops": int(counter.get_total_flops()) // b}


def counts() -> dict:
    with open(os.path.join(HERE, "configs", f"{SERVE}.json")) as f:
        serve = json.load(f)
    with open(os.path.join(HERE, "configs", f"{TRAIN}.json")) as f:
        train = json.load(f)
    return {SERVE: serve_counts(serve["image_size"]), TRAIN: train_counts(train)}


def main(argv) -> int:
    got = counts()
    for name, values in got.items():
        print(name, {k: v for k, v in values.items() if not isinstance(v, list)})
    if "--write" in argv:
        for name, values in got.items():
            path = os.path.join(HERE, "configs", f"{name}.json")
            with open(path) as f:
                cfg = json.load(f)
            cfg["per_image"] = values
            with open(path, "w") as f:
                json.dump(cfg, f, indent=2)
                f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
