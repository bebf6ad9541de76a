"""Operations per image of the dual-decoder training configuration, from
shapes, over the reference networks (on the meta device: nothing is
computed).

    python3 h100bench/count_ops_dual.py            # print the count
    python3 h100bench/count_ops_dual.py --write    # write it into the configuration file

`octave-phg304-train`: the forward and backward FLOPs of one step of the
dual segmentor (`reference.dual.DualNet`) and both critics, the generator
phase's forwards and the critic phase's, as `count_ops.train_counts` counts
the single-critic step.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

DUAL = "octave-phg304-train"


def dual_train_counts(cfg: dict) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from count_ops import _meta_params
    from reference.dual import CRITICS, DualNet, critics_spec, dual_segmentor_spec, part
    from reference.model import critic
    from reference.train import ild, wpce

    hw = cfg["image_size"]
    depths = {name: c["depth"] for name, c in cfg["critic"].items()}
    seg = _meta_params(dual_segmentor_spec())
    crit = _meta_params(critics_spec((hw, hw), depths, cfg["critic"]["main"]["filters"]))
    buffers = {k: v for k, v in crit.items() if k.endswith(("weight_u", "weight_v"))}
    cp = {k: v.requires_grad_(True) for k, v in crit.items() if k not in buffers}
    trainable = {k: v.requires_grad_(True) for k, v in seg.items()
                 if k.endswith(("weight", "bias"))}
    b = 2  # batch statistics need more than one value per channel; counted per image below
    x = torch.empty((b, hw, hw, 3), device="meta")
    target = torch.empty((b, hw, hw, 2), device="meta")
    real = [torch.empty((b, hw // 2 ** i, hw // 2 ** i, 2), device="meta")
            for i in range(depths["main"] + 1)]

    def judge(params, name, pyramid, update):
        return critic(part(params, name), part(buffers, name), pyramid[:depths[name] + 1],
                      depths[name], None, update, torch.float32)

    counter = FlopCounterMode(display=False)
    with counter:
        pyramids, heads = DualNet(seg, train=True).dual(x)
        frozen = {k: v.detach() for k, v in cp.items()}
        total = sum(wpce(torch.softmax(h, -1), target) for h in heads)
        total = total + sum(ild(p) for p in pyramids)
        for name, pyramid in zip(CRITICS, pyramids):
            total = total + (judge(frozen, name, pyramid, False) - 1).square().mean()
        torch.autograd.grad(total, list(trainable.values()))
        l_d = 0
        for name, pyramid in zip(CRITICS, pyramids):
            yf = judge(cp, name, [a.detach() for a in pyramid], True)
            yr = judge(cp, name, real, True)
            l_d = l_d + (yr - 1).square().mean() + (yf + 1).square().mean()
        torch.autograd.grad(l_d, list(cp.values()))
    return {"train_flops": int(counter.get_total_flops()) // b}


def counts() -> dict:
    with open(os.path.join(HERE, "configs", f"{DUAL}.json")) as f:
        return {DUAL: dual_train_counts(json.load(f))}


def main(argv) -> int:
    got = counts()
    for name, values in got.items():
        print(name, values)
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
