"""Weight bridge: the JAX package's variable trees -> reference torch state dicts.

The inverse of `octave_tpu/utils/torch_convert.py::convert_resnest_unet`
(:237-278) for the whole segmentor family: HWIO conv kernels back to OIHW,
Dense kernels transposed back, ConvTranspose kernels (in, out, 2, 2) as they
are, BN scale/bias/mean/var back to weight/bias/running_mean/running_var, and
the backbone renamed to the U-Nets' encoder_0_1_2 / encoder_1..4 keys. The
dual decoders' `_c` branch, the encoder gates (`encoder_{i}_gate.0`) and the
classification heads (`linear_head_emb.1`, `linear_head_dec.{1,3,4,6,8}`)
map when the tree has them; so does a propagation block's `base` trunk. The
result loads into the matching module of `models/segmentor.py` (or
`models/propagation.py`) with `load_reference_state_dict`, which drops the
heads for a ResnestUNet built without them. Folded stats (octave_tpu's
fold_batch_stats) load the same way; mark the model with
`ops.norm.folded_inference` then.

`from_jax_discriminator` is the inverse of `convert_discriminator`
(:281-293): the critic's params and its `spectral` u, v go to the
reference-named state dict of `models.discriminator.DiscriminatorBlock`;
`from_jax_critics` does it for the JAX trainer's {"main", "c"} pair of
critics, under the keys of the port's `nn.ModuleDict` of them.

`convert_resnest50` is the counterpart of `convert_resnest50` (:196-210) for
the pretrained `resnest50-*.pth`: the port's `models.resnest.ResNeSt` already
carries the file's key names, so conversion is a strict key and shape check
that files the tensors under `backbone.`; `backbone_to_unet_keys` renames
them to the segmentor's encoder modules.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

Path = Tuple[str, ...]

# reference keys of the classification heads, which a ResnestUNet built
# without heads (the default) drops on load
HEAD_PREFIXES = ("linear_head_emb.", "linear_head_dec.")


def _flatten(tree: Mapping[str, Any], prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out: Dict[Path, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _j(prefix: str, sub: str) -> str:
    return sub if not prefix else f"{prefix}.{sub}"


class _Inverter:
    def __init__(self, variables: Mapping[str, Any]):
        self.leaves = {("params",) + p: v for p, v in _flatten(variables["params"]).items()}
        for col in ("batch_stats", "spectral"):
            self.leaves.update({(col,) + p: v for p, v in
                                _flatten(variables.get(col, {})).items()})
        self.sd: Dict[str, np.ndarray] = {}
        self.used: set = set()

    def _take(self, path: Path) -> np.ndarray:
        if path not in self.leaves:
            raise KeyError(f"variables are missing {'/'.join(path)}")
        self.used.add(path)
        return self.leaves[path]

    def has(self, col: str, path: Path) -> bool:
        return (col,) + path in self.leaves

    def conv(self, tkey: str, fpath: Path):
        self.sd[_j(tkey, "weight")] = self._take(("params",) + fpath + ("kernel",)).transpose(3, 2, 0, 1)
        if self.has("params", fpath + ("bias",)):
            self.sd[_j(tkey, "bias")] = self._take(("params",) + fpath + ("bias",))

    def dense(self, tkey: str, fpath: Path):
        self.sd[_j(tkey, "weight")] = self._take(("params",) + fpath + ("kernel",)).T
        if self.has("params", fpath + ("bias",)):
            self.sd[_j(tkey, "bias")] = self._take(("params",) + fpath + ("bias",))

    def conv_transpose(self, tkey: str, fpath: Path):
        self.sd[_j(tkey, "weight")] = self._take(("params",) + fpath + ("kernel",))
        self.sd[_j(tkey, "bias")] = self._take(("params",) + fpath + ("bias",))

    def spectral_conv(self, tkey: str, fpath: Path):
        """Spectral-norm conv: weight_orig, bias and the u, v buffers."""
        self.sd[_j(tkey, "weight_orig")] = self._take(("params",) + fpath + ("kernel",)).transpose(3, 2, 0, 1)
        self.sd[_j(tkey, "bias")] = self._take(("params",) + fpath + ("bias",))
        self.sd[_j(tkey, "weight_u")] = self._take(("spectral",) + fpath + ("u",))
        self.sd[_j(tkey, "weight_v")] = self._take(("spectral",) + fpath + ("v",))

    def finish(self) -> Dict[str, torch.Tensor]:
        unused = sorted("/".join(p) for p in self.leaves if p not in self.used)
        if unused:
            raise ValueError(f"{len(unused)} variable(s) not mapped: {unused[:20]}")
        return {k: torch.from_numpy(np.array(v)) for k, v in self.sd.items()}

    def bn(self, tkey: str, fpath: Path):
        self.sd[_j(tkey, "weight")] = self._take(("params",) + fpath + ("scale",))
        self.sd[_j(tkey, "bias")] = self._take(("params",) + fpath + ("bias",))
        self.sd[_j(tkey, "running_mean")] = self._take(("batch_stats",) + fpath + ("mean",))
        self.sd[_j(tkey, "running_var")] = self._take(("batch_stats",) + fpath + ("var",))

    def splat(self, tkey: str, fpath: Path):
        self.conv(_j(tkey, "conv"), fpath + ("conv", "conv"))
        self.bn(_j(tkey, "bn0"), fpath + ("bn0",))
        self.conv(_j(tkey, "fc1"), fpath + ("fc1", "conv"))
        self.bn(_j(tkey, "bn1"), fpath + ("bn1",))
        self.conv(_j(tkey, "fc2"), fpath + ("fc2", "conv"))

    def bottleneck(self, tkey: str, fpath: Path):
        self.conv(_j(tkey, "conv1"), fpath + ("conv1", "conv"))
        self.bn(_j(tkey, "bn1"), fpath + ("bn1",))
        self.splat(_j(tkey, "conv2"), fpath + ("conv2",))
        self.conv(_j(tkey, "conv3"), fpath + ("conv3", "conv"))
        self.bn(_j(tkey, "bn3"), fpath + ("bn3",))
        if self.has("params", fpath + ("downsample_conv", "conv", "kernel")):
            # the avg_down shortcut: [AvgPool, Conv, BN]
            self.conv(_j(tkey, "downsample.1"), fpath + ("downsample_conv", "conv"))
            self.bn(_j(tkey, "downsample.2"), fpath + ("downsample_bn",))

    def decoder(self, tkey: str, fpath: Path):
        self.conv(_j(tkey, "conv.0"), fpath + ("conv1", "conv"))
        self.bn(_j(tkey, "conv.1"), fpath + ("bn1",))
        self.splat(_j(tkey, "conv.3"), fpath + ("splat",))
        self.conv(_j(tkey, "downsample.0"), fpath + ("downsample_conv", "conv"))
        self.bn(_j(tkey, "downsample.1"), fpath + ("downsample_bn",))


def _walk_segmentor(inv: _Inverter) -> None:
    """The segmentor family's table: every module of the JAX tree that `inv`
    says is there, handed to `inv` under its reference name."""
    bb = ("backbone",)
    inv.conv("encoder_0_1_2.0.0", bb + ("stem_conv1", "conv"))
    inv.bn("encoder_0_1_2.0.1", bb + ("stem_bn1",))
    inv.conv("encoder_0_1_2.0.3", bb + ("stem_conv2", "conv"))
    inv.bn("encoder_0_1_2.0.4", bb + ("stem_bn2",))
    inv.conv("encoder_0_1_2.0.6", bb + ("stem_conv3", "conv"))
    inv.bn("encoder_0_1_2.1", bb + ("bn1",))
    for layer in range(1, 5):
        block = 0
        while inv.has("params", bb + (f"layer{layer}_{block}",)
                      + ("conv1", "conv", "kernel")):
            inv.bottleneck(f"encoder_{layer}.{block}", bb + (f"layer{layer}_{block}",))
            block += 1
    # the main decoder, and the dual decoders' shallow `_c` branch
    decoders = [(i, "") for i in range(5)]
    if inv.has("params", ("fc_c", "conv", "kernel")):
        decoders += [(1, "_c"), (0, "_c")]
        inv.conv("fc_c", ("fc_c", "conv"))
    for i, c in decoders:
        inv.conv_transpose(f"upsampling_{i}{c}.up", (f"upsampling_{i}{c}",))
        inv.decoder(f"decoder_{i}{c}", (f"decoder_{i}{c}",))
        if inv.has("params", (f"aag_{i}{c}", "conv1", "conv", "kernel")):
            inv.conv(f"aag_{i}{c}.conv1", (f"aag_{i}{c}", "conv1", "conv"))
    inv.conv("fc", ("fc", "conv"))
    for i in range(5):
        if inv.has("params", (f"encoder_{i}_gate", "conv", "conv", "kernel")):
            inv.conv(f"encoder_{i}_gate.0", (f"encoder_{i}_gate", "conv", "conv"))
    # classification heads, when the tree has them
    if inv.has("params", ("linear_head_emb", "kernel")):
        inv.dense("linear_head_emb.1", ("linear_head_emb",))
    if inv.has("params", ("head_dec_conv1", "conv", "kernel")):
        inv.conv("linear_head_dec.1", ("head_dec_conv1", "conv"))
        inv.bn("linear_head_dec.3", ("head_dec_bn1",))
        inv.conv("linear_head_dec.4", ("head_dec_conv2", "conv"))
        inv.bn("linear_head_dec.6", ("head_dec_bn2",))
        inv.dense("linear_head_dec.8", ("linear_head_dec",))


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of octave_tpu's ResnestUNet (with encoder
    gates and heads or without), ResnestUnetParallelHead,
    ResnestUnetParallelHeadAttentionGate, or of a propagation block
    (BasePC / BaseC / BaseMulti), as nested dicts of arrays -> the
    reference-named torch state dict. Every leaf must map."""
    inv = _Inverter(variables)
    if "base" in variables["params"]:
        inv.conv("base.conv1", ("base", "conv1", "conv"))
        inv.bn("base.bn1", ("base", "bn1"))
        inv.conv("base.conv4", ("base", "conv4", "conv"))
        inv.bn("base.bn4", ("base", "bn4"))
        inv.conv("base.conv7", ("base", "conv7", "conv"))
        inv.bn("base.bn7", ("base", "bn7"))
        return inv.finish()
    _walk_segmentor(inv)
    return inv.finish()


class _ConvNames(_Inverter):
    """Walks the segmentor's table without a tree: notes the reference name
    of every conv path the family can have (resnest50's blocks, the dual
    decoders' `_c` branch, the gates and heads)."""

    def __init__(self):
        from octave_tpu_torch.models.resnest import ResNeStConfig

        self.blocks = ResNeStConfig().layers
        self.sd, self.used, self.names = {}, set(), {}

    def has(self, col: str, path: Path) -> bool:
        if path[0] == "backbone" and path[1].startswith("layer"):
            layer, block = map(int, path[1][len("layer"):].split("_"))
            return block < self.blocks[layer - 1]
        return True

    def _take(self, path: Path):
        return None

    def conv(self, tkey: str, fpath: Path):
        self.names[fpath] = tkey

    conv_transpose = conv

    def dense(self, tkey: str, fpath: Path):
        pass  # a Dense records no int8 scale


def scales_from_jax(scales: Mapping[str, float]) -> Dict[str, float]:
    """The JAX package's int8 activation scales ({"decoder_3/conv1_a_absmax":
    s, "decoder_3/splat/conv/in_absmax": s, "upsampling_2/in_absmax": s,
    "backbone/stem_conv2/in_absmax": s, ...}, floats) of a segmentor -> the
    port's keys (ops/quant.py): `decoder_3.conv.0:a`, `decoder_3.conv.3.conv`,
    `upsampling_2.up`, `encoder_0_1_2.0.3`. Every key must map."""
    names = _ConvNames()
    _walk_segmentor(names)
    out = {}
    for key, v in scales.items():
        mod, leaf = key.rsplit("/", 1)
        parts = tuple(mod.split("/"))
        if leaf == "in_absmax":
            fpath, half = parts + ("conv",), ""
            if fpath not in names.names:
                fpath = parts  # an Upsampling's own kernel
        elif leaf.endswith(("_a_absmax", "_b_absmax")):
            fpath, half = parts + (leaf[: -len("_a_absmax")], "conv"), ":" + leaf[-len("a_absmax")]
        else:
            fpath, half = None, ""
        if fpath not in names.names:
            raise KeyError(f"no module of the port takes the JAX scale {key!r}")
        out[names.names[fpath] + half] = float(v)
    return out


def from_jax_build_resnet(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of octave_tpu's BuildResNet (CE-Net's ResNet
    of BasicBlocks) -> the state dict of `models.resnest.BuildResNet`: the
    stem `conv1`/`bn1`, then `layer{l}.{b}.conv1/bn1/conv2/bn2` and, where
    a block has it, `downsample.0/.1` from `layer{l}_{b}`'s
    downsample_conv / downsample_bn. Every leaf must map."""
    inv = _Inverter(variables)
    inv.conv("conv1", ("conv1", "conv"))
    inv.bn("bn1", ("bn1",))
    for layer in range(1, 5):
        block = 0
        while inv.has("params", (f"layer{layer}_{block}", "conv1", "conv", "kernel")):
            tkey, fpath = f"layer{layer}.{block}", (f"layer{layer}_{block}",)
            for name in ("1", "2"):
                inv.conv(f"{tkey}.conv{name}", fpath + (f"conv{name}", "conv"))
                inv.bn(f"{tkey}.bn{name}", fpath + (f"bn{name}",))
            if inv.has("params", fpath + ("downsample_conv", "conv", "kernel")):
                inv.conv(f"{tkey}.downsample.0", fpath + ("downsample_conv", "conv"))
                inv.bn(f"{tkey}.downsample.1", fpath + ("downsample_bn",))
            block += 1
    return inv.finish()


def from_jax_discriminator(variables: Mapping[str, Any],
                           instance_noise: bool = True) -> Dict[str, torch.Tensor]:
    """{"params", "spectral"} of octave_tpu's DiscriminatorBlock -> the
    reference-named state dict of `models.discriminator.DiscriminatorBlock`
    (the inverse of `convert_discriminator`, torch_convert.py:281-293).
    Every leaf must map."""
    inv = _Inverter(variables)
    inv.conv(f"stack_0.{int(instance_noise)}", ("conv_0",))
    depth = 0
    while inv.has("params", (f"squeeze_{depth}", "kernel")):
        inv.conv(f"squeeze_dict.squeeze_{depth}.0", (f"squeeze_{depth}",))
        inv.spectral_conv(f"spectral_dict.spectral_{depth}.0", (f"spectral_{depth}",))
        depth += 1
    inv.conv("out.0", ("out_conv",))
    return inv.finish()


def from_jax_critics(params: Mapping[str, Any], spectral: Mapping[str, Any],
                     instance_noise: bool = True) -> Dict[str, torch.Tensor]:
    """The JAX trainer's pair of critics, `disc_params` and `spectral` as
    {"main": ..., "c": ...} dicts -> the state dict of the port's
    `nn.ModuleDict` of DiscriminatorBlocks (keys `main.<key>`, `c.<key>`)."""
    if set(params) != set(spectral):
        raise ValueError(f"critics {sorted(params)} and spectral {sorted(spectral)} differ")
    return {f"{name}.{k}": v for name in params for k, v in from_jax_discriminator(
        {"params": params[name], "spectral": spectral[name]}, instance_noise).items()}


def load_reference_state_dict(model: nn.Module, state_dict: Mapping[str, Any]) -> nn.Module:
    """Load a reference-named state dict (torch tensors or numpy arrays) into
    `model`. The classification heads are dropped when the model was built
    without them; every other key must map, and every parameter and buffer
    of `model` must be given, except BN step counters and the gates of
    depths the model does not gate (`idle_prefixes`)."""
    has_heads = any(k.startswith(HEAD_PREFIXES) for k in model.state_dict())
    sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
          for k, v in state_dict.items() if has_heads or not k.startswith(HEAD_PREFIXES)}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    idle = model.idle_prefixes() if hasattr(model, "idle_prefixes") else ()
    missing = [k for k in missing if not k.endswith("num_batches_tracked")
               and not k.startswith(idle)]
    if missing or unexpected:
        raise ValueError(f"state dict does not match the model: missing {missing[:20]}, "
                         f"unexpected {unexpected[:20]}")
    return model


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a .pth state dict (tensors only) onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach() for k, v in sd.items() if torch.is_tensor(v)}


def convert_resnest50(sd: Mapping[str, torch.Tensor], with_fc: bool = True,
                      strict: bool = True) -> Dict[str, torch.Tensor]:
    """A resnest50 classification state dict -> {"backbone.<key>": tensor}.

    Every tensor the backbone needs must be there with its shape (KeyError /
    ValueError otherwise). With `strict`, every tensor of the file must also
    have been taken: nothing is dropped silently except BN step counters and,
    with with_fc=False, the classification head `fc`."""
    from octave_tpu_torch.models.resnest import resnest50

    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in resnest50().state_dict().items()
                if not k.endswith("num_batches_tracked")}
    if with_fc:
        want.update({"fc.weight": (1000, 2048), "fc.bias": (1000,)})
    out = {}
    for key, shape in want.items():
        if key not in sd:
            near = [k for k in sd if k.split(".")[0] == key.split(".")[0]][:8]
            raise KeyError(f"state dict is missing {key!r}; keys under the same module: {near}")
        if tuple(sd[key].shape) != shape:
            raise ValueError(f"{key}: shape {tuple(sd[key].shape)}, expected {shape}")
        out["backbone." + key] = sd[key]
    unused = sorted(k for k in sd if k not in want and not k.endswith("num_batches_tracked")
                    and not (k.startswith("fc.") and not with_fc))
    if strict and unused:
        raise ValueError(f"{len(unused)} state dict tensor(s) were not mapped (the .pth does "
                         f"not match resnest50): {unused[:20]}")
    return out


def backbone_to_unet_keys(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """{"backbone.<resnest key>"} -> the ResnestUNet's own names: the deep
    stem `conv1` and `bn1` are `encoder_0_1_2.0` and `.1`, `layerN` is
    `encoder_N`; the classification `fc` has no place in the segmentor."""
    out = {}
    for key, v in tree.items():
        key = key[len("backbone."):]
        head, rest = key.split(".", 1)
        if head == "conv1":
            out["encoder_0_1_2.0." + rest] = v
        elif head == "bn1":
            out["encoder_0_1_2.1." + rest] = v
        elif head.startswith("layer"):
            out[f"encoder_{head[len('layer'):]}.{rest}"] = v
    return out
